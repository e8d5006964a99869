"""The SD1.5 train step and its state assembly, ported from
``stable_diffusion_training_tpu/train``: ``on_device_model_training_state``
then ``train_step``, the pair the JAX package's tests drive."""

from .config import TrainingConfig, training_config_from_dict
from .states import (
    FrozenModel,
    TrainState,
    build_lr_schedule,
    create_frozen_states,
    create_lion_optimizer_states,
    load_models,
    on_device_model_training_state,
)
from .train_step import train_step

__all__ = [
    "FrozenModel",
    "TrainState",
    "TrainingConfig",
    "build_lr_schedule",
    "create_frozen_states",
    "create_lion_optimizer_states",
    "load_models",
    "on_device_model_training_state",
    "train_step",
    "training_config_from_dict",
]
