"""The SD1.5 train step, its state assembly, checkpoints and the chunked
trainer, ported from ``stable_diffusion_training_tpu/train``:
``on_device_model_training_state`` then ``train_step``, the pair the JAX
package's tests drive, and ``trainer.main``, the body of the command line."""

from .aot import all_unique_resolutions, batch_dispatch_key, bucket_train_steps
from .checkpoint import restore_train_state, save_model, save_train_state
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
    "all_unique_resolutions",
    "batch_dispatch_key",
    "bucket_train_steps",
    "restore_train_state",
    "save_model",
    "save_train_state",
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
