"""The port's command line: ``python -m stable_diffusion_training_tpu_torch.training``
reads ``model_properties.json`` (the JAX package's schema; the root
``training.py`` is the JAX command line) and runs the chunked training loop
on the card.

Optionally pass a config path:
``python -m stable_diffusion_training_tpu_torch.training my_config.json``.

Under torchrun, ``torchrun --standalone --nproc_per_node=N -m
stable_diffusion_training_tpu_torch.training cfg.json`` trains
data-parallel over N cards, one process each (``batch_size`` is the global
batch); without torchrun it runs one process.
"""

import sys

import torch.distributed as dist

from .train.trainer import main

if __name__ == "__main__":
    config_path = sys.argv[1] if len(sys.argv) > 1 else "model_properties.json"
    try:
        main(config_dict_path=config_path)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
