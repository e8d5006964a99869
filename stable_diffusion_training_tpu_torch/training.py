"""The port's command line: ``python -m stable_diffusion_training_tpu_torch.training``
reads ``model_properties.json`` (the JAX package's schema; the root
``training.py`` is the JAX command line) and runs the chunked training loop
on the card.

Optionally pass a config path:
``python -m stable_diffusion_training_tpu_torch.training my_config.json``.
"""

import sys

from .train.trainer import main

if __name__ == "__main__":
    config_path = sys.argv[1] if len(sys.argv) > 1 else "model_properties.json"
    main(config_dict_path=config_path)
