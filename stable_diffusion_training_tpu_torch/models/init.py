"""Seeded random weights for the port's models (no pretrained weights ship
with the repository)."""

import torch
from torch import nn


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Overwrite every parameter from ``generator`` (on the parameters'
    device): matrices and conv kernels ~ N(0, 1/fan_in), other weights
    (norm scales) 1, biases 0."""
    for name, param in module.named_parameters():
        if name.endswith("bias"):
            param.zero_()
        elif param.dim() > 1:
            fan_in = param[0].numel()
            noise = torch.randn(
                param.shape, generator=generator, device=param.device, dtype=torch.float32
            )
            param.copy_(noise * fan_in**-0.5)
        else:
            param.fill_(1.0)
    return module
