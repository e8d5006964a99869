"""Seeded weights, made on the device in a few large draws.

The law is the one the program's seeded families use (matrices and conv
kernels ~ N(0, 1/fan_in), norm scales 1, biases 0); the draws are the
benchmark's own, from ``--seed``. The same seed gives the same weights to
the program and to the reference, by name. An EMA's starting weights draw
every leaf, vectors too, from N(0, 1/fan_in) (N(0, 1) for a vector), so
that each of its leaves starts away from the parameters.
"""

from typing import Dict, Iterable, Tuple

import torch

# f32 normals drawn in one call at most
DRAW_ELEMENTS = 1 << 28


def seeded_weights(specs: Iterable[Tuple[str, torch.Size]], seed: int, device, dtype,
                   every_leaf: bool = False) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``(name, shape)`` pairs, in ``dtype``; with
    ``every_leaf`` the vectors are drawn too."""
    specs = list(specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    group, size = [], 0

    def flush():
        nonlocal group, size
        if not group:
            return
        normal = torch.randn(size, generator=gen, device=device, dtype=torch.float32)
        offset = 0
        for name, shape in group:
            n = shape.numel()
            fan_in = shape[1:].numel()
            out[name] = (normal[offset : offset + n].view(shape) * fan_in**-0.5).to(dtype)
            offset += n
        group, size = [], 0

    for name, shape in specs:
        shape = torch.Size(shape)
        if name.endswith("bias") and not every_leaf:
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif len(shape) > 1 or every_leaf:
            if size and size + shape.numel() > DRAW_ELEMENTS:
                flush()
            group.append((name, shape))
            size += shape.numel()
        else:
            out[name] = torch.ones(shape, device=device, dtype=dtype)
    flush()
    return {name: out[name] for name, _ in specs}


def module_specs(module: torch.nn.Module):
    """``(name, shape)`` of a module's parameters, in its order."""
    return [(name, p.shape) for name, p in module.named_parameters()]
