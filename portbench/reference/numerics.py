"""How the plain reference multiplies: at the configuration's precision, or
one step below it (the control of the correctness check).

Every matmul and convolution of the reference goes through one
``Numerics`` object:

- ``"exact"``: the operands as they are (bf16 or f32; f32 with TF32 off).
- ``"fp8"``: both operands rounded to float8 e4m3 under a per-tensor
  scale (amax / 448) before the product, the step below bf16. The rounding
  is straight-through in the backward, so the gradients are taken through
  the rounded operands that the forward saved.
- ``"tf32"``: f32 products with TF32 allowed, the step below f32 with TF32
  off.

``products`` sets the matmul precision for a step (see there).
"""

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 under a per-tensor scale, straight-through."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


class Numerics:
    def __init__(self, mode: str = "exact"):
        if mode not in ("exact", "fp8", "tf32"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.mode == "fp8" else x

    @contextlib.contextmanager
    def products(self, dtype: torch.dtype):
        """The matmul precision inside, for parameters of ``dtype``: TF32
        for ``"tf32"``; off for f32 otherwise. At bf16 the f32 matmuls (the
        attention's logits and weighted sums, whose operands are bf16 or fp8
        values, which TF32 holds exactly) take TF32, which leaves their
        forward exact and rounds their backward's f32 operands to 10 bits,
        finer than the bf16 grads they become. Convolutions: TF32 only for
        ``"tf32"``."""
        allow = self.mode == "tf32"
        matmul = allow or dtype != torch.float32
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, allow
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def linear(self, x, weight, bias=None):
        return F.linear(self.operand(x), self.operand(weight), bias)

    def conv(self, x, weight, bias, stride=1, padding=0):
        return F.conv2d(self.operand(x), self.operand(weight), bias, stride=stride, padding=padding)

    def matmul(self, a, b):
        return torch.matmul(self.operand(a), self.operand(b))
