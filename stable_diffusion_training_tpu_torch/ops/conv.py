"""Polyphase decomposition of the stride-2 3x3 downsample convolution.

Port of ``stable_diffusion_training_tpu/ops/conv.py``
(``polyphase_stride2_conv``, ``stride2_conv_reference``), in NCHW with
torch's ``(O, I, kh, kw)`` kernels. A stride-2 3x3 conv is exactly the sum
of four stride-1 convs over the input's four polyphase components, the nine
kernel taps split 4 + 2 + 2 + 1: the same products, one more pass over the
input to slice the phases. The JAX package wrote it for the TPU, where it
measured slower than the stride-2 form (its ``ops/conv.py`` docstring);
``vae_polyphase_downsample`` turns it on for the VAE encoder's downsamples
and is off by default. It is no Pallas kernel (JAX computes it with
``lax.conv_general_dilated``), so the port's four convs are stock ones.

Derivation (the asymmetric ``((0, 1), (0, 1))`` padding of the VAE
encoder): ``y[i, j] = sum_{di, dj} x[2i + di, 2j + dj] w[di, dj]``, so tap
``di = 0`` reads phase 0's row ``i``, ``di = 1`` phase 1's row ``i`` and
``di = 2`` phase 0's row ``i + 1``: phase 0 carries a 2-tap ``[w0, w2]``
stride-1 conv padded by one after, phase 1 a 1-tap ``[w1]``. The symmetric
``((1, 1), (1, 1))`` padding (the UNet's) shifts it: ``di = 0`` reads phase
1's row ``i - 1``, ``di = 1`` phase 0's row ``i``, ``di = 2`` phase 1's row
``i``: phase 1 carries the 2-tap conv padded by one before.

The four partial outputs are summed in f32, then cast to the input's dtype,
as the JAX package sums its f32 partials (``preferred_element_type``).
"""

import torch
import torch.nn.functional as F

_TWO = [0, 2]  # the kernel taps of a row or column that the 2-tap phase carries


def _conv(x: torch.Tensor, kernel: torch.Tensor, pad_h, pad_w) -> torch.Tensor:
    """A stride-1 conv of ``x`` padded ``pad_h`` (before, after) rows and
    ``pad_w`` columns, in f32."""
    x = F.pad(x, (*pad_w, *pad_h))
    return F.conv2d(x.float(), kernel.float())


def polyphase_stride2_conv(x: torch.Tensor, kernel: torch.Tensor, asymmetric_padding: bool = True) -> torch.Tensor:
    """Stride-2 3x3 conv (NCHW x OIHW, no bias) as four stride-1 polyphase
    convs: ``F.conv2d(x, kernel, stride=2)`` over ``x`` padded ``(0, 1)`` on
    both spatial axes (``asymmetric_padding``, the VAE encoder's) or ``(1,
    1)`` (the UNet's). Needs even spatial dims (every SD and SDXL
    resolution is a multiple of 64)."""
    kh, kw = kernel.shape[2:]
    if (kh, kw) != (3, 3):
        raise ValueError(f"polyphase decomposition expects a 3x3 kernel, got {(kh, kw)}")
    h, w = x.shape[2:]
    if h % 2 or w % 2:
        raise ValueError(f"even spatial dims required, got {(h, w)}")
    x00, x01 = x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2]
    x10, x11 = x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2]
    none = (0, 0)
    if asymmetric_padding:  # phase 0 carries taps {0, 2} at (i, i + 1): pad one after
        two = (0, 1)
        y = _conv(x00, kernel[:, :, _TWO][:, :, :, _TWO], two, two)
        y += _conv(x01, kernel[:, :, _TWO][:, :, :, 1:2], two, none)
        y += _conv(x10, kernel[:, :, 1:2][:, :, :, _TWO], none, two)
        y += _conv(x11, kernel[:, :, 1:2][:, :, :, 1:2], none, none)
    else:  # phase 1 carries taps {0, 2} at (i - 1, i): pad one before
        two = (1, 0)
        y = _conv(x00, kernel[:, :, 1:2][:, :, :, 1:2], none, none)
        y += _conv(x01, kernel[:, :, 1:2][:, :, :, _TWO], none, two)
        y += _conv(x10, kernel[:, :, _TWO][:, :, :, 1:2], two, none)
        y += _conv(x11, kernel[:, :, _TWO][:, :, :, _TWO], two, two)
    return y.to(x.dtype)


def stride2_conv_reference(x: torch.Tensor, kernel: torch.Tensor, asymmetric_padding: bool = True) -> torch.Tensor:
    """The plain stride-2 conv (what ``nn.Conv2d(stride=2)`` computes)."""
    pad = (0, 1, 0, 1) if asymmetric_padding else (1, 1, 1, 1)
    return F.conv2d(F.pad(x, pad), kernel, stride=2)
