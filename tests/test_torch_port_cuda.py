"""The CUDA flash-attention kernel against its plain version, on the card.

These cases need an NVIDIA GPU and nvcc and skip elsewhere. The file imports
no JAX, so it also runs on a machine with the card and no JAX installed:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

(``tests/conftest.py`` imports JAX; ``--noconftest`` leaves it out.)
Shapes cover the three kernels behind the entry point: tensor cores for bf16
with D % 8 == 0 (D <= 64, and the wide-head kernel for D = 80, 128, 160,
512) and CUDA cores for f32 and for D = 36; and the edges: one query and one
key, a single ragged key tile, and a last key tile of one key.
Tolerances are those of ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

TOL = {"float32": dict(o=1e-4, lse=1e-4), "bfloat16": dict(o=1e-2, lse=1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "bh,sq,sk,d",
    [(4, 300, 300, 40), (2, 257, 129, 64), (3, 100, 70, 36), (2, 130, 190, 80),
     (1, 70, 100, 160), (1, 200, 333, 512), (3, 1, 1, 8), (2, 33, 5, 24),
     (1, 17, 2049, 128)],
)
def test_cuda_kernel_matches_plain_version(bh, sq, sk, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    q, k, v = (
        torch.tensor(rng.standard_normal((bh, s, d)), dtype=torch.float32)
        .to(getattr(torch, dtype))
        .cuda()
        for s in (sq, sk, sk)
    )
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == 1
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, d**-0.5)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol["o"], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=tol["lse"], rtol=0)


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version():
    """A CUDA tensor the kernel does not take raises; it is not sent to the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.zeros(2, 8, 40, dtype=torch.float16, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(x, x, x)
