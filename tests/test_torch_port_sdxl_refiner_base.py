"""The port's SDXL img2img pipeline with a first text tower (the base
checkpoint as img2img, 6 time ids) against the JAX package's, on the CPU in
f32. The builders, inputs, draws and the 1e-4 image bound are
``tests/test_torch_port_sdxl_refiner.py``'s (its docstring says why)."""

import numpy as np

from test_torch_port_sdxl_refiner import IMAGE_TOL, _both, _build, _inputs
from torch_threads import _one_thread  # noqa: F401 (the fixture)


def test_base_checkpoint_as_img2img_matches_jax():
    """A pipeline with a first tower conditions on both (6 time ids)."""
    jax_pipe, params, pipe = _build(with_tower_1=True)
    ids, neg, image = _inputs(seed=3)
    got, want = _both(jax_pipe, params, pipe, ids, neg, image, seed=4, strength=0.75)
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL, rtol=0)
