"""The train step's side paths in the port against the JAX package's, on the
CPU in f32: the cached text context (``encoder_hidden_states`` batches, the
text encoder frozen) and ``vae_encode_chunk``. The cases, the check, its
bounds and the module-scoped JAX state are
``tests/test_torch_port_train_side_paths.py``'s (``CASES_BY_FILE``,
``check_side_path``, ``jax_base``); the cases are split over files that
``--dist loadfile`` runs on separate workers."""

import pytest

from test_torch_port_train_side_paths import CASES_BY_FILE, check_side_path, jax_base  # noqa: F401 (the fixture)
from torch_threads import _one_thread  # noqa: F401 (the fixture)

# torch's intra-op threads here (tests/torch_threads.py). At one or two the
# cached-context step's sums put one momentum code of
# up_blocks.0.resnets.0.time_emb_proj.weight at 11 where the JAX step's is
# 9, past the noise level of 10 that the bound allows; at four and eight
# (the default before) every code is within it.
TORCH_THREADS = 4


@pytest.mark.parametrize("case", CASES_BY_FILE["train_side_paths_encode"])
def test_side_path_matches_jax(case, jax_base):  # noqa: F811
    check_side_path(case, jax_base)
