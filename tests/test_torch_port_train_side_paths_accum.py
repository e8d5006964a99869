"""The train step's side paths in the port against the JAX package's, on the
CPU in f32: grad accumulation (two micro-batches, each with its own draws).
The cases, the check, its bounds and the module-scoped JAX state are
``tests/test_torch_port_train_side_paths.py``'s (``CASES_BY_FILE``,
``check_side_path``, ``jax_base``); the cases are split over files that
``--dist loadfile`` runs on separate workers."""

import pytest

from test_torch_port_train_side_paths import CASES_BY_FILE, check_side_path, jax_base  # noqa: F401 (the fixture)
from torch_threads import _one_thread  # noqa: F401 (the fixture)


@pytest.mark.parametrize("case", CASES_BY_FILE["train_side_paths_accum"])
def test_side_path_matches_jax(case, jax_base):  # noqa: F811
    check_side_path(case, jax_base)
