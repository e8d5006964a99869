"""SDXL's micro-conditioned train step in the port against the JAX package's,
on the CPU in f32, from latent-cache batches: the dual-tower family with
its context cached. The cases, the check and its bounds are
``tests/test_torch_port_sdxl_train.py``'s (``CASES_BY_FILE``,
``check_micro_conditioned_step``; its docstring says why each bound); the
cases are split over files that ``--dist loadfile`` runs on separate
workers."""

import pytest

from test_torch_port_sdxl_train import CASES_BY_FILE, check_micro_conditioned_step
from torch_threads import _one_thread  # noqa: F401 (the fixture)


@pytest.mark.parametrize("case", CASES_BY_FILE["sdxl_train_cached"])
def test_micro_conditioned_step_matches_jax(case, tmp_path):
    check_micro_conditioned_step(case, tmp_path)
