"""Options of the JAX package's config that the port's trainer once did not
take, run through ``trainer.main`` on ``tiny`` in f32 on the CPU:
``fsdp_shard_params`` (bitwise the default run).
The cases and their check are ``tests/test_torch_port_trainer_paths.py``'s
(``OPTIONS``, ``check_option``); each case runs the trainer twice, so they
are split over files that ``--dist loadfile`` runs on separate workers."""

import pytest

from test_torch_port_trainer_paths import OPTIONS_BY_FILE, check_option, options_params
from torch_threads import _one_thread  # noqa: F401 (the fixture)


@pytest.mark.parametrize(**options_params(OPTIONS_BY_FILE["trainer_options"]))
def test_options_not_ported_raise(tmp_path, overrides, error):
    check_option(tmp_path, overrides, error)
