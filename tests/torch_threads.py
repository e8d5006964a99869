"""One intra-op thread for the port's CPU tests.

The test runner starts several worker processes on one machine, and torch
gives each a thread per core: the workers' spinning threads then outnumber
the cores several times over, and a tiny model's step waits on them. Every
``tests/test_torch_port_*.py`` imports ``_one_thread`` (module scope,
autouse), which runs the module's torch work on one thread and sets
``OMP_NUM_THREADS=1`` for the processes it starts (spawned ranks,
subprocesses), and puts both back after the module. A module whose
results move past a bound with the thread count names its own count in
``TORCH_THREADS``.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_thread(request):
    threads = torch.get_num_threads()
    env = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(getattr(request.module, "TORCH_THREADS", 1))
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
