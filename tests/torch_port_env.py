"""Each test worker's share of the CPU, for the port's tests.

Every ``tests/test_torch_*.py`` imports this module first. Under
pytest-xdist several workers share the machine, and torch's default of one
intra-op thread a core in each of them puts many spinning OpenMP threads on
every core: a test of many small tensor ops then stalls at each op. On
import the module gives this process ``cpu_count // workers`` intra-op
threads (all of them outside xdist) and puts the same count into
``OMP_NUM_THREADS``, which the processes that a test spawns (the gloo ranks,
the CLIs' children) inherit, so a rank of ``multihost.launch`` divides the
same count as the test that compares against it.
"""

from __future__ import annotations

import os

import torch


def thread_share(cpus: int | None, workers: int) -> int:
    """The intra-op threads of one of ``workers`` processes on ``cpus``
    cores: at least one."""
    return max(1, (cpus or 1) // max(1, workers))


def workers_of(environ) -> int:
    """The number of xdist workers that ``environ`` names; 1 outside
    xdist."""
    return int(environ.get("PYTEST_XDIST_WORKER_COUNT", 1))


THREADS = thread_share(os.cpu_count(), workers_of(os.environ))
torch.set_num_threads(THREADS)
os.environ["OMP_NUM_THREADS"] = str(THREADS)
