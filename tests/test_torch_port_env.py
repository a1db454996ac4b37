"""The CPU share of the port's test workers (``tests/torch_port_env.py``):
every ``tests/test_torch_*.py`` imports it, and the share is one worker's
cores, all of them outside xdist."""

import ast
import glob
import os
import os.path as osp

import pytest
import torch

import torch_port_env
from torch_port_env import thread_share, workers_of

FILES = sorted(glob.glob(osp.join(osp.dirname(__file__), "test_torch_*.py")))


@pytest.mark.parametrize("path", FILES, ids=osp.basename)
def test_every_port_test_file_imports_the_share(path):
    tree = ast.parse(open(path).read())
    names = {a.name for node in tree.body if isinstance(node, ast.Import)
             for a in node.names}
    assert "torch_port_env" in names, (
        f"{osp.basename(path)} must import torch_port_env at module level")


@pytest.mark.parametrize("cpus, env, want", [
    (8, {"PYTEST_XDIST_WORKER_COUNT": "6"}, 1),
    (8, {"PYTEST_XDIST_WORKER_COUNT": "4"}, 2),
    (8, {"PYTEST_XDIST_WORKER_COUNT": "16"}, 1),
    (8, {}, 8),
    (None, {}, 1),
])
def test_share_divides_the_cores_among_the_workers(cpus, env, want):
    assert thread_share(cpus, workers_of(env)) == want


def test_this_process_takes_its_share():
    want = thread_share(os.cpu_count(), workers_of(os.environ))
    assert torch_port_env.THREADS == want
    assert os.environ["OMP_NUM_THREADS"] == str(want)
    assert torch.get_num_threads() == want
