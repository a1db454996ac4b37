"""The control comes out not ``correct`` on the card: the kind's
``control``, for training the reference put in the program's place and
computed in TF32, one precision below the configurations' float32, against
the reference in float32, at the cell's own size. Run on a card with
``python -m pytest benchmark/tests -m cuda``."""

import pytest
import torch

from benchmark import cells, run
from benchmark.tests.small import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = cells.load_cell(cells.load_manifest(), name)
    values = cell.kind.control(cell, 4_000_000_007, "cuda")
    _, ok = run.judge(values, cells.load_limits(name))
    assert not ok, values
