"""A run with the timed path broken underneath comes out not ``correct``:
the harness's look for a card skipped (the CPU runs the program's plain
path at small sizes), the rest of a run driven as it is, once for each
fault that the cell's kind can plant (``kinds/<kind>.py``'s ``FAULTS``)."""

import pytest

from benchmark import cells, run
from benchmark.tests.small import CELLS, SEED, SMALL

MANIFEST = cells.load_manifest()
FAULTY = [(c, f) for c in CELLS
          for f in cells.load_cell(MANIFEST, c).kind.FAULTS]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run.run_cell(MANIFEST, name, SEED + 7, 0.0, False, device="cpu",
                     override=SMALL)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name,fault", FAULTY)
def test_fault_is_not_correct(name, fault):
    r = run.run_cell(MANIFEST, name, SEED + 7, 0.0, False, device="cpu",
                     override=SMALL, fault=fault)
    assert not r["correct"], r["checks"]


def test_a_number_without_a_limit_fails():
    checks, ok = run.judge({"gap": 0.0, "other": 0.0}, {"gap": 1.0})
    assert not ok and checks["gap"] == {"value": 0.0, "limit": 1.0}
