"""The benchmark's plain stage-2 reference (``benchmark/reference/
nof_stage.py``) against the program's stage-2 step, on the CPU (where #3/#4
run their plain versions) at a small size: 16 cube and 16 near-surface
points a step, NoFs of depth 3 and width 16 (``benchmark/tests/small.py``),
a 64-vertex body, seeded random weights; the body, the trainer and the
draws are the cell ``init_nof.train_points``'s (``benchmark/kinds/
nof_step.py``). Also the reference's blocked KNN, its weight tree, the
kind's faults and counts, and what the reference imports."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from benchmark import cells, counts, run, scene
from benchmark.kinds import nof_step
from benchmark.reference import nof_stage
from benchmark.reference.model import leaves, nearest
from benchmark.tests.small import SEED, SMALL_NOF

ROOT = Path(__file__).resolve().parents[1]
CELL = "init_nof.train_points"
SMALL = {"scene": {"num_verts": 64},
         "model": {"N_sampled": 16, "bw_NoF": SMALL_NOF, "fw_NoF": SMALL_NOF}}
MANIFEST = cells.load_manifest()


def small_cell():
    return cells.load_cell(MANIFEST, CELL, override=SMALL)


def test_weights_tree_as_the_programs():
    """The reference's tree has the program's leaves, shapes and order, so
    the seed fills both alike."""
    cell = small_cell()
    body = nof_step.make_body(cell.cfg, SEED, "cpu")
    tr = nof_step.build_trainer(cell.cfg, cell.traffic, body, SEED, "cpu")
    ref = nof_stage.param_tree(cell.cfg, "cpu")
    scene.make_weights(ref, cell.cfg, SEED, "cpu")
    got, want = leaves(ref), leaves(tr.params)
    assert list(got) == list(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_three_steps_as_the_program():
    """The program's first three steps (set-up's, on the window's call)
    against the reference's from the same weights on the same draws."""
    cell = small_cell()
    job = nof_step.setup(cell, SEED + 1, "cpu")
    prog = job.prog
    tree = nof_stage.param_tree(cell.cfg, "cpu")
    for k, t in leaves(tree).items():
        t.copy_(job.start[k])
    ref = nof_stage.run_steps(cell.cfg, tree, job.body, job.checked)
    # each step's loss: two means of 32 |differences| of order 1, the
    # same fp32 operations in another order (the program's NoF on its
    # re-chunked ray, its quaternion head, its einsum of the chains): a
    # few ulps apart (read: up to 7e-8)
    for p, r in zip(prog["losses"], ref["losses"]):
        assert p == pytest.approx(r, rel=1e-6)
    # the first gradient of every leaf (the optimizer's first moment over
    # 1 - b1), by the leaf's norm: sums over 32 points in another order,
    # read back through Adam's first moment (read: up to 2.1e-7)
    for k, g in ref["first_grad"].items():
        gap = float(torch.linalg.norm(prog["first_grad"][k] - g.double()))
        assert gap <= 1e-5 * float(torch.linalg.norm(g)), k
    # the parameters after three steps, each leaf's change by its norm:
    # Adam moves an element by about lr sign(g) whatever |g|, so an element
    # whose gradient is nought to rounding may move either way (read: up
    # to 3.7e-6)
    for k, p in ref["params"].items():
        dp = prog["params"][k] - job.start[k]
        dr = p - job.start[k]
        gap = float(torch.linalg.norm(dp - dr))
        assert gap <= 1e-4 * float(torch.linalg.norm(dr)), k
    # every leaf has a gradient; every leaf moves
    assert all(float(g.abs().max()) > 0 for g in ref["first_grad"].values())
    assert all(float((p - job.start[k]).abs().max()) > 0
               for k, p in ref["params"].items())


@pytest.mark.parametrize("rows", [1, 7, 64, 333, None])
def test_blocked_nearest_as_unblocked(rows):
    """Each query's nearest vertex is its own block's, ties (a vertex
    twice) included."""
    g = torch.Generator().manual_seed(5)
    verts = torch.rand((50, 3), generator=g) * 2 - 1
    verts[7] = verts[31]
    q = torch.cat([torch.rand((300, 3), generator=g) * 3 - 1.5,
                   verts[:33]])
    want = nearest(verts, q)
    got = nof_stage.nearest_blocked(verts, q, rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sound_run_is_correct():
    r = run.run_cell(MANIFEST, CELL, SEED + 7, 0.0, False, device="cpu",
                     override=SMALL)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("fault", nof_step.FAULTS)
def test_fault_is_not_correct(fault):
    r = run.run_cell(MANIFEST, CELL, SEED + 7, 0.0, False, device="cpu",
                     override=SMALL, fault=fault)
    assert not r["correct"], r["checks"]


def test_draws_are_the_traffics():
    """A step's draws depend on (seed, step) alone and have the traffic's
    shape: one frame of the body's, N_sampled cube points in +-1.5,
    N_sampled picks over its vertices and as many standard normals; and
    the program's record holds the same tensors."""
    cfg = small_cell().cfg
    cfg = {**cfg, "model": {**cfg["model"], "N_sampled": 4000}}
    a = nof_step.draw_step(cfg, SEED, 11, 320, 6890, "cpu")
    b = nof_step.draw_step(cfg, SEED, 11, 320, 6890, "cpu")
    c = nof_step.draw_step(cfg, SEED, 12, 320, 6890, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in ("cube", "pick", "noise"))
    assert a["frame"] == b["frame"] and 0 <= a["frame"] < 320
    assert not torch.equal(a["cube"], c["cube"])
    assert a["cube"].shape == (4000, 3) and a["noise"].shape == (4000, 3)
    assert float(a["cube"].abs().max()) <= 1.5
    assert float(a["cube"].abs().max()) > 1.45
    assert abs(float(a["cube"].mean())) < 0.05
    assert a["pick"].shape == (4000,) and a["pick"].dtype == torch.int64
    assert 0 <= int(a["pick"].min()) and int(a["pick"].max()) < 6890
    assert abs(float(a["noise"].std()) - 1.0) < 0.05
    d = nof_step.as_point_draws(a)
    assert d.frame == a["frame"] and d.cube is a["cube"]
    assert d.pick is a["pick"] and d.noise is a["noise"]

def test_step_work_at_the_cells_size():
    """At the YAML's sizes: 58,752 multiply-adds a point a NoF, 141 GFLOP
    a step, #3 and #4 once for each NoF on 200,000 points, and the KNN's
    three launches of 66,667 rows (a 1.84 GB block each)."""
    cfg = cells.load_cell(MANIFEST, CELL).cfg
    assert counts.nof_net(cfg).sample_macs == 58752
    work = nof_step.step_work(cfg, 6890)
    assert work["model_flops"] == pytest.approx(141.0e9, rel=2e-3)
    assert [x.kernel for x in work["launches"]] == ["#3", "#4"] * 2
    assert work["launches"][0].flops == 2.0 * 200000 * 58752
    assert work["knn"] == {"launches": 3, "rows": 66667,
                           "block_bytes": 4 * 66667 * 6890}
    assert work["roofline_kernel"]("void nof_walk_pass<float>(Args)")


def _tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add("." * node.level + (node.module or ""))
    return tops


def test_reference_imports_no_jax_and_no_kernel():
    """The file imports torch and ``model.py`` alone; a fresh interpreter
    that imports it holds neither JAX nor any module of the program."""
    path = ROOT / "benchmark" / "reference" / "nof_stage.py"
    assert _tops(path) == {"__future__", "torch", ".model"}
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, json\nimport benchmark.reference.nof_stage\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "moco_flow_tpu",
                       "moco_flow_tpu_torch"}
