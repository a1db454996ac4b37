"""The plain reference against the program's plain CPU path (the CPU runs
each kernel's plain version): one ``msk`` step and one stage-1 step at a
small width, the same weights, scene and draws. The reference is faithful
before it judges the card."""

import pytest
import torch

from benchmark import cells, reference, scene
from benchmark.kinds.train_step import as_draws, build_trainer, draw_step, \
    make_scene
from benchmark.reference.model import leaves, param_tree
from benchmark.tests.small import CELLS, SEED, SMALL


def small_trainer(name, seed):
    """The cell at the small sizes, its scene and the program's trainer."""
    cell = cells.load_cell(cells.load_manifest(), name, override=SMALL)
    sc = make_scene(cell.cfg, seed, "cpu")
    tr = build_trainer(cell.cfg, cell.traffic, sc, seed, "cpu", "unused")
    return cell, sc, tr


@pytest.mark.parametrize("name", CELLS)
def test_weights_tree_as_the_programs(name):
    """The reference's tree of the configuration has the program's leaves,
    shapes and order, so the seed fills both alike."""
    cell, _, tr = small_trainer(name, SEED)
    ref = param_tree(cell.cfg, "cpu")
    scene.make_weights(ref, cell.cfg, SEED, "cpu")
    got, want = leaves(ref), leaves(tr.params)
    assert list(got) == list(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", CELLS)
def test_one_step_as_the_program(name):
    cell, sc, tr = small_trainer(name, SEED + 1)
    start = {k: v.detach().clone() for k, v in leaves(tr.params).items()}
    draws = draw_step(cell.cfg, cell.traffic, sc, SEED + 1, 0, "cpu")
    chain_global = bool(cell.cfg["loss"].get("chain_global", False))
    out = tr.train_step(draws=as_draws(draws, chain_global))
    prog_loss = float(sum(v for k, v in out.items() if k != "train_psnr"))
    grads = {k: v.grad for k, v in leaves(tr.params).items()}
    after = {k: v.detach() for k, v in leaves(tr.params).items()}
    tree = param_tree(cell.cfg, "cpu")
    for k, t in leaves(tree).items():
        t.copy_(start[k])
    ref = reference.run_steps(cell.cfg, tree, sc, [draws],
                              cell.traffic.get("phase"))
    assert ref["losses"][0] == pytest.approx(prog_loss, rel=1e-5)
    # by each leaf's norm: at this size one sample at a ReLU's kink or at
    # the consensus mask's alpha 0.01, on the other side under another
    # order of summation, moves a few gradient elements by ~5e-5 (~1e-4 of
    # the leaf's norm)
    for k, g in ref["first_grad"].items():
        gap = float(torch.linalg.norm(grads[k] - g))
        assert gap <= 1e-3 * float(torch.linalg.norm(g)), k
    # the update by each leaf's norm: Adam's first step moves an element
    # by ~lr sign(g), and an element whose gradient is nought to rounding
    # may take the other sign
    for k, p in ref["params"].items():
        dp = float(torch.linalg.norm(after[k] - start[k]))
        dr = float(torch.linalg.norm(p - start[k]))
        assert abs(dp - dr) <= 1e-3 * dr + 1e-12, k
    # every leaf has a gradient; the step moves the parameters
    assert all(float(g.abs().max()) > 0 for g in ref["first_grad"].values())
    assert any(float((p - start[k]).abs().max()) > 0
               for k, p in ref["params"].items())
