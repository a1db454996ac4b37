"""The comparison that decides ``correct`` for training steps (the kind
``train_step``).

Set-up drives the program's trainer through its first steps on the
window's own call and feed; the reference then follows those steps from the
same weights on the same draws. Three numbers are compared, each against
its limit in ``limits/<cell>.json``:

- ``loss_gap``: the largest relative gap, over the steps, of a step's loss
  without the warp-consensus terms (``CONSENSUS``): the image loss and, in
  the ``msk`` phase, the mask BCE. A consensus term is the mean of
  |x - fw(bw(x))| over the samples whose alpha passes a threshold, a
  difference of near-equal values: its relative gap swings from seed to
  seed by a hundred times, and the float32 reference reads as far from
  the float64 one. The consensus chains are compared through the
  gradients: the fw NoF's come from them alone;
- ``grad_gap``: the first step's gradient as the optimizer got it (its
  first moment over 1 - b1), by the worst leaf: the gap between the
  program's norm and the reference's, over the larger of that leaf's
  reference norm and the median leaf's;
- ``update_gap``: the change of the parameters over the steps, by the
  median leaf (the gap of each leaf taken as ``grad_gap``'s), leaving out
  the leaves whose reference gradient is under a thousandth of the median
  leaf's (Adam moves those by round-off). Not the worst leaf: Adam's first
  steps move every element by about the learning rate whatever its
  gradient, so an element whose gradient is nought to rounding moves
  either way on either side, and the worst leaf's gap swings from seed to
  seed by twenty times. A part of the model left unmoved still shows: it
  changes the later steps' losses and the other leaves' updates.
"""

from __future__ import annotations

import math

import torch

B1 = 0.9            # the first-moment decay of the configs' adam / radam
NAMES = ("loss_gap", "grad_gap", "update_gap")
CONSENSUS = ("nof_local", "nof_global")


def keystr(path: str) -> str:
    """``coarse_NeRF/trunk/0/w`` -> ``['coarse_NeRF']['trunk'][0]['w']``,
    the optimizers' names of a leaf in their state."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in path.split("/"))


def first_grads(opt, names: list) -> dict:
    """The first step's gradient of each leaf, from the first moment that
    the optimizer ``opt`` holds after one step."""
    state = opt.state_named("")
    return {n: torch.as_tensor(state[f"[0].mu{keystr(n)}"]).double() / (1 - B1)
            for n in names}


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in tree.items()}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                    + v[len(v) // 2])


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """| |prog| - |ref| | / max(|ref|, median |ref|) of each leaf."""
    keep = list(ref) if keep is None else keep
    np_, nr = _norms({k: prog[k] for k in keep}), _norms({k: ref[k]
                                                          for k in keep})
    med = _median(nr.values())
    return {k: abs(np_[k] - nr[k]) / max(nr[k], med, 1e-30) for k in keep}


def _worst(values) -> float:
    """The largest value; infinite where any is not finite."""
    values = list(values)
    return (max(values) if all(math.isfinite(v) for v in values)
            else math.inf)


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    return _worst(leaf_gaps(prog, ref, keep).values())


def kept_leaves(ref: dict) -> list:
    """The leaves whose first reference gradient is at least a thousandth
    of the median leaf's."""
    gnorm = _norms(ref["first_grad"])
    med = _median(gnorm.values())
    return [k for k in ref["params"] if gnorm[k] >= 1e-3 * med]


def _loss(terms: dict, consensus: bool = False) -> float:
    """A step's loss from its terms: without the consensus terms, or with
    ``consensus`` those alone."""
    return sum(v for k, v in terms.items()
               if k != "train_psnr" and (k in CONSENSUS) == consensus)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def readings(prog: dict, ref: dict) -> dict:
    """The numbers of one run. ``prog`` and ``ref`` each hold ``losses``
    (a step's total), ``terms`` (a step's loss terms), ``first_grad`` and
    ``start`` / ``params`` ({leaf: tensor} before the first step and after
    the last)."""
    loss = max(_rel(_loss(a), _loss(b))
               for a, b in zip(prog["terms"], ref["terms"]))
    if any(not math.isfinite(x) for x in prog["losses"]):
        loss = math.inf
    grad = worst_leaf_gap(prog["first_grad"], ref["first_grad"])
    keep = kept_leaves(ref)
    upd = leaf_gaps(changes(prog, keep), changes(ref, keep), keep)
    return {"loss_gap": loss, "grad_gap": grad,
            "update_gap": (_median(upd.values()) if _worst(upd.values())
                           < math.inf else math.inf)}


def changes(run: dict, keep: list) -> dict:
    return {k: run["params"][k].double() - run["start"][k].double()
            for k in keep}


def details(prog: dict, ref: dict, top: int = 3) -> dict:
    """Where each number comes from: every step's loss terms on both sides,
    the leaves that read worst, and the leaves left out of the change."""
    keep = kept_leaves(ref)
    grad = leaf_gaps(prog["first_grad"], ref["first_grad"])
    upd = leaf_gaps(changes(prog, keep), changes(ref, keep), keep)

    def worst(gaps):
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:top]

    cons = [_rel(_loss(a, True), _loss(b, True))
            for a, b in zip(prog["terms"], ref["terms"]) if _loss(b, True)]
    return {"prog_terms": prog["terms"], "ref_terms": ref["terms"],
            "consensus_gap": max(cons, default=0.0),
            "update_gap_worst": _worst(upd.values()),
            "worst_grad": worst(grad), "worst_update": worst(upd),
            "left_out": sorted(set(ref["params"]) - set(keep))}
