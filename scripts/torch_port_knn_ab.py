#!/usr/bin/env python
"""Time formulas of the port's nearest-neighbour search (``ops/knn.py``) at
stage 2's shape, 200,000 queries against 6,890 vertices, on one card, and
check which of them give the same bits whatever the chunk.

    python scripts/torch_port_knn_ab.py [--queries 200000] [--refs 6890]
        [--reps 5] [--device cuda]

Every formula takes the argmin over |v|^2 - 2 q.v and adds |q|^2 to the
minimum, as JAX's ``ops/knn.py`` does; they differ in how the (chunk, V)
block is made:

- ``blas``: ``ref_sq - 2 * (q @ refs.T)`` (two blocks alive), in chunks of
  8192 queries (the port before stage 2) and of the tree's budget;
- ``addmm``: one ``torch.addmm(ref_sq, q, refs.T, alpha=-2)`` (one block;
  -2 is a power of two, so the same number as ``blas``'s when the product
  is), in chunks of the budget;
- ``elementwise``: (q_x v_x + q_y v_y) + q_z v_z summed block by block;
- ``tree``: the tree's ``knn.nearest_neighbor`` as it is.

For each: the mean ms of ``--reps`` calls after a warm one (CUDA events),
and whether chunks of 4096, of 1000 and a chunk leaving a one-row tail give
bitwise the chunk-free result. TF32 is off throughout. Prints one line per
formula and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _finish(d2, q):
    idx = torch.argmin(d2, dim=-1)
    best = torch.gather(d2, 1, idx[:, None])[:, 0]
    return torch.sqrt(torch.clamp(best + torch.sum(q * q, dim=-1),
                                  min=0.0)), idx


def chunked(block, refs, queries, chunk):
    """(dist, idx) of ``queries`` against ``refs``, ``block`` making the
    (chunk, V) block of |v|^2 - 2 q.v chunk by chunk."""
    ref_sq = torch.sum(refs * refs, dim=-1)
    rt = refs.T.contiguous()
    ds, ids = [], []
    for i in range(0, queries.shape[0], chunk):
        q = queries[i:i + chunk]
        d, j = _finish(block(q, rt, ref_sq), q)
        ds.append(d)
        ids.append(j)
    return torch.cat(ds), torch.cat(ids)


def blas(q, rt, ref_sq):
    return ref_sq[None, :] - 2.0 * (q @ rt)


def addmm(q, rt, ref_sq):
    return torch.addmm(ref_sq, q, rt, alpha=-2.0)


def elementwise(q, rt, ref_sq):
    d2 = q[:, 0:1] * rt[0]
    d2 += q[:, 1:2] * rt[1]
    d2 += q[:, 2:3] * rt[2]
    return d2.mul_(-2.0).add_(ref_sq)


def main(argv=None):
    from moco_flow_tpu_torch.ops import knn
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--queries", type=int, default=200_000)
    p.add_argument("--refs", type=int, default=6890)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    refs = (0.6 * torch.randn(a.refs, 3, generator=gen)).to(dev)
    queries = (3.0 * torch.rand(a.queries, 3, generator=gen) - 1.5).to(dev)
    budget = knn.chunk_rows(a.refs)
    tail = a.queries - 1                  # the last chunk one row
    forms = {"blas 8192": (lambda r, q, c=8192: chunked(blas, r, q, c)),
             f"blas {budget}": (lambda r, q, c=budget: chunked(blas, r, q,
                                                                c)),
             f"addmm {budget}": (lambda r, q, c=budget: chunked(addmm, r,
                                                                 q, c)),
             f"elementwise {budget}": (lambda r, q, c=budget: chunked(
                 elementwise, r, q, c)),
             "tree": knn.nearest_neighbor}
    bit_forms = {"blas": blas, "addmm": addmm, "elementwise": elementwise}
    ref_idx = None
    for name, fn in forms.items():
        fn(refs, queries)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(a.reps):
                d, i = fn(refs, queries)
            e1.record()
            torch.cuda.synchronize()
            ms = f"{e0.elapsed_time(e1) / a.reps:.3f} ms"
        else:
            d, i = fn(refs, queries)
            ms = "not timed (CPU)"
        if ref_idx is None:
            ref_idx, ref_d = i, d
        same = ""
        kind = name.split()[0]
        if kind in bit_forms:
            d0, i0 = chunked(bit_forms[kind], refs, queries, a.queries)
            for c in (4096, 1000, tail):
                dc, ic = chunked(bit_forms[kind], refs, queries, c)
                same += (f"; chunk {c}: "
                         f"{'same bits' if torch.equal(dc.view(torch.int32), d0.view(torch.int32)) and torch.equal(ic, i0) else 'OTHER BITS'}")
        print(f"[knn] {name}: {ms}; idx as blas 8192 at "
              f"{(i == ref_idx).float().mean().item():.6f} of queries, max "
              f"|d - blas 8192's| {(d - ref_d).abs().max().item():.3e}"
              f"{same}", flush=True)
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        print(f"[knn] {a.queries} x {a.refs} queries, chunk budget {budget} "
              f"rows, on {card}")


if __name__ == "__main__":
    main()
