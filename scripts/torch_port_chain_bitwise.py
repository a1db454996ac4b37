#!/usr/bin/env python
"""Compare the warp-chain kernels (#5 ``csrc/nof_chain.cu``, #6
``csrc/chain_bwd.cu``) of two trees of this repository bit for bit on one
card.

    (cd TREE_A && python /path/to/scripts/torch_port_chain_bitwise.py dump a.pt)
    (cd TREE_B && python /path/to/scripts/torch_port_chain_bitwise.py dump b.pt)
    python scripts/torch_port_chain_bitwise.py compare a.pt b.pt

``dump`` runs from a tree's root and uses that tree's package: it launches
``chain_fwd`` and ``chain_bwd`` at full NoF width (4x128, skip 2, 5 + 16
frequencies, quaternion head) with local + global chains on fixed seeded
inputs, N x S = 1000 x 128 and 256 x 256, fp32 and bf16, and saves every
output, dxyz, d(partial) and dW. ``compare`` prints how many of the saved
tensors are bitwise equal and the max |diff| of the others.
"""

from __future__ import annotations

import os
import sys

import torch


def dump(path: str):
    sys.path.insert(0, os.getcwd())
    from moco_flow_tpu_torch.nn.embedding import anneal_weights
    from moco_flow_tpu_torch.nn.nof import NoFConfig, init_nof
    from moco_flow_tpu_torch.ops import nof_chain as nc
    from moco_flow_tpu_torch.ops.folds import _NofSpec, _nof_fold

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    fcfg = NoFConfig()
    bw, fw = init_nof(gen, fcfg, dev), init_nof(gen, fcfg, dev)
    an = anneal_weights(505000, 5, 5000, 1005000).to(dev)
    spec = nc._ChainSpec(_NofSpec(4, 128, 15, (2,), True, True), True, True)
    out = {}
    for n, s in ((1000, 128), (256, 256)):
        xyz = (torch.randn(3, n, s, generator=gen) * 0.6).to(dev)
        emb = torch.randn(n, 33, generator=gen).to(dev)
        emb_c = torch.randn(n, 33, generator=gen).to(dev)
        wsb, pb = _nof_fold(bw, fcfg, 5, an, emb)
        wsf, pf = _nof_fold(fw, fcfg, 5, an, emb)
        sets = [pb, pf, _nof_fold(fw, fcfg, 5, an, emb_c)[1],
                _nof_fold(bw, fcfg, 5, an, emb_c)[1]]
        parts = [p for st in sets for p in st]
        gs = [(torch.randn(3, n, s, generator=gen) / (n * s) ** 0.5).to(dev)
              for _ in range(3)]
        for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
            fo = nc.chain_fwd(spec, dt, 2, xyz, parts, wsb, wsf)
            dx, dp, dw = nc.chain_bwd(spec, dt, 2, xyz, parts, wsb, wsf, gs)
            tag = f"{n}x{s}/{dname}"
            for i, o in enumerate(fo):
                out[f"{tag}/out{i}"] = o.cpu()
            out[f"{tag}/dx"] = dx.cpu()
            for i, o in enumerate(dp):
                out[f"{tag}/dp{i}"] = o.cpu()
            for i, o in enumerate(dw):
                out[f"{tag}/dw{i}"] = o.cpu()
    torch.cuda.synchronize()
    torch.save(out, path)
    print(f"saved {len(out)} tensors to {path}")


def compare(path_a: str, path_b: str):
    a, b = torch.load(path_a), torch.load(path_b)
    if set(a) != set(b):
        raise SystemExit(f"the dumps hold other tensors: {set(a) ^ set(b)}")
    same = [k for k in a if torch.equal(a[k], b[k])]
    diff = {k: (a[k] - b[k]).abs().max().item() for k in a if k not in same}
    print(f"chain kernels A vs B: {len(same)} of {len(a)} tensors bitwise "
          f"equal; max |diff| of the others: {diff}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 3:
        dump(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        compare(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(__doc__)
