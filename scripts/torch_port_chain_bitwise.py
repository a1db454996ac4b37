#!/usr/bin/env python
"""Compare kernels of two trees of this repository bit for bit on one card:
the training step's backward kernels #2 ``nerf_bwd``, #4 ``nof_bwd`` and #6
``chain_bwd``,
its forward kernels #1 ``nerf_fwd`` and #5 ``chain_fwd``, the render pass
#7 ``render_pass`` and the per-op NeRF #8 ``nerf_pallas``.

    (cd TREE_A && python /path/to/scripts/torch_port_chain_bitwise.py dump a.pt)
    (cd TREE_B && python /path/to/scripts/torch_port_chain_bitwise.py dump b.pt)
    python scripts/torch_port_chain_bitwise.py compare a.pt b.pt
    python scripts/torch_port_chain_bitwise.py sass LIB_A LIB_B

``dump`` runs from a tree's root and uses that tree's package: on fixed
seeded inputs, N x S = 1000 x 128 and 256 x 256, fp32 and bf16, it
launches the warp chain at full NoF width (4x128, skip 2, 5 + 16
frequencies, quaternion head) with local + global chains, and the NeRF at
full width (8x256, skip 4, 10 frequencies, the 5-dim frame feature) with
its rgb head and sigma-only, and saves every forward output, and every
dxyz, d(partial) and dW of the backward (#4 on the bw NoF alone); #7 at the same widths with the
bw-NoF warp (N x S = 1000 x 128, coarse sigma-only and fine); and #8 at
init_nerf.yaml's model (8x256, 63 inputs, the 27-wide ``dir`` extra) on
100003 seeded rows, full and sigma-only. ``compare`` prints, per kernel and
compute type, how many of the saved tensors are bitwise equal and the max
|diff| of the others. ``sass`` compares two builds of the kernel library
(``build/torch_kernels/*/libmoco_kernels.so``) instruction by instruction
(``cuobjdump -sass``, addresses and encodings left out) for the backward
kernels' row-tile passes, which #1 and #5 share their code with, and in
LIB_B the single warp's entry points (#3 ``nof_fwd_kernel``, #4
``nof_fwd_pass`` / ``nof_walk_pass``) against the chain's (#5 / #6) whose
device code they instantiate.
"""

from __future__ import annotations

import difflib
import os
import re
import shutil
import subprocess
import sys

import torch

KERNELS = ("nerf_fwd", "nerf_bwd", "chain_fwd", "chain_bwd", "nof_bwd",
           "render_pass", "nerf_pallas")


def dump(path: str):
    sys.path.insert(0, os.getcwd())
    from moco_flow_tpu_torch.nn.embedding import anneal_weights
    from moco_flow_tpu_torch.nn.nerf import NeRFConfig, init_nerf
    from moco_flow_tpu_torch.nn.nof import NoFConfig, init_nof
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    from moco_flow_tpu_torch.ops import nof_rays
    from moco_flow_tpu_torch.ops.folds import (_NerfSpec, _NofSpec,
                                               _nerf_fold, _nof_fold)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    fcfg = NoFConfig()
    bw, fw = init_nof(gen, fcfg, dev), init_nof(gen, fcfg, dev)
    ncfg = NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
    nerf = init_nerf(gen, ncfg, dev)
    an = anneal_weights(505000, 5, 5000, 1005000).to(dev)
    an_n = anneal_weights(505000, 10, 5000, 1005000).to(dev)
    spec = nc._ChainSpec(_NofSpec(4, 128, 15, (2,), True, True), True, True)
    out = {}

    def keep(kernel, tag, tensors):
        for i, t in enumerate(tensors):
            out[f"{kernel}/{tag}/{i}"] = t.cpu()

    for n, s in ((1000, 128), (256, 256)):
        xyz = (torch.randn(3, n, s, generator=gen) * 0.6).to(dev)
        emb = torch.randn(n, 33, generator=gen).to(dev)
        emb_c = torch.randn(n, 33, generator=gen).to(dev)
        emb_n = torch.randn(n, 5, generator=gen).to(dev)
        wsb, pb = _nof_fold(bw, fcfg, 5, an, emb)
        wsf, pf = _nof_fold(fw, fcfg, 5, an, emb)
        sets = [pb, pf, _nof_fold(fw, fcfg, 5, an, emb_c)[1],
                _nof_fold(bw, fcfg, 5, an, emb_c)[1]]
        parts = [p for st in sets for p in st]
        gs = [(torch.randn(3, n, s, generator=gen) / (n * s) ** 0.5).to(dev)
              for _ in range(3)]
        for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
            tag = f"{n}x{s}/{dname}"
            keep("chain_fwd", tag,
                 nc.chain_fwd(spec, dt, 2, xyz, parts, wsb, wsf))
            dx, dp, dw = nc.chain_bwd(spec, dt, 2, xyz, parts, wsb, wsf, gs)
            keep("chain_bwd", tag, [dx, *dp, *dw])
            dx, dp, dw = nof_rays.nof_bwd(spec.nof, dt, xyz, pb, wsb, gs[0])
            keep("nof_bwd", tag, [dx, *dp, *dw])
        for sigma_only in (False, True):
            ws, p_e = _nerf_fold(nerf, ncfg, 10, an_n,
                                 None if sigma_only else emb_n, sigma_only)
            nspec = _NerfSpec(8, 256, 30, (4,), sigma_only, not sigma_only,
                              True)
            g = (torch.randn(1 if sigma_only else 4, n, s, generator=gen)
                 / (n * s) ** 0.5).to(dev)
            for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
                tag = f"{n}x{s}/{dname}/{'sigma' if sigma_only else 'full'}"
                keep("nerf_fwd", tag, [nr.nerf_fwd(nspec, dt, xyz, p_e, ws)])
                dx, dp, dw = nr.nerf_bwd(nspec, dt, xyz, p_e, ws, g)
                keep("nerf_bwd", tag, [dx] + ([] if dp is None else [dp])
                     + list(dw))
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    from moco_flow_tpu_torch.ops.render_pass import render_pass
    from moco_flow_tpu_torch.render.volume import EmbeddingSpec, embed_padded
    n, s = 1000, 128
    o = (torch.tensor([0.0, 0.0, 4.0])
         + 0.05 * torch.randn(n, 3, generator=gen)).to(dev)
    d = torch.randn(n, 3, generator=gen)
    d[:, 2] = -d[:, 2].abs() - 1
    d = (d / d.norm(dim=-1, keepdim=True)).to(dev)
    z = torch.sort(2.5 + 3 * torch.rand(n, s, generator=gen), -1).values
    ind = (torch.rand(n, 1, generator=gen) * 2 - 1).to(dev)
    extra = embed_padded(ind, EmbeddingSpec(2, in_channels=1), 5)
    ind_emb = embed_padded(ind, EmbeddingSpec(16, in_channels=1), 33)
    params = {"coarse_NeRF": nerf, "bw_NoF": bw}
    for sigma_only in (True, False):
        for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
            outs = render_pass(params, "coarse_NeRF", ncfg, fcfg, 10, 5,
                               True, True, an_n, an, o, d, z.to(dev),
                               None if sigma_only else extra, ind_emb, True,
                               sigma_only, dt)
            keep("render_pass",
                 f"{n}x{s}/{dname}/{'sigma' if sigma_only else 'full'}",
                 [t for t in outs if t is not None])
    mcfg = NeRFConfig(depth=8, width=256, in_channels_xyz=63, skips=(4,),
                      extra_feat_type="dir", extra_feat_dim=27)
    mlp = init_nerf(gen, mcfg, dev)
    rows = 100003
    x = (torch.rand(rows, 63, generator=gen) * 2 - 1).to(dev)
    e = (torch.rand(rows, 27, generator=gen) * 2 - 1).to(dev)
    for sigma_only in (False, True):
        ws = fm._nerf_weights_flat(mlp, sigma_only)
        for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
            keep("nerf_pallas",
                 f"{rows}/{dname}/{'sigma' if sigma_only else 'full'}",
                 [fm.nerf_pallas(mcfg, dt, x, None if sigma_only else e,
                                 sigma_only, ws)])
    torch.cuda.synchronize()
    torch.save(out, path)
    print(f"saved {len(out)} tensors to {path}")


def compare(path_a: str, path_b: str):
    a, b = torch.load(path_a), torch.load(path_b)
    if set(a) != set(b):
        raise SystemExit(f"the dumps hold other tensors: {set(a) ^ set(b)}")
    for kernel in KERNELS:
        for dname in ("fp32", "bf16"):
            keys = [k for k in a if k.startswith(kernel + "/")
                    and f"/{dname}" in k]
            same = [k for k in keys if torch.equal(a[k], b[k])]
            diff = max(((a[k].float() - b[k].float()).abs().max().item()
                        for k in keys if k not in same), default=0.0)
            print(f"{kernel} {dname} A vs B: {len(same)} of {len(keys)} "
                  f"tensors bitwise equal; largest |diff| of the others "
                  f"{diff:.3e}")


PASSES = ("nerf_fwd_pass", "nerf_walk_pass", "chain_fwd_pass",
          "chain_walk_pass")


def _sass(lib: str) -> dict:
    """{kernel (its mangled name without the translation unit's hash):
    [instructions]} of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    txt = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    out, name = {}, None
    for line in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            key = re.search(r"_cu_[0-9a-f]{8}(\w+)$", m.group(1))
            name = key.group(1) if key else m.group(1)
            out[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/(.*?)(/\* 0x[0-9a-f]+ \*/)?$",
                       line)
        if name and ins:           # an instruction line, address dropped
            out[name].append(ins.group(1).strip())
    return out


def sass(lib_a: str, lib_b: str):
    a, b = _sass(lib_a), _sass(lib_b)
    for name in sorted(k for k in a if any(p in k for p in PASSES)):
        other = b.get(name, [])
        print(f"{name}: {len(a[name])} / {len(other)} instructions, the "
              f"same in both builds {a[name] == other}")
        if a[name] != other:
            diff = [ln for ln in difflib.unified_diff(a[name], other,
                                                      lineterm="", n=0)
                    if ln[:1] in "+-" and ln[:3] not in ("---", "+++")]
            print(f"  {len(diff)} lines differ, the first: "
                  + " | ".join(diff[:12]))
    for name in sorted(k for k in b if re.match(r"\d+nof_fwd_(pass|kernel)"
                                                r"|\d+nof_walk_pass", k)):
        m = re.match(r"(\d+)nof_(.*)", name)   # mangled: length, name
        twin = f"{int(m.group(1)) + 2}chain_{m.group(2)}"
        print(f"B {name} vs {twin}: {len(b[name])} / {len(b.get(twin, []))} "
              f"instructions, the same {b[name] == b.get(twin)}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 3:
        dump(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        compare(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["sass"] and len(sys.argv) == 4:
        sass(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(__doc__)
