#!/usr/bin/env python
"""Where the time of the backward kernels #2 (nerf_bwd) and #6 (chain_bwd)
went in their persistent-grid design, by elimination, on one card.

    python scripts/torch_port_bwd_elimination.py PARENT_DIR OUT_DIR

PARENT_DIR is a checkout of the tree before the row-tile redesign (the
persistent-grid kernels on ``csrc/mlp_tile.cuh``, for example commit
3f98b84 unpacked with ``git archive`` under the git-ignored ``build/``).
The script copies it three times under OUT_DIR: ``base`` as it is,
``noatom`` with the weight- and bias-gradient atomics never firing (their
sums still computed, so only the L2 reductions go), and ``nowgrad`` without
the per-tile weight-gradient products at all. These are deliberately wrong
copies for timing only. It builds the three in parallel, then times each
tree's nerf_bwd and chain_bwd at one stage-3 step's shapes (two launches
each: NeRF 1024 x 128 + 1024 x 256, chain 1024 x 128 with both chains;
bf16 and fp32; mean of 3 after a warm pair) in the order base, noatom,
nowgrad, base, each in a process of its own. Prints one JSON line per run
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

# (file, old, new) edits of each variant, relative to the tree's root
TILE = "moco_flow_tpu_torch/ops/csrc/mlp_tile.cuh"
VARIANTS = {
    "base": [],
    "noatom": [
        (TILE, "    atomicAdd(dst + static_cast<int64_t>(m) * N + n, acc);",
         "    if (acc == 3.0e38f) "
         "atomicAdd(dst + static_cast<int64_t>(m) * N + n, acc);"),
        (TILE, "    atomicAdd(dst + n, s);                 // as in add_wgrad",
         "    if (s == 3.0e38f) atomicAdd(dst + n, s);")],
    "nowgrad": [
        (TILE, "  gemm<TM>(M, N, R, h, d, [&](int m, int n, float acc) {\n"
               "    atomicAdd(dst + static_cast<int64_t>(m) * N + n, acc);\n"
               "  });", "")],
}

CHILD = r"""
import json, os, sys
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from moco_flow_tpu_torch.ops import _build
if sys.argv[1] == "build":
    _build.build()
    _build.load_library()
    sys.exit(0)
from moco_flow_tpu_torch.nn.embedding import anneal_weights
from moco_flow_tpu_torch.ops import nerf_rays as nr
from moco_flow_tpu_torch.ops import nof_chain as nc
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(1)
ncfg = cs.NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
fcfg = cs.NoFConfig()
P = {"nerf": cs.init_nerf(gen, ncfg, dev),
     "bw_NoF": cs.init_nof(gen, fcfg, dev),
     "fw_NoF": cs.init_nof(gen, fcfg, dev)}
an_n = anneal_weights(505000, 10, 5000, 1005000).to(dev)
an_f = anneal_weights(505000, 5, 5000, 1005000).to(dev)
nerf = [cs._nerf_case(P["nerf"], ncfg, an_n, 1024, s, False, gen, dev)
        for s in (128, 256)]
c = cs._chain_case(P, fcfg, an_f, 1024, 128, True, True, gen, dev)
out = {}
for dname, dt in (("bf16", torch.bfloat16), ("fp32", None)):
    out["nerf_bwd " + dname] = cs.cuda_ms(
        lambda: [nr.nerf_bwd(x[0], dt, *x[1:5]) for x in nerf], reps=3)
    out["chain_bwd " + dname] = cs.cuda_ms(
        lambda: [nc.chain_bwd(c[0], dt, 2, *c[1:]) for _ in range(2)],
        reps=3)
print("MS " + json.dumps(out), flush=True)
"""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("parent")
    p.add_argument("out")
    args = p.parse_args(argv)
    trees = {}
    for name, edits in VARIANTS.items():
        dst = os.path.join(os.path.abspath(args.out), name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(args.parent, dst,
                        ignore=shutil.ignore_patterns("build"))
        for rel, old, new in edits:
            path = os.path.join(dst, rel)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the edit does not apply to {rel}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        trees[name] = dst
    builds = {k: subprocess.Popen([sys.executable, "-c", CHILD, "build"],
                                  cwd=d) for k, d in trees.items()}
    for k, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"build of {k} failed")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for k in ("base", "noatom", "nowgrad", "base"):
        run = subprocess.run([sys.executable, "-c", CHILD, "time"],
                             cwd=trees[k], capture_output=True, text=True)
        line = next((ln for ln in run.stdout.splitlines()
                     if ln.startswith("MS ")), None)
        if run.returncode != 0 or line is None:
            sys.stderr.write(run.stdout[-4000:] + run.stderr[-4000:])
            raise SystemExit(f"run {k} failed ({run.returncode})")
        print(json.dumps({"tree": k, "ms": json.loads(line[len("MS "):])}),
              flush=True)
    print(card)


if __name__ == "__main__":
    main()
