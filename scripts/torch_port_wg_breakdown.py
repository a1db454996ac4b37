#!/usr/bin/env python
"""Where a warpgroup of the bf16 wgmma tile (``csrc/wg_tile.cuh``) spends
its time, by clock64 counters in instrumented copies of this tree, on one
card.

    python scripts/torch_port_wg_breakdown.py OUT_DIR

The script copies this tree twice under OUT_DIR and adds counters to
``wg_tile.cuh`` and ``render_pass.cu``: per consumer warpgroup and tile,
the cycles spent waiting for weight slices, in the products (from the
first wgmma of a layer to its wait_group 0, the slice waits included),
setting the accumulators up (bias, partial), in the epilogues, and in
the position fill, the PE fills and the NoF warp; ``base`` as it is,
``prodonly`` without the accumulator set-up and the epilogues (the
products on zeroed accumulators and whatever H holds), so that the
products' own time shows. These are deliberately wrong copies for timing
only. It builds both in parallel, then times one fine launch of kernel #7
in bf16 at a frame's shape (16384 rays x 256 samples, the bw-NoF warp,
c2f.yaml widths) in each, and prints the launch's time and the cycles a
warpgroup spends on each part of a tile (mean over the warpgroup-tiles of
the launch), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

TILE = "moco_flow_tpu_torch/ops/csrc/wg_tile.cuh"
PASS = "moco_flow_tpu_torch/ops/csrc/render_pass.cu"
# counters: slice waits, products, epilogues, whole, tiles, set-up, x + PE,
# warp + PE
COUNTERS = "tw, tm, te, tl, ti, tx, tp"
TILE_EDITS = [
    ("namespace {\nnamespace wg {",
     "__device__ unsigned long long g_prof[16];\nnamespace {\nnamespace wg {"),
    ("  const float* bsig;      // (1,)\n};",
     f"  const float* bsig;      // (1,)\n  long long {COUNTERS};\n}};"),
    ("      wait_parity(c.ring.full + 8 * c.ring.stage, c.ring.phase);\n",
     "      long long tq = clock64();\n"
     "      wait_parity(c.ring.full + 8 * c.ring.stage, c.ring.phase);\n"
     "      c.tw += clock64() - tq;\n"),
    ("  init<kN, kPart>(acc, c, L);\n  product<kN>(acc, c, L);\n",
     "  long long ti0 = clock64();\n  init<kN, kPart>(acc, c, L);\n"
     "  long long t0 = clock64();\n  c.ti += t0 - ti0;\n"
     "  product<kN>(acc, c, L);\n  long long t1 = clock64();\n"
     "  c.tm += t1 - t0;\n"),
    ("  epilogue<kN, kEp>(acc, c, L);\n  fence_async_smem();   // the stores, "
     "before the next wgmma reads them\n  wg_sync(c.wgi);\n}",
     "  epilogue<kN, kEp>(acc, c, L);\n  fence_async_smem();   // the stores, "
     "before the next wgmma reads them\n  wg_sync(c.wgi);\n"
     "  c.te += clock64() - t1;\n}"),
    ("  zero_rows(c, h_blocks, e_blocks);",
     "  c.tw = c.tm = c.te = c.ti = c.tx = c.tp = 0;\n  c.tl = clock64();\n"
     "  zero_rows(c, h_blocks, e_blocks);"),
]
PRODONLY_EDITS = [
    ("  long long ti0 = clock64();\n  init<kN, kPart>(acc, c, L);\n",
     "  long long ti0 = clock64();\n#pragma unroll\n"
     "  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;\n"),
    ("  epilogue<kN, kEp>(acc, c, L);\n",
     "  if (acc[0] == 12345.f) epilogue<kN, kEp>(acc, c, L);\n"),
]
PASS_EDITS = [
    ("      fill_x(w.od,", "      long long tx0 = clock64();\n      fill_x(w.od,"),
    ("      else wg::pe_fill(c, w.nerf_bands, w.nerf_kc);\n",
     "      else wg::pe_fill(c, w.nerf_bands, w.nerf_kc);\n"
     "      c.tx += clock64() - tx0;\n"),
    ("        if (w.has_nof && l == w.n_nof) {   // the warp, then the NeRF's "
     "PE\n",
     "        if (w.has_nof && l == w.n_nof) {   // the warp, then the NeRF's "
     "PE\n          long long tp0 = clock64();\n"),
    ("          wg::pe_fill(c, w.nerf_bands, w.nerf_kc);\n        }",
     "          wg::pe_fill(c, w.nerf_bands, w.nerf_kc);\n"
     "          c.tp += clock64() - tp0;\n        }"),
    ("        wg::run(c, w.layers[l]);\n      }\n    }\n  }\n}",
     "        wg::run(c, w.layers[l]);\n      }\n    }\n    if (c.tid == 0) {\n"
     "      const long long v[8] = {c.tw, c.tm, c.te, clock64() - c.tl,\n"
     "                              wg::tiles_of(n_tiles), c.ti, c.tx, c.tp};\n"
     "      for (int i = 0; i < 8; ++i)\n"
     "        atomicAdd(&g_prof[i], static_cast<unsigned long long>(v[i]));\n"
     "    }\n  }\n}"),
]
# the counters' readers, at file scope (the kernels sit in an anonymous
# namespace)
PASS_TAIL = """
extern "C" int wg_breakdown_read(unsigned long long* o) {
  return static_cast<int>(cudaMemcpyFromSymbol(o, g_prof, 128));
}
extern "C" int wg_breakdown_zero() {
  unsigned long long z[16] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, 128));
}
"""
VARIANTS = {"base": [], "prodonly": PRODONLY_EDITS}

CHILD = r"""
import ctypes, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from moco_flow_tpu_torch.ops import _build
if sys.argv[1] == "build":
    _build.build()
    _build.load_library()
    sys.exit(0)
from moco_flow_tpu_torch.nn.embedding import anneal_weights
from moco_flow_tpu_torch.ops.render_pass import render_pass
from moco_flow_tpu_torch.render.volume import EmbeddingSpec, embed_padded
lib = _build.load_library()
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
ncfg = cs.NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
fcfg = cs.NoFConfig()
params = {"coarse_NeRF": cs.init_nerf(gen, ncfg, dev),
          "bw_NoF": cs.init_nof(gen, fcfg, dev)}
an_n = anneal_weights(505000, 10, 5000, 1005000).to(dev)
an_f = anneal_weights(505000, 5, 5000, 1005000).to(dev)
n, s = 16384, 256
o, d, z, ind = cs._full_width_inputs(n, s, dev, seed=n + s)
extra = embed_padded(ind, EmbeddingSpec(2, in_channels=1), 5)
ind_emb = embed_padded(ind, EmbeddingSpec(16, in_channels=1), 33)
args = (params, "coarse_NeRF", ncfg, fcfg, 10, 5, True, True, an_n, an_f, o,
        d, z, extra, ind_emb, True, False, torch.bfloat16)
render_pass(*args)
torch.cuda.synchronize()
lib.wg_breakdown_zero()
ms = cs.cuda_ms(lambda: render_pass(*args), reps=1)   # warm + 1 timed
buf = (ctypes.c_ulonglong * 16)()
lib.wg_breakdown_read(buf)
names = ("slice waits", "products", "epilogues", "whole tile", "tiles",
         "accumulator set-up", "x + PE", "warp + PE")
cnt = buf[4]
out = {k: buf[i] / cnt for i, k in enumerate(names) if k != "tiles"}
out["launch ms"] = ms
print("MS " + json.dumps(out), flush=True)
"""


def _edit(path: str, edits, name: str, tail: str = ""):
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: an edit does not apply to {path}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text + tail)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out")
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {}
    for name, extra in VARIANTS.items():
        dst = os.path.join(os.path.abspath(args.out), name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(root, dst, ignore=shutil.ignore_patterns(
            "build", ".git", "moco_flow_tpu", "tests"))
        _edit(os.path.join(dst, TILE), TILE_EDITS + extra, name)
        _edit(os.path.join(dst, PASS), PASS_EDITS, name, PASS_TAIL)
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
    for k, d in trees.items():
        run = subprocess.run([sys.executable, "-c", CHILD, "time"], cwd=d,
                             capture_output=True, text=True)
        line = next((ln for ln in run.stdout.splitlines()
                     if ln.startswith("MS ")), None)
        if run.returncode != 0 or line is None:
            sys.stderr.write(run.stdout[-4000:] + run.stderr[-4000:])
            raise SystemExit(f"run {k} failed ({run.returncode})")
        print(f"{k} {line[len('MS '):]}", flush=True)
    print(card)


if __name__ == "__main__":
    main()
