#!/usr/bin/env python
"""Where the time of the bf16 render-pass kernel #7 (``render_pass``) went in
its ``mma.sync`` design (``pass_tile.cuh::mma_layer``), by elimination, and
how fast one block can stream a tile's weight slices from L2, on one card.

    python scripts/torch_port_fwd_elimination.py PARENT_DIR OUT_DIR

PARENT_DIR is a checkout of a tree that still has that design: commit
6245cc4, the last one before #7 moved to the wgmma tile, unpacked with ``git
archive`` under the git-ignored ``build/``. The script edits only
PARENT_DIR's copies, never the tree it runs from: from a4e337b on #7 no
longer runs ``mma_layer``, and later trees have no ``mma_layer`` at all.
The script copies it four times under OUT_DIR: ``base`` as it is,
``noproduct`` without the layers' ldmatrix + mma.sync loops (the weight
staging, the barriers and the epilogues remain), ``nostage`` without the
cp.async copies of the weight slices (the products run on whatever shared
memory holds), and ``headsonly`` whose trunk, final and extra layers return
at once (the xyz load, the PE fills, the NoF head with its warp, and the
sigma and rgb heads remain). These are deliberately wrong copies for timing
only. It builds the four in parallel, together with ``stream``: a kernel in
which one thread a block streams a tile's weight slices, in the order and
sizes of the redesigned kernel's (``wg_tile.cuh``: W^T slices 64 deep,
N padded to 8, 16, 128 or 256), from L2 into a ring of RING 32 KB stages
with ``cp.async.bulk`` and ``mbarrier``s, one block an SM, nothing else.

Each tree then times one 256x256 frame's own 8 launches of #7 in bf16
(4 x coarse S=128 sigma-only + fine S=256, N=16384 rays, the bw-NoF warp,
c2f.yaml widths; mean of 3 after a warm one), in the order base,
noproduct, nostage, headsonly, base, and ``stream`` the same frame's
65,536 coarse and 131,072 fine tiles of slices, each run in a process of
its own. Prints one JSON line per run and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

RING = 4                 # stages of the redesigned kernel's weight ring
TILE = "moco_flow_tpu_torch/ops/csrc/pass_tile.cuh"
PRODUCT = """    for (int ks = 0; ks < kl; ks += 16) {
      unsigned af[4];
      ldsm_x4(af, A + ks);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (t < ntw) {
          unsigned bfr[2];
          ldsm_x2(bfr, B + t * 8 * kWsLd + ks);
          mma_bf16(acc[t], af, bfr);
        }
      }
    }
"""
STAGING = """      for (int v = c.tid; v < n_pad * vpr; v += kMmaThreads) {
        const int row = v / vpr, q = v % vpr;
        cp_async16(buf + row * kWsLd + q * 8,
                   w + static_cast<int64_t>(row) * K + k0 + q * 8);
      }
"""
LAYER_START = """  const int n_pad = pad16(n);
  const int ntw = n_pad / 16;            // 8-column tiles per column half
"""
# (file, old, new) edits of each variant, relative to the tree's root
VARIANTS = {
    "base": [],
    "noproduct": [(TILE, PRODUCT, "")],
    "nostage": [(TILE, STAGING, "")],
    "headsonly": [(TILE, LAYER_START,
                   "  if (ep == kReluPartialFirst || ep == kReluBiasFirst ||"
                   " ep == kLinear) return;\n" + LAYER_START)],
}

STREAM_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// one tile's slices (sizes[i] bytes, contiguous from src) into a ring of
// `ring` stages of 32 KB, one thread, each stage reused once its last copy
// has landed
__global__ void __launch_bounds__(32, 1)
stream_kernel(const unsigned char* src, const int* sizes, int n_slices,
              int ring) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* buf = smem + 1024;
  if (threadIdx.x != 0) return;
  for (int s = 0; s < ring; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(full + s)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  int64_t off = 0;
  for (int i = 0; i < n_slices; ++i) {
    const int s = i % ring, m = i / ring;
    if (m > 0) wait_parity(smem_u32(full + s), (m - 1) & 1);
    const int bytes = sizes[i];
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(full + s)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(buf + s * 32768)), "l"(src + off),
                    "r"(bytes), "r"(smem_u32(full + s)) : "memory");
    off += bytes;
  }
  for (int i = n_slices > ring ? n_slices - ring : 0; i < n_slices; ++i)
    wait_parity(smem_u32(full + i % ring), (i / ring) & 1);
}

extern "C" int stream_launch(const void* src, const int* sizes, int n_slices,
                             int ring, int blocks, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  stream_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), sizes, n_slices, ring);
  return static_cast<int>(cudaGetLastError());
}
"""

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
from moco_flow_tpu_torch.ops.render_pass import render_pass
from moco_flow_tpu_torch.render.volume import EmbeddingSpec, embed_padded
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
ncfg = cs.NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
fcfg = cs.NoFConfig()
params = {"coarse_NeRF": cs.init_nerf(gen, ncfg, dev),
          "bw_NoF": cs.init_nof(gen, fcfg, dev)}
an_n = anneal_weights(505000, 10, 5000, 1005000).to(dev)
an_f = anneal_weights(505000, 5, 5000, 1005000).to(dev)
n, calls = 16384, []
for s, sigma_only in ((128, True), (256, False)):
    o, d, z, ind = cs._full_width_inputs(n, s, dev, seed=n + s)
    extra = embed_padded(ind, EmbeddingSpec(2, in_channels=1), 5)
    ind_emb = embed_padded(ind, EmbeddingSpec(16, in_channels=1), 33)
    args = (params, "coarse_NeRF", ncfg, fcfg, 10, 5, True, True, an_n,
            an_f, o, d, z, None if sigma_only else extra, ind_emb, True,
            sigma_only, torch.bfloat16)
    calls.append(lambda a=args: render_pass(*a))
ms = cs.cuda_ms(lambda: [f() for f in calls for _ in range(4)], reps=3)
print("MS " + json.dumps({"frame bf16": ms}), flush=True)
"""

# a tile's weight slices in the redesigned kernel's order: (K, N) of each
# product term, N padded to the wgmma width, 64-deep slices of N_pad rows
# of 128 bytes; the sigma head is a dot product and streams nothing
NOF = [(33, 128), (128, 128), (33, 128), (128, 128), (128, 128), (128, 16)]
NERF = ([(63, 256)] + [(256, 256)] * 3 + [(63, 256), (256, 256)]
        + [(256, 256)] * 3)
HEADS = [(256, 256), (256, 128), (128, 8)]       # final, extra, rgb


def slice_sizes(terms) -> list:
    return [n * 128 for k, n in terms for _ in range(-(-k // 64))]


STREAM_CHILD = r"""
import ctypes, json, sys
import torch
lib = ctypes.CDLL(sys.argv[1])
lib.stream_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
sizes = json.loads(sys.argv[2])
dev = torch.device("cuda")
st = torch.cuda.current_stream().cuda_stream
launches = []
for name, tiles in (("coarse", 16384), ("fine", 32768)):
    sz = torch.tensor(sizes[name], dtype=torch.int32, device=dev)
    src = torch.randint(0, 255, (sum(sizes[name]),), dtype=torch.uint8,
                        device=dev)
    launches.append((src, sz, tiles, name))
ring = int(sys.argv[3])

def frame():
    for src, sz, tiles, _ in launches * 4:
        rc = lib.stream_launch(src.data_ptr(), sz.data_ptr(), sz.numel(),
                               ring, tiles, 1024 + 200 * 1024, st)
        assert rc == 0, rc

frame()
torch.cuda.synchronize()
e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
e0.record()
for _ in range(3):
    frame()
e1.record()
torch.cuda.synchronize()
ms = e0.elapsed_time(e1) / 3
nbytes = 4 * sum(t * sum(s) for s, t in ((sizes["coarse"], 16384),
                                         (sizes["fine"], 32768)))
print("MS " + json.dumps({"frame stream": ms, "bytes": nbytes,
                          "TB/s": nbytes / ms / 1e9}), flush=True)
"""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("parent")
    p.add_argument("out")
    args = p.parse_args(argv)
    out = os.path.abspath(args.out)
    trees = {}
    for name, edits in VARIANTS.items():
        dst = os.path.join(out, name)
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
    sdir = os.path.join(out, "stream")
    os.makedirs(sdir, exist_ok=True)
    with open(os.path.join(sdir, "stream.cu"), "w") as f:
        f.write(STREAM_CU)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(sdir, "libstream.so")
    builds = {k: subprocess.Popen([sys.executable, "-c", CHILD, "build"],
                                  cwd=d) for k, d in trees.items()}
    builds["stream"] = subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
         os.path.join(sdir, "stream.cu")])
    for k, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"build of {k} failed")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sizes = {"coarse": slice_sizes(NOF + NERF),
             "fine": slice_sizes(NOF + NERF + HEADS)}
    runs = [(k, [sys.executable, "-c", CHILD, "time"], trees[k])
            for k in ("base", "noproduct", "nostage", "headsonly", "base")]
    runs.append(("stream", [sys.executable, "-c", STREAM_CHILD, lib,
                            json.dumps(sizes), str(RING)], sdir))
    for k, cmd, cwd in runs:
        run = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
        line = next((ln for ln in run.stdout.splitlines()
                     if ln.startswith("MS ")), None)
        if run.returncode != 0 or line is None:
            sys.stderr.write(run.stdout[-4000:] + run.stderr[-4000:])
            raise SystemExit(f"run {k} failed ({run.returncode})")
        print(json.dumps({"tree": k, "ms": json.loads(line[len("MS "):])}),
              flush=True)
    print(json.dumps({"slice_bytes": {k: sum(v) for k, v in sizes.items()},
                      "ring": RING}))
    print(card)


if __name__ == "__main__":
    main()
