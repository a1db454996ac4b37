"""How the split-TF32 product of the fp32 forward kernels loses accuracy.

The fp32 builds of #1 / #3 / #5 / #7 / #8 / #9 multiply on the tensor
cores in split TF32 (``moco_flow_tpu_torch/ops/csrc/row_tile.cuh``): three
``mma.sync.m16n8k8`` products a k-step (a_lo b_hi, a_hi b_lo, a_hi b_hi).
Two things can take such a product further from the exact one than an fp32
FFMA loop goes: the dropped a_lo b_lo term, and the tensor core's own
additions into a running accumulator (which need not round to nearest);
``row_tile.cuh::mma_split`` sums a k-step's three products from zero and
adds them to the running sum with ``__fadd_rn``. This script builds one small
kernel (one warp a 16 x 8 output tile, the row tile's fragment layout) in
several variants and measures each against the product in fp64 on the card,
beside cuBLAS's fp32 product (TF32 off) and an FFMA loop:

- ``3term``: each product added into the running accumulator;
- ``3term_fresh``: the three products of a k-step summed into a zeroed
  accumulator, which is then added to the running sum with an fp32 add
  (``mma_split``'s scheme);
- ``4term``: ``3term`` with a_lo b_lo added;
- ``4term_fresh``: both;
- ``3term_fresh32``: the zeroed accumulator added every 4 k-steps;
- ``1term``: one TF32 product (no split);
- ``ffma``: a round-to-nearest fp32 FFMA loop over k.

Inputs are seeded: A as post-ReLU activations (non-negative, scaled) or
signed, B as weights with a small shared mean, so that partial sums drift
in one direction as a trained layer's do. It prints, per case and variant,
the largest and the rms distance from fp64 as multiples of cuBLAS fp32's,
one JSON line per case, and writes the lines to
``build/tf32_accum_probe/probe.jsonl``. Card only:

    python scripts/torch_port_tf32_accum_probe.py
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("3term", "3term_fresh", "4term", "4term_fresh", "3term_fresh32",
            "1term", "ffma")

SRC = r"""
#include <cstdint>
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo)
      : "f"(__fsub_rn(x, __uint_as_float(hi))));
}
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// one warp: C[16 x 8] tile (blockIdx.x rows, blockIdx.y cols) of A @ B,
// A (M, K) and B (K, N) row-major fp32
template <int V>
__global__ void probe(const float* A, const float* B, float* C, int K,
                      int N) {
  const int lane = threadIdx.x, g = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * 16, c0 = blockIdx.y * 8;
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, tmp[4] = {0.f, 0.f, 0.f, 0.f};
  if (V == 6) {
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + g + 8 * (q >> 1), c = c0 + 2 * tq + (q & 1);
      float s = 0.f;
      for (int k = 0; k < K; ++k) s = fmaf(A[(int64_t)r * K + k],
                                            B[(int64_t)k * N + c], s);
      acc[q] = s;
    }
  } else {
    const float* a = A + (int64_t)(r0 + g) * K + tq;
    const float* b = B + (int64_t)tq * N + c0 + g;
    for (int ks = 0; ks < K; ks += 8) {
      unsigned ah[4], al[4], bh[2], bl[2];
      split(a[ks], ah[0], al[0]);
      split(a[ks + 8 * K], ah[1], al[1]);
      split(a[ks + 4], ah[2], al[2]);
      split(a[ks + 8 * K + 4], ah[3], al[3]);
      split(b[(int64_t)ks * N], bh[0], bl[0]);
      split(b[(int64_t)(ks + 4) * N], bh[1], bl[1]);
      const bool fresh = V == 1 || V == 3 || V == 4;
      float (&dst)[4] = fresh ? tmp : acc;
      if (V == 2 || V == 3) mma(dst, al, bl);
      if (V != 5) {
        mma(dst, al, bh);
        mma(dst, ah, bl);
      }
      mma(dst, ah, bh);
      if (fresh && (V != 4 || (ks & 31) == 24 || ks + 8 >= K)) {
        for (int q = 0; q < 4; ++q) {
          acc[q] = __fadd_rn(acc[q], tmp[q]);
          tmp[q] = 0.f;
        }
      }
    }
  }
  for (int q = 0; q < 4; ++q)
    C[(int64_t)(r0 + g + 8 * (q >> 1)) * N + c0 + 2 * tq + (q & 1)] = acc[q];
}
extern "C" int probe_launch(int v, const float* A, const float* B, float* C,
                            int M, int K, int N) {
  dim3 grid(M / 16, N / 8);
  switch (v) {
    case 0: probe<0><<<grid, 32>>>(A, B, C, K, N); break;
    case 1: probe<1><<<grid, 32>>>(A, B, C, K, N); break;
    case 2: probe<2><<<grid, 32>>>(A, B, C, K, N); break;
    case 3: probe<3><<<grid, 32>>>(A, B, C, K, N); break;
    case 4: probe<4><<<grid, 32>>>(A, B, C, K, N); break;
    case 5: probe<5><<<grid, 32>>>(A, B, C, K, N); break;
    default: probe<6><<<grid, 32>>>(A, B, C, K, N); break;
  }
  return (int)cudaGetLastError();
}
"""
# variant name -> template argument
CODE = {"3term": 0, "3term_fresh": 1, "4term": 2, "4term_fresh": 3,
        "3term_fresh32": 4, "1term": 5, "ffma": 6}


def build() -> ctypes.CDLL:
    h = hashlib.sha256(SRC.encode()).hexdigest()[:16]
    out = ROOT / "build" / "tf32_accum_probe" / h / "probe.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        src = out.with_name("probe.cu")
        src.write_text(SRC)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
                        str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.probe_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3
    lib.probe_launch.restype = ctypes.c_int
    return lib


def cases(gen: torch.Generator):
    """(name, A, B) on the card: M 65,536 rows, N 256 columns."""
    m, n = 65536, 256
    for k in (64, 256):
        z = torch.randn(m, k, generator=gen)
        w = torch.randn(k, n, generator=gen) / k ** 0.5
        yield f"signed K={k}", z, w
        yield f"relu K={k}", z.clamp_min(0), w
        yield (f"relu x30, weights mean 0.02 K={k}", 30 * z.clamp_min(0),
               w + 0.02)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build()
    dev = torch.device("cuda")
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    lines = []
    for case, a, b in cases(torch.Generator().manual_seed(0)):
        a, b = a.to(dev).contiguous(), b.to(dev).contiguous()
        m, k = a.shape
        n = b.shape[1]
        exact = a.double() @ b.double()
        blas = (a @ b).double() - exact
        ref_max, ref_rms = blas.abs().max().item(), blas.pow(2).mean().sqrt(
            ).item()
        row = {"case": case, "card": name, "cublas_fp32_max": ref_max,
               "cublas_fp32_rms": ref_rms}
        for v in VARIANTS:
            c = torch.empty(m, n, device=dev)
            rc = lib.probe_launch(CODE[v], a.data_ptr(), b.data_ptr(),
                                  c.data_ptr(), m, k, n)
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"{v}: launch failed ({rc})")
            d = c.double() - exact
            row[v] = {"max_x": d.abs().max().item() / ref_max,
                      "rms_x": d.pow(2).mean().sqrt().item() / ref_rms,
                      "mean_x": d.mean().item() / ref_rms}
        print(json.dumps(row), flush=True)
        lines.append(row)
    out = ROOT / "build" / "tf32_accum_probe" / "probe.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
