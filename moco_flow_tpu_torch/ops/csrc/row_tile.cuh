// Row-tile passes of the training backward kernels (nerf_rays.cu,
// chain_bwd.cu): a block of 512 threads carries a tile of 128 consecutive
// sample rows through one product at a time, out = A1 @ B1 + A2 @ B2, with
// A in shared memory and B (a layer's weights, or their transpose for an
// input gradient) streamed from L2, and hands every result pair to an
// epilogue functor. The forward recompute and the backward walk are built
// from it; they store what the weight gradients need to a device scratch
// (wgrad.cuh) instead of keeping it in shared memory.
//
// - bf16: tensor cores (16 warps = 8 row groups x 2 column halves,
//   mma.sync m16n8k16, A fragments by ldmatrix from row-major shared
//   memory, 64-deep slices of B^T staged with cp.async, double-buffered,
//   shared by the 16 warps). B arrives as B^T zero-padded to (pad16(n),
//   pad16(k)); A holds finite values (zeros) in its columns k..pad16(k).
// - fp32 (rt_mm with fp32 staging; every pass of #1-#6, and the fp32
//   builds of #7 / #8 in render_pass.cu and fused_mlp.cu): mma.sync
//   m16n8k8 in TF32 with split operands ("3xTF32"): a = a_hi + a_lo and
//   b = b_hi + b_lo, each part rounded to TF32 by cvt.rna; a k-step's
//   a_lo b_hi + a_hi b_lo + a_hi b_hi is summed on the tensor cores from
//   zero and added to the running sum with an fp32 add (mma_split). The
//   tensor core's own additions do not round to nearest: adding each
//   product into the running sum left it 2.4-4.4x further from the exact
//   product than cuBLAS's fp32 one (at most; rms 3.2-9.4x), the k-step sum
//   added with __fadd_rn 0.39-0.70x
//   (scripts/torch_port_tf32_accum_probe.py). The dropped a_lo b_lo
//   (~2^-22 of a term) moved neither. The warp layout is the bf16 one; B
//   (zero-padded to (k, pad16(n))) is staged in 16-deep fp32 slices with
//   cp.async, double-buffered, and split at fragment load; A fragments are
//   32-bit loads from row-major fp32 shared memory, whose row stride
//   (tile_ld: 4 mod 16 floats) keeps them conflict-free. The per-op NoF #9
//   takes B split once by its wrapper (rt_mm_presplit): only A is split in
//   the kernel, with the same bits.
// Every product accumulates in fp32 from the stored operands.

#pragma once

#include "pass_tile.cuh"

namespace {

constexpr int kRT = 128;                 // rows per tile
constexpr int kRTThreads = 512;          // 16 warps

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T
template <typename T> __device__ __forceinline__ float rnd_t(float v) {
  return to_f(from_f<T>(v));
}

// two consecutive elements (the first at an even index)
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One term A @ B of a row-tile product (k = 0: absent).
template <typename T> struct Term {
  const T* a;     // (kRT, k) in shared memory, row stride lda
  int lda;
  const T* b;     // B in device memory, laid out as above
  int k;
};

// epi(r, c, v0, v1) for each row r < kRT and even column c < n with the
// results of columns c and c + 1 (c + 1 may be a padded column, whose value
// is exactly 0). Block-wide; starts and ends with every thread in step, so
// the epilogue may overwrite an A operand.
template <class Epi>
__device__ void rt_mm(bf16* Ws, Term<bf16> t1, Term<bf16> t2, int n,
                      Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp_m = (tid >> 5) & 7, warp_n = tid >> 8;
  const int n_pad = pad16(n), ntw = n_pad / 16, nbase = warp_n * ntw * 8;
  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = 0.f;
  const int k1 = t1.k ? pad16(t1.k) : 0, k2 = t2.k ? pad16(t2.k) : 0;
  const int n1 = (k1 + kKc - 1) / kKc;
  const int n_slices = n1 + (k2 + kKc - 1) / kKc;
  auto stage = [&](int ci) {
    if (ci < n_slices) {
      const bool first = ci < n1;
      const bf16* w = first ? t1.b : t2.b;
      const int K = first ? k1 : k2;
      const int k0 = (first ? ci : ci - n1) * kKc;
      const int vpr = min(kKc, K - k0) / 8;   // 16-byte vectors per row
      bf16* buf = Ws + (ci & 1) * kMaxWidth * kWsLd;
      for (int v = tid; v < n_pad * vpr; v += kRTThreads) {
        const int row = v / vpr, q = v % vpr;
        cp_async16(buf + row * kWsLd + q * 8,
                   w + static_cast<int64_t>(row) * K + k0 + q * 8);
      }
    }
    cp_async_commit();
  };
  stage(0);
  for (int ci = 0; ci < n_slices; ++ci) {
    stage(ci + 1);
    cp_async_wait_all_but_one();         // slice ci has landed ...
    __syncthreads();                     // ... for every thread
    const bool first = ci < n1;
    const int K = first ? k1 : k2;
    const int k0 = (first ? ci : ci - n1) * kKc;
    const int kl = min(kKc, K - k0);
    const bf16* A = (first ? t1.a : t2.a) +
                    (warp_m * 16 + (lane & 15)) * (first ? t1.lda : t2.lda) +
                    k0 + (lane >> 4) * 8;
    const bf16* B = Ws + (ci & 1) * kMaxWidth * kWsLd +
                    (nbase + (lane & 7)) * kWsLd + ((lane >> 3) & 1) * 8;
    for (int ks = 0; ks < kl; ks += 16) {
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
    __syncthreads();   // slice ci consumed; after the last, A read by all
  }
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (t >= ntw) continue;
    const int col = nbase + t * 8 + tq * 2;
    if (col >= n) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      epi(warp_m * 16 + g + 8 * hh, col, acc[t][2 * hh], acc[t][2 * hh + 1]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// fp32 on the tensor cores: split TF32 products
// ---------------------------------------------------------------------------

constexpr int kKs = 16;                  // fp32: k per staged slice
constexpr int kWsLdF = kMaxWidth + 8;    // its row stride: conflict-free B

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// x = hi + lo, each rounded to TF32 (nearest, ties away from zero)
__device__ __forceinline__ void tf32_split(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(lo)
      : "f"(__fsub_rn(x, __uint_as_float(hi))));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b from zero (one zero register as the accumulator operand, so d
// takes no registers before the product)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// c += a_hi b_lo + a_lo b_hi + a_hi b_hi for one k-step: the three
// products summed from zero on the tensor cores, then added to c rounding
// to nearest. In this order (b_lo's registers free first) #7's fp32
// kernel fits its 128 registers without spilling (chip_smoke.py phase 2
// fails on a spill).
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const unsigned (&ah)[4],
                                          const unsigned (&al)[4],
                                          const unsigned (&bh)[2],
                                          const unsigned (&bl)[2]) {
  float s[4];
  mma_tf32_zero(s, ah, bl);
  mma_tf32(s, al, bh);
  mma_tf32(s, ah, bh);
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = __fadd_rn(c[q], s[q]);
}

// The fp32 product on the tensor cores, the contract of the bf16 rt_mm. A
// holds finite values (zeros) in its columns k..pad8(k); B's rows past k
// are staged as zeros.
template <class Epi>
__device__ void rt_mm(float* Ws, Term<float> t1, Term<float> t2, int n,
                      Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp_m = (tid >> 5) & 7, warp_n = tid >> 8;
  const int g = lane >> 2, tq = lane & 3;
  const int n_pad = pad16(n), ntw = n_pad / 16, nbase = warp_n * ntw * 8;
  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = 0.f;
  const int k1 = (t1.k + 7) & ~7, k2 = (t2.k + 7) & ~7;
  const int n1 = (k1 + kKs - 1) / kKs;
  const int n_slices = n1 + (k2 + kKs - 1) / kKs;
  auto stage = [&](int ci) {
    if (ci < n_slices) {
      const bool first = ci < n1;
      const float* w = first ? t1.b : t2.b;
      const int K = first ? t1.k : t2.k;
      const int k0 = (first ? ci : ci - n1) * kKs;
      const int rows = min(kKs, (first ? k1 : k2) - k0);
      const int vpr = n_pad / 4;              // 16-byte vectors per row
      float* buf = Ws + (ci & 1) * kKs * kWsLdF;
      for (int v = tid; v < rows * vpr; v += kRTThreads) {
        const int kk = v / vpr, q = (v % vpr) * 4;
        float* dst = buf + kk * kWsLdF + q;
        if (k0 + kk < K)
          cp_async16(dst, w + static_cast<int64_t>(k0 + kk) * n_pad + q);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  };
  stage(0);
  for (int ci = 0; ci < n_slices; ++ci) {
    stage(ci + 1);
    cp_async_wait_all_but_one();         // slice ci has landed ...
    __syncthreads();                     // ... for every thread
    const bool first = ci < n1;
    const int k0 = (first ? ci : ci - n1) * kKs;
    const int kl = min(kKs, (first ? k1 : k2) - k0);
    const int lda = first ? t1.lda : t2.lda;
    const float* A = (first ? t1.a : t2.a) + (warp_m * 16 + g) * lda + k0 +
                     tq;
    const float* B = Ws + (ci & 1) * kKs * kWsLdF + tq * kWsLdF + nbase + g;
    for (int ks = 0; ks < kl; ks += 8) {
      unsigned ah[4], al[4];
      tf32_split(A[ks], ah[0], al[0]);
      tf32_split(A[ks + 8 * lda], ah[1], al[1]);
      tf32_split(A[ks + 4], ah[2], al[2]);
      tf32_split(A[ks + 8 * lda + 4], ah[3], al[3]);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (t < ntw) {
          unsigned bh[2], bl[2];
          tf32_split(B[ks * kWsLdF + t * 8], bh[0], bl[0]);
          tf32_split(B[(ks + 4) * kWsLdF + t * 8], bh[1], bl[1]);
          mma_split(acc[t], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();   // slice ci consumed; after the last, A read by all
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (t >= ntw) continue;
    const int col = nbase + t * 8 + tq * 2;
    if (col >= n) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      epi(warp_m * 16 + g + 8 * hh, col, acc[t][2 * hh], acc[t][2 * hh + 1]);
  }
  __syncthreads();
}

// rt_mm's split-TF32 product with B split once by the caller (the per-op
// NoF #9): B's TF32 hi part at t.b and its lo part at t.b + lo (elements),
// each in rt_mm's layout and rounded as tf32_split rounds
// (ops/_args.py::tf32_split), so the sums are rt_mm's bit for bit and only A
// is split here. A slice is kd (16 or 8) deep: its hi and lo parts are
// staged side by side, double-buffered, 2 x 2 x kd x kWsLdF floats.
template <class Epi>
__device__ void rt_mm_presplit(float* Ws, int kd, Term<float> t1,
                               Term<float> t2, int64_t lo, int n, Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp_m = (tid >> 5) & 7, warp_n = tid >> 8;
  const int g = lane >> 2, tq = lane & 3;
  const int n_pad = pad16(n), ntw = n_pad / 16, nbase = warp_n * ntw * 8;
  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = 0.f;
  const int k1 = (t1.k + 7) & ~7, k2 = (t2.k + 7) & ~7;
  const int n1 = (k1 + kd - 1) / kd;
  const int n_slices = n1 + (k2 + kd - 1) / kd;
  const int part = kd * kWsLdF;               // a slice's hi (or lo) part
  auto stage = [&](int ci) {
    if (ci < n_slices) {
      const bool first = ci < n1;
      const float* w = first ? t1.b : t2.b;
      const int K = first ? t1.k : t2.k;
      const int k0 = (first ? ci : ci - n1) * kd;
      const int rows = min(kd, (first ? k1 : k2) - k0);
      const int vpr = n_pad / 4;              // 16-byte vectors per row
      float* buf = Ws + (ci & 1) * 2 * part;
      for (int v = tid; v < 2 * rows * vpr; v += kRTThreads) {
        const int lo_part = v >= rows * vpr, u = v - lo_part * rows * vpr;
        const int kk = u / vpr, q = (u % vpr) * 4;
        float* dst = buf + lo_part * part + kk * kWsLdF + q;
        if (k0 + kk < K)
          cp_async16(dst, w + lo_part * lo +
                              static_cast<int64_t>(k0 + kk) * n_pad + q);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  };
  stage(0);
  for (int ci = 0; ci < n_slices; ++ci) {
    stage(ci + 1);
    cp_async_wait_all_but_one();         // slice ci has landed ...
    __syncthreads();                     // ... for every thread
    const bool first = ci < n1;
    const int k0 = (first ? ci : ci - n1) * kd;
    const int kl = min(kd, (first ? k1 : k2) - k0);
    const int lda = first ? t1.lda : t2.lda;
    const float* A = (first ? t1.a : t2.a) + (warp_m * 16 + g) * lda + k0 +
                     tq;
    const float* Bh = Ws + (ci & 1) * 2 * part + tq * kWsLdF + nbase + g;
    const float* Bl = Bh + part;
    for (int ks = 0; ks < kl; ks += 8) {
      unsigned ah[4], al[4];
      tf32_split(A[ks], ah[0], al[0]);
      tf32_split(A[ks + 8 * lda], ah[1], al[1]);
      tf32_split(A[ks + 4], ah[2], al[2]);
      tf32_split(A[ks + 8 * lda + 4], ah[3], al[3]);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (t < ntw) {
          const int b0 = ks * kWsLdF + t * 8, b1 = b0 + 4 * kWsLdF;
          const unsigned bh[2] = {__float_as_uint(Bh[b0]),
                                  __float_as_uint(Bh[b1])};
          const unsigned bl[2] = {__float_as_uint(Bl[b0]),
                                  __float_as_uint(Bl[b1])};
          mma_split(acc[t], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();   // slice ci consumed; after the last, A read by all
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (t >= ntw) continue;
    const int col = nbase + t * 8 + tq * 2;
    if (col >= n) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      epi(warp_m * 16 + g + 8 * hh, col, acc[t][2 * hh], acc[t][2 * hh + 1]);
  }
  __syncthreads();
}

// bytes of a pass's staged weight slices (of T: rt_mm's bf16 product in
// the bf16 build, its split-TF32 product in the fp32 one)
template <typename T> __host__ __device__ constexpr size_t stage_bytes() {
  return sizeof(T) == 4 ? 2 * kKs * kWsLdF * sizeof(float)
                        : 2 * kMaxWidth * kWsLd * sizeof(bf16);
}

template <typename T> __device__ __forceinline__ Term<T> no_term() {
  return Term<T>{nullptr, 0, nullptr, 0};
}

// Shared-memory row stride of a T tile with `cols` columns: padded to 16,
// plus 16 bytes so ldmatrix rows fall in other banks; a multiple of 16
// bytes either way.
template <typename T> __host__ __device__ inline int tile_ld(int cols) {
  return pad16(cols) + 16 / static_cast<int>(sizeof(T));
}

// dst rows [row0, row0 + kRT) (row stride dst_ld) <- the tile (row stride
// src_ld), `cols` columns (a multiple of 16 / sizeof(T)), 16 bytes a thread.
template <typename T>
__device__ void rt_store(T* dst, int dst_ld, int64_t row0, const T* src,
                         int src_ld, int cols) {
  constexpr int kV = 16 / sizeof(T);
  const int vpr = cols / kV;
  for (int v = threadIdx.x; v < kRT * vpr; v += kRTThreads) {
    const int r = v / vpr, q = (v % vpr) * kV;
    *reinterpret_cast<uint4*>(dst + (row0 + r) * dst_ld + q) =
        *reinterpret_cast<const uint4*>(src + r * src_ld + q);
  }
}

// the tile <- dst's rows (the inverse of rt_store); ends with a barrier
template <typename T>
__device__ void rt_load(T* dst, int dst_ld, const T* src, int src_ld,
                        int64_t row0, int cols) {
  constexpr int kV = 16 / sizeof(T);
  const int vpr = cols / kV;
  for (int v = threadIdx.x; v < kRT * vpr; v += kRTThreads) {
    const int r = v / vpr, q = (v % vpr) * kV;
    *reinterpret_cast<uint4*>(dst + r * dst_ld + q) =
        *reinterpret_cast<const uint4*>(src + (row0 + r) * src_ld + q);
  }
  __syncthreads();
}

// Packed PE of the tile into row-major E: [x(3), sin(kc), cos(kc), zeros to
// pad16(3 + 2kc)], column 3 + f*3 + j = sin(bands[f] * x_j); X is [3][kRT].
template <typename T>
__device__ void rt_pe_fill(T* E, int e_ld, const float* X,
                           const float* bands, int kc) {
  const int kp = 3 + 2 * kc;
  for (int i = threadIdx.x; i < kRT * kc; i += kRTThreads) {
    const int r = i % kRT, f3j = i / kRT;
    float s, c;
    sincosf(__fmul_rn(bands[f3j / 3], X[(f3j % 3) * kRT + r]), &s, &c);
    E[r * e_ld + 3 + f3j] = from_f<T>(s);
    E[r * e_ld + 3 + kc + f3j] = from_f<T>(c);
  }
  const int extra = 3 + pad16(kp) - kp;
  for (int i = threadIdx.x; i < kRT * extra; i += kRTThreads) {
    const int r = i % kRT, j = i / kRT;
    if (j < 3) E[r * e_ld + j] = from_f<T>(X[j * kRT + r]);
    else E[r * e_ld + kp + j - 3] = from_f<T>(0.f);
  }
  __syncthreads();
}

// dX [3][kRT] += de[:, :3] + B . (de_sin cos - de_cos sin): the PE chain of
// _nerf_bwd_tile / _nof_bwd_tile (de, row stride de_ld, is the packed
// embedding's cotangent). Ends with a barrier.
__device__ void rt_pe_backward(float* dX, const float* de, int de_ld,
                               const float* X, const float* bands, int kc) {
  for (int i = threadIdx.x; i < kRT * 3; i += kRTThreads) {
    const int r = i % kRT, j = i / kRT;
    const float* d = de + r * de_ld;
    const float x = X[j * kRT + r];
    float acc = 0.f;
    for (int f = 0; f < kc / 3; ++f) {
      float s, c;
      sincosf(__fmul_rn(bands[f], x), &s, &c);
      const int q = 3 + f * 3 + j;
      const float ds = __fsub_rn(__fmul_rn(d[q], c), __fmul_rn(d[q + kc], s));
      acc = __fadd_rn(acc, __fmul_rn(bands[f], ds));
    }
    dX[i] = __fadd_rn(__fadd_rn(dX[i], d[j]), acc);
  }
  __syncthreads();
}

// Operands of one layer: each matrix as the forward product's B (f) and the
// input gradient's B (b = the transpose), in the layout rt_mm takes.
struct RLayer {
  const void* pe_f;       // packed-PE rows, or null
  const void* pe_b;
  const void* h_f;        // hidden rows, or null
  const void* h_b;
  const float* bias;
};

struct RMat {
  const void* f;
  const void* b;
  const float* bias;
};

}  // namespace
