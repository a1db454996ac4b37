// Row-tile building blocks of the per-op NoF kernel #9 (fused_mlp.cu): a
// block carries a tile of sample rows through an MLP with every activation
// in shared memory, updated in place layer by layer, while the weights
// stream from L2. The helpers (pad16, the quaternion head, sigmoid, the
// launcher, the mma.sync and cp.async wrappers) also serve row_tile.cuh and
// wg_tile.cuh.
//
// - bf16 (mma_layer): tensor cores. A block of 16 warps takes 128 rows; each
//   warp owns 16 rows and one half of a layer's output columns and runs
//   mma.sync m16n8k16 (bf16 operands, fp32 accumulation). Activations are
//   row-major bf16 in shared memory (ldmatrix A fragments); each 64-deep
//   slice of a layer's transposed weight is staged once per block in shared
//   memory, double-buffered with cp.async so the next slice streams in from
//   L2 while the warps multiply this one, and shared by all 16 warps
//   (ldmatrix B fragments). Weights arrive transposed and zero-padded to
//   multiples of 16; padded output columns come out exactly zero.
// - fp32 (layer, head): a plain FFMA loop. A block of 8 warps takes 64 rows;
//   a warp owns 8 rows, K-major in shared memory (one 16-byte load gives the
//   warp the 8 rows of a feature), and lane l computes output columns l,
//   l+32, ... from coalesced weight rows; warps never wait for each other.
//
// A layer is out = E @ wpe + H @ wh (either term may be absent) followed by
// an epilogue: E holds the layer's direct inputs (a packed PE embedding, or
// pre-embedded rows), H the previous activation. Biases, per-ray partials,
// heads and the quaternion transform are fp32; elementwise steps use
// explicitly rounded intrinsics (__fmul_rn, __fadd_rn) so nvcc cannot fuse
// them into FMAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWidth = 256;
constexpr int kMaxSmem = 232448;         // 227 KB a block can opt into
constexpr int kMaxHeadOut = 16;          // NoF head outputs (9 or 3), padded

__host__ __device__ __forceinline__ int pad16(int x) {
  return (x + 15) & ~15;
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  o[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  o[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

// _nof_quat_fwd_t on one sample: o = [v, s, t] (or a 3-vector offset),
// x in place: d = x - s; theta = sqrt(|v|^2 + eps^2);
// qv = -v sin(theta)/theta; t1 = qv x d + cos(theta) d;
// warped = d + 2 qv x t1 + s + t
__device__ void nof_head_apply(const float* o, bool use_quat, float* x) {
  if (!use_quat) {
    for (int j = 0; j < 3; ++j) x[j] = __fadd_rn(o[j], x[j]);
    return;
  }
  const float* v = o;
  const float* s = o + 3;
  const float* t = o + 6;
  float d[3], qv[3], c1[3], t1[3], c2[3];
  for (int j = 0; j < 3; ++j) d[j] = __fsub_rn(x[j], s[j]);
  const float th2 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])),
                __fmul_rn(v[2], v[2])),
      1e-16f);
  const float theta = sqrtf(th2);
  const float w = cosf(theta);
  const float k = __fdiv_rn(sinf(theta), theta);
  for (int j = 0; j < 3; ++j) qv[j] = __fmul_rn(-v[j], k);
  cross3(qv, d, c1);
  for (int j = 0; j < 3; ++j) t1[j] = __fadd_rn(c1[j], __fmul_rn(w, d[j]));
  cross3(qv, t1, c2);
  for (int j = 0; j < 3; ++j)
    x[j] = __fadd_rn(__fadd_rn(__fadd_rn(d[j], __fmul_rn(2.f, c2[j])), s[j]),
                     t[j]);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// ===========================================================================
// bf16: tensor cores
// ===========================================================================

constexpr int kMmaRows = 128;            // rows per block
constexpr int kMmaWarps = 16;            // 8 row groups x 2 column halves
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kKc = 64;                  // k per staged weight slice
constexpr int kWsLd = kKc + 8;           // 144-byte rows: conflict-free ldmatrix

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct MmaCtx {
  bf16* H;                // [kMmaRows][h_ld] hidden activations
  bf16* E;                // [kMmaRows][e_ld] the layers' direct inputs
  bf16* Ws;               // [2][kMaxWidth][kWsLd] staged weight slices
  float* X;               // [3][kMmaRows] positions
  float* O;               // [kMaxHeadOut][kMmaRows] NoF head outputs
  int h_ld, e_ld;
  int tid, lane, warp_m, warp_n;
  int64_t row0, total;
  int64_t ray[2];         // ray of rows warp_m*16 + lane/4 + {0, 8}
  // kSigma writes sigma[g * out_rs], kRgb rgb[c * rgb_cs + g * out_rs] for
  // the tile's rows g < total
  float* sigma;
  float* rgb;
  int64_t out_rs, rgb_cs;
};

enum MmaEpilogue {
  kReluPartialFirst,  // NoF / NeRF trunk: relu((acc + partial) + b) -> H
  kReluBiasFirst,     // NeRF extra: relu((acc + b) + partial) -> H
  kLinear,            // NeRF final: acc + b -> H
  kHeadO,             // NoF head: acc + b -> O (fp32)
  kSigma,             // acc + b -> sigma
  kRgb,               // sigmoid(acc + b) -> rgb
};

// One layer for the block's 128 rows: out = A_E @ wpe + A_H @ wh (each
// operand W^T, zero-padded to [pad16(n)][pad16(K)]), then the epilogue.
__device__ void mma_layer(const MmaCtx& c, const bf16* wpe, int kp,
                          const bf16* wh, int kh, int n, const float* bias,
                          const float* partial, MmaEpilogue ep) {
  const int n_pad = pad16(n);
  const int ntw = n_pad / 16;            // 8-column tiles per column half
  const int nbase = c.warp_n * ntw * 8;  // this warp's first column
  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = 0.f;

  // The layer's weight slices in order (wpe's against E, then wh's against
  // H), double-buffered: slice ci+1 is copied in (cp.async) while the warps
  // multiply slice ci.
  const int kpe = wpe ? pad16(kp) : 0, khh = wh ? pad16(kh) : 0;
  const int n_pe = (kpe + kKc - 1) / kKc;
  const int n_slices = n_pe + (khh + kKc - 1) / kKc;
  auto stage = [&](int ci) {
    if (ci < n_slices) {
      const bool pe = ci < n_pe;
      const bf16* w = pe ? wpe : wh;
      const int K = pe ? kpe : khh;
      const int k0 = (pe ? ci : ci - n_pe) * kKc;
      const int vpr = min(kKc, K - k0) / 8;  // 16-byte vectors per row
      bf16* buf = c.Ws + (ci & 1) * kMaxWidth * kWsLd;
      for (int v = c.tid; v < n_pad * vpr; v += kMmaThreads) {
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
    const bool pe = ci < n_pe;
    const int K = pe ? kpe : khh;
    const int k0 = (pe ? ci : ci - n_pe) * kKc;
    const int kl = min(kKc, K - k0);
    const bf16* A = (pe ? c.E : c.H) + (c.warp_m * 16 + (c.lane & 15)) *
                                           (pe ? c.e_ld : c.h_ld) +
                    k0 + (c.lane >> 4) * 8;
    const bf16* B = c.Ws + (ci & 1) * kMaxWidth * kWsLd +
                    (nbase + (c.lane & 7)) * kWsLd + ((c.lane >> 3) & 1) * 8;
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
    // slice ci is consumed before stage(ci + 2) overwrites its buffer; after
    // the last slice: every warp has read H before any warp overwrites it
    __syncthreads();
  }

  const int g = c.lane >> 2, tq = c.lane & 3;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (t >= ntw) continue;
    const int col = nbase + t * 8 + tq * 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = c.warp_m * 16 + g + 8 * hh;
      const int64_t gi = c.row0 + r;
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cj = col + j;
        float z = acc[t][2 * hh + j];
        if (cj >= n) {
          v[j] = 0.f;               // padded column: exactly zero
          continue;
        }
        const float b = bias[cj];
        const float p = partial ? partial[c.ray[hh] * n + cj] : 0.f;
        if (ep == kReluPartialFirst) {
          if (partial) z = __fadd_rn(z, p);
          v[j] = fmaxf(__fadd_rn(z, b), 0.f);
        } else if (ep == kReluBiasFirst) {
          z = __fadd_rn(z, b);
          if (partial) z = __fadd_rn(z, p);
          v[j] = fmaxf(z, 0.f);
        } else {
          v[j] = __fadd_rn(z, b);
        }
      }
      if (ep == kReluPartialFirst || ep == kReluBiasFirst || ep == kLinear) {
        *reinterpret_cast<__nv_bfloat162*>(c.H + r * c.h_ld + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cj = col + j;
          if (cj >= n) continue;
          if (ep == kHeadO) {
            c.O[cj * kMmaRows + r] = v[j];
          } else if (gi < c.total) {
            if (ep == kSigma) c.sigma[gi * c.out_rs] = v[j];
            else c.rgb[cj * c.rgb_cs + gi * c.out_rs] = sigmoid(v[j]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// ===========================================================================
// fp32: FFMA
// ===========================================================================

constexpr int kWarps = 8;
constexpr int kRows = 8;                 // rows per warp
constexpr int kTile = kWarps * kRows;    // rows per block
constexpr int kLda = kTile + 4;          // K-major row stride (floats)

// 8 consecutive rows of one feature (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&a)[kRows]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 v = *reinterpret_cast<const float4*>(p + 4);
  a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
  a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
}

// acc[i][j] += sum_k A[k][r0 + i] * W[k][lane + 32 j]
template <int NJ>
__device__ __forceinline__ void mm_acc(float (&acc)[kRows][NJ], const float* A,
                                       int K, const float* __restrict__ W,
                                       int N, int lane) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[kRows];
    load8(A + k * kLda, av);
    const float* wr = W + static_cast<int64_t>(k) * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      const float w = c < N ? __ldg(wr + c) : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(av[i], w, acc[i][j]);
    }
  }
}

enum Epilogue { kPartialFirst, kBiasFirst, kNoRelu };

// One hidden layer for a warp's 8 rows, in place on H:
// H[:N] = epilogue(E @ wpe + H[:K] @ wh)
template <int NJ>
__device__ void layer_nj(float* H, const float* E, int kp, const float* wpe,
                         const float* wh, int k_in, const float* b,
                         const float* partial, int N, const int64_t* ray,
                         Epilogue ep, int lane) {
  float acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  if (wpe) mm_acc<NJ>(acc, E, kp, wpe, N, lane);
  if (wh) mm_acc<NJ>(acc, H, k_in, wh, N, lane);
  __syncwarp();  // every lane has read H before any lane overwrites it
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    if (c >= N) continue;
    const float bias = b[c];
    float v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float z = acc[i][j];
      if (ep == kPartialFirst) {            // NoF: (dot + partial) + b
        if (partial) z = __fadd_rn(z, partial[ray[i] * N + c]);
        z = fmaxf(__fadd_rn(z, bias), 0.f);
      } else if (ep == kBiasFirst) {        // NeRF extra: (dot + b) + p
        z = __fadd_rn(z, bias);
        if (partial) z = __fadd_rn(z, partial[ray[i] * N + c]);
        z = fmaxf(z, 0.f);
      } else {                              // NeRF final: dot + b
        z = __fadd_rn(z, bias);
      }
      v[i] = z;
    }
    *reinterpret_cast<float4*>(H + c * kLda) =
        make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(H + c * kLda + 4) =
        make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncwarp();
}

__device__ void layer(float* H, const float* E, int kp, const void* wpe,
                      const void* wh, int k_in, const float* b,
                      const float* partial, int N, const int64_t* ray,
                      Epilogue ep, int lane) {
  const float* pe = static_cast<const float*>(wpe);
  const float* hw = static_cast<const float*>(wh);
  switch ((N + 31) / 32) {
#define MOCO_LAYER_CASE(nj)                                                  \
  case nj:                                                                   \
    layer_nj<nj>(H, E, kp, pe, hw, k_in, b, partial, N, ray, ep, lane);      \
    break;
    MOCO_LAYER_CASE(1) MOCO_LAYER_CASE(2) MOCO_LAYER_CASE(3)
    MOCO_LAYER_CASE(4) MOCO_LAYER_CASE(5) MOCO_LAYER_CASE(6)
    MOCO_LAYER_CASE(7) MOCO_LAYER_CASE(8)
#undef MOCO_LAYER_CASE
  }
}

// Head with at most 32 outputs: lane c < N gets column c of its 8 rows.
__device__ __forceinline__ void head(float (&out)[kRows], const float* H,
                                     int K, const void* w, int N, int lane) {
  float acc[kRows][1];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i][0] = 0.f;
  mm_acc<1>(acc, H, K, static_cast<const float*>(w), N, lane);
#pragma unroll
  for (int i = 0; i < kRows; ++i) out[i] = acc[i][0];
}

template <typename Kernel, typename... KArgs>
int launch(Kernel kernel, size_t smem, unsigned blocks, unsigned threads,
           cudaStream_t stream, KArgs... args) {
  if (smem > kMaxSmem) return -3;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
