// Shared helpers of the row-tile kernels: the limits of a tile (widths,
// shared memory), pad16, the NoF head's warp on one sample
// (nof_head_apply), sigmoid, the launcher, and the bf16 tensor-core
// wrappers (ldmatrix, cp.async of 16 bytes, mma.sync m16n8k16) that
// row_tile.cuh's bf16 product and wgrad.cu's dW products are built from.
// row_tile.cuh, wg_tile.cuh and wgrad.cu include it.
//
// Elementwise steps use explicitly rounded intrinsics (__fmul_rn,
// __fadd_rn) so nvcc cannot fuse them into FMAs.

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
// bf16 tensor-core wrappers
// ===========================================================================

// row_tile.cuh's bf16 product: k per staged weight slice, and its row
// stride (144-byte rows: conflict-free ldmatrix)
constexpr int kKc = 64;
constexpr int kWsLd = kKc + 8;

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
