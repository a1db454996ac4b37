// The long-K weight-gradient products and the ordered sums of wgrad.cuh
// (kernels #2, #4 and #6), for Hopper (sm_90a). Both products are one
// template, matrix_mma_kernel<T>: bf16 on mma.sync m16n8k16, fp32 on
// warpgroup wgmma with the split-TF32 terms of the row-tile passes
// (row_tile.cuh::mma_split; tf32_split rounds the parts).
//
// What bounds them on this card: compute for the products (K = every row
// of the call: 10^5 and more, against outputs of at most 256 x 256, so each
// operand element read from device memory feeds 64-128 multiply-adds), the
// bytes of the scratch for the sums.

#include "row_tile.cuh"
#include "wgrad.cuh"

namespace {

using wg::Call;
using wg::Job;

// bf16 tiles: 128 (m) x 128 (n), 8 warps as 2 x 4 of 64 x 32
constexpr int kBM = 128, kBN = 128, kKC = 64;
constexpr int kALd = kBM + 8, kDLd = kBN + 8;  // conflict-free ldmatrix rows
constexpr int kWThreads = 256;
// fp32 (split TF32): 128 x 128 tiles, two warpgroups, 32-row K chunks;
// two buffers of four hi / lo TF32 planes (A hi, A lo, D hi, D lo: 128 rows
// of 128 bytes): 132,096 bytes with the alignment.
constexpr int kSBM = 128, kSBN = 128, kSKc = 32;
constexpr int kSPlane = 128 * 128;                // bytes: one plane
constexpr int kSPlanes = 4 * kSPlane;
constexpr size_t kSSmem = 2 * kSPlanes + 1024;

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// the job, output tile and split of this block; false past the last job
__device__ bool pick(const Call& c, int bm, int bn, int* ji, int* mt,
                     int* nt, int64_t* sp) {
  const int64_t nsplit = cdiv(c.rows, c.split_rows);
  int64_t b = blockIdx.x;
  for (int j = 0; j < c.n_jobs; ++j) {
    const int tm = static_cast<int>(cdiv(c.job[j].m, bm));
    const int tn = static_cast<int>(cdiv(c.job[j].n, bn));
    const int64_t nb = tm * tn * nsplit;
    if (b < nb) {
      *ji = j;
      *sp = b / (tm * tn);
      *mt = static_cast<int>((b % (tm * tn)) / tn);
      *nt = static_cast<int>(b % tn);
      return true;
    }
    b -= nb;
  }
  return false;
}

// the bf16 product: mma.sync m16n8k16 on ldmatrix.trans fragments
__device__ __forceinline__ void matrix_bf16(const Call& c) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);        // [2][kKC][kALd]
  bf16* Ds = As + 2 * kKC * kALd;                   // [2][kKC][kDLd]
  int ji, mt, nt;
  int64_t sp;
  if (!pick(c, kBM, kBN, &ji, &mt, &nt, &sp)) return;
  const Job& j = c.job[ji];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int64_t r_begin = sp * c.split_rows;
  const int64_t r_end = min(r_begin + c.split_rows, c.rows);
  const int nk = static_cast<int>((r_end - r_begin) / kKC);
  const int n_it = j.n_pieces * nk;
  // columns past lda / ldd are never copied: zero them once
  for (int i = tid; i < 2 * kKC * (kALd + kDLd); i += kWThreads)
    As[i] = __float2bfloat16_rn(0.f);
  __syncthreads();
  auto stage = [&](int it) {
    if (it < n_it) {
      const int p = it / nk;
      const int64_t row = r_begin + static_cast<int64_t>(it % nk) * kKC;
      const bf16* a = static_cast<const bf16*>(j.a[p]);
      const bf16* d = static_cast<const bf16*>(j.d[p]);
      bf16* as = As + (it & 1) * kKC * kALd;
      bf16* ds = Ds + (it & 1) * kKC * kDLd;
      for (int v = tid; v < kKC * (kBM / 8); v += kWThreads) {
        const int r = v / (kBM / 8), q = (v % (kBM / 8)) * 8;
        if (m0 + q < j.lda)
          cp16(as + r * kALd + q, a + (row + r) * j.lda + m0 + q);
      }
      for (int v = tid; v < kKC * (kBN / 8); v += kWThreads) {
        const int r = v / (kBN / 8), q = (v % (kBN / 8)) * 8;
        if (n0 + q < j.ldd)
          cp16(ds + r * kDLd + q, d + (row + r) * j.ldd + n0 + q);
      }
    }
    cp_async_commit();
  };
  const int wm = warp & 1, wn = warp >> 1;
  const bool active = n0 + wn * 32 < j.n && m0 + wm * 64 < j.m;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][t][q] = 0.f;
  // ldmatrix.trans addresses: matrix lane/8 of the four 8 x 8 blocks
  const int mi = lane >> 3, mr = lane & 7;
  const int a_k = (mi >> 1) * 8 + mr, a_m = wm * 64 + (mi & 1) * 8;
  const int d_k = (mi & 1) * 8 + mr, d_n = wn * 32 + (mi >> 1) * 8;
  stage(0);
  for (int it = 0; it < n_it; ++it) {
    stage(it + 1);
    cp_async_wait_all_but_one();
    __syncthreads();
    if (active) {
      const bf16* as = As + (it & 1) * kKC * kALd;
      const bf16* ds = Ds + (it & 1) * kKC * kDLd;
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 16) {
        unsigned af[4][4], bq[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ldsm_x4_t(af[i], as + (ks + a_k) * kALd + a_m + i * 16);
#pragma unroll
        for (int pi = 0; pi < 2; ++pi)
          ldsm_x4_t(bq[pi], ds + (ks + d_k) * kDLd + d_n + pi * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const unsigned b[2] = {bq[t >> 1][(t & 1) * 2],
                                   bq[t >> 1][(t & 1) * 2 + 1]};
            mma_bf16(acc[i][t], af[i], b);
          }
      }
    }
    __syncthreads();
  }
  float* out = c.part + (c.split0 + sp) * c.total + j.out;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 64 + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * 32 + t * 8 + q2 + (e & 1);
        if (m < j.m && n < j.n)
          out[static_cast<int64_t>(m) * j.n + n] = acc[i][t][e];
      }
}

// warpgroup products (wg_tile.cuh has the same for its bf16 tiles; its
// namespace wg clashes with wgrad.cuh's, so it is not included here)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kN> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kN) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads of the accumulators above the wait
template <int kR> __device__ __forceinline__ void fence_acc(float (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// descriptor of a 128-byte-swizzled K-major operand at shared address addr
// (8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t desc_at(unsigned addr) {
  return ((static_cast<uint64_t>(addr) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// wgmma.mma_async m64nNk8, tf32 A and B from shared memory (descriptors),
// fp32 accumulators d; scale_d 0 overwrites d, 1 accumulates. Thread t of
// the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8 for d[4j + 2],
// d[4j + 3]) and columns 8j + 2 (t % 4) (+ 1 for the odd entries).
template <int kN> struct TfMma;

template <> struct TfMma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct TfMma<16> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
        "}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// A plane holds 128 rows (of A^T or D^T) of 32 k in tf32, K-major: 128
// bytes a row, 16-byte chunk q of row r at chunk q ^ (r % 8) (wgmma's
// 128-byte swizzle, as wg_tile.cuh lays out bf16); a k-step of 8 is 32
// bytes into the row.

// x[i] (k = 4c + i of one plane row) -> the row's 16-byte chunk c: hi at
// dst, lo a plane further
__device__ __forceinline__ void split_chunk(const float (&x)[4],
                                            unsigned char* dst) {
  uint4 hi, lo;
  tf32_split(x[0], hi.x, lo.x);
  tf32_split(x[1], hi.y, lo.y);
  tf32_split(x[2], hi.z, lo.z);
  tf32_split(x[3], hi.w, lo.w);
  *reinterpret_cast<uint4*>(dst) = hi;
  *reinterpret_cast<uint4*>(dst + kSPlane) = lo;
}

// The fp32 product in split TF32 on a 128 x 128 tile: two warpgroups,
// each 64 rows of the output by N columns (N = 16 for a job of at most 16
// columns, else 128), on wgmma. The block loads a chunk of 32 rows of A and
// D into registers, one chunk ahead, and splits each element once into hi
// and lo TF32 planes of A^T and D^T (K-major, as wgmma reads both
// operands). A k-step of 8 rows is three wgmmas into a register sum from
// zero, s = A_hi D_lo + A_lo D_hi + A_hi D_hi (row_tile.cuh::mma_split's
// terms, in its order), then acc += s rounding to nearest. The next chunk
// is split into the other planes while the chunk's last products run; one
// barrier a chunk.
//
// Measured on an H100 at the cells' shapes (PERF.md section 6): the same
// contract on mma.sync m16n8k8 (row_tile.cuh's fragments, tiles 64 x 64 to
// 128 x 128, split at each fragment load or once into planes) ran at 30-35
// TFLOP/s, as fast as the FFMA loop it replaced, bound by the instructions
// around its products; on wgmma with the chunks staged by cp.async through
// shared memory, 50-53, bound by shared memory; staged in registers, 55-59
// (two warpgroups of 64 x 128 or four of 64 x 64 alike).
template <int N>
__device__ __forceinline__ void matrix_wg(const Call& c, const Job& j, int m0,
                                          int n0, int64_t sp,
                                          unsigned char* base) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = tid >> 7;  // warpgroup: rows 64 wm.. of the tile
  const bool active = m0 + 64 * wm < j.m;
  const int64_t r_begin = sp * c.split_rows;
  const int64_t r_end = min(r_begin + c.split_rows, c.rows);
  const int nk = static_cast<int>((r_end - r_begin) / kSKc);
  const int n_it = j.n_pieces * nk;
  // This thread's part of a chunk: k = 4 warp + i (i < 4) of tile rows r =
  // 32 jj + lane (jj < 4) of A^T and of D^T (of D only r < N): a warp reads
  // 128 bytes of a row of A or D at a time, and writes one 16-byte chunk
  // (warp ^ lane) % 8 of each of 8 consecutive plane rows a quarter-warp,
  // so no bank conflict.
  const int rk = 4 * warp;
  const int s_dst = lane * 128 + (((warp ^ lane) & 7) << 4);
  float xa[4][4], xd[4][4];
  int ld_p = 0, ld_k = 0;  // piece and chunk of the next load
  auto load = [&](int it) {  // registers <- chunk it (0 past lda / ldd)
    if (it >= n_it) return;
    const int64_t row = r_begin + static_cast<int64_t>(ld_k) * kSKc + rk;
    const float* a = static_cast<const float*>(j.a[ld_p]) + row * j.lda +
                     m0 + lane;
    const float* d = static_cast<const float*>(j.d[ld_p]) + row * j.ldd +
                     n0 + lane;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xa[jj][i] = m0 + lane + 32 * jj < j.lda ? a[i * j.lda + 32 * jj]
                                                : 0.f;
        xd[jj][i] = lane + 32 * jj < N && n0 + lane + 32 * jj < j.ldd
                        ? d[i * j.ldd + 32 * jj] : 0.f;
      }
    if (++ld_k == nk) {
      ld_k = 0;
      ++ld_p;
    }
  };
  auto split = [&](int it) {  // the registers -> chunk it's planes
    unsigned char* pl = base + (it & 1) * kSPlanes + s_dst;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      split_chunk(xa[jj], pl + 4096 * jj);
      if (lane + 32 * jj < N)
        split_chunk(xd[jj], pl + 2 * kSPlane + 4096 * jj);
    }
  };
  float acc[N / 2], s[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = s[i] = 0.f;
  // k-step q of the chunk in planes `pl`: its three products into s from
  // zero (kstep), then acc += s (add)
  auto kstep = [&](const unsigned char* pl, int q) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(pl)) +
                       64 * wm * 128 + 32 * q;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(pl)) +
                       2 * kSPlane + 32 * q;
    wgmma_fence();
    TfMma<N>::run(s, desc_at(a), desc_at(d + kSPlane), 0);
    TfMma<N>::run(s, desc_at(a + kSPlane), desc_at(d), 1);
    TfMma<N>::run(s, desc_at(a), desc_at(d), 1);
    wgmma_commit();
  };
  auto add = [&]() {
    wgmma_wait<0>();
    fence_acc(s);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = __fadd_rn(acc[i], s[i]);
  };
  load(0);
  if (n_it > 0) split(0);
  fence_async_smem();
  __syncthreads();
  load(1);
  for (int it = 0; it < n_it; ++it) {
    const unsigned char* pl = base + (it & 1) * kSPlanes;
    static_assert(kSKc == 32, "four k-steps a chunk");
    if (active)
      for (int q = 0; q < 3; ++q) {
        kstep(pl, q);
        add();
      }
    if (active) kstep(pl, 3);
    if (it + 1 < n_it) split(it + 1);    // the other planes, meanwhile
    fence_async_smem();
    load(it + 2);
    if (active) add();
    __syncthreads();                     // chunk it + 1 split, chunk it read
  }
  if (!active) return;
  float* out = c.part + (c.split0 + sp) * c.total + j.out;
  const int row = m0 + 64 * wm + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = row + (e >> 1) * 8;
      const int n = n0 + 8 * jj + 2 * (lane & 3) + (e & 1);
      if (m < j.m && n < j.n)
        out[static_cast<int64_t>(m) * j.n + n] = acc[4 * jj + e];
    }
}

__device__ __forceinline__ void matrix_split(const Call& c) {
  extern __shared__ __align__(16) unsigned char smem[];
  // planes at a 1024-byte boundary (the swizzle's 8-row groups)
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(
                                                       1023));
  int ji, mt, nt;
  int64_t sp;
  if (!pick(c, kSBM, kSBN, &ji, &mt, &nt, &sp)) return;
  const Job& j = c.job[ji];
  if (j.n - nt * kSBN <= 16)
    matrix_wg<16>(c, j, mt * kSBM, nt * kSBN, sp, base);
  else
    matrix_wg<128>(c, j, mt * kSBM, nt * kSBN, sp, base);
}

// dW = A^T D on the tensor cores, one template for both storage types, so
// one name in a trace
template <typename T>
__global__ void __launch_bounds__(kWThreads) matrix_mma_kernel(const Call c) {
  if constexpr (sizeof(T) == 2)
    matrix_bf16(c);
  else
    matrix_split(c);
}

__device__ __forceinline__ float load_el(const void* p, int64_t i, bool f32) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// One block per (job, split, column block): warp w sums its columns over
// the w-th of kCsWarps equal row ranges of the split, in row order, and the
// warps' sums are added in warp order. Where the columns allow, a lane
// reads 16 bytes of a row (8 bf16 or 4 fp32 columns), so a warp reads whole
// rows; otherwise one column a lane. Rows go kCsUnroll at a time, their
// loads issued together.
constexpr int kCsWarps = 16;
constexpr int kCsUnroll = 8;

__host__ __device__ inline int cs_vec(const Job& j, int bf16) {
  const int v = j.d_f32 || !bf16 ? 4 : 8;
  return j.n % v == 0 && j.ldd % v == 0 ? v : 1;
}

// v <- the V elements of D from flat index i (F32: fp32, else bf16)
template <int V, bool F32>
__device__ __forceinline__ void load_vec(const void* d, int64_t i,
                                         float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = load_el(d, i, F32);
  } else if constexpr (F32) {
    const float4 q = *reinterpret_cast<const float4*>(
        static_cast<const float*>(d) + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(d) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < V / 2; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
}

// s[e] = the sum over rows [w0, w1) of column col0 + e, in row order
template <int V, bool F32>
__device__ void colsum_rows(const Job& j, int col0, int64_t w0, int64_t w1,
                            float (&s)[V]) {
  if (j.split) {                 // hi + mid + lo: the fp32 value, exactly
    constexpr int kU = kCsUnroll / 2;
    for (int64_t r = w0; r < w1; r += kU) {
      const int nr = static_cast<int>(min(static_cast<int64_t>(kU), w1 - r));
      float v[kU][V], u[kU][V];
#pragma unroll
      for (int k = 0; k < kU; ++k)
        if (k < nr) load_vec<V, F32>(j.d[0], (r + k) * j.ldd + col0, v[k]);
      for (int p = 1; p < j.n_pieces; ++p) {
#pragma unroll
        for (int k = 0; k < kU; ++k)
          if (k < nr) load_vec<V, F32>(j.d[p], (r + k) * j.ldd + col0, u[k]);
#pragma unroll
        for (int k = 0; k < kU; ++k)
#pragma unroll
          for (int e = 0; e < V; ++e) v[k][e] = __fadd_rn(v[k][e], u[k][e]);
      }
#pragma unroll
      for (int k = 0; k < kU; ++k)
        if (k < nr)
#pragma unroll
          for (int e = 0; e < V; ++e) s[e] = __fadd_rn(s[e], v[k][e]);
    }
    return;
  }
  for (int p = 0; p < j.n_pieces; ++p) {
    int64_t r = w0;
    for (; r + kCsUnroll <= w1; r += kCsUnroll) {
      float v[kCsUnroll][V];
#pragma unroll
      for (int k = 0; k < kCsUnroll; ++k)
        load_vec<V, F32>(j.d[p], (r + k) * j.ldd + col0, v[k]);
#pragma unroll
      for (int k = 0; k < kCsUnroll; ++k) {
        const float w = j.w ? j.w[r + k] : 1.f;
#pragma unroll
        for (int e = 0; e < V; ++e)
          s[e] = __fadd_rn(s[e], j.w ? __fmul_rn(w, v[k][e]) : v[k][e]);
      }
    }
    for (; r < w1; ++r) {
      float v[V];
      load_vec<V, F32>(j.d[p], r * j.ldd + col0, v);
      const float w = j.w ? j.w[r] : 1.f;
#pragma unroll
      for (int e = 0; e < V; ++e)
        s[e] = __fadd_rn(s[e], j.w ? __fmul_rn(w, v[e]) : v[e]);
    }
  }
}

template <int V, bool F32>
__device__ void colsum_block(const Call& c, const Job& j, int64_t sp,
                             int cb, float (*ws)[256]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = cb * 32 * V + lane * V;
  const int64_t len = c.split_rows / kCsWarps;
  const int64_t w0 = sp * c.split_rows + warp * len;
  const int64_t w1 = min(w0 + len, c.real_rows);
  float s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0.f;
  if (col0 < j.n) colsum_rows<V, F32>(j, col0, w0, w1, s);
#pragma unroll
  for (int e = 0; e < V; ++e) ws[warp][lane * V + e] = s[e];
  __syncthreads();
  for (int k = threadIdx.x; k < 32 * V; k += blockDim.x) {
    const int col = cb * 32 * V + k;
    if (col >= j.n) continue;
    float t = ws[0][k];
    for (int w = 1; w < kCsWarps; ++w) t = __fadd_rn(t, ws[w][k]);
    c.part[(c.split0 + sp) * c.total + j.out + col] = t;
  }
}

__global__ void __launch_bounds__(kCsWarps * 32) colsum_kernel(const Call c) {
  __shared__ float ws[kCsWarps][256];
  const int64_t nsplit = cdiv(c.rows, c.split_rows);
  int64_t b = blockIdx.x;
  int ji = 0;
  for (; ji < c.n_jobs; ++ji) {
    const int64_t nb = cdiv(c.job[ji].n, 32 * cs_vec(c.job[ji], c.bf16)) *
                       nsplit;
    if (b < nb) break;
    b -= nb;
  }
  if (ji >= c.n_jobs) return;
  const Job& j = c.job[ji];
  const int V = cs_vec(j, c.bf16);
  const int64_t nb_split = cdiv(j.n, 32 * V);
  const int64_t sp = b / nb_split;
  const int cb = static_cast<int>(b % nb_split);
  const bool f32 = j.d_f32 || !c.bf16;
  if (V == 8) colsum_block<8, false>(c, j, sp, cb, ws);
  else if (V == 4) colsum_block<4, true>(c, j, sp, cb, ws);
  else if (f32) colsum_block<1, true>(c, j, sp, cb, ws);
  else colsum_block<1, false>(c, j, sp, cb, ws);
}

__global__ void __launch_bounds__(128) segsum_kernel(const wg::SegCall c) {
  const wg::SegJob& j = c.job[blockIdx.y];
  const int64_t ray = blockIdx.x;
  for (int col = threadIdx.x; col < j.n; col += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < j.n_pieces; ++p) {
      float ps = 0.f;
      for (int64_t i = 0; i < c.s; ++i)
        ps = __fadd_rn(ps, load_el(j.d[p], (ray * c.s + i) * j.ld + col,
                                   !c.bf16));
      s = p ? __fadd_rn(s, ps) : ps;
    }
    j.out[ray * j.n + col] = s;
  }
}

__global__ void reduce_kernel(const float* part, int nsplit, int64_t total,
                              float* out) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s = __fadd_rn(s, part[k * total + i]);
    out[i] = s;
  }
}

int64_t count_blocks(const Call& c, int bm, int bn) {
  const int64_t nsplit = cdiv(c.rows, c.split_rows);
  int64_t n = 0;
  for (int j = 0; j < c.n_jobs; ++j)
    n += cdiv(c.job[j].m, bm) * cdiv(c.job[j].n, bn) * nsplit;
  return n;
}

// A block's work: its rows (pieces) times the warpgroups that multiply (a
// job of at most 64 rows leaves one idle) times the columns each takes
int job_weight(const Job& j) {
  return j.n_pieces * (j.m > 64 ? 2 : 1) * (j.n > 16 ? 128 : 16);
}

// The jobs heaviest first (each writes its own outputs, so their order
// changes no bit): the longest blocks start in the first wave, and the
// light ones fill in behind them.
int matrix_f32_launch(const Call& c, cudaStream_t s) {
  Call t = c;
  for (int i = 1; i < t.n_jobs; ++i)
    for (int k = i; k > 0 && job_weight(t.job[k]) > job_weight(t.job[k - 1]);
         --k) {
      const Job tmp = t.job[k];
      t.job[k] = t.job[k - 1];
      t.job[k - 1] = tmp;
    }
  return launch(matrix_mma_kernel<float>, kSSmem,
                static_cast<unsigned>(count_blocks(t, kSBM, kSBN)), kWThreads,
                s, t);
}

}  // namespace

namespace wg {

int matrix_launch(const Call& c, cudaStream_t s) {
  if (c.n_jobs <= 0 || c.rows <= 0) return 0;
  if (c.n_jobs > kMaxJobs || c.rows % 128 || c.split_rows % 128) return -4;
  for (int j = 0; j < c.n_jobs; ++j)
    if (c.job[j].n_pieces > kMaxPieces) return -4;
  if (c.bf16) {
    const size_t smem = 2 * kKC * (kALd + kDLd) * sizeof(bf16);
    return launch(matrix_mma_kernel<bf16>, smem,
                  static_cast<unsigned>(count_blocks(c, kBM, kBN)),
                  kWThreads, s, c);
  }
  return matrix_f32_launch(c, s);
}

int colsum_launch(const Call& c, cudaStream_t s) {
  if (c.n_jobs <= 0 || c.rows <= 0) return 0;
  if (c.n_jobs > kMaxJobs) return -4;
  if (c.split_rows % kCsWarps) return -4;
  const int64_t nsplit = cdiv(c.rows, c.split_rows);
  int64_t blocks = 0;
  for (int j = 0; j < c.n_jobs; ++j)
    blocks += cdiv(c.job[j].n, 32 * cs_vec(c.job[j], c.bf16)) * nsplit;
  colsum_kernel<<<static_cast<unsigned>(blocks), kCsWarps * 32, 0, s>>>(c);
  return static_cast<int>(cudaGetLastError());
}

int segsum_launch(const SegCall& c, cudaStream_t s) {
  if (c.n_jobs <= 0 || c.n_rays <= 0) return 0;
  if (c.n_jobs > kMaxSegJobs) return -4;
  segsum_kernel<<<dim3(static_cast<unsigned>(c.n_rays), c.n_jobs), 128, 0,
                  s>>>(c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// out[i] = sum over the nsplit rows of part (splits, total), in order
extern "C" int wgrad_reduce(const float* part, int nsplit, int64_t total,
                            float* out, void* stream) {
  if (total <= 0) return 0;
  const int64_t b = cdiv(total, 256);
  reduce_kernel<<<static_cast<unsigned>(b < 4096 ? b : 4096), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(part, nsplit, total,
                                                        out);
  return static_cast<int>(cudaGetLastError());
}
