// The long-K weight-gradient products and the ordered sums of wgrad.cuh
// (kernels #2 and #6), for Hopper (sm_90a).
//
// What bounds them on this card: compute for the products (K = every row
// of the call: 10^5 and more, against outputs of at most 256 x 256, so each
// operand element read from device memory feeds 64-128 multiply-adds), the
// bytes of the scratch for the sums.

#include "pass_tile.cuh"
#include "wgrad.cuh"

namespace {

using wg::Call;
using wg::Job;

// tensor-core tiles: 128 (m) x 128 (n), 8 warps as 2 x 4 of 64 x 32
constexpr int kBM = 128, kBN = 128, kKC = 64;
constexpr int kALd = kBM + 8, kDLd = kBN + 8;  // conflict-free ldmatrix rows
constexpr int kWThreads = 256;
// FFMA tiles: 64 x 64, a thread 4 x 4, 32-row K chunks
constexpr int kFM = 64, kFN = 64, kFKC = 32, kFLd = 64 + 4;

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

__global__ void __launch_bounds__(kWThreads) matrix_mma_kernel(const Call c) {
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

__global__ void __launch_bounds__(kWThreads) matrix_ffma_kernel(const Call c) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);      // [2][kFKC][kFLd]
  float* Ds = As + 2 * kFKC * kFLd;                 // [2][kFKC][kFLd]
  int ji, mt, nt;
  int64_t sp;
  if (!pick(c, kFM, kFN, &ji, &mt, &nt, &sp)) return;
  const Job& j = c.job[ji];
  const int tid = threadIdx.x;
  const int m0 = mt * kFM, n0 = nt * kFN;
  const int64_t r_begin = sp * c.split_rows;
  const int64_t r_end = min(r_begin + c.split_rows, c.rows);
  const int nk = static_cast<int>((r_end - r_begin) / kFKC);
  const int n_it = j.n_pieces * nk;
  for (int i = tid; i < 4 * kFKC * kFLd; i += kWThreads) As[i] = 0.f;
  __syncthreads();
  auto stage = [&](int it) {
    if (it < n_it) {
      const int p = it / nk;
      const int64_t row = r_begin + static_cast<int64_t>(it % nk) * kFKC;
      const float* a = static_cast<const float*>(j.a[p]);
      const float* d = static_cast<const float*>(j.d[p]);
      float* as = As + (it & 1) * kFKC * kFLd;
      float* ds = Ds + (it & 1) * kFKC * kFLd;
      for (int v = tid; v < kFKC * 16; v += kWThreads) {
        const int r = v / 16, q = (v % 16) * 4;
        if (m0 + q < j.lda)
          cp16(as + r * kFLd + q, a + (row + r) * j.lda + m0 + q);
        if (n0 + q < j.ldd)
          cp16(ds + r * kFLd + q, d + (row + r) * j.ldd + n0 + q);
      }
    }
    cp_async_commit();
  };
  const int tm = (tid >> 4) * 4, tn = (tid & 15) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  stage(0);
  for (int it = 0; it < n_it; ++it) {
    stage(it + 1);
    cp_async_wait_all_but_one();
    __syncthreads();
    const float* as = As + (it & 1) * kFKC * kFLd;
    const float* ds = Ds + (it & 1) * kFKC * kFLd;
#pragma unroll 8
    for (int k = 0; k < kFKC; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(as + k * kFLd + tm);
      const float4 d = *reinterpret_cast<const float4*>(ds + k * kFLd + tn);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(av[i], dv[e], acc[i][e]);
    }
    __syncthreads();
  }
  float* out = c.part + (c.split0 + sp) * c.total + j.out;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + tm + i, n = n0 + tn + e;
      if (m < j.m && n < j.n) out[static_cast<int64_t>(m) * j.n + n] = acc[i][e];
    }
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

}  // namespace

namespace wg {

int matrix_launch(const Call& c, cudaStream_t s) {
  if (c.n_jobs <= 0 || c.rows <= 0) return 0;
  if (c.n_jobs > kMaxJobs || c.rows % 128 || c.split_rows % 128) return -4;
  for (int j = 0; j < c.n_jobs; ++j)
    if (c.job[j].n_pieces > kMaxPieces) return -4;
  if (c.bf16) {
    const size_t smem = 2 * kKC * (kALd + kDLd) * sizeof(bf16);
    return launch(matrix_mma_kernel, smem,
                  static_cast<unsigned>(count_blocks(c, kBM, kBN)),
                  kWThreads, s, c);
  }
  const size_t smem = 4 * kFKC * kFLd * sizeof(float);
  return launch(matrix_ffma_kernel, smem,
                static_cast<unsigned>(count_blocks(c, kFM, kFN)), kWThreads,
                s, c);
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
