// Block-wide building blocks of the NoF kernels (nof_rays.cu, through
// nof_tile.cuh): a tile of R sample rows is carried through an MLP
// with every activation in shared memory, forward and backward.
//
// Storage type T is float (fp32 build) or bf16 (bf16 build). Activations,
// the packed PE embedding and the ReLU-masked cotangents dz are stored in T;
// weights arrive in T from the wrapper; every product multiplies the stored
// values in fp32 and accumulates in fp32 (a product of two bf16 values is
// exact in fp32), so the bf16 build rounds exactly where the JAX tiles
// (_nerf_tile, _nof_tile, _nerf_bwd_tile, _nof_bwd_tile) round. Elementwise
// steps use explicitly rounded intrinsics (__fadd_rn, __fmul_rn) so nvcc
// cannot contract them into FMAs, and sin/cos are full precision: a 1-ulp
// change of a warped position grows 512-fold through the top NeRF PE band.
//
// Products (gemm below) whose operands are both bf16 run on tensor cores:
// mma.sync m16n8k16, a warp per 16 x 32 tile of the result, fragments
// loaded element by element through the same accessors. Every other
// product (the fp32 build, and the bf16 build's products with an fp32
// operand) is an FFMA loop: each thread owns a TM x TN tile of the result,
// the column index runs fastest across threads, so a warp reads one A
// element by broadcast and TN consecutive B elements per thread. Three
// shapes occur: activations @ W (forward), dz @ W^T (input gradients;
// the wrapper passes W^T row-major), and H^T @ dz summed over the tile's
// rows (weight gradients). Weight gradients of a tile are added into the
// block's own fp32 partial sums in device memory (`part`, one row of
// `total` floats per block of a persistent grid); sum_rows then adds the
// blocks' rows in a fixed order, so the result does not depend on timing.
// Per-ray sums (the gradients of the per-ray partials) go through `seg`: a
// tile writes the sum of each ray's rows it holds into the slot of that
// (ray, tile), and sum_segs adds a ray's slots in order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

constexpr int kThreads = 256;
constexpr int kMaxDepth = 8;
constexpr int kMaxWidth = 256;
constexpr int kMaxOut = 9;               // NoF head outputs (9 or 3)
constexpr int kMaxSmem = 232448;         // 227 KB a block can opt into
constexpr int kTN = 8;                   // result columns per thread

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ldv(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ldv(const bf16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void stv(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void stv(bf16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// element (r, c) of a row-major matrix with row stride ld
template <typename T> struct Rows {
  const T* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return ldv(p, static_cast<int64_t>(r) * ld + c);
  }
};
// element (r, c) = p[c * ld + r]: the transpose of a row-major matrix
template <typename T> struct Cols {
  const T* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return ldv(p, static_cast<int64_t>(c) * ld + r);
  }
};
struct Zero {
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};

// Accessors whose values are bf16: products of two of them run on tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 accumulate), exactly as the FFMA
// loop would multiply them, summed in another order.
template <class X> struct IsBf16 { static constexpr bool value = false; };
template <> struct IsBf16<Rows<bf16>> { static constexpr bool value = true; };
template <> struct IsBf16<Cols<bf16>> { static constexpr bool value = true; };
template <> struct IsBf16<Zero> { static constexpr bool value = true; };

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // exact: bf16 in
  return *reinterpret_cast<const unsigned*>(&v);
}

constexpr int kMmaN = 4;                 // 8-column tiles per warp task

// acc[j] += A(m0.., k) B(k, n0 + 8j..) over k < K, as m16n8k16 fragments
// (PTX ISA "Matrix Fragments for mma.m16n8k16"): lane l holds A rows
// m0 + l/4 (+8), columns 2(l%4) (+1, +8, +9), B columns n0 + 8j + l/4.
template <class A, class B>
__device__ __forceinline__ void mma_k(int M, int N, int K, A a, B b, int m0,
                                      int n0, float (&acc)[kMmaN][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = (lane & 3) * 2;
  auto av = [&](int m, int k) { return m < M && k < K ? a(m, k) : 0.f; };
  auto bv = [&](int k, int n) { return k < K && n < N ? b(k, n) : 0.f; };
  for (int k0 = 0; k0 < K; k0 += 16) {
    const unsigned af[4] = {
        pack_bf16(av(m0 + g, k0 + q), av(m0 + g, k0 + q + 1)),
        pack_bf16(av(m0 + g + 8, k0 + q), av(m0 + g + 8, k0 + q + 1)),
        pack_bf16(av(m0 + g, k0 + q + 8), av(m0 + g, k0 + q + 9)),
        pack_bf16(av(m0 + g + 8, k0 + q + 8), av(m0 + g + 8, k0 + q + 9))};
#pragma unroll
    for (int j = 0; j < kMmaN; ++j) {
      const int n = n0 + 8 * j + g;
      if (n0 + 8 * j >= N) break;
      const unsigned bf[2] = {pack_bf16(bv(k0 + q, n), bv(k0 + q + 1, n)),
                              pack_bf16(bv(k0 + q + 8, n), bv(k0 + q + 9, n))};
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(bf[0]),
            "r"(bf[1]));
    }
  }
}

// epi(m, n, sum_k<K1 A1(m,k) B1(k,n) + sum_k<K2 A2(m,k) B2(k,n)) for
// m < M, n < N, accumulated in fp32. Block-wide; no barrier inside. Both
// operands bf16: tensor cores, a warp per 16 x 32 tile of the result;
// otherwise an FFMA loop summing in k order.
template <int TM, class A1, class B1, class A2, class B2, class Epi>
__device__ __forceinline__ void gemm(int M, int N, int K1, A1 a1, B1 b1,
                                     int K2, A2 a2, B2 b2, Epi epi) {
  if constexpr (IsBf16<A1>::value && IsBf16<B1>::value &&
                IsBf16<A2>::value && IsBf16<B2>::value) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = (lane & 3) * 2;
    const int tn = (N + 8 * kMmaN - 1) / (8 * kMmaN), tm = (M + 15) / 16;
    for (int t = threadIdx.x >> 5; t < tm * tn; t += blockDim.x >> 5) {
      const int m0 = (t / tn) * 16, n0 = (t % tn) * 8 * kMmaN;
      float acc[kMmaN][4] = {};
      mma_k(M, N, K1, a1, b1, m0, n0, acc);
      mma_k(M, N, K2, a2, b2, m0, n0, acc);
#pragma unroll
      for (int j = 0; j < kMmaN; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + g + (i >> 1) * 8, n = n0 + 8 * j + q + (i & 1);
          if (m < M && n < N) epi(m, n, acc[j][i]);
        }
    }
    return;
  }
  const int tn = (N + kTN - 1) / kTN, tm = (M + TM - 1) / TM;
  for (int t = threadIdx.x; t < tm * tn; t += blockDim.x) {
    const int n0 = (t % tn) * kTN, m0 = (t / tn) * TM;
    float acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K1; ++k) {
      float av[TM], bv[kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = m0 + i < M ? a1(m0 + i, k) : 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = n0 + j < N ? b1(k, n0 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    for (int k = 0; k < K2; ++k) {
      float av[TM], bv[kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = m0 + i < M ? a2(m0 + i, k) : 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = n0 + j < N ? b2(k, n0 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (m0 + i < M && n0 + j < N) epi(m0 + i, n0 + j, acc[i][j]);
  }
}

template <int TM, class A, class B, class Epi>
__device__ __forceinline__ void gemm(int M, int N, int K, A a, B b, Epi epi) {
  gemm<TM>(M, N, K, a, b, 0, Zero(), Zero(), epi);
}

// dst[m * N + n] += (H^T @ D)[m][n] over the tile's R rows: the weight
// gradient of a layer with input H (R, M) and output cotangent D (R, N).
// dst is the block's own fp32 partial row in device memory. The add is a
// reduction performed in L2 (atomicAdd, its result unused), so the thread
// does not wait for the old value; one thread adds to a given element in
// every tile, in tile order, so the sum is the same as a load-add-store.
template <int TM, int R, class HA, class DB>
__device__ __forceinline__ void add_wgrad(float* dst, int M, int N, HA h,
                                          DB d) {
  gemm<TM>(M, N, R, h, d, [&](int m, int n, float acc) {
    atomicAdd(dst + static_cast<int64_t>(m) * N + n, acc);
  });
}

// dst[n] += sum over the tile's rows of D(r, n)
template <int R, class DB>
__device__ __forceinline__ void add_colsum(float* dst, int N, DB d) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s = __fadd_rn(s, d(r, n));
    atomicAdd(dst + n, s);                 // as in add_wgrad
  }
}

// Tile geometry: rows [row0, row0 + R) of n_rows = n_rays * s.
struct Tile {
  int64_t row0, n_rows, s, index;
  __device__ __forceinline__ bool valid(int r) const {
    return row0 + r < n_rows;
  }
  __device__ __forceinline__ int64_t ray(int r) const {
    const int64_t g = row0 + r;
    return (g < n_rows ? g : n_rows - 1) / s;
  }
};

// seg[((ray * nseg) + slot) * N + n] += sum of D(r, n) over the tile's
// valid rows of that ray, slot = tile index - the index of the ray's
// first tile (a ray spans at most nseg tiles).
template <int R, class DB>
__device__ __forceinline__ void add_segsum(float* seg, int nseg, int N,
                                           const Tile& t, DB d) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.f;
    int64_t cur = -1;
    for (int r = 0; r <= R; ++r) {
      const bool v = r < R && t.valid(r);
      const int64_t ray = v ? t.ray(r) : -2;
      if (ray != cur && cur >= 0) {
        const int64_t slot = t.index - (cur * t.s) / R;
        float* q = seg + (cur * nseg + slot) * N + n;
        *q = __fadd_rn(*q, s);
        s = 0.f;
      }
      cur = ray;
      if (v) s = __fadd_rn(s, d(r, n));
      if (!v) break;
    }
  }
}

// Packed PE of the tile's rows: E[r] = [x(3), sin(kc), cos(kc)] with column
// 3 + f*3 + j = sin(bands[f] * x_j) (frequency-major), stored in T.
template <typename T, int R>
__device__ void pe_fill(T* E, int kp, const float* X, const float* bands,
                        int kc) {
  for (int i = threadIdx.x; i < R * kc; i += blockDim.x) {
    const int r = i % R, f3j = i / R;
    float s, c;
    sincosf(__fmul_rn(bands[f3j / 3], X[r * 3 + f3j % 3]), &s, &c);
    stv(E, r * kp + 3 + f3j, s);
    stv(E, r * kp + 3 + kc + f3j, c);
  }
  for (int i = threadIdx.x; i < R * 3; i += blockDim.x)
    stv(E, (i / 3) * kp + i % 3, X[i]);
  __syncthreads();
}

// dX (R, 3) += de[:, :3] + B . (de_sin * cos - de_cos * sin), the PE chain
// of _nerf_bwd_tile / _nof_bwd_tile (de is the packed-embedding cotangent).
template <int R>
__device__ void pe_backward(float* dX, const float* de, int kp,
                            const float* X, const float* bands, int kc) {
  for (int i = threadIdx.x; i < R * 3; i += blockDim.x) {
    const int r = i / 3, j = i % 3;
    const float* d = de + r * kp;
    float acc = 0.f;
    for (int f = 0; f < kc / 3; ++f) {
      float s, c;
      sincosf(__fmul_rn(bands[f], X[r * 3 + j]), &s, &c);
      const int q = 3 + f * 3 + j;
      const float ds = __fsub_rn(__fmul_rn(d[q], c), __fmul_rn(d[q + kc], s));
      acc = __fadd_rn(acc, __fmul_rn(bands[f], ds));
    }
    dX[i] = __fadd_rn(__fadd_rn(dX[i], d[j]), acc);
  }
  __syncthreads();
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  o[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  o[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

// The quaternion transform's scalars: theta = sqrt(|v|^2 + eps^2), w =
// cos(theta), k = sin(theta) / theta, qv = -v k (_nof_quat_fwd_t).
__device__ __forceinline__ void quat_scalars(const float* v, float* theta,
                                             float* w, float* k, float* qv) {
  const float th2 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])),
                __fmul_rn(v[2], v[2])),
      1e-16f);
  *theta = sqrtf(th2);
  *w = cosf(*theta);
  *k = __fdiv_rn(sinf(*theta), *theta);
  for (int j = 0; j < 3; ++j) qv[j] = __fmul_rn(-v[j], *k);
}

// warped = d + 2 qv x t1 + s + t, d = x - s, t1 = qv x d + w d; or x + o
inline __device__ void head_apply(const float* o, bool use_quat, const float* x,
                           float* out) {
  if (!use_quat) {
    for (int j = 0; j < 3; ++j) out[j] = __fadd_rn(o[j], x[j]);
    return;
  }
  float d[3], qv[3], c1[3], t1[3], c2[3], theta, w, k;
  for (int j = 0; j < 3; ++j) d[j] = __fsub_rn(x[j], o[3 + j]);
  quat_scalars(o, &theta, &w, &k, qv);
  cross3(qv, d, c1);
  for (int j = 0; j < 3; ++j) t1[j] = __fadd_rn(c1[j], __fmul_rn(w, d[j]));
  cross3(qv, t1, c2);
  for (int j = 0; j < 3; ++j)
    out[j] = __fadd_rn(__fadd_rn(__fadd_rn(d[j], __fmul_rn(2.f, c2[j])),
                                 o[3 + j]),
                       o[6 + j]);
}

// _nof_quat_bwd_t on one sample: cotangent g of the warped position ->
// dout (9: dv, ds, dt) and dx; o = [v, s, t] is the head output.
inline __device__ void head_vjp(const float* o, bool use_quat, const float* x,
                         const float* g, float* dout, float* dx) {
  if (!use_quat) {
    for (int j = 0; j < 3; ++j) dout[j] = dx[j] = g[j];
    return;
  }
  const float* v = o;
  float d[3], qv[3], c1[3], t1[3], theta, w, k;
  for (int j = 0; j < 3; ++j) d[j] = __fsub_rn(x[j], o[3 + j]);
  quat_scalars(v, &theta, &w, &k, qv);
  cross3(qv, d, c1);
  for (int j = 0; j < 3; ++j) t1[j] = __fadd_rn(c1[j], __fmul_rn(w, d[j]));
  float g2[3], dqv[3], dt1[3], tmp[3], dd[3];
  for (int j = 0; j < 3; ++j) g2[j] = __fmul_rn(2.f, g[j]);
  cross3(t1, g2, dqv);
  cross3(g2, qv, dt1);
  cross3(d, dt1, tmp);
  for (int j = 0; j < 3; ++j) dqv[j] = __fadd_rn(dqv[j], tmp[j]);
  cross3(dt1, qv, tmp);
  for (int j = 0; j < 3; ++j)
    dd[j] = __fadd_rn(__fadd_rn(g[j], tmp[j]), __fmul_rn(w, dt1[j]));
  const float dw = __fadd_rn(__fadd_rn(__fmul_rn(dt1[0], d[0]),
                                       __fmul_rn(dt1[1], d[1])),
                             __fmul_rn(dt1[2], d[2]));
  float dv[3];
  for (int j = 0; j < 3; ++j) dv[j] = __fmul_rn(-k, dqv[j]);
  const float dk = __fadd_rn(__fadd_rn(__fmul_rn(-v[0], dqv[0]),
                                       __fmul_rn(-v[1], dqv[1])),
                             __fmul_rn(-v[2], dqv[2]));
  const float sin_t = __fmul_rn(k, theta);
  const float dtheta = __fadd_rn(
      __fmul_rn(-sin_t, dw),
      __fmul_rn(dk, __fsub_rn(__fdiv_rn(w, theta),
                              __fdiv_rn(sin_t, __fmul_rn(theta, theta)))));
  for (int j = 0; j < 3; ++j) {
    dout[j] = __fadd_rn(dv[j], __fdiv_rn(__fmul_rn(dtheta, v[j]), theta));
    dout[3 + j] = __fsub_rn(g[j], dd[j]);
    dout[6 + j] = g[j];
    dx[j] = dd[j];
  }
}

// ---------------------------------------------------------------------------
// Operands. Matrices are row-major (K, N) in T plus their transposes (N, K);
// biases fp32. g_* are offsets of the gradients in the flat fp32 dW buffer
// (the wrapper lays it out in the order of the folded operand list).
// ---------------------------------------------------------------------------

struct Lay {
  const void* wpe;        // packed PE rows (kp, W), or null
  const void* wpeT;
  const void* wh;         // hidden rows (W, W), or null (layer 0)
  const void* whT;
  const float* b;         // (W,)
  int64_t g_wpe, g_wh, g_b;
};

struct Mat {
  const void* w;          // (K, N)
  const void* wT;         // (N, K)
  const float* b;         // (N,)
  int64_t g_w, g_b;
};

struct Net {
  int depth, width, kc, n_out;
  const float* bands;     // kc / 3 frequencies
  Lay layer[kMaxDepth];
  Mat head;               // NoF head (W, n_out)
};

// int64 argument decoding, in the order the wrappers write them
struct Reader {
  const int64_t* p;
  int64_t i() { return *p++; }
  template <typename P> P ptr() {
    return reinterpret_cast<P>(static_cast<intptr_t>(*p++));
  }
};

inline void read_lay(Reader& rd, Lay* l) {
  l->wpe = rd.ptr<const void*>();
  l->wpeT = rd.ptr<const void*>();
  l->wh = rd.ptr<const void*>();
  l->whT = rd.ptr<const void*>();
  l->b = rd.ptr<const float*>();
  l->g_wpe = rd.i();
  l->g_wh = rd.i();
  l->g_b = rd.i();
}

inline void read_mat(Reader& rd, Mat* m) {
  m->w = rd.ptr<const void*>();
  m->wT = rd.ptr<const void*>();
  m->b = rd.ptr<const float*>();
  m->g_w = rd.i();
  m->g_b = rd.i();
}

// net block: depth, width, kc, n_out, bands, kMaxDepth x lay (8), head (5)
inline void read_net(Reader& rd, Net* n) {
  n->depth = static_cast<int>(rd.i());
  n->width = static_cast<int>(rd.i());
  n->kc = static_cast<int>(rd.i());
  n->n_out = static_cast<int>(rd.i());
  n->bands = rd.ptr<const float*>();
  for (int l = 0; l < kMaxDepth; ++l) read_lay(rd, &n->layer[l]);
  read_mat(rd, &n->head);
}

inline bool net_ok(const Net& n) {
  return n.depth >= 1 && n.depth <= kMaxDepth && n.width >= 2 &&
         n.width <= kMaxWidth && n.kc >= 3 && n.kc % 3 == 0 &&
         n.n_out >= 0 && n.n_out <= kMaxOut;
}

// out[j] = sum_{g < rows} in[g * n + j], g ascending
static __global__ void sum_rows(const float* in, int rows, int64_t n, float* out) {
  for (int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       j < n; j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < rows; ++g) s = __fadd_rn(s, in[g * n + j]);
    out[j] = s;
  }
}

// out[q * N + c] = sum_{k < nseg} seg[(q * nseg + k) * N + c], k ascending
static __global__ void sum_segs(const float* seg, int nseg, int N, int64_t nq,
                         float* out) {
  const int64_t total = nq * N;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t q = i / N, c = i % N;
    float s = 0.f;
    for (int k = 0; k < nseg; ++k) s = __fadd_rn(s, seg[(q * nseg + k) * N + c]);
    out[i] = s;
  }
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

inline unsigned reduce_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

template <typename Kernel, typename... KArgs>
int launch(Kernel kernel, size_t smem, unsigned blocks, cudaStream_t stream,
           KArgs... args) {
  if (smem > kMaxSmem) return -3;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

inline const char* error_string(int code) {
  switch (code) {
    case -1: return "wrong argument count";
    case -2: return "unsupported network shape (depth 1..8, width 2..256, "
                    "head 1..9 outputs)";
    case -3: return "a tile exceeds the 227 KB of shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // namespace mlp
