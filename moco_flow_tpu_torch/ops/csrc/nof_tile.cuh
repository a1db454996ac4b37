// One NoF warp of a tile of sample rows, forward and backward: the body of
// the single warp (nof_rays.cu, kernels #3/#4).
//
// A NoF evaluation is the packed PE [x; sin; cos], a ReLU trunk with per-ray
// frame partials added at layer 0 and at the skip layer, and the
// log-quaternion (or offset) head (_nof_tile). Its VJP (_nof_bwd_tile) takes
// the forward's stored activations and head output: the quaternion VJP, the
// trunk VJP, weight gradients added into the block's fp32 partial row and
// per-ray partial gradients into the (ray, tile) slots of `seg`
// (mlp_tile.cuh). Rounding follows mlp_tile.cuh: storage type T for
// activations, embeddings and dz, fp32 accumulation, explicitly rounded
// elementwise intrinsics.

#pragma once

#include "mlp_tile.cuh"

namespace mlp {

// One NoF evaluation of the tile: Xin (R, 3) -> acts (depth, R, W) in T,
// O (R, kMaxOut) head output (fp32), Xout (R, 3). _nof_tile's order:
// relu(((E @ wpe + H @ wh) + partial) + b).
template <typename T, int R>
__device__ void nof_forward(const Net& n, const float* const* parts,
                            bool use_quat, const Tile& t, const float* Xin,
                            T* E, T* acts, float* O, float* Xout) {
  constexpr int TM = R / 8;
  const int W = n.width, kp = 3 + 2 * n.kc;
  pe_fill<T, R>(E, kp, Xin, n.bands, n.kc);
  int pe = 0;
  for (int l = 0; l < n.depth; ++l) {
    const Lay& L = n.layer[l];
    T* out = acts + static_cast<int64_t>(l) * R * W;
    const T* in = l > 0 ? acts + static_cast<int64_t>(l - 1) * R * W : acts;
    const float* part = L.wpe ? parts[pe++] : nullptr;
    gemm<TM>(R, W, L.wpe ? kp : 0, Rows<T>{E, kp},
             Rows<T>{static_cast<const T*>(L.wpe), W}, L.wh ? W : 0,
             Rows<T>{in, W}, Rows<T>{static_cast<const T*>(L.wh), W},
             [&](int r, int c, float acc) {
               float z = acc;
               if (part) z = __fadd_rn(z, part[t.ray(r) * W + c]);
               stv(out, r * W + c, fmaxf(__fadd_rn(z, L.b[c]), 0.f));
             });
    __syncthreads();
  }
  const T* hl = acts + static_cast<int64_t>(n.depth - 1) * R * W;
  gemm<TM>(R, n.n_out, W, Rows<T>{hl, W},
           Rows<T>{static_cast<const T*>(n.head.w), n.n_out},
           [&](int r, int c, float acc) {
             O[r * kMaxOut + c] = __fadd_rn(acc, n.head.b[c]);
           });
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    head_apply(O + r * kMaxOut, use_quat, Xin + r * 3, Xout + r * 3);
  __syncthreads();
}

struct Work {       // backward scratch of one tile
  float* dout;      // (R, kMaxOut) head cotangent, fp32
  float* dh;        // (R, W)
  float* de;        // (R, kp) packed-embedding cotangent
  void* E;          // (R, kp) T
  void* d9;         // (R, kMaxOut) T
  void* dz;         // (R, W) T
};

// Where the per-ray partial gradients go: seg holds (sets * n_pe, N, nseg,
// W) slots, one (ray, tile) slot per partial of each partial set.
struct Segs {
  float* seg;
  int64_t n_rays;
  int nseg, n_pe;
};

// _nof_bwd_tile on stored residuals: cotangent G (R, 3) of the warp's
// output -> dX (R, 3) of its input; weight gradients into P, partial
// gradients into partial set `set`'s slots of sg.seg.
template <typename T, int R>
__device__ void nof_backward(const Segs& sg, bool use_quat, const Net& n,
                             int set, const Tile& t, const float* Xin,
                             const T* acts, const float* O, const float* G,
                             float* dX, float* P, const Work& w) {
  constexpr int TM = R / 8;
  const int W = n.width, kp = 3 + 2 * n.kc, no = n.n_out;
  T* E = static_cast<T*>(w.E);
  T* d9 = static_cast<T*>(w.d9);
  T* dz = static_cast<T*>(w.dz);
  float* dh = w.dh;
  float* de = w.de;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    head_vjp(O + r * kMaxOut, use_quat, Xin + r * 3, G + r * 3,
             w.dout + r * kMaxOut, dX + r * 3);
    for (int c = 0; c < no; ++c)
      stv(d9, r * kMaxOut + c, w.dout[r * kMaxOut + c]);
  }
  __syncthreads();
  const T* hl = acts + static_cast<int64_t>(n.depth - 1) * R * W;
  add_colsum<R>(P + n.head.g_b, no, Rows<float>{w.dout, kMaxOut});
  add_wgrad<TM, R>(P + n.head.g_w, W, no, Cols<T>{hl, W},
                   Rows<T>{d9, kMaxOut});
  gemm<TM>(R, W, no, Rows<T>{d9, kMaxOut},
           Rows<T>{static_cast<const T*>(n.head.wT), W},
           [&](int r, int c, float acc) { dh[r * W + c] = acc; });
  pe_fill<T, R>(E, kp, Xin, n.bands, n.kc);   // barrier inside
  bool de_set = false;
  int pe = sg.n_pe;
  for (int l = n.depth - 1; l >= 0; --l) {
    const Lay& L = n.layer[l];
    const T* al = acts + static_cast<int64_t>(l) * R * W;
    for (int i = threadIdx.x; i < R * W; i += blockDim.x)
      stv(dz, i, ldv(al, i) > 0.f ? dh[i] : 0.f);
    __syncthreads();
    add_colsum<R>(P + L.g_b, W, Rows<T>{dz, W});
    if (L.wpe) {
      --pe;
      float* seg = sg.seg + static_cast<int64_t>(set * sg.n_pe + pe) *
                                sg.n_rays * sg.nseg * W;
      add_segsum<R>(seg, sg.nseg, W, t, Rows<T>{dz, W});
      add_wgrad<TM, R>(P + L.g_wpe, kp, W, Cols<T>{E, kp}, Rows<T>{dz, W});
      const bool first = !de_set;
      gemm<TM>(R, kp, W, Rows<T>{dz, W},
               Rows<T>{static_cast<const T*>(L.wpeT), kp},
               [&](int r, int c, float acc) {
                 float* q = de + r * kp + c;
                 *q = first ? acc : __fadd_rn(*q, acc);
               });
      de_set = true;
    }
    if (L.wh) {
      add_wgrad<TM, R>(P + L.g_wh, W, W,
                       Cols<T>{acts + static_cast<int64_t>(l - 1) * R * W, W},
                       Rows<T>{dz, W});
      gemm<TM>(R, W, W, Rows<T>{dz, W},
               Rows<T>{static_cast<const T*>(L.whT), W},
               [&](int r, int c, float acc) { dh[r * W + c] = acc; });
    }
    __syncthreads();
  }
  pe_backward<R>(dX, de, kp, Xin, n.bands, n.kc);
}

// X (rows, 3) <- the tile's rows of the transposed (3, n_rows) src; zeros
// past the end
__device__ __forceinline__ void load_rows(float* X, const float* src,
                                          const Tile& t, int rows) {
  for (int i = threadIdx.x; i < rows * 3; i += blockDim.x) {
    const int r = i / 3, j = i % 3;
    X[i] = t.valid(r) ? src[j * t.n_rows + t.row0 + r] : 0.f;
  }
}

__device__ __forceinline__ void store_rows(float* dst, const float* X,
                                           const Tile& t, int rows) {
  for (int i = threadIdx.x; i < rows * 3; i += blockDim.x) {
    const int r = i / 3, j = i % 3;
    if (t.valid(r)) dst[j * t.n_rows + t.row0 + r] = X[i];
  }
}

}  // namespace mlp
