// The NeRF backward of the training step for Hopper (sm_90a).
//
// Replaces the TPU kernel moco_flow_tpu/ops/megakernel.py::_nerf_bwd_call
// (via nerf_fused_rays_t / _nerf_op_bwd). For a tile of sample rows it
// recomputes the forward (packed PE, the ReLU trunk with the PE re-injected
// at the skip layer, `final`, the extra layer plus the per-ray partial, the
// sigmoid rgb head), keeps every activation in shared memory, and then walks
// the layers in reverse as _nerf_bwd_tile does: the sigmoid and rgb head,
// the extra layer and d(partial), `final`, the sigma head's outer product,
// each trunk layer's dz = relu'(a) dh, the weight and bias gradients, the
// packed-PE cotangent split into x, sin and cos rows, dscaled = dsin cos -
// dcos sin, and dx += B dscaled. The forward of the training step is the
// render-pass kernel reading xyz (render_pass.cu).
//
// What bounds it on this card: compute. At full width (8x256 trunk, 63
// packed PE inputs, extra 256->128, rgb 128->3) the forward is ~590k
// multiply-adds a sample and the backward with its recompute about three
// times that, ~3.5 MFLOP, against 12 bytes of xyz and 16 bytes of
// cotangent in and 12 bytes of dx out. The weight gradients add the
// read-modify-write of the block's ~2.4 MB fp32 partial once per tile.
//
// What the design does about it: the activations of a tile never leave
// shared memory. Eight 256-wide activations, `final`'s and the extra
// layer's outputs, the cotangent buffers and the embedding take ~7.8 KB a
// row in bf16 and ~13.3 KB in fp32, so a tile is 24 rows in bf16 and 16 in
// fp32 (the largest that fit 227 KB, rather than recomputing per layer,
// which would cost up to 4x the forward again). The grid is persistent
// (one block per SM); each block adds its tiles' weight gradients into its
// own fp32 row of `part`, and sum_rows reduces the rows in a fixed order,
// so the gradients are deterministic. The bf16 build multiplies on tensor
// cores (mma.sync) wherever both operands are bf16, the fp32 build with an
// FFMA loop (mlp_tile.cuh::gemm); dW of `final` takes the fp32 dhf, as
// JAX's bf16 x fp32 dot does, and stays on the FFMA loop in both.

#include <initializer_list>

#include "mlp_tile.cuh"

namespace {

using namespace mlp;

struct NerfBwd {
  int64_t n_rays, s;
  int sigma_only, has_extra, nseg;
  Net net;                // trunk layers (head unused)
  const float* wsig;      // (W,) fp32: the sigma row, not rounded
  int64_t g_wsig, g_bsig;
  Mat fin, ext, rgb;      // final (W, W), extra (W, W/2), rgb (W/2, 3)
  const float* p_extra;   // (N, W/2) per-ray partial, or null
  const float* xyz;       // (3, N*S)
  const float* g;         // cotangent (4, N*S) [rgb; sigma] or (1, N*S)
  float* dx;              // (3, N*S)
  float* part;            // (G, total) per-block dW
  int64_t total;
  float* seg;             // (N, nseg, W/2) d(extra partial) segments
};

template <typename T>
size_t bytes_per_row(const NerfBwd& a) {
  const int W = a.net.width, kp = 3 + 2 * a.net.kc, D = a.net.depth;
  return sizeof(float) * (3 + 2 * W + kp + 3 + 3 + 1) +
         sizeof(T) * (kp + D * W + W + W / 2 + W + 3);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
nerf_bwd_kernel(const NerfBwd a) {
  constexpr int TM = R / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const Net& n = a.net;
  const int W = n.width, W2 = W / 2, kp = 3 + 2 * n.kc, D = n.depth;
  float* X = reinterpret_cast<float*>(smem);  // [R][3]
  float* dh = X + R * 3;                       // [R][W]
  float* dhf = dh + R * W;                     // [R][W] d(final output)
  float* de = dhf + R * W;                     // [R][kp]
  float* rgb = de + R * kp;                    // [R][3]
  float* drgb = rgb + R * 3;                   // [R][3]
  float* dsig = drgb + R * 3;                  // [R]
  T* E = reinterpret_cast<T*>(dsig + R);       // [R][kp]
  T* acts = E + R * kp;                        // [D][R][W]
  T* hf = acts + static_cast<int64_t>(D) * R * W;  // [R][W]
  T* he = hf + R * W;                          // [R][W2]
  T* dz = he + R * W2;                         // [R][W]
  T* d3 = dz + R * W;                          // [R][3]
  float* P = a.part + static_cast<int64_t>(blockIdx.x) * a.total;
  const int64_t n_rows = a.n_rays * a.s;
  const int64_t ntiles = (n_rows + R - 1) / R;
  const T* hl = acts + static_cast<int64_t>(D - 1) * R * W;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile t{tile * R, n_rows, a.s, tile};
    // inputs; rows past N*S get x = 0 and a zero cotangent
    for (int i = threadIdx.x; i < R * 3; i += blockDim.x) {
      const int r = i / 3, j = i % 3;
      const bool v = t.valid(r);
      X[i] = v ? a.xyz[j * n_rows + t.row0 + r] : 0.f;
      if (!a.sigma_only) drgb[i] = v ? a.g[j * n_rows + t.row0 + r] : 0.f;
    }
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      dsig[r] = t.valid(r)
                    ? a.g[(a.sigma_only ? 0 : 3) * n_rows + t.row0 + r]
                    : 0.f;
    __syncthreads();
    pe_fill<T, R>(E, kp, X, n.bands, n.kc);

    // ---- forward recompute (_nerf_tile) ----
    for (int l = 0; l < D; ++l) {
      const Lay& L = n.layer[l];
      T* out = acts + static_cast<int64_t>(l) * R * W;
      const T* in = l > 0 ? acts + static_cast<int64_t>(l - 1) * R * W : acts;
      gemm<TM>(R, W, L.wpe ? kp : 0, Rows<T>{E, kp},
               Rows<T>{static_cast<const T*>(L.wpe), W}, L.wh ? W : 0,
               Rows<T>{in, W}, Rows<T>{static_cast<const T*>(L.wh), W},
               [&](int r, int c, float acc) {
                 stv(out, r * W + c, fmaxf(__fadd_rn(acc, L.b[c]), 0.f));
               });
      __syncthreads();
    }
    if (!a.sigma_only) {
      gemm<TM>(R, W, W, Rows<T>{hl, W},
               Rows<T>{static_cast<const T*>(a.fin.w), W},
               [&](int r, int c, float acc) {
                 stv(hf, r * W + c, __fadd_rn(acc, a.fin.b[c]));
               });
      __syncthreads();
      gemm<TM>(R, W2, W, Rows<T>{hf, W},
               Rows<T>{static_cast<const T*>(a.ext.w), W2},
               [&](int r, int c, float acc) {
                 float z = __fadd_rn(acc, a.ext.b[c]);
                 if (a.has_extra)
                   z = __fadd_rn(z, a.p_extra[t.ray(r) * W2 + c]);
                 stv(he, r * W2 + c, fmaxf(z, 0.f));
               });
      __syncthreads();
      gemm<TM>(R, 3, W2, Rows<T>{he, W2},
               Rows<T>{static_cast<const T*>(a.rgb.w), 3},
               [&](int r, int c, float acc) {
                 rgb[r * 3 + c] =
                     1.f / (1.f + expf(-__fadd_rn(acc, a.rgb.b[c])));
               });
      __syncthreads();

      // ---- rgb head, extra layer, final ----
      for (int i = threadIdx.x; i < R * 3; i += blockDim.x) {
        const float v = __fmul_rn(__fmul_rn(drgb[i], rgb[i]),
                                  __fsub_rn(1.f, rgb[i]));
        drgb[i] = v;
        stv(d3, i, v);
      }
      __syncthreads();
      add_colsum<R>(P + a.rgb.g_b, 3, Rows<float>{drgb, 3});
      add_wgrad<TM, R>(P + a.rgb.g_w, W2, 3, Cols<T>{he, W2}, Rows<T>{d3, 3});
      gemm<TM>(R, W2, 3, Rows<T>{d3, 3},
               Rows<T>{static_cast<const T*>(a.rgb.wT), W2},
               [&](int r, int c, float acc) {   // dhe, masked, in dz
                 stv(dz, r * W2 + c, ldv(he, r * W2 + c) > 0.f ? acc : 0.f);
               });
      __syncthreads();
      add_colsum<R>(P + a.ext.g_b, W2, Rows<T>{dz, W2});
      if (a.has_extra) add_segsum<R>(a.seg, a.nseg, W2, t, Rows<T>{dz, W2});
      add_wgrad<TM, R>(P + a.ext.g_w, W, W2, Cols<T>{hf, W}, Rows<T>{dz, W2});
      gemm<TM>(R, W, W2, Rows<T>{dz, W2},
               Rows<T>{static_cast<const T*>(a.ext.wT), W},
               [&](int r, int c, float acc) { dhf[r * W + c] = acc; });
      __syncthreads();
      // dW_final against the unrounded fp32 dhf (JAX's bf16 x fp32 dot)
      add_wgrad<TM, R>(P + a.fin.g_w, W, W, Cols<T>{hl, W},
                       Rows<float>{dhf, W});
      add_colsum<R>(P + a.fin.g_b, W, Rows<float>{dhf, W});
      gemm<TM>(R, W, W, RowsRnd<T>{dhf, W},
               Rows<T>{static_cast<const T*>(a.fin.wT), W},
               [&](int r, int c, float acc) {
                 dh[r * W + c] = __fadd_rn(acc, __fmul_rn(dsig[r], a.wsig[c]));
               });
    } else {
      for (int i = threadIdx.x; i < R * W; i += blockDim.x)
        dh[i] = __fmul_rn(dsig[i / W], a.wsig[i % W]);
    }
    // sigma head: dW (1, W) = dsigma^T h, db = sum dsigma
    gemm<TM>(1, W, R, [&](int, int k) { return dsig[k]; }, Rows<T>{hl, W},
             [&](int, int c, float acc) {
               P[a.g_wsig + c] = __fadd_rn(P[a.g_wsig + c], acc);
             });
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s = __fadd_rn(s, dsig[r]);
      P[a.g_bsig] = __fadd_rn(P[a.g_bsig], s);
    }
    __syncthreads();

    // ---- trunk, in reverse ----
    bool de_set = false;
    for (int l = D - 1; l >= 0; --l) {
      const Lay& L = n.layer[l];
      const T* al = acts + static_cast<int64_t>(l) * R * W;
      for (int i = threadIdx.x; i < R * W; i += blockDim.x)
        stv(dz, i, ldv(al, i) > 0.f ? dh[i] : 0.f);
      __syncthreads();
      add_colsum<R>(P + L.g_b, W, Rows<T>{dz, W});
      if (L.wpe) {
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
    for (int i = threadIdx.x; i < R * 3; i += blockDim.x) drgb[i] = 0.f;
    __syncthreads();
    pe_backward<R>(drgb, de, kp, X, n.bands, n.kc);   // dx in drgb
    for (int i = threadIdx.x; i < R * 3; i += blockDim.x) {
      const int r = i / 3, j = i % 3;
      if (t.valid(r)) a.dx[j * n_rows + t.row0 + r] = drgb[i];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Arguments (int64): dtype (0 fp32, 1 bf16), n_rays, S, sigma_only,
// has_extra, nseg, blocks; the trunk net block (mlp_tile.cuh read_net);
// wsig, g_wsig, g_bsig; final, extra, rgb (read_mat); p_extra, xyz, g, dx,
// part, total, seg, dw_out (total,), dp_out (N, W/2).
constexpr int kArgs = 7 + (5 + 8 * kMaxDepth + 5) + 3 + 3 * 5 + 9;

struct Decoded {
  NerfBwd a;
  int dtype, blocks;
  float* dw_out;
  float* dp_out;
};

int decode(const int64_t* p, int n, Decoded* d) {
  if (n != kArgs) return -1;
  Reader rd{p};
  NerfBwd& a = d->a;
  d->dtype = static_cast<int>(rd.i());
  a.n_rays = rd.i();
  a.s = rd.i();
  a.sigma_only = static_cast<int>(rd.i());
  a.has_extra = static_cast<int>(rd.i());
  a.nseg = static_cast<int>(rd.i());
  d->blocks = static_cast<int>(rd.i());
  read_net(rd, &a.net);
  a.wsig = rd.ptr<const float*>();
  a.g_wsig = rd.i();
  a.g_bsig = rd.i();
  read_mat(rd, &a.fin);
  read_mat(rd, &a.ext);
  read_mat(rd, &a.rgb);
  a.p_extra = rd.ptr<const float*>();
  a.xyz = rd.ptr<const float*>();
  a.g = rd.ptr<const float*>();
  a.dx = rd.ptr<float*>();
  a.part = rd.ptr<float*>();
  a.total = rd.i();
  a.seg = rd.ptr<float*>();
  d->dw_out = rd.ptr<float*>();
  d->dp_out = rd.ptr<float*>();
  if (!net_ok(a.net) || a.net.width % 2) return -2;
  return 0;
}

int pick_rows(const Decoded& d) {
  const size_t per = d.dtype == 1 ? bytes_per_row<bf16>(d.a)
                                  : bytes_per_row<float>(d.a);
  for (int R : {24, 16, 8})
    if (R * per + 64 <= static_cast<size_t>(kMaxSmem)) return R;
  return 0;
}

template <typename T>
int launch_bwd(const NerfBwd& a, int R, int blocks, cudaStream_t s) {
  const size_t smem = R * bytes_per_row<T>(a) + 64;
  switch (R) {
    case 24: return launch(nerf_bwd_kernel<T, 24>, smem, blocks, s, a);
    case 16: return launch(nerf_bwd_kernel<T, 16>, smem, blocks, s, a);
    case 8: return launch(nerf_bwd_kernel<T, 8>, smem, blocks, s, a);
  }
  return -3;
}

}  // namespace

// Rows per tile of the backward for these arguments; 0 if none fits.
extern "C" int nerf_bwd_tile_rows(const int64_t* p, int n) {
  Decoded d;
  const int rc = decode(p, n, &d);
  return rc ? rc : pick_rows(d);
}

// The backward kernel on `blocks` blocks (part holds that many zeroed rows,
// seg is zeroed), then dw_out = part's rows summed in order and dp_out =
// each ray's segment slots summed in order.
extern "C" int nerf_bwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  int rc = decode(p, n, &d);
  if (rc) return rc;
  const NerfBwd& a = d.a;
  if (a.n_rays <= 0 || a.s <= 0) return 0;
  const int R = pick_rows(d);
  if (!R || d.blocks < 1) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = d.dtype == 1 ? launch_bwd<bf16>(a, R, d.blocks, s)
                    : launch_bwd<float>(a, R, d.blocks, s);
  if (rc) return rc;
  sum_rows<<<reduce_blocks(a.total), kThreads, 0, s>>>(a.part, d.blocks,
                                                      a.total, d.dw_out);
  rc = static_cast<int>(cudaGetLastError());
  if (rc || !a.has_extra) return rc;
  const int W2 = a.net.width / 2;
  sum_segs<<<reduce_blocks(a.n_rays * W2), kThreads, 0, s>>>(
      a.seg, a.nseg, W2, a.n_rays, d.dp_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nerf_bwd_error(int code) { return error_string(code); }
