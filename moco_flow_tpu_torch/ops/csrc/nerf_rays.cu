// The NeRF of the training step for Hopper (sm_90a): its forward (kernel
// #1) and its recompute backward (kernel #2).
//
// Replaces the TPU kernels moco_flow_tpu/ops/megakernel.py::_nerf_fwd_call
// and ::_nerf_bwd_call (via nerf_fused_rays_t / _nerf_op): the NeRF on
// transposed xyz (packed PE, the ReLU trunk with the PE re-injected at the
// skip layer, the sigma row, `final`, the extra layer plus the per-ray
// partial, the sigmoid rgb head) -> [rgb; sigma], and its backward -> dxyz,
// d(extra partial) and every weight and bias gradient.
//
// What bounds it on this card: compute. At full width (8x256 trunk, 63
// packed PE inputs, extra 256->128, rgb 128->3) the forward is ~590k
// multiply-adds a sample against 12 bytes of xyz in and 16 bytes out, and
// the backward with its recompute about three times that, ~3.5 MFLOP,
// against 12 bytes of xyz, 16 bytes of cotangent in and 12 bytes of dx out.
//
// What the design does about it: row-tile passes on row_tile.cuh, 128 rows
// a block with every activation in shared memory and each layer's weights
// staged in slices shared by the block's 16 warps.
//   #1: one pass; nothing but xyz, the per-ray partial and the outputs
//       touches device memory. The sigma row is an fp32 dot product of the
//       last activation (four threads a row).
//   #2 (a) the same pass as a forward recompute (one layer sequence, a
//       compile-time flag): the packed PE, the trunk, `final`, the extra
//       layer and the rgb head with its cotangent d(rgb) sigmoid'; every
//       layer's output goes to the device scratch;
//   (b) backward walk, 128-row tiles: dz = relu'(a) dh of each layer, from
//       the rgb head down, with a read back from the scratch and dz stored
//       there; dh = dz W^T on weights staged in shared memory; then the PE
//       cotangent and dx. The PE cotangent (fp32) takes E's place, which
//       is dead once the rgb head's input gradient has read d3;
//   (c) the weight and bias gradients as long-K products and ordered sums
//       over the scratch (wgrad.cuh): K is every row of the call.
// Every pass multiplies on the tensor cores (mma.sync): bf16 in the bf16
// build, split TF32 operands in the fp32 one (at W=256 and 63 packed PE
// inputs, 16-deep fp32 weight slices, E and the 260-float activation rows
// take 200 KB of a block's 227 in #1 and pass (a), 200.5 KB in the walk).
// Rounding follows _nerf_tile / _nerf_bwd_tile: activations and dz stored
// in T, fp32 accumulation, explicitly rounded elementwise steps,
// full-precision sincosf; dW of `final` takes the fp32 d(final output)
// (JAX's bf16 x fp32 dot): in bf16 as its exact split hi + mid + lo into
// three bf16 parts on the tensor cores (each product exact, the sums
// fp32), while dh takes it rounded to T (hi). The scratch (~10.9
// KB a row in bf16, ~21 KB in fp32 at full width) lives for one call; the
// wrapper cuts calls above its cap into chunks of whole rays.

#include <initializer_list>

#include "row_tile.cuh"
#include "wgrad.cuh"

namespace {

constexpr int kMaxDepth = 8;

struct Layout {           // byte offsets into the scratch
  int64_t e, act[kMaxDepth], hf, he, drgb, d3, dze, dhf, dz[kMaxDepth], end;
};

struct NB {
  int64_t n_rays, s, rows, rp;   // rp: rows padded to a multiple of kRT
  int sigma_only, has_extra, depth, width, kc, bf16;
  const float* bands;
  const float* xyz;              // (3, rows)
  const float* g;                // (4 | 1, rows) cotangent of the output
  float* dx;                     // (3, rows)
  const float* p_extra;          // (n_rays, W/2) or null
  RLayer layer[kMaxDepth];
  const float* wsig;             // (W,) fp32
  RMat fin, ext, rgb;
  unsigned char* scratch;
  Layout lay;
  const float* bsig;             // (1,) fp32
  float* out;                    // #1: (4 | 1, rows) [rgb; sigma]
};

// Scratch of rp rows: E (pad16(kp)), each activation (W), hf (W), he (W/2),
// d(rgb) fp32 (4), d3 (16), dz of the extra layer (W/2), d(final output)
// (W; bf16: hi, mid, lo), each layer's dz (W); in T unless stated.
Layout layout(const NB& a) {
  const int64_t t = a.bf16 ? 2 : 4, W = a.width, rp = a.rp;
  Layout l{};
  int64_t o = 0;
  auto take = [&](int64_t bytes_per_row) {
    const int64_t at = o;
    o += rp * bytes_per_row;
    return at;
  };
  l.e = take(t * pad16(3 + 2 * a.kc));
  for (int i = 0; i < a.depth; ++i) l.act[i] = take(t * W);
  if (!a.sigma_only) {
    l.hf = take(t * W);
    l.he = take(t * W / 2);
    l.drgb = take(4 * 4);
    l.d3 = take(t * 16);
    l.dze = take(t * W / 2);
    l.dhf = take(a.bf16 ? 3 * 2 * W : 4 * W);
  }
  for (int i = 0; i < a.depth; ++i) l.dz[i] = take(t * W);
  l.end = o;
  return l;
}

template <typename T> __device__ __forceinline__ T* at(const NB& a, int64_t off) {
  return reinterpret_cast<T*>(a.scratch + off);
}

template <typename T>
size_t fwd_smem(const NB& a) {
  return 6 * kRT * sizeof(float) + stage_bytes<T>() +
         kRT * (tile_ld<T>(3 + 2 * a.kc) + tile_ld<T>(a.width)) * sizeof(T);
}

// the walk's E (d3, row stride e_ld) and the PE cotangent de (fp32, row
// stride pad16(kp)) share one region
template <typename T>
__host__ __device__ size_t e_de_bytes(const NB& a) {
  const int kp = 3 + 2 * a.kc;
  const size_t e = tile_ld<T>(kp) * sizeof(T), de = pad16(kp) * sizeof(float);
  return kRT * (e > de ? e : de);
}

template <typename T>
size_t walk_smem(const NB& a) {
  return 7 * kRT * sizeof(float) + stage_bytes<T>() + e_de_bytes<T>(a) +
         kRT * tile_ld<T>(a.width) * sizeof(T);
}

// One 128-row tile through the NeRF (_nerf_tile). kForward: kernel #1,
// which writes [rgb; sigma] (or sigma) and nothing else; else pass (a) of
// #2, the forward recompute, which stores every layer's output and the rgb
// head's cotangent d(rgb) sigmoid' to the scratch.
template <typename T, bool kForward>
__device__ __forceinline__ void nerf_tile(const NB& a, unsigned char* smem) {
  const int W = a.width, W2 = W / 2, kp = 3 + 2 * a.kc, kpp = pad16(kp);
  const int e_ld = tile_ld<T>(kp), h_ld = tile_ld<T>(W);
  float* X = reinterpret_cast<float*>(smem);      // [3][kRT]
  float* G = X + 3 * kRT;                          // [3][kRT] d(rgb)
  T* Ws = reinterpret_cast<T*>(G + 3 * kRT);
  T* E = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(Ws) +
                              stage_bytes<T>());   // [kRT][e_ld]
  T* H = E + kRT * e_ld;                           // [kRT][h_ld]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRT;
  for (int i = threadIdx.x; i < 3 * kRT; i += blockDim.x) {
    const int j = i / kRT;
    const int64_t gi = row0 + i % kRT;
    const bool v = gi < a.rows;
    X[i] = v ? a.xyz[j * a.rows + gi] : 0.f;
    if constexpr (!kForward)
      G[i] = v && !a.sigma_only ? a.g[j * a.rows + gi] : 0.f;
  }
  __syncthreads();
  rt_pe_fill<T>(E, e_ld, X, a.bands, a.kc);
  if constexpr (!kForward)
    rt_store(at<T>(a, a.lay.e), kpp, row0, E, e_ld, kpp);
  for (int l = 0; l < a.depth; ++l) {
    const RLayer& L = a.layer[l];
    rt_mm(Ws, Term<T>{E, e_ld, static_cast<const T*>(L.pe_f), L.pe_f ? kp : 0},
          Term<T>{H, h_ld, static_cast<const T*>(L.h_f), L.h_f ? W : 0}, W,
          [&](int r, int c, float v0, float v1) {
            st2(H + r * h_ld + c, fmaxf(__fadd_rn(v0, L.bias[c]), 0.f),
                fmaxf(__fadd_rn(v1, L.bias[c + 1]), 0.f));
          });
    if constexpr (!kForward)
      rt_store(at<T>(a, a.lay.act[l]), W, row0, H, h_ld, W);
  }
  if constexpr (kForward) {
    // sigma = h . wsig + bsig in fp32, four threads a row (wsig rounded to
    // T, as the plain version's product rounds it); `final` overwrites H
    // only after the barriers of its product
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    float acc = 0.f;
    for (int c = q; c < W; c += 4)
      acc = fmaf(to_f(H[r * h_ld + c]), rnd_t<T>(a.wsig[c]), acc);
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
    const int64_t gi = row0 + r;
    if (q == 0 && gi < a.rows)
      a.out[(a.sigma_only ? 0 : 3) * a.rows + gi] = __fadd_rn(acc, a.bsig[0]);
  }
  if (a.sigma_only) return;
  rt_mm(Ws, Term<T>{H, h_ld, static_cast<const T*>(a.fin.f), W}, no_term<T>(),
        W, [&](int r, int c, float v0, float v1) {
          st2(H + r * h_ld + c, __fadd_rn(v0, a.fin.bias[c]),
              __fadd_rn(v1, a.fin.bias[c + 1]));
        });
  if constexpr (!kForward)
    rt_store(at<T>(a, a.lay.hf), W, row0, H, h_ld, W);
  rt_mm(Ws, Term<T>{H, h_ld, static_cast<const T*>(a.ext.f), W}, no_term<T>(),
        W2, [&](int r, int c, float v0, float v1) {
          const int64_t gi = row0 + r;
          const int64_t ray = (gi < a.rows ? gi : a.rows - 1) / a.s;
          float z[2] = {__fadd_rn(v0, a.ext.bias[c]),
                        __fadd_rn(v1, a.ext.bias[c + 1])};
          if (a.has_extra)
            for (int e = 0; e < 2; ++e)
              z[e] = __fadd_rn(z[e], a.p_extra[ray * W2 + c + e]);
          st2(H + r * h_ld + c, fmaxf(z[0], 0.f), fmaxf(z[1], 0.f));
        });
  if constexpr (kForward) {
    rt_mm(Ws, Term<T>{H, h_ld, static_cast<const T*>(a.rgb.f), W2},
          no_term<T>(), 3, [&](int r, int c, float v0, float v1) {
            const int64_t gi = row0 + r;
            const float v[2] = {v0, v1};
            for (int e = 0; e < 2 && c + e < 3 && gi < a.rows; ++e)
              a.out[(c + e) * a.rows + gi] =
                  1.f / (1.f + expf(-__fadd_rn(v[e], a.rgb.bias[c + e])));
          });
  } else {
    rt_store(at<T>(a, a.lay.he), W2, row0, H, h_ld, W2);
    for (int i = threadIdx.x; i < kRT * 16; i += blockDim.x)
      E[(i / 16) * e_ld + i % 16] = from_f<T>(0.f);   // d3, zero-padded
    float* drgb = at<float>(a, a.lay.drgb);
    rt_mm(Ws, Term<T>{H, h_ld, static_cast<const T*>(a.rgb.f), W2},
          no_term<T>(), 3, [&](int r, int c, float v0, float v1) {
            const float v[2] = {v0, v1};
            for (int e = 0; e < 2 && c + e < 3; ++e) {
              const int cc = c + e;
              const float rgb = 1.f / (1.f + expf(-__fadd_rn(v[e],
                                                             a.rgb.bias[cc])));
              const float d = __fmul_rn(__fmul_rn(G[cc * kRT + r], rgb),
                                        __fsub_rn(1.f, rgb));
              drgb[(row0 + r) * 4 + cc] = d;
              E[r * e_ld + cc] = from_f<T>(d);
            }
          });
    rt_store(at<T>(a, a.lay.d3), 16, row0, E, e_ld, 16);
  }
}

// (a) the forward recompute of one 128-row tile
template <typename T>
__global__ void __launch_bounds__(kRTThreads, 1) nerf_fwd_pass(const NB a) {
  extern __shared__ __align__(16) unsigned char smem[];
  nerf_tile<T, false>(a, smem);
}

// kernel #1: the NeRF forward of one 128-row tile
template <typename T>
__global__ void __launch_bounds__(kRTThreads, 1)
nerf_fwd_kernel(const NB a) {
  extern __shared__ __align__(16) unsigned char smem[];
  nerf_tile<T, true>(a, smem);
}

// dst pair (c, c + 1) = the pair (u0, u1) where the activation pair of `act`
// is positive, else 0: dz = relu'(a) dh, rounded to T
template <typename T>
__device__ __forceinline__ void masked(T* dst, const T* act, float u0,
                                       float u1) {
  const float2 m = ld2(act);
  st2(dst, m.x > 0.f ? u0 : 0.f, m.y > 0.f ? u1 : 0.f);
}

// (b) the backward walk of one 128-row tile
template <typename T>
__global__ void __launch_bounds__(kRTThreads, 1) nerf_walk_pass(const NB a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.width, W2 = W / 2, kp = 3 + 2 * a.kc, D = a.depth;
  const int e_ld = tile_ld<T>(kp), h_ld = tile_ld<T>(W), de_ld = pad16(kp);
  float* X = reinterpret_cast<float*>(smem);      // [3][kRT]
  float* dX = X + 3 * kRT;                         // [3][kRT]
  float* dsig = dX + 3 * kRT;                      // [kRT]
  T* Ws = reinterpret_cast<T*>(dsig + kRT);
  unsigned char* e_de =
      reinterpret_cast<unsigned char*>(Ws) + stage_bytes<T>();
  T* E = reinterpret_cast<T*>(e_de);               // [kRT][e_ld] d3
  float* de = reinterpret_cast<float*>(e_de);      // [kRT][de_ld], after d3
  T* H = reinterpret_cast<T*>(e_de + e_de_bytes<T>(a));  // [kRT][h_ld]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRT;
  for (int i = threadIdx.x; i < 3 * kRT; i += blockDim.x) {
    const int64_t gi = row0 + i % kRT;
    X[i] = gi < a.rows ? a.xyz[(i / kRT) * a.rows + gi] : 0.f;
    dX[i] = 0.f;
  }
  for (int r = threadIdx.x; r < kRT; r += blockDim.x) {
    const int64_t gi = row0 + r;
    dsig[r] = gi < a.rows ? a.g[(a.sigma_only ? 0 : 3) * a.rows + gi] : 0.f;
  }
  const T* a_last = at<T>(a, a.lay.act[D - 1]);
  if (!a.sigma_only) {
    rt_load(E, e_ld, at<T>(a, a.lay.d3), 16, row0, 16);  // barrier inside
    const T* he = at<T>(a, a.lay.he);
    rt_mm(Ws, Term<T>{E, e_ld, static_cast<const T*>(a.rgb.b), 3},
          no_term<T>(), W2, [&](int r, int c, float v0, float v1) {
            masked(H + r * h_ld + c, he + (row0 + r) * W2 + c, v0, v1);
          });
    rt_store(at<T>(a, a.lay.dze), W2, row0, H, h_ld, W2);
    T* dhf = at<T>(a, a.lay.dhf);
    rt_mm(Ws, Term<T>{H, h_ld, static_cast<const T*>(a.ext.b), W2},
          no_term<T>(), W, [&](int r, int c, float v0, float v1) {
            const int64_t o = (row0 + r) * W + c;
            if constexpr (sizeof(T) == 2) {   // dhf = hi + mid + lo, exactly
              const float h0 = rnd_t<T>(v0), h1 = rnd_t<T>(v1);
              const float r0 = __fsub_rn(v0, h0), r1 = __fsub_rn(v1, h1);
              const float m0 = rnd_t<T>(r0), m1 = rnd_t<T>(r1);
              st2(dhf + o, h0, h1);
              st2(dhf + a.rp * W + o, m0, m1);
              st2(dhf + 2 * a.rp * W + o, __fsub_rn(r0, m0),
                  __fsub_rn(r1, m1));
              st2(H + r * h_ld + c, h0, h1);
            } else {
              st2(dhf + o, v0, v1);
              st2(H + r * h_ld + c, v0, v1);
            }
          });
    rt_mm(Ws, Term<T>{H, h_ld, static_cast<const T*>(a.fin.b), W},
          no_term<T>(), W, [&](int r, int c, float v0, float v1) {
            masked(H + r * h_ld + c, a_last + (row0 + r) * W + c,
                   __fadd_rn(v0, __fmul_rn(dsig[r], a.wsig[c])),
                   __fadd_rn(v1, __fmul_rn(dsig[r], a.wsig[c + 1])));
          });
  } else {
    __syncthreads();
    for (int i = threadIdx.x; i < kRT * W / 2; i += blockDim.x) {
      const int r = i / (W / 2), c = (i % (W / 2)) * 2;
      masked(H + r * h_ld + c, a_last + (row0 + r) * W + c,
             __fmul_rn(dsig[r], a.wsig[c]), __fmul_rn(dsig[r], a.wsig[c + 1]));
    }
    __syncthreads();
  }
  rt_store(at<T>(a, a.lay.dz[D - 1]), W, row0, H, h_ld, W);
  bool de_set = false;
  for (int l = D - 1; l >= 0; --l) {
    const RLayer& L = a.layer[l];
    if (L.pe_b) {
      const bool first = !de_set;
      rt_mm(Ws, Term<T>{H, h_ld, static_cast<const T*>(L.pe_b), W},
            no_term<T>(), kp, [&](int r, int c, float v0, float v1) {
              float* q = de + r * de_ld + c;
              q[0] = first ? v0 : __fadd_rn(q[0], v0);
              q[1] = first ? v1 : __fadd_rn(q[1], v1);
            });
      de_set = true;
    }
    if (L.h_b) {
      const T* ap = at<T>(a, a.lay.act[l - 1]);
      rt_mm(Ws, Term<T>{H, h_ld, static_cast<const T*>(L.h_b), W},
            no_term<T>(), W, [&](int r, int c, float v0, float v1) {
              masked(H + r * h_ld + c, ap + (row0 + r) * W + c, v0, v1);
            });
      rt_store(at<T>(a, a.lay.dz[l - 1]), W, row0, H, h_ld, W);
    }
  }
  rt_pe_backward(dX, de, de_ld, X, a.bands, a.kc);
  for (int i = threadIdx.x; i < 3 * kRT; i += blockDim.x) {
    const int64_t gi = row0 + i % kRT;
    if (gi < a.rows) a.dx[(i / kRT) * a.rows + gi] = dX[i];
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Arguments (int64): dtype (0 fp32, 1 bf16), n_rays, S, sigma_only,
// has_extra, depth, width, kc, split_rows, split0, total; bands, xyz, g (the
// cotangent, or for #1 the output), dx, p_extra, part, dp_out, scratch; 8
// layers of (pe_f, pe_b, h_f, h_b, bias, g_pe, g_h, g_b); wsig, bsig,
// g_wsig, g_bsig; final, extra, rgb as (f, b, bias, g_w, g_b). Matrices: f
// the forward product's operand, b the input gradient's (row_tile.cuh); g_*
// offsets in the flat gradient row.
constexpr int kArgs = 11 + 8 + 8 * kMaxDepth + 4 + 3 * 5;

struct Decoded {
  NB a;
  int split_rows;
  int64_t split0, total, g_pe[kMaxDepth], g_h[kMaxDepth], g_b[kMaxDepth];
  int64_t g_wsig, g_bsig, g_w[3], g_bias[3];
  float* part;
  float* dp_out;
};

const void* P(int64_t v) { return reinterpret_cast<const void*>(v); }

int decode(const int64_t* p, int n, Decoded* d) {
  if (n != kArgs) return -1;
  NB& a = d->a;
  a.bf16 = static_cast<int>(p[0]);
  a.n_rays = p[1];
  a.s = p[2];
  a.sigma_only = static_cast<int>(p[3]);
  a.has_extra = static_cast<int>(p[4]);
  a.depth = static_cast<int>(p[5]);
  a.width = static_cast<int>(p[6]);
  a.kc = static_cast<int>(p[7]);
  d->split_rows = static_cast<int>(p[8]);
  d->split0 = p[9];
  d->total = p[10];
  a.bands = static_cast<const float*>(P(p[11]));
  a.xyz = static_cast<const float*>(P(p[12]));
  a.g = static_cast<const float*>(P(p[13]));
  a.out = reinterpret_cast<float*>(p[13]);
  a.dx = reinterpret_cast<float*>(p[14]);
  a.p_extra = static_cast<const float*>(P(p[15]));
  d->part = reinterpret_cast<float*>(p[16]);
  d->dp_out = reinterpret_cast<float*>(p[17]);
  a.scratch = reinterpret_cast<unsigned char*>(p[18]);
  const int64_t* q = p + 19;
  for (int l = 0; l < kMaxDepth; ++l, q += 8) {
    a.layer[l] = RLayer{P(q[0]), P(q[1]), P(q[2]), P(q[3]),
                        static_cast<const float*>(P(q[4]))};
    d->g_pe[l] = q[5];
    d->g_h[l] = q[6];
    d->g_b[l] = q[7];
  }
  a.wsig = static_cast<const float*>(P(q[0]));
  a.bsig = static_cast<const float*>(P(q[1]));
  d->g_wsig = q[2];
  d->g_bsig = q[3];
  q += 4;
  RMat* mats[3] = {&a.fin, &a.ext, &a.rgb};
  for (int k = 0; k < 3; ++k, q += 5) {
    *mats[k] = RMat{P(q[0]), P(q[1]), static_cast<const float*>(P(q[2]))};
    d->g_w[k] = q[3];
    d->g_bias[k] = q[4];
  }
  if (a.depth < 1 || a.depth > kMaxDepth || a.width < 32 ||
      a.width > kMaxWidth || a.width % 32 || a.kc < 3 || a.kc % 3)
    return -2;
  if (d->split_rows <= 0 || d->split_rows % kRT) return -4;
  a.rows = a.n_rays * a.s;
  a.rp = (a.rows + kRT - 1) / kRT * kRT;
  a.lay = layout(a);
  return 0;
}

// the gradient jobs of pass (c)
void jobs(const Decoded& d, wg::Call* mat, wg::Call* col, wg::SegCall* seg) {
  const NB& a = d.a;
  const int W = a.width, W2 = W / 2, kp = 3 + 2 * a.kc, D = a.depth;
  unsigned char* s = a.scratch;
  const Layout& l = a.lay;
  for (wg::Call* c : {mat, col}) {
    c->bf16 = a.bf16;
    c->rows = a.rp;
    c->real_rows = a.rows;
    c->split_rows = d.split_rows;
    c->split0 = d.split0;
    c->part = d.part;
    c->total = d.total;
    c->n_jobs = 0;
  }
  auto mjob = [&](int m, int n, int lda, int ldd, const void* A,
                  const void* Dm, int64_t out) {
    wg::Job j{};
    j.m = m;
    j.n = n;
    j.lda = lda;
    j.ldd = ldd;
    j.n_pieces = 1;
    j.a[0] = A;
    j.d[0] = Dm;
    j.out = out;
    mat->job[mat->n_jobs++] = j;
    return &mat->job[mat->n_jobs - 1];
  };
  auto cjob = [&](int n, int ldd, const void* Dm, int d_f32, int64_t out) {
    wg::Job j{};
    j.m = 1;
    j.n = n;
    j.ldd = ldd;
    j.n_pieces = 1;
    j.d_f32 = d_f32;
    j.d[0] = Dm;
    j.out = out;
    col->job[col->n_jobs++] = j;
    return &col->job[col->n_jobs - 1];
  };
  for (int i = 0; i < D; ++i) {
    const RLayer& L = a.layer[i];
    if (L.pe_f) mjob(kp, W, pad16(kp), W, s + l.e, s + l.dz[i], d.g_pe[i]);
    if (L.h_f) mjob(W, W, W, W, s + l.act[i - 1], s + l.dz[i], d.g_h[i]);
    cjob(W, W, s + l.dz[i], 0, d.g_b[i]);
  }
  // the sigma row: dsigma^T h_last (fp32 weights), and sum dsigma
  const float* dsig = a.g + (a.sigma_only ? 0 : 3) * a.rows;
  cjob(W, W, s + l.act[D - 1], 0, d.g_wsig)->w = dsig;
  cjob(1, 1, dsig, 1, d.g_bsig);
  seg->bf16 = a.bf16;
  seg->n_rays = a.n_rays;
  seg->s = a.s;
  seg->n_jobs = 0;
  if (a.sigma_only) return;
  wg::Job* fin = mjob(W, W, W, W, s + l.act[D - 1], s + l.dhf, d.g_w[0]);
  wg::Job* fb = cjob(W, W, s + l.dhf, !a.bf16, d.g_bias[0]);
  if (a.bf16) {
    fin->n_pieces = fb->n_pieces = 3;
    fb->split = 1;
    for (int k = 1; k < 3; ++k) {
      fin->a[k] = fin->a[0];
      fin->d[k] = fb->d[k] =
          s + l.dhf + static_cast<int64_t>(k) * a.rp * W * 2;
    }
  }
  mjob(W, W2, W, W2, s + l.hf, s + l.dze, d.g_w[1]);
  cjob(W2, W2, s + l.dze, 0, d.g_bias[1]);
  mjob(W2, 3, W2, 16, s + l.he, s + l.d3, d.g_w[2]);
  cjob(3, 4, s + l.drgb, 1, d.g_bias[2]);
  if (a.has_extra) {
    wg::SegJob& j = seg->job[seg->n_jobs++];
    j = wg::SegJob{};
    j.n = W2;
    j.ld = W2;
    j.n_pieces = 1;
    j.d[0] = s + l.dze;
    j.out = d.dp_out;
  }
}

template <typename T>
int run_passes(const NB& a, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(a.rp / kRT);
  int rc = launch(nerf_fwd_pass<T>, fwd_smem<T>(a), blocks, kRTThreads, s,
                  a);
  if (rc) return rc;
  return launch(nerf_walk_pass<T>, walk_smem<T>(a), blocks, kRTThreads, s, a);
}

}  // namespace

// Scratch bytes for the rows of these arguments (rows padded to 128), or
// < 0 on bad arguments.
extern "C" int64_t nerf_bwd_scratch_bytes(const int64_t* p, int n) {
  Decoded d;
  const int rc = decode(p, n, &d);
  return rc ? rc : d.a.lay.end;
}

// One chunk of whole rays: passes (a), (b), (c); the weight and bias
// gradients go to the chunk's rows of `part` (summed by wgrad_reduce once
// every chunk is done), d(extra partial) to dp_out, dxyz to dx.
extern "C" int nerf_bwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  int rc = decode(p, n, &d);
  if (rc) return rc;
  if (d.a.rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = d.a.bf16 ? run_passes<bf16>(d.a, s) : run_passes<float>(d.a, s);
  if (rc) return rc;
  wg::Call mat, col;
  wg::SegCall seg;
  jobs(d, &mat, &col, &seg);
  if ((rc = wg::matrix_launch(mat, s))) return rc;
  if ((rc = wg::colsum_launch(col, s))) return rc;
  return wg::segsum_launch(seg, s);
}

// Kernel #1 on the arguments of nerf_bwd_launch: the cotangent slot holds
// the output (4 | 1, rows), and the backward's pointers (dx, part, dp_out,
// scratch, the transposed operands) may be 0.
extern "C" int nerf_fwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  const int rc = decode(p, n, &d);
  if (rc) return rc;
  const NB& a = d.a;
  if (a.rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(a.rp / kRT);
  return a.bf16 ? launch(nerf_fwd_kernel<bf16>, fwd_smem<bf16>(a), blocks,
                         kRTThreads, s, a)
                : launch(nerf_fwd_kernel<float>, fwd_smem<float>(a), blocks,
                         kRTThreads, s, a);
}

extern "C" const char* nerf_bwd_error(int code) {
  switch (code) {
    case -1: return "wrong argument count";
    case -2: return "unsupported network shape (depth 1..8, width a multiple "
                    "of 32 up to 256)";
    case -3: return "a tile exceeds the 227 KB of shared memory";
    case -4: return "bad split rows or gradient jobs";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
