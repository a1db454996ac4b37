// The NoF warp chain of the training step for Hopper (sm_90a): its forward
// (kernel #5) and its backward (kernel #6); and the single NoF warp, its
// forward (kernel #3) and backward (kernel #4), which are the chain's first
// stage alone.
//
// Replaces the TPU kernels moco_flow_tpu/ops/megakernel.py::_chain_fwd_call
// and ::_chain_bwd_call (via nof_chain_rays_t / _chain_op), and
// ::_nof_fwd_call and ::_nof_bwd_call (via nof_fused_rays / _nof_op): up to
// five NoF evaluations a sample (_chain_stages: bw@ind -> cano; fw@ind ->
// recon; fw@chained -> bw@chained -> fw@ind -> chain_recon), each the packed PE
// [x; sin; cos], a ReLU trunk with per-ray frame partials added at layer 0
// and at the skip layer, and the log-quaternion (or offset) head. The
// backward recomputes them, then runs their VJPs in reverse (global, local,
// bw) as _chain_bwd_tile does: the quaternion head's VJP, the trunk's, the
// packed PE's -> dxyz, the per-ray partials' gradients per partial set and
// the weight gradients summed per net.
//
// What bounds it on this card: compute. At full width (NoF 4x128, 33 packed
// PE inputs, 9 head outputs) one evaluation is ~59k multiply-adds: the
// five-stage forward is ~0.6 MFLOP a sample against 12 bytes of xyz in and
// 36 bytes out, the backward with its recompute ~1.8 MFLOP against 12
// bytes of xyz and 36 bytes of cotangents in and 12 bytes of dx out.
//
// What the design does about it: row-tile passes on row_tile.cuh, 128 rows
// a block with every activation in shared memory and each layer's weights
// staged in slices shared by the block's 16 warps.
//   #5: one pass, every stage; nothing but xyz, the per-ray partials and
//       the outputs touches device memory.
//   #6 (a) the same pass as a forward recompute (one stage loop, a
//       compile-time flag): every stage's input, packed PE, trunk
//       activations and head output go to the device scratch;
//   (b) backward walk, 128-row tiles: the stages in reverse, each the
//       quaternion-head VJP, dz = relu'(a) dh of each trunk layer (stored),
//       dh = dz W^T on staged weights, the PE cotangent;
//   (c) per net and layer one long-K product over the rows of every stage
//       that uses the net (the stages as pieces, in stage order); bias
//       gradients as column sums, each partial set's gradients as
//       segmented row sums over the stages that use the set.
// #3 and #4 run the same device code on arguments with one stage (bw@ind,
// the caller's net and partials; no fw net) through entry points of their
// own (nof_fwd_kernel; nof_fwd_pass, nof_walk_pass), so a profile and the
// launch counts tell them apart from #5 / #6.
// Every pass multiplies on the tensor cores (mma.sync): bf16 in the bf16
// build, split TF32 operands in the fp32 one.
// Rounding follows _nof_tile / _nof_bwd_tile: activations, embeddings, dz
// and the head cotangent stored in T, fp32 accumulation, explicitly rounded
// elementwise steps.

#include <initializer_list>

#include "mlp_tile.cuh"
#include "row_tile.cuh"
#include "wgrad.cuh"

namespace {

constexpr int kMaxStages = 5;
constexpr int kMaxSets = 4;
constexpr int kMaxPe = 4;
constexpr int kMaxDepth = 8;
constexpr int kHeadLd = 16;              // head outputs (<= 9), padded

struct CNet {
  RLayer layer[kMaxDepth];
  RMat head;
};

struct Layout {           // byte offsets into the scratch, per stage
  int64_t x[kMaxStages], e[kMaxStages], o[kMaxStages], d9[kMaxStages],
      dout[kMaxStages], act[kMaxStages][kMaxDepth],
      dz[kMaxStages][kMaxDepth], end;
};

struct CB {
  int64_t n_rays, s, rows, rp;
  int n_stages, use_quat, chain_local, chain_global, n_pe, depth, width, kc,
      n_out, bf16;
  int stage_net[kMaxStages], stage_set[kMaxStages], in_src[kMaxStages];
  const float* bands;
  const float* xyz;                      // (3, rows)
  const float* gin[3];                   // cotangents of cano, recon, chain
  float* dx;                             // (3, rows)
  const float* parts[kMaxSets][kMaxPe];  // per-ray partials (n_rays, W)
  CNet net[2];                           // bw, fw
  unsigned char* scratch;
  Layout lay;
  float* out[3];                         // #5: cano, recon, chain_recon
};

// Per stage, rp rows: x fp32 (4), E (pad16(kp)), each activation (W), the
// head output fp32 (16), each layer's dz (W), the head cotangent d9 (16)
// and its fp32 value (16); in T unless stated.
Layout layout(const CB& a) {
  const int64_t t = a.bf16 ? 2 : 4, W = a.width, rp = a.rp;
  Layout l{};
  int64_t o = 0;
  auto take = [&](int64_t bytes_per_row) {
    const int64_t at = o;
    o += rp * bytes_per_row;
    return at;
  };
  for (int si = 0; si < a.n_stages; ++si) {
    l.x[si] = take(4 * 4);
    l.e[si] = take(t * pad16(3 + 2 * a.kc));
    for (int i = 0; i < a.depth; ++i) l.act[si][i] = take(t * W);
    l.o[si] = take(4 * kHeadLd);
    for (int i = 0; i < a.depth; ++i) l.dz[si][i] = take(t * W);
    l.d9[si] = take(t * kHeadLd);
    l.dout[si] = take(4 * kHeadLd);
  }
  l.end = o;
  return l;
}

template <typename T> __device__ __forceinline__ T* at(const CB& a, int64_t off) {
  return reinterpret_cast<T*>(a.scratch + off);
}

template <typename T>
size_t fwd_smem(const CB& a) {
  return ((kMaxStages + 1) * 3 * kRT + kRT * kHeadLd) * sizeof(float) +
         stage_bytes<T>() +
         kRT * (tile_ld<T>(3 + 2 * a.kc) + tile_ld<T>(a.width)) * sizeof(T);
}

template <typename T>
size_t walk_smem(const CB& a) {
  return (4 * 3 * kRT + kRT * pad16(3 + 2 * a.kc)) * sizeof(float) +
         stage_bytes<T>() +
         kRT * (tile_ld<T>(3 + 2 * a.kc) + tile_ld<T>(a.width)) * sizeof(T);
}

// One 128-row tile through every stage of the chain. kForward: kernel #5,
// which writes cano, recon and chain_recon and nothing else; else pass (a)
// of #6, which stores every stage's input, packed PE, activations and head
// output to the scratch.
template <typename T, bool kForward>
__device__ __forceinline__ void chain_tile(const CB& a, unsigned char* smem) {
  const int W = a.width, kp = 3 + 2 * a.kc, kpp = pad16(kp);
  const int e_ld = tile_ld<T>(kp), h_ld = tile_ld<T>(W);
  float* X0 = reinterpret_cast<float*>(smem);     // [3][kRT] positions
  float* Xs = X0 + 3 * kRT;                        // [stage][3][kRT] outputs
  float* O = Xs + kMaxStages * 3 * kRT;            // [kRT][kHeadLd]
  T* Ws = reinterpret_cast<T*>(O + kRT * kHeadLd);
  T* E = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(Ws) +
                              stage_bytes<T>());   // [kRT][e_ld]
  T* H = E + kRT * e_ld;                           // [kRT][h_ld]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRT;
  for (int i = threadIdx.x; i < 3 * kRT; i += blockDim.x) {
    const int64_t gi = row0 + i % kRT;
    X0[i] = gi < a.rows ? a.xyz[(i / kRT) * a.rows + gi] : 0.f;
  }
  for (int i = threadIdx.x; i < kRT * kHeadLd; i += blockDim.x) O[i] = 0.f;
  __syncthreads();
  for (int si = 0; si < a.n_stages; ++si) {
    const CNet& n = a.net[a.stage_net[si]];
    const float* const* parts = a.parts[a.stage_set[si]];
    const float* X = si == 0 ? X0 : Xs + a.in_src[si] * 3 * kRT;
    if constexpr (!kForward) {
      float* xs = at<float>(a, a.lay.x[si]);
      for (int i = threadIdx.x; i < 3 * kRT; i += blockDim.x)
        xs[(row0 + i % kRT) * 4 + i / kRT] = X[i];
    }
    rt_pe_fill<T>(E, e_ld, X, a.bands, a.kc);
    if constexpr (!kForward)
      rt_store(at<T>(a, a.lay.e[si]), kpp, row0, E, e_ld, kpp);
    int pe = 0;
    for (int l = 0; l < a.depth; ++l) {
      const RLayer& L = n.layer[l];
      const float* part = L.pe_f ? parts[pe++] : nullptr;
      rt_mm(Ws,
            Term<T>{E, e_ld, static_cast<const T*>(L.pe_f), L.pe_f ? kp : 0},
            Term<T>{H, h_ld, static_cast<const T*>(L.h_f), L.h_f ? W : 0}, W,
            [&](int r, int c, float v0, float v1) {
              float z[2] = {v0, v1};
              if (part) {
                const int64_t gi = row0 + r;
                const int64_t ray = (gi < a.rows ? gi : a.rows - 1) / a.s;
                for (int e = 0; e < 2; ++e)
                  z[e] = __fadd_rn(z[e], part[ray * W + c + e]);
              }
              st2(H + r * h_ld + c, fmaxf(__fadd_rn(z[0], L.bias[c]), 0.f),
                  fmaxf(__fadd_rn(z[1], L.bias[c + 1]), 0.f));
            });
      if constexpr (!kForward)
        rt_store(at<T>(a, a.lay.act[si][l]), W, row0, H, h_ld, W);
    }
    rt_mm(Ws, Term<T>{H, h_ld, static_cast<const T*>(n.head.f), W},
          no_term<T>(), a.n_out, [&](int r, int c, float v0, float v1) {
            O[r * kHeadLd + c] = __fadd_rn(v0, n.head.bias[c]);
            if (c + 1 < a.n_out)
              O[r * kHeadLd + c + 1] = __fadd_rn(v1, n.head.bias[c + 1]);
          });
    if constexpr (!kForward)
      rt_store(at<float>(a, a.lay.o[si]), kHeadLd, row0, O, kHeadLd, kHeadLd);
    float* out = Xs + si * 3 * kRT;
    for (int r = threadIdx.x; r < kRT; r += blockDim.x) {
      float x[3], w[3];
      for (int j = 0; j < 3; ++j) x[j] = X[j * kRT + r];
      mlp::head_apply(O + r * kHeadLd, a.use_quat, x, w);
      for (int j = 0; j < 3; ++j) out[j * kRT + r] = w[j];
    }
    __syncthreads();
    if constexpr (kForward) {   // the output of this stage, if any
      int slot = -1;
      if (si == 0) slot = 0;
      else if (a.chain_local && si == 1) slot = 1;
      else if (a.chain_global && si == a.n_stages - 1) slot = 2;
      if (slot >= 0)
        for (int i = threadIdx.x; i < 3 * kRT; i += blockDim.x) {
          const int64_t gi = row0 + i % kRT;
          if (gi < a.rows) a.out[slot][(i / kRT) * a.rows + gi] = out[i];
        }
    }
  }
}

// (a) the forward recompute of one 128-row tile, every stage
template <typename T>
__global__ void __launch_bounds__(kRTThreads, 1) chain_fwd_pass(const CB a) {
  extern __shared__ __align__(16) unsigned char smem[];
  chain_tile<T, false>(a, smem);
}

// kernel #5: the chain's forward of one 128-row tile
template <typename T>
__global__ void __launch_bounds__(kRTThreads, 1)
chain_fwd_kernel(const CB a) {
  extern __shared__ __align__(16) unsigned char smem[];
  chain_tile<T, true>(a, smem);
}

// #4's pass (a): chain_fwd_pass on one stage
template <typename T>
__global__ void __launch_bounds__(kRTThreads, 1) nof_fwd_pass(const CB a) {
  extern __shared__ __align__(16) unsigned char smem[];
  chain_tile<T, false>(a, smem);
}

// kernel #3: chain_fwd_kernel on one stage
template <typename T>
__global__ void __launch_bounds__(kRTThreads, 1) nof_fwd_kernel(const CB a) {
  extern __shared__ __align__(16) unsigned char smem[];
  chain_tile<T, true>(a, smem);
}

template <typename T>
__device__ __forceinline__ void masked(T* dst, const T* act, float u0,
                                       float u1) {
  const float2 m = ld2(act);
  st2(dst, m.x > 0.f ? u0 : 0.f, m.y > 0.f ? u1 : 0.f);
}

// (b) the backward walk of one 128-row tile through the stages in reverse
template <typename T>
__device__ __forceinline__ void chain_walk(const CB& a, unsigned char* smem) {
  const int W = a.width, kp = 3 + 2 * a.kc, D = a.depth;
  const int e_ld = tile_ld<T>(kp), h_ld = tile_ld<T>(W), de_ld = pad16(kp);
  float* X = reinterpret_cast<float*>(smem);      // [3][kRT] stage input
  float* Gc = X + 3 * kRT;                         // [3][kRT] d(cano)
  float* Gt = Gc + 3 * kRT;
  float* Gu = Gt + 3 * kRT;
  float* de = Gu + 3 * kRT;                        // [kRT][de_ld]
  T* Ws = reinterpret_cast<T*>(de + kRT * de_ld);
  T* E = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(Ws) +
                              stage_bytes<T>());   // [kRT][e_ld] d9
  T* H = E + kRT * e_ld;                           // [kRT][h_ld] dz
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRT;
  auto load_g = [&](float* G, const float* src) {
    for (int i = threadIdx.x; i < 3 * kRT; i += blockDim.x) {
      const int64_t gi = row0 + i % kRT;
      G[i] = gi < a.rows ? src[(i / kRT) * a.rows + gi] : 0.f;
    }
    __syncthreads();
  };
  // the VJP of stage si: cotangent G of its output -> dX of its input
  auto vjp = [&](int si, const float* G, float* dX) {
    const CNet& n = a.net[a.stage_net[si]];
    const float* xs = at<float>(a, a.lay.x[si]);
    const float* os = at<float>(a, a.lay.o[si]);
    float* dout = at<float>(a, a.lay.dout[si]);
    for (int r = threadIdx.x; r < kRT; r += blockDim.x) {
      const int64_t gr = row0 + r;
      float o[kHeadLd], x[3], g[3], d[9], dx[3];
      for (int q = 0; q < kHeadLd; ++q) o[q] = os[gr * kHeadLd + q];
      for (int j = 0; j < 3; ++j) {
        x[j] = xs[gr * 4 + j];
        g[j] = G[j * kRT + r];
        X[j * kRT + r] = x[j];
      }
      mlp::head_vjp(o, a.use_quat, x, g, d, dx);
      for (int j = 0; j < 3; ++j) dX[j * kRT + r] = dx[j];
      for (int q = 0; q < kHeadLd; ++q) {
        const float v = q < a.n_out ? d[q] : 0.f;
        dout[gr * kHeadLd + q] = v;
        E[r * e_ld + q] = from_f<T>(v);
      }
    }
    __syncthreads();
    rt_store(at<T>(a, a.lay.d9[si]), kHeadLd, row0, E, e_ld, kHeadLd);
    const T* a_last = at<T>(a, a.lay.act[si][D - 1]);
    rt_mm(Ws, Term<T>{E, e_ld, static_cast<const T*>(n.head.b), a.n_out},
          no_term<T>(), W, [&](int r, int c, float v0, float v1) {
            masked(H + r * h_ld + c, a_last + (row0 + r) * W + c, v0, v1);
          });
    rt_store(at<T>(a, a.lay.dz[si][D - 1]), W, row0, H, h_ld, W);
    bool de_set = false;
    for (int l = D - 1; l >= 0; --l) {
      const RLayer& L = n.layer[l];
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
        const T* ap = at<T>(a, a.lay.act[si][l - 1]);
        rt_mm(Ws, Term<T>{H, h_ld, static_cast<const T*>(L.h_b), W},
              no_term<T>(), W, [&](int r, int c, float v0, float v1) {
                masked(H + r * h_ld + c, ap + (row0 + r) * W + c, v0, v1);
              });
        rt_store(at<T>(a, a.lay.dz[si][l - 1]), W, row0, H, h_ld, W);
      }
    }
    rt_pe_backward(dX, de, de_ld, X, a.bands, a.kc);
  };
  auto add_into_gc = [&]() {
    for (int i = threadIdx.x; i < 3 * kRT; i += blockDim.x)
      Gc[i] = __fadd_rn(Gc[i], Gu[i]);
    __syncthreads();
  };
  // The stages in the order of _chain_bwd_tile: the global chain's three
  // (glob0 + 2 down to glob0, from its cotangent in Gt, then to and fro
  // between Gt and Gu), the local chain's one (stage 1, from Gt), each
  // chain's input cotangent added into d(cano), then stage 0 from Gc. One
  // call site, so the walk is compiled once: five inlined copies left ptxas
  // short of registers (spills in both builds).
  load_g(Gc, a.gin[0]);
  const int glob0 = a.chain_local ? 2 : 1;
  for (int k = 0; k < a.n_stages; ++k) {
    const bool global = a.chain_global && k < 3;
    const int si = global ? glob0 + 2 - k : (k + 1 < a.n_stages ? 1 : 0);
    if (si != 0 && (!global || k == 0)) load_g(Gt, a.gin[global ? 2 : 1]);
    const bool back = global && k == 1;    // from Gu into Gt
    vjp(si, si == 0 ? Gc : (back ? Gu : Gt), back ? Gt : Gu);
    if (si != 0 && (!global || si == glob0)) add_into_gc();
  }
  for (int i = threadIdx.x; i < 3 * kRT; i += blockDim.x) {
    const int64_t gi = row0 + i % kRT;
    if (gi < a.rows) a.dx[(i / kRT) * a.rows + gi] = Gu[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kRTThreads, 1) chain_walk_pass(const CB a) {
  extern __shared__ __align__(16) unsigned char smem[];
  chain_walk<T>(a, smem);
}

// #4's pass (b): chain_walk_pass on one stage
template <typename T>
__global__ void __launch_bounds__(kRTThreads, 1) nof_walk_pass(const CB a) {
  extern __shared__ __align__(16) unsigned char smem[];
  chain_walk<T>(a, smem);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Arguments (int64): dtype (0 fp32, 1 bf16), n_rays, S, n_stages, use_quat,
// chain_local, chain_global, n_pe, depth, width, kc, n_out, split_rows,
// split0, total; stage_net[5], stage_set[5], in_src[5]; bands, xyz,
// gin[3] (the cotangents of cano, recon, chain_recon, or for #5 the
// outputs; 0 where absent), dx, part, scratch;
// parts[4][4]; dparts_out[4][4] (each (n_rays, W), or 0); the bw and fw
// nets as 8 layers of (pe_f, pe_b, h_f, h_b, bias, g_pe, g_h, g_b) and the
// head (f, b, bias, g_w, g_b) (row_tile.cuh operands, gradient offsets).
constexpr int kNetArgs = 8 * kMaxDepth + 5;
constexpr int kArgs = 15 + 3 * kMaxStages + 8 + 2 * kMaxSets * kMaxPe +
                      2 * kNetArgs;

struct Decoded {
  CB a;
  int split_rows;
  int64_t split0, total;
  int64_t g_pe[2][kMaxDepth], g_h[2][kMaxDepth], g_b[2][kMaxDepth];
  int64_t g_hw[2], g_hb[2];
  float* part;
  float* dparts[kMaxSets][kMaxPe];
};

const void* P(int64_t v) { return reinterpret_cast<const void*>(v); }

int decode(const int64_t* p, int n, Decoded* d) {
  if (n != kArgs) return -1;
  CB& a = d->a;
  a.bf16 = static_cast<int>(p[0]);
  a.n_rays = p[1];
  a.s = p[2];
  a.n_stages = static_cast<int>(p[3]);
  a.use_quat = static_cast<int>(p[4]);
  a.chain_local = static_cast<int>(p[5]);
  a.chain_global = static_cast<int>(p[6]);
  a.n_pe = static_cast<int>(p[7]);
  a.depth = static_cast<int>(p[8]);
  a.width = static_cast<int>(p[9]);
  a.kc = static_cast<int>(p[10]);
  a.n_out = static_cast<int>(p[11]);
  d->split_rows = static_cast<int>(p[12]);
  d->split0 = p[13];
  d->total = p[14];
  const int64_t* q = p + 15;
  for (int i = 0; i < kMaxStages; ++i) a.stage_net[i] = static_cast<int>(q[i]);
  for (int i = 0; i < kMaxStages; ++i)
    a.stage_set[i] = static_cast<int>(q[kMaxStages + i]);
  for (int i = 0; i < kMaxStages; ++i)
    a.in_src[i] = static_cast<int>(q[2 * kMaxStages + i]);
  q += 3 * kMaxStages;
  a.bands = static_cast<const float*>(P(q[0]));
  a.xyz = static_cast<const float*>(P(q[1]));
  for (int k = 0; k < 3; ++k) {
    a.gin[k] = static_cast<const float*>(P(q[2 + k]));
    a.out[k] = reinterpret_cast<float*>(q[2 + k]);
  }
  a.dx = reinterpret_cast<float*>(q[5]);
  d->part = reinterpret_cast<float*>(q[6]);
  a.scratch = reinterpret_cast<unsigned char*>(q[7]);
  q += 8;
  for (int k = 0; k < kMaxSets; ++k)
    for (int j = 0; j < kMaxPe; ++j)
      a.parts[k][j] = static_cast<const float*>(P(*q++));
  for (int k = 0; k < kMaxSets; ++k)
    for (int j = 0; j < kMaxPe; ++j) d->dparts[k][j] = reinterpret_cast<float*>(*q++);
  for (int net = 0; net < 2; ++net) {
    CNet& cn = a.net[net];
    for (int l = 0; l < kMaxDepth; ++l, q += 8) {
      cn.layer[l] = RLayer{P(q[0]), P(q[1]), P(q[2]), P(q[3]),
                           static_cast<const float*>(P(q[4]))};
      d->g_pe[net][l] = q[5];
      d->g_h[net][l] = q[6];
      d->g_b[net][l] = q[7];
    }
    cn.head = RMat{P(q[0]), P(q[1]), static_cast<const float*>(P(q[2]))};
    d->g_hw[net] = q[3];
    d->g_hb[net] = q[4];
    q += 5;
  }
  if (a.depth < 1 || a.depth > kMaxDepth || a.width < 32 ||
      a.width > kMaxWidth || a.width % 32 || a.kc < 3 || a.kc % 3 ||
      a.n_out < 1 || a.n_out > 9 || a.n_stages < 1 ||
      a.n_stages > kMaxStages || a.n_pe < 1 || a.n_pe > kMaxPe)
    return -2;
  for (int i = 0; i < a.n_stages; ++i)
    if (a.stage_net[i] < 0 || a.stage_net[i] > 1 || a.stage_set[i] < 0 ||
        a.stage_set[i] >= kMaxSets || (i > 0 && (a.in_src[i] < 0 ||
                                                 a.in_src[i] >= i)))
      return -2;
  if (d->split_rows <= 0 || d->split_rows % kRT) return -4;
  a.rows = a.n_rays * a.s;
  a.rp = (a.rows + kRT - 1) / kRT * kRT;
  a.lay = layout(a);
  return 0;
}

// the gradient jobs of pass (c)
void jobs(const Decoded& d, wg::Call* mat, wg::Call* col, wg::SegCall* seg) {
  const CB& a = d.a;
  const int W = a.width, kp = 3 + 2 * a.kc, D = a.depth;
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
  for (int net = 0; net < 2; ++net) {
    if (!a.net[net].head.f) continue;  // #4 passes no fw net
    int st[kMaxStages], ns = 0;        // the stages of this net, in order
    for (int si = 0; si < a.n_stages; ++si)
      if (a.stage_net[si] == net) st[ns++] = si;
    auto mjob = [&](int m, int n, int lda, int ldd, const int64_t* A,
                    const int64_t* Dm, int64_t out) {
      wg::Job j{};
      j.m = m;
      j.n = n;
      j.lda = lda;
      j.ldd = ldd;
      j.n_pieces = ns;
      for (int k = 0; k < ns; ++k) {
        j.a[k] = s + A[st[k]];
        j.d[k] = s + Dm[st[k]];
      }
      j.out = out;
      mat->job[mat->n_jobs++] = j;
    };
    auto cjob = [&](int n, int ldd, const int64_t* Dm, int d_f32,
                    int64_t out) {
      wg::Job j{};
      j.m = 1;
      j.n = n;
      j.ldd = ldd;
      j.n_pieces = ns;
      j.d_f32 = d_f32;
      for (int k = 0; k < ns; ++k) j.d[k] = s + Dm[st[k]];
      j.out = out;
      col->job[col->n_jobs++] = j;
    };
    int64_t act[kMaxDepth][kMaxStages], dz[kMaxDepth][kMaxStages];
    for (int i = 0; i < D; ++i)
      for (int si = 0; si < a.n_stages; ++si) {
        act[i][si] = l.act[si][i];
        dz[i][si] = l.dz[si][i];
      }
    for (int i = 0; i < D; ++i) {
      const RLayer& L = a.net[net].layer[i];
      if (L.pe_f) mjob(kp, W, pad16(kp), W, l.e, dz[i], d.g_pe[net][i]);
      if (L.h_f) mjob(W, W, W, W, act[i - 1], dz[i], d.g_h[net][i]);
      cjob(W, W, dz[i], 0, d.g_b[net][i]);
    }
    mjob(W, a.n_out, W, kHeadLd, act[D - 1], l.d9, d.g_hw[net]);
    cjob(a.n_out, kHeadLd, l.dout, 1, d.g_hb[net]);
  }
  seg->bf16 = a.bf16;
  seg->n_rays = a.n_rays;
  seg->s = a.s;
  seg->n_jobs = 0;
  int pe_layer[kMaxPe], npe = 0;
  for (int i = 0; i < D && npe < kMaxPe; ++i)
    if (a.net[0].layer[i].pe_f) pe_layer[npe++] = i;
  for (int set = 0; set < kMaxSets; ++set)
    for (int j = 0; j < npe; ++j) {
      if (!d.dparts[set][j]) continue;
      wg::SegJob& sj = seg->job[seg->n_jobs++];
      sj = wg::SegJob{};
      sj.n = W;
      sj.ld = W;
      sj.out = d.dparts[set][j];
      for (int si = 0; si < a.n_stages; ++si)
        if (a.stage_set[si] == set) sj.d[sj.n_pieces++] = s + l.dz[si][pe_layer[j]];
    }
}

template <typename T>
int run_passes(const CB& a, bool nof, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(a.rp / kRT);
  int rc = launch(nof ? nof_fwd_pass<T> : chain_fwd_pass<T>,
                  fwd_smem<T>(a), blocks, kRTThreads, s, a);
  if (rc) return rc;
  return launch(nof ? nof_walk_pass<T> : chain_walk_pass<T>, walk_smem<T>(a),
                blocks, kRTThreads, s, a);
}

// #3 / #4 take the chain's arguments with one stage, bw@ind (set 0, net 0)
int decode_nof(const int64_t* p, int n, Decoded* d) {
  const int rc = decode(p, n, d);
  if (rc) return rc;
  const CB& a = d->a;
  return a.n_stages == 1 && !a.chain_local && !a.chain_global &&
                 a.stage_net[0] == 0 && a.stage_set[0] == 0
             ? 0
             : -2;
}

// passes (a), (b), (c) of one chunk of whole rays (#4 or #6)
int run_backward(const Decoded& d, bool nof, cudaStream_t s) {
  if (d.a.rows <= 0) return 0;
  int rc = d.a.bf16 ? run_passes<bf16>(d.a, nof, s)
                    : run_passes<float>(d.a, nof, s);
  if (rc) return rc;
  wg::Call mat, col;
  wg::SegCall seg;
  jobs(d, &mat, &col, &seg);
  if ((rc = wg::matrix_launch(mat, s))) return rc;
  if ((rc = wg::colsum_launch(col, s))) return rc;
  return wg::segsum_launch(seg, s);
}

// the forward of all stages (#3 or #5)
int run_forward(const CB& a, bool nof, cudaStream_t s) {
  if (a.rows <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>(a.rp / kRT);
  if (a.bf16)
    return launch(nof ? nof_fwd_kernel<bf16> : chain_fwd_kernel<bf16>,
                  fwd_smem<bf16>(a), blocks, kRTThreads, s, a);
  return launch(nof ? nof_fwd_kernel<float> : chain_fwd_kernel<float>,
                fwd_smem<float>(a), blocks, kRTThreads, s, a);
}

}  // namespace

// Scratch bytes for the rows of these arguments (rows padded to 128), or
// < 0 on bad arguments.
extern "C" int64_t chain_bwd_scratch_bytes(const int64_t* p, int n) {
  Decoded d;
  const int rc = decode(p, n, &d);
  return rc ? rc : d.a.lay.end;
}

// One chunk of whole rays: passes (a), (b), (c); weight and bias gradients
// to the chunk's rows of `part` (summed by wgrad_reduce once every chunk is
// done), partial gradients to dparts_out, dxyz to dx.
extern "C" int chain_bwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  const int rc = decode(p, n, &d);
  return rc ? rc
            : run_backward(d, false, static_cast<cudaStream_t>(stream));
}

// Kernel #5 on the arguments of chain_bwd_launch: the three cotangent
// slots hold the outputs (cano, recon, chain_recon; 0 where absent), and
// the backward's pointers (dx, part, scratch, d(partials), the transposed
// operands) may be 0.
extern "C" int chain_fwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  const int rc = decode(p, n, &d);
  return rc ? rc
            : run_forward(d.a, false, static_cast<cudaStream_t>(stream));
}

// Kernel #4 (the single warp's backward): chain_bwd_scratch_bytes and
// chain_bwd_launch on arguments with one stage, bw@ind, and the fw net's
// operands 0.
extern "C" int64_t nof_bwd_scratch_bytes(const int64_t* p, int n) {
  Decoded d;
  const int rc = decode_nof(p, n, &d);
  return rc ? rc : d.a.lay.end;
}

extern "C" int nof_bwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  const int rc = decode_nof(p, n, &d);
  return rc ? rc
            : run_backward(d, true, static_cast<cudaStream_t>(stream));
}

// Kernel #3 (the single warp's forward): chain_fwd_launch on the same
// one-stage arguments.
extern "C" int nof_fwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  const int rc = decode_nof(p, n, &d);
  return rc ? rc
            : run_forward(d.a, true, static_cast<cudaStream_t>(stream));
}

extern "C" const char* chain_bwd_error(int code) {
  switch (code) {
    case -1: return "wrong argument count";
    case -2: return "unsupported chain or network shape (depth 1..8, width "
                    "a multiple of 32 up to 256, head 1..9 outputs)";
    case -3: return "a tile exceeds the 227 KB of shared memory";
    case -4: return "bad split rows or gradient jobs";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
