// Test-time render pass for Hopper (sm_90a): rays + depths in, dense sigma
// and rgb out, with the optional bw-NoF warp and the whole NeRF in between.
//
// Replaces the TPU kernel moco_flow_tpu/ops/megakernel.py::_pass_call (via
// render_pass_fused). Per sample it computes xyz = o + d*z, the NoF warp
// (packed PE [x; sin; cos], a ReLU trunk with per-ray frame partials at
// layer 0 and the skip layer, the log-quaternion head), then the NeRF in the
// order of _nerf_tile (trunk, sigma head, final, extra + per-ray partial,
// sigmoid rgb head), and writes sigma (N, S) and rgb (3, N, S), fp32.
//
// What bounds it on this card: compute. At full width (NeRF 8x256, NoF
// 4x128) a fine sample costs about 0.65M multiply-adds (0.59M in the NeRF,
// 0.06M in the NoF), about 1.3 MFLOP, against 4 bytes of depth read and
// 16 bytes of sigma + rgb written: ~65,000 FLOP per byte of device memory,
// far above the ~295 FLOP/byte at which the card stops being memory-bound.
//
// What the design does about it: no activation ever goes to device memory.
// A block carries a tile of 128 consecutive (ray, sample) rows through all
// ~13 layers with the activations in shared memory, updated in place layer
// by layer; the weights (~1.2 MB in bf16) stay resident in the 50 MB L2 and
// stream through in slices. Rays are never padded: rows past N*S are
// computed on zeros and never stored.
//   bf16: the warp-specialised wgmma tile (wg_tile.cuh): a producer
//     warpgroup bulk-copies the weight slices, packed by the wrapper into
//     their shared-memory image, through a ring of stages; two consumer
//     warpgroups of 64 rows each run every layer on the tensor cores at
//     full rate, with the sigma dot fused into the last trunk layer.
//   fp32: the split-TF32 product of row_tile.cuh (rt_mm with fp32 staging,
//     the training forwards #1 / #5's): 512 threads on the 128-row tile,
//     three TF32 products a term on the tensor cores, fp32 accumulation;
//     the NoF stages as #5's, the NeRF as #1's, the sigma row an fp32 dot.
//
// Rounding points follow _nerf_tile/_nof_tile: the PE embedding, hidden
// activations and the output of `final` are stored in the storage type;
// biases, per-ray partials, heads and the quaternion transform are fp32.
// Elementwise steps use explicitly rounded intrinsics (__fmul_rn,
// __fadd_rn) so nvcc cannot fuse them into FMAs: the plain PyTorch version
// rounds after every operation, and a 1-ulp change in a warped position
// grows 512-fold through the top PE band. sinf/cosf are full precision (no
// --use_fast_math).

#include "row_tile.cuh"
#include "wg_tile.cuh"

namespace {

constexpr int kMaxLayers = 16;

struct Layer {
  const void* wpe;        // packed PE rows (3+2kc, W), or null
  const void* wh;         // hidden rows (W_in, W), or null
  const float* b;         // (W,)
  const float* partial;   // (N_rays, W) per-ray partial, or null
};

struct Net {
  int depth, width, kc;   // kc = width of the sin block (3 * n_freqs)
  const float* bands;     // kc / 3 frequencies
  Layer layer[kMaxLayers];
  const void* h[12];      // heads, see render_pass_launch
};

struct Args {
  int64_t n_rays, s;
  int sigma_only, has_nof, use_quat;
  const float* od;        // (N, 6) origin | direction
  const float* z;         // (N, S)
  float* sigma;           // (N, S)
  float* rgb;             // (3, N, S) or null
  Net nof, nerf;
};

// X [3][rows] <- xyz = o + d*z of the rows [lo, hi) of the tile from row0
// (od (N, 6), z (N, S))
__device__ __forceinline__ void fill_x(const float* od_all, const float* zs,
                                       int64_t n_rays, int64_t s, float* X,
                                       int rows, int64_t row0, int lo, int hi,
                                       int tid, int nt) {
  const int64_t total = n_rays * s;
  for (int i = lo + tid; i < hi; i += nt) {
    const int64_t g = row0 + i;
    const float* od = od_all + (g < total ? g / s : 0) * 6;
    const float z = g < total ? zs[g] : 0.f;
    for (int j = 0; j < 3; ++j)
      X[j * rows + i] =
          g < total ? __fadd_rn(od[j], __fmul_rn(od[3 + j], z)) : 0.f;
  }
}

// ===========================================================================
// bf16: the wgmma tile
// ===========================================================================

struct WgArgs {
  int64_t n_rays, s;
  int has_nof, use_quat, nof_kc, nerf_kc;
  const float* od;
  const float* z;
  const float* nof_bands;
  const float* nerf_bands;
  const float* wsig;      // (W,) fp32
  const float* bsig;
  float* sigma;
  float* rgb;
  int n_layers, n_nof, stages, h_blocks, e_blocks;
  wg::Layer layers[wg::kMaxLayers];
};

constexpr size_t kWgTail = (3 + wg::kHeadLd) * wg::kRows * sizeof(float);

__global__ void __launch_bounds__(wg::kThreads, 1)
render_pass_wg_kernel(const __grid_constant__ WgArgs w) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  wg::Ctx c;
  wg::setup(c, wg_smem, w.stages, w.h_blocks, w.e_blocks, kWgTail);
  const int64_t n_tiles = (w.n_rays * w.s + wg::kRows - 1) / wg::kRows;
  if (threadIdx.x < 128) {
    wg::producer(c, w.layers, w.n_layers, n_tiles);
  } else {
    wg::consumer(c, w.h_blocks, w.e_blocks);
    c.total = static_cast<int>(w.n_rays * w.s);
    c.s = static_cast<int>(w.s);
    c.sigma = w.sigma;
    c.sig_rs = 1;
    c.rgb = w.rgb;
    c.rgb_cs = c.total;
    c.rgb_rs = 1;
    c.wsig = w.wsig;
    c.bsig = w.bsig;
    const int r0 = 64 * c.wgi;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      c.row0 = static_cast<int>(tile * wg::kRows);
      fill_x(w.od, w.z, w.n_rays, w.s, c.X, wg::kRows, c.row0, r0, r0 + 64,
             c.tid, 128);
      wg::wg_sync(c.wgi);
      if (w.has_nof) wg::pe_fill(c, w.nof_bands, w.nof_kc);
      else wg::pe_fill(c, w.nerf_bands, w.nerf_kc);
      for (int l = 0; l < w.n_layers; ++l) {
        if (w.has_nof && l == w.n_nof) {   // the warp, then the NeRF's PE
          if (c.tid < 64) {
            const int r = r0 + c.tid;
            float x[3];
            for (int j = 0; j < 3; ++j) x[j] = c.X[j * wg::kRows + r];
            nof_head_apply(c.O + r * wg::kHeadLd, w.use_quat, x);
            for (int j = 0; j < 3; ++j) c.X[j * wg::kRows + r] = x[j];
          }
          wg::wg_sync(c.wgi);
          wg::pe_fill(c, w.nerf_bands, w.nerf_kc);
        }
        wg::run(c, w.layers[l]);
      }
    }
  }
}

// ===========================================================================
// fp32: the split-TF32 product
// ===========================================================================

__global__ void __launch_bounds__(kRTThreads, 1)
render_pass_tf32_kernel(const Args a, int e_ld, int h_ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);   // [3][kRT] positions
  float* O = X + 3 * kRT;                      // [kRT][kMaxHeadOut]
  float* Ws = O + kRT * kMaxHeadOut;           // the staged weight slices
  float* E = Ws + 2 * kKs * kWsLdF;            // [kRT][e_ld]
  float* H = E + kRT * e_ld;                   // [kRT][h_ld]
  const int64_t total = a.n_rays * a.s;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRT;
  auto ray_of = [&](int r) {
    const int64_t g = row0 + r;
    return (g < total ? g : total - 1) / a.s;
  };
  fill_x(a.od, a.z, a.n_rays, a.s, X, kRT, row0, 0, kRT, threadIdx.x,
         kRTThreads);
  __syncthreads();
  if (a.has_nof) {   // #5's bw stage
    const Net& n = a.nof;
    const int W = n.width, kp = 3 + 2 * n.kc;
    rt_pe_fill<float>(E, e_ld, X, n.bands, n.kc);
    for (int l = 0; l < n.depth; ++l) {
      const Layer& L = n.layer[l];
      rt_mm(Ws,
            Term<float>{E, e_ld, static_cast<const float*>(L.wpe),
                        L.wpe ? kp : 0},
            Term<float>{H, h_ld, static_cast<const float*>(L.wh),
                        L.wh ? W : 0},
            W, [&](int r, int c, float v0, float v1) {
              float z[2] = {v0, v1};
              if (L.partial)
                for (int e = 0; e < 2; ++e)
                  z[e] = __fadd_rn(z[e], L.partial[ray_of(r) * W + c + e]);
              st2(H + r * h_ld + c, fmaxf(__fadd_rn(z[0], L.b[c]), 0.f),
                  fmaxf(__fadd_rn(z[1], L.b[c + 1]), 0.f));
            });
    }
    const int n_out = static_cast<int>(reinterpret_cast<intptr_t>(n.h[2]));
    const float* hb = static_cast<const float*>(n.h[1]);
    rt_mm(Ws, Term<float>{H, h_ld, static_cast<const float*>(n.h[0]), W},
          no_term<float>(), n_out, [&](int r, int c, float v0, float v1) {
            O[r * kMaxHeadOut + c] = __fadd_rn(v0, hb[c]);
            if (c + 1 < n_out)
              O[r * kMaxHeadOut + c + 1] = __fadd_rn(v1, hb[c + 1]);
          });
    for (int r = threadIdx.x; r < kRT; r += kRTThreads) {
      float x[3];
      for (int j = 0; j < 3; ++j) x[j] = X[j * kRT + r];
      nof_head_apply(O + r * kMaxHeadOut, a.use_quat, x);
      for (int j = 0; j < 3; ++j) X[j * kRT + r] = x[j];
    }
    __syncthreads();
  }
  // #1's NeRF
  const Net& n = a.nerf;
  const int W = n.width, W2 = W / 2, kp = 3 + 2 * n.kc;
  rt_pe_fill<float>(E, e_ld, X, n.bands, n.kc);
  for (int l = 0; l < n.depth; ++l) {
    const Layer& L = n.layer[l];
    rt_mm(Ws,
          Term<float>{E, e_ld, static_cast<const float*>(L.wpe),
                      L.wpe ? kp : 0},
          Term<float>{H, h_ld, static_cast<const float*>(L.wh),
                      L.wh ? W : 0},
          W, [&](int r, int c, float v0, float v1) {
            st2(H + r * h_ld + c, fmaxf(__fadd_rn(v0, L.b[c]), 0.f),
                fmaxf(__fadd_rn(v1, L.b[c + 1]), 0.f));
          });
  }
  {  // sigma = h . wsig + bsig in fp32, four threads a row; `final`
     // overwrites H only after the barriers of its product
    const float* wsig = static_cast<const float*>(n.h[0]);
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    float acc = 0.f;
    for (int c = q; c < W; c += 4) acc = fmaf(H[r * h_ld + c], wsig[c], acc);
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
    const int64_t gi = row0 + r;
    if (q == 0 && gi < total)
      a.sigma[gi] = __fadd_rn(acc, static_cast<const float*>(n.h[1])[0]);
  }
  if (a.sigma_only) return;
  const float* bf = static_cast<const float*>(n.h[3]);
  rt_mm(Ws, Term<float>{H, h_ld, static_cast<const float*>(n.h[2]), W},
        no_term<float>(), W, [&](int r, int c, float v0, float v1) {
          st2(H + r * h_ld + c, __fadd_rn(v0, bf[c]),
              __fadd_rn(v1, bf[c + 1]));
        });
  const float* be = static_cast<const float*>(n.h[5]);
  const float* pe = static_cast<const float*>(n.h[6]);
  rt_mm(Ws, Term<float>{H, h_ld, static_cast<const float*>(n.h[4]), W},
        no_term<float>(), W2, [&](int r, int c, float v0, float v1) {
          float z[2] = {__fadd_rn(v0, be[c]), __fadd_rn(v1, be[c + 1])};
          if (pe)
            for (int e = 0; e < 2; ++e)
              z[e] = __fadd_rn(z[e], pe[ray_of(r) * W2 + c + e]);
          st2(H + r * h_ld + c, fmaxf(z[0], 0.f), fmaxf(z[1], 0.f));
        });
  const float* br = static_cast<const float*>(n.h[8]);
  rt_mm(Ws, Term<float>{H, h_ld, static_cast<const float*>(n.h[7]), W2},
        no_term<float>(), 3, [&](int r, int c, float v0, float v1) {
          const int64_t gi = row0 + r;
          const float v[2] = {v0, v1};
          for (int e = 0; e < 2 && c + e < 3 && gi < total; ++e)
            a.rgb[(c + e) * total + gi] = sigmoid(__fadd_rn(v[e], br[c + e]));
        });
}

// ===========================================================================
// Host side
// ===========================================================================

const void* P(int64_t v) { return reinterpret_cast<const void*>(v); }

// Net block layout (80 int64): depth, width, kc, bands,
// 16 x (wpe, wh, b, partial), 12 head slots.
void decode_net(const int64_t* p, Net* n) {
  n->depth = static_cast<int>(p[0]);
  n->width = static_cast<int>(p[1]);
  n->kc = static_cast<int>(p[2]);
  n->bands = static_cast<const float*>(P(p[3]));
  for (int l = 0; l < kMaxLayers; ++l) {
    const int64_t* q = p + 4 + 4 * l;
    n->layer[l] = Layer{P(q[0]), P(q[1]), static_cast<const float*>(P(q[2])),
                        static_cast<const float*>(P(q[3]))};
  }
  for (int i = 0; i < 12; ++i) n->h[i] = P(p[4 + 4 * kMaxLayers + i]);
}

const bf16* B(const void* p) { return static_cast<const bf16*>(p); }

// a wg::Layer of one or two terms (img, src: 0 E / 1 H, k)
wg::Layer wg_layer(const bf16* i0, int s0, int k0, const bf16* i1, int s1,
                   int k1, int n, int ep, const float* bias,
                   const float* partial) {
  wg::Layer L{};
  L.img[0] = i0;
  L.src[0] = s0;
  L.k[0] = i0 ? k0 : 0;
  L.img[1] = i1;
  L.src[1] = s1;
  L.k[1] = i1 ? k1 : 0;
  L.n = n;
  L.n_pad = wg::width_of(n);
  L.ep = ep;
  L.bias = bias;
  L.partial = partial;
  return L;
}

int launch_wg(const Args& a, cudaStream_t s) {
  if (a.n_rays * a.s > wg::kMaxRows) return -2;
  WgArgs w{};
  w.n_rays = a.n_rays;
  w.s = a.s;
  w.has_nof = a.has_nof;
  w.use_quat = a.use_quat;
  w.nof_kc = a.nof.kc;
  w.nerf_kc = a.nerf.kc;
  w.od = a.od;
  w.z = a.z;
  w.nof_bands = a.nof.bands;
  w.nerf_bands = a.nerf.bands;
  w.wsig = static_cast<const float*>(a.nerf.h[0]);
  w.bsig = static_cast<const float*>(a.nerf.h[1]);
  w.sigma = a.sigma;
  w.rgb = a.rgb;
  int n = 0, h_max = 0, k_e = 0;
  auto add = [&](const wg::Layer& L) {
    w.layers[n++] = L;
    if (L.ep == wg::kRelu || L.ep == wg::kReluBiasFirst || L.ep == wg::kLinear)
      h_max = L.n_pad > h_max ? L.n_pad : h_max;
  };
  auto trunk = [&](const Net& m, bool partials) {
    const int kp = 3 + 2 * m.kc;
    k_e = kp > k_e ? kp : k_e;
    for (int l = 0; l < m.depth; ++l) {
      const Layer& L = m.layer[l];
      add(wg_layer(B(L.wpe), 0, kp, B(L.wh), 1, m.width, m.width, wg::kRelu,
                   L.b, partials ? L.partial : nullptr));
    }
  };
  if (a.has_nof) {
    const Net& m = a.nof;
    trunk(m, true);
    const int n_out = static_cast<int>(reinterpret_cast<intptr_t>(m.h[2]));
    add(wg_layer(B(m.h[0]), 1, m.width, nullptr, 0, 0, n_out, wg::kHeadO,
                 static_cast<const float*>(m.h[1]), nullptr));
    w.n_nof = n;   // the NoF's trunk and head come first
  }
  const Net& m = a.nerf;
  const int W = m.width;
  trunk(m, false);
  w.layers[n - 1].sigma = 1;
  if (!a.sigma_only) {
    add(wg_layer(B(m.h[2]), 1, W, nullptr, 0, 0, W, wg::kLinear,
                 static_cast<const float*>(m.h[3]), nullptr));
    add(wg_layer(B(m.h[4]), 1, W, nullptr, 0, 0, W / 2, wg::kReluBiasFirst,
                 static_cast<const float*>(m.h[5]),
                 static_cast<const float*>(m.h[6])));
    add(wg_layer(B(m.h[7]), 1, W / 2, nullptr, 0, 0, 3, wg::kRgb,
                 static_cast<const float*>(m.h[8]), nullptr));
  }
  w.n_layers = n;
  w.h_blocks = (h_max + 63) / 64;
  w.e_blocks = (k_e + 63) / 64;
  const size_t fixed = wg::smem_bytes(0, w.h_blocks, w.e_blocks, kWgTail);
  w.stages = static_cast<int>((kMaxSmem - fixed) / wg::kStageBytes);
  if (w.stages > wg::kMaxStages) w.stages = wg::kMaxStages;
  if (w.stages < 2) return -3;
  const int64_t total = a.n_rays * a.s;
  return launch(render_pass_wg_kernel,
                wg::smem_bytes(w.stages, w.h_blocks, w.e_blocks, kWgTail),
                wg::grid_of((total + wg::kRows - 1) / wg::kRows),
                wg::kThreads, s, w);
}

}  // namespace

// args (170 int64): dtype (0 float, 1 bf16), n_rays, S, sigma_only,
// has_nof, use_quat, od, z, sigma, rgb; then the NoF and the NeRF net
// blocks. NoF head slots: w_head (W, 9|3), b_head, head_out.
// NeRF head slots: w_sigma (W,) fp32, b_sigma, w_final, b_final, w_extra
// (W, W/2), b_extra, p_extra (N, W/2) or 0, w_rgb (W/2, 3), b_rgb.
// Matrices (K, N): in fp32 the row-tile layout of row_tile.cuh, (K,
// pad16(N)) zero-padded; in bf16 wg_tile.cuh's slice images (ops/_args.py
// wg_pack). Biases, partials and the sigma row are fp32 and unpadded.
// Returns 0, a cudaError_t, or -1 bad arg count, -2 bad shape, -3 too
// much shared memory.
extern "C" int render_pass_launch(const int64_t* p, int n, void* stream) {
  if (n != 10 + 2 * (4 + 4 * kMaxLayers + 12)) return -1;
  Args a;
  const int dtype = static_cast<int>(p[0]);
  a.n_rays = p[1];
  a.s = p[2];
  a.sigma_only = static_cast<int>(p[3]);
  a.has_nof = static_cast<int>(p[4]);
  a.use_quat = static_cast<int>(p[5]);
  a.od = static_cast<const float*>(P(p[6]));
  a.z = static_cast<const float*>(P(p[7]));
  a.sigma = reinterpret_cast<float*>(p[8]);
  a.rgb = reinterpret_cast<float*>(p[9]);
  decode_net(p + 10, &a.nof);
  decode_net(p + 10 + 4 + 4 * kMaxLayers + 12, &a.nerf);
  if (a.n_rays <= 0 || a.s <= 0) return 0;
  const Net* nets[2] = {&a.nof, &a.nerf};
  int kp_max = 3 + 2 * a.nerf.kc, w_max = a.nerf.width;
  for (int i = a.has_nof ? 0 : 1; i < 2; ++i) {
    const Net& m = *nets[i];
    if (m.depth < 1 || m.depth > kMaxLayers || m.width < 2 ||
        m.width > kMaxWidth || m.width % (i ? 4 : 2) || m.kc < 3 ||
        m.kc % 3)
      return -2;
    if (3 + 2 * m.kc > kp_max) kp_max = 3 + 2 * m.kc;
    if (m.width > w_max) w_max = m.width;
  }
  if (a.has_nof && (reinterpret_cast<intptr_t>(a.nof.h[2]) < 1 ||
                    reinterpret_cast<intptr_t>(a.nof.h[2]) > 9))
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_wg(a, s);
  const int e_ld = tile_ld<float>(kp_max), h_ld = tile_ld<float>(w_max);
  const size_t smem = ((3 + kMaxHeadOut) * kRT + 2 * kKs * kWsLdF +
                       static_cast<size_t>(kRT) * (e_ld + h_ld)) *
                      sizeof(float);
  const int64_t total = a.n_rays * a.s;
  const unsigned blocks = static_cast<unsigned>((total + kRT - 1) / kRT);
  return launch(render_pass_tf32_kernel, smem, blocks, kRTThreads, s, a,
                e_ld, h_ld);
}

extern "C" const char* render_pass_error(int code) {
  switch (code) {
    case -1: return "wrong argument count";
    case -2: return "unsupported network shape (depth 1..16, width up to "
                    "256, even for the NoF and a multiple of 4 for the "
                    "NeRF, NoF head 1..9 outputs)";
    case -3: return "activations exceed the 227 KB of shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
