// The per-op NeRF and NoF MLPs on pre-embedded rows for Hopper (sm_90a),
// forward only (the mlp_impl: pallas route).
//
// Replaces the TPU kernels moco_flow_tpu/ops/fused_mlp.py::_nerf_pallas and
// ::_nof_pallas. The caller embeds the positions (and broadcasts the per-ray
// extra feature to every sample) in PyTorch; a kernel takes the embedded
// rows and carries them through the whole MLP:
//   - NeRF (_nerf_tile_forward): the ReLU trunk with the skip as a split
//     product x @ W_x + h @ W_h, the sigma head, and unless sigma_only the
//     final layer, the extra layer (split hf @ W_f + extra @ W_e) and the
//     sigmoid rgb head; out (n, 4) [rgb, sigma] or (n, 1) sigma, fp32;
//   - NoF (_nof_tile_forward): the ReLU trunk on the (n, xyz_emb + ind_emb)
//     inputs with the skip as a split product, the head, then the
//     quaternion warp (_quat_apply_rowvec: d + 2 q x (q x d + w d) with the
//     conjugate q, eps 1e-8, plus s + t) or the offset x + o; out (n, 3).
// Rounding follows the Pallas tiles: every product multiplies operands
// rounded to the compute type (bf16 or fp32) and accumulates in fp32; bias,
// ReLU, the sigmoid and the warp are fp32. An activation is only ever the
// operand of the next product, so it is stored rounded to the compute type.
// JAX has no backward kernel for either: its custom VJP recomputes through
// the plain MLP (nerf_apply / nof_apply), and so does the port's
// (ops/fused_mlp.py).
//
// What bounds it on this card: compute. A NeRF row of the stage-1 model is
// ~593k multiply-adds against 4 * (63 + 27 + 4) bytes in and out, far above
// the ~295 FLOP/byte where the card stops being memory-bound.
//
// What the design does about it: a block takes a tile of consecutive rows
// (128) and carries them through the whole MLP with the tile's direct
// inputs in E (x, then the extra feature once the trunk is done) and its
// activations in H, both in shared memory; the weights (~0.6M NeRF values)
// stream from L2. Rows past n are computed on zeros and never stored, so
// nothing is padded.
//   NeRF (#8), bf16: the warp-specialised wgmma tile of wg_tile.cuh, the
//     render pass's (render_pass.cu) on pre-embedded rows: a producer
//     warpgroup bulk-copies the weight slices packed by the wrapper, two
//     consumer warpgroups of 64 rows run the layers on the tensor cores,
//     the sigma dot fused into the last trunk layer.
//   NeRF (#8), fp32: the split-TF32 product of row_tile.cuh (the training
//     forward #1's) on the 128-row tile, the `dir` extra as a second term
//     of the extra layer, the sigma row an fp32 dot.
//   NoF (#9): the row-tile layers of pass_tile.cuh, 128 rows on mma.sync
//     in bf16 (64-deep weight slices staged with cp.async and shared by the
//     block), 64 rows on an FFMA loop in fp32.

#include "row_tile.cuh"
#include "wg_tile.cuh"

namespace {

constexpr int kMaxDepth = 8;             // ops/_args.py MAX_DEPTH

// out = E @ wpe + H @ wh + b: wpe against the layer's direct inputs (x,
// extra), wh against the previous activation; either may be null. fp32:
// (K, N) row-major; bf16: W^T zero-padded to (pad16(N), pad16(K)).
struct Lin {
  const void* wpe;
  const void* wh;
  const float* b;         // (N,)
};

struct NerfArgs {
  int64_t n;
  int kx, ke, n_ext, depth, width, sigma_only;
  const float* x;         // (n, kx) embedded positions
  const float* extra;     // (n, ke) per-sample extra feature, or null
  float* out;             // (n, 4) [rgb, sigma] or (n, 1)
  Lin layer[kMaxDepth];
  Lin sigma, fin, ext, rgb;   // sigma.wh: the (W,) fp32 row
};

struct NofArgs {
  int64_t n;
  int kin, depth, width, n_out, use_quat;
  const float* in;        // (n, kin) [xyz_emb, ind_emb]
  const float* xyz;       // (n, 3)
  float* out;             // (n, 3) warped
  Lin layer[kMaxDepth];
  Lin head;
};

__device__ __forceinline__ const bf16* wbf(const void* p) {
  return static_cast<const bf16*>(p);
}

// ===========================================================================
// NoF (#9), bf16: tensor cores
// ===========================================================================

// rows [row0, row0 + 128) of an (n, k) fp32 matrix into row-major E, rounded
// to bf16, zeros in the columns k..pad16(k) and in the rows past n
__device__ void mma_load(const MmaCtx& c, const float* src, int k) {
  const int kp = pad16(k);
  const float* s = src + c.row0 * k;
  for (int i = c.tid; i < kMmaRows * kp; i += kMmaThreads) {
    const int r = i / kp, j = i % kp;
    const bool in = j < k && c.row0 + r < c.total;
    c.E[r * c.e_ld + j] = __float2bfloat16_rn(in ? s[r * k + j] : 0.f);
  }
  __syncthreads();
}

__device__ MmaCtx mma_ctx(unsigned char* smem, int e_ld, int h_ld,
                          int64_t n) {
  MmaCtx c;
  c.X = nullptr;
  c.O = reinterpret_cast<float*>(smem);
  c.Ws = reinterpret_cast<bf16*>(c.O + kMaxHeadOut * kMmaRows);
  c.E = c.Ws + 2 * kMaxWidth * kWsLd;
  c.H = c.E + kMmaRows * e_ld;
  c.e_ld = e_ld;
  c.h_ld = h_ld;
  c.tid = threadIdx.x;
  c.lane = threadIdx.x & 31;
  c.warp_m = (threadIdx.x >> 5) & 7;
  c.warp_n = threadIdx.x >> 8;
  c.total = n;
  c.row0 = static_cast<int64_t>(blockIdx.x) * kMmaRows;
  c.ray[0] = c.ray[1] = 0;   // no per-ray partials
  c.sigma = c.rgb = nullptr;
  c.out_rs = c.rgb_cs = 0;
  return c;
}

// the ReLU trunk: E @ wpe at layer 0 and the skips, H @ wh elsewhere
__device__ void mma_trunk(const MmaCtx& c, const Lin* layers, int depth,
                          int k_in, int width) {
  for (int l = 0; l < depth; ++l) {
    const Lin& L = layers[l];
    mma_layer(c, wbf(L.wpe), k_in, wbf(L.wh), width, width, L.b,
              nullptr, kReluPartialFirst);
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
nof_mma_kernel(const NofArgs a, int e_ld, int h_ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaCtx c = mma_ctx(smem, e_ld, h_ld, a.n);
  mma_load(c, a.in, a.kin);
  mma_trunk(c, a.layer, a.depth, a.kin, a.width);
  mma_layer(c, nullptr, 0, wbf(a.head.wh), a.width, a.n_out, a.head.b,
            nullptr, kHeadO);
  const int64_t g = c.row0 + c.tid;
  if (c.tid < kMmaRows && g < a.n) {
    float o[9], x[3];
    for (int q = 0; q < a.n_out; ++q) o[q] = c.O[q * kMmaRows + c.tid];
    for (int j = 0; j < 3; ++j) x[j] = a.xyz[g * 3 + j];
    nof_head_apply(o, a.use_quat, x);
    for (int j = 0; j < 3; ++j) a.out[g * 3 + j] = x[j];
  }
}

// ===========================================================================
// NeRF (#8), bf16: the wgmma tile
// ===========================================================================

struct NerfWgArgs {
  int64_t n;
  int kx, ke, sigma_only, depth;
  const float* x;
  const float* extra;
  float* out;
  const float* wsig;      // (W,) fp32
  const float* bsig;
  int n_layers, stages, h_blocks, e_blocks;
  wg::Layer layers[kMaxDepth + 3];   // trunk, final, extra, rgb
};

__global__ void __launch_bounds__(wg::kThreads, 1)
nerf_wg_kernel(const __grid_constant__ NerfWgArgs a) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  wg::Ctx c;
  wg::setup(c, wg_smem, a.stages, a.h_blocks, a.e_blocks, 0);
  const int64_t n_tiles = (a.n + wg::kRows - 1) / wg::kRows;
  if (threadIdx.x < 128) {
    wg::producer(c, a.layers, a.n_layers, n_tiles);
  } else {
    wg::consumer(c, a.h_blocks, a.e_blocks);
    const int od = a.sigma_only ? 1 : 4;
    c.total = static_cast<int>(a.n);
    c.s = 1;
    c.sigma = a.out + od - 1;
    c.sig_rs = od;
    c.rgb = a.out;
    c.rgb_cs = 1;
    c.rgb_rs = 4;
    c.wsig = a.wsig;
    c.bsig = a.bsig;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      c.row0 = static_cast<int>(tile * wg::kRows);
      wg::load_rows(c, c.E, a.x, a.kx);
      // the trunk, then unless sigma_only final, extra (on the extra rows,
      // loaded once the trunk is done with x) and rgb
      for (int l = 0; l < a.n_layers; ++l) {
        if (l == a.depth + 1 && a.ke) wg::load_rows(c, c.E, a.extra, a.ke);
        wg::run(c, a.layers[l]);
      }
    }
  }
}

// ===========================================================================
// NeRF (#8), fp32: the split-TF32 product
// ===========================================================================

// the tile's rows [row0, row0 + 128) of an (n, k) matrix into row-major E
// (row stride e_ld), zeros to column pad16(k) and in the rows past n; ends
// with a barrier
__device__ void tf32_load(float* E, int e_ld, const float* src, int k,
                          int64_t row0, int64_t n) {
  const int kp = pad16(k);
  for (int i = threadIdx.x; i < kRT * kp; i += kRTThreads) {
    const int r = i / kp, j = i % kp;
    E[r * e_ld + j] = j < k && row0 + r < n ? src[(row0 + r) * k + j] : 0.f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kRTThreads, 1)
nerf_tf32_kernel(const NerfArgs a, int e_ld, int h_ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem);  // the staged weight slices
  float* E = Ws + 2 * kKs * kWsLdF;            // [kRT][e_ld]
  float* H = E + kRT * e_ld;                   // [kRT][h_ld]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRT;
  const int w = a.width, od = a.sigma_only ? 1 : 4;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  tf32_load(E, e_ld, a.x, a.kx, row0, a.n);
  for (int l = 0; l < a.depth; ++l) {
    const Lin& L = a.layer[l];
    rt_mm(Ws, Term<float>{E, e_ld, f(L.wpe), L.wpe ? a.kx : 0},
          Term<float>{H, h_ld, f(L.wh), L.wh ? w : 0}, w,
          [&](int r, int c, float v0, float v1) {
            st2(H + r * h_ld + c, fmaxf(__fadd_rn(v0, L.b[c]), 0.f),
                fmaxf(__fadd_rn(v1, L.b[c + 1]), 0.f));
          });
  }
  {  // sigma = h . wsig + bsig in fp32, four threads a row; `final`
     // overwrites H only after the barriers of its product
    const float* wsig = f(a.sigma.wh);
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    float acc = 0.f;
    for (int c = q; c < w; c += 4) acc = fmaf(H[r * h_ld + c], wsig[c], acc);
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
    const int64_t gi = row0 + r;
    if (q == 0 && gi < a.n)
      a.out[gi * od + od - 1] = __fadd_rn(acc, a.sigma.b[0]);
  }
  if (a.sigma_only) return;
  rt_mm(Ws, Term<float>{H, h_ld, f(a.fin.wh), w}, no_term<float>(), w,
        [&](int r, int c, float v0, float v1) {
          st2(H + r * h_ld + c, __fadd_rn(v0, a.fin.b[c]),
              __fadd_rn(v1, a.fin.b[c + 1]));
        });
  if (a.ke) tf32_load(E, e_ld, a.extra, a.ke, row0, a.n);
  rt_mm(Ws, Term<float>{H, h_ld, f(a.ext.wh), w},
        Term<float>{E, e_ld, f(a.ext.wpe), a.ke}, a.n_ext,
        [&](int r, int c, float v0, float v1) {
          st2(H + r * h_ld + c, fmaxf(__fadd_rn(v0, a.ext.b[c]), 0.f),
              fmaxf(__fadd_rn(v1, a.ext.b[c + 1]), 0.f));
        });
  rt_mm(Ws, Term<float>{H, h_ld, f(a.rgb.wh), a.n_ext}, no_term<float>(), 3,
        [&](int r, int c, float v0, float v1) {
          const int64_t gi = row0 + r;
          const float v[2] = {v0, v1};
          for (int e = 0; e < 2 && c + e < 3 && gi < a.n; ++e)
            a.out[gi * 4 + c + e] = sigmoid(__fadd_rn(v[e], a.rgb.b[c + e]));
        });
}

// ===========================================================================
// NoF (#9), fp32: FFMA
// ===========================================================================

// the warp's 8 rows [row0, row0 + 8) of an (n, k) matrix into K-major E
// (E[j * kLda + i]); zeros in the rows past n
__device__ void ffma_load(float* E, const float* src, int64_t row0,
                          int64_t n, int k, int lane) {
  const float* s = src + row0 * k;
  for (int i = lane; i < kRows * k; i += 32) {
    const int r = i / k, j = i % k;
    E[j * kLda + r] = row0 + r < n ? s[i] : 0.f;
  }
  __syncwarp();
}

__device__ void ffma_trunk(float* H, const float* E, const Lin* layers,
                           int depth, int k_in, int width, int lane) {
  for (int l = 0; l < depth; ++l) {
    const Lin& L = layers[l];
    layer(H, E, k_in, L.wpe, L.wh, width, L.b, nullptr, width, nullptr,
          kPartialFirst, lane);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
nof_ffma_kernel(const NofArgs a, int e_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* O = reinterpret_cast<float*>(smem);   // [kMaxHeadOut][kTile]
  float* E = O + kMaxHeadOut * kTile;          // [e_rows][kLda]
  float* H = E + e_rows * kLda;                // [width][kLda]
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTile + r0;
  if (row0 >= a.n) return;
  ffma_load(E + r0, a.in, row0, a.n, a.kin, lane);
  ffma_trunk(H + r0, E + r0, a.layer, a.depth, a.kin, a.width, lane);
  float out[kRows];
  head(out, H + r0, a.width, a.head.wh, a.n_out, lane);
  if (lane < a.n_out) {
    const float bias = a.head.b[lane];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      O[lane * kTile + r0 + i] = __fadd_rn(out[i], bias);
  }
  __syncwarp();
  const int64_t g = row0 + lane;
  if (lane < kRows && g < a.n) {
    float o[9], x[3];
    for (int q = 0; q < a.n_out; ++q) o[q] = O[q * kTile + r0 + lane];
    for (int j = 0; j < 3; ++j) x[j] = a.xyz[g * 3 + j];
    nof_head_apply(o, a.use_quat, x);
    for (int j = 0; j < 3; ++j) a.out[g * 3 + j] = x[j];
  }
}

// ===========================================================================
// Host side
// ===========================================================================

struct Reader {
  const int64_t* p;
  int64_t i() { return *p++; }
  template <typename P> P ptr() {
    return reinterpret_cast<P>(static_cast<intptr_t>(*p++));
  }
};

void read_lin(Reader& rd, Lin* l) {
  l->wpe = rd.ptr<const void*>();
  l->wh = rd.ptr<const void*>();
  l->b = rd.ptr<const float*>();
}

// NeRF arguments (int64): dtype (0 fp32, 1 bf16), n, kx, ke, n_ext, depth,
// width, sigma_only; x; extra; out; kMaxDepth x (wpe, wh, b); sigma, final,
// extra, rgb (wpe, wh, b) each.
constexpr int kNerfArgs = 8 + 3 + 3 * kMaxDepth + 12;
// NoF arguments: dtype, n, kin, depth, width, n_out, use_quat; in; xyz;
// out; kMaxDepth x (wpe, wh, b); head (wpe, wh, b).
constexpr int kNofArgs = 7 + 3 + 3 * kMaxDepth + 3;

bool shape_ok(int depth, int width) {
  return depth >= 1 && depth <= kMaxDepth && width >= 2 &&
         width <= kMaxWidth;
}

int decode_nerf(const int64_t* p, int n, NerfArgs* a, int* dtype) {
  if (n != kNerfArgs) return -1;
  Reader rd{p};
  *dtype = static_cast<int>(rd.i());
  a->n = rd.i();
  a->kx = static_cast<int>(rd.i());
  a->ke = static_cast<int>(rd.i());
  a->n_ext = static_cast<int>(rd.i());
  a->depth = static_cast<int>(rd.i());
  a->width = static_cast<int>(rd.i());
  a->sigma_only = static_cast<int>(rd.i());
  a->x = rd.ptr<const float*>();
  a->extra = rd.ptr<const float*>();
  a->out = rd.ptr<float*>();
  for (int l = 0; l < kMaxDepth; ++l) read_lin(rd, &a->layer[l]);
  read_lin(rd, &a->sigma);
  read_lin(rd, &a->fin);
  read_lin(rd, &a->ext);
  read_lin(rd, &a->rgb);
  if (!shape_ok(a->depth, a->width) || a->width % 2 || a->kx < 1 ||
      a->kx > kMaxWidth || a->ke < 0 || a->ke > kMaxWidth ||
      (!a->sigma_only &&
       (a->n_ext < 2 || a->n_ext > kMaxWidth || a->n_ext % 2)))
    return -2;
  return 0;
}

int decode_nof(const int64_t* p, int n, NofArgs* a, int* dtype) {
  if (n != kNofArgs) return -1;
  Reader rd{p};
  *dtype = static_cast<int>(rd.i());
  a->n = rd.i();
  a->kin = static_cast<int>(rd.i());
  a->depth = static_cast<int>(rd.i());
  a->width = static_cast<int>(rd.i());
  a->n_out = static_cast<int>(rd.i());
  a->use_quat = static_cast<int>(rd.i());
  a->in = rd.ptr<const float*>();
  a->xyz = rd.ptr<const float*>();
  a->out = rd.ptr<float*>();
  for (int l = 0; l < kMaxDepth; ++l) read_lin(rd, &a->layer[l]);
  read_lin(rd, &a->head);
  if (!shape_ok(a->depth, a->width) || a->kin < 1 || a->kin > kMaxWidth ||
      a->n_out != (a->use_quat ? 9 : 3))
    return -2;
  return 0;
}

// bf16: O, the two weight slices, then E (e_cols) and H (width) per row
size_t mma_bytes(int e_ld, int h_ld) {
  return kMaxHeadOut * kMmaRows * sizeof(float) +
         (2 * static_cast<size_t>(kMaxWidth) * kWsLd +
          static_cast<size_t>(kMmaRows) * (e_ld + h_ld)) * sizeof(bf16);
}

template <typename Args, typename Kernel>
int launch_mma(Kernel kernel, const Args& a, int e_cols, int width,
               cudaStream_t s) {
  const int e_ld = pad16(e_cols) + 8, h_ld = pad16(width) + 8;
  const unsigned blocks = static_cast<unsigned>((a.n + kMmaRows - 1) /
                                                kMmaRows);
  return launch(kernel, mma_bytes(e_ld, h_ld), blocks, kMmaThreads, s, a,
                e_ld, h_ld);
}

// #8 in bf16: the layer list of the wgmma tile, the ring's depth, launch
int launch_nerf_wg(const NerfArgs& a, int e_cols, cudaStream_t s) {
  if (a.n > wg::kMaxRows) return -2;
  NerfWgArgs w{};
  w.n = a.n;
  w.kx = a.kx;
  w.ke = a.ke;
  w.sigma_only = a.sigma_only;
  w.depth = a.depth;
  w.x = a.x;
  w.extra = a.extra;
  w.out = a.out;
  w.wsig = static_cast<const float*>(a.sigma.wh);
  w.bsig = a.sigma.b;
  int n = 0;
  auto add = [&](const Lin& L, int k_e, int k_h, int n_out, int ep,
                 bool h_first) {
    wg::Layer& d = w.layers[n++];
    d = wg::Layer{};
    const bf16* img[2] = {static_cast<const bf16*>(L.wpe),
                          static_cast<const bf16*>(L.wh)};
    const int src[2] = {0, 1}, k[2] = {L.wpe ? k_e : 0, L.wh ? k_h : 0};
    for (int t = 0; t < 2; ++t) {
      const int u = h_first ? 1 - t : t;
      d.img[t] = img[u];
      d.src[t] = src[u];
      d.k[t] = k[u];
    }
    d.n = n_out;
    d.n_pad = wg::width_of(n_out);
    d.ep = ep;
    d.bias = L.b;
  };
  for (int l = 0; l < a.depth; ++l)
    add(a.layer[l], a.kx, a.width, a.width, wg::kRelu, false);
  w.layers[n - 1].sigma = 1;
  if (!a.sigma_only) {
    add(a.fin, 0, a.width, a.width, wg::kLinear, false);
    add(a.ext, a.ke, a.width, a.n_ext, wg::kRelu, true);
    add(a.rgb, 0, a.n_ext, 3, wg::kRgb, false);
  }
  w.n_layers = n;
  const int h_max = wg::width_of(a.width) > wg::width_of(a.n_ext)
                        ? wg::width_of(a.width)
                        : wg::width_of(a.n_ext);
  w.h_blocks = (h_max + 63) / 64;
  w.e_blocks = (e_cols + 63) / 64;
  const size_t fixed = wg::smem_bytes(0, w.h_blocks, w.e_blocks, 0);
  w.stages = static_cast<int>((kMaxSmem - fixed) / wg::kStageBytes);
  if (w.stages > wg::kMaxStages) w.stages = wg::kMaxStages;
  if (w.stages < 2) return -3;
  return launch(nerf_wg_kernel,
                wg::smem_bytes(w.stages, w.h_blocks, w.e_blocks, 0),
                wg::grid_of((a.n + wg::kRows - 1) / wg::kRows), wg::kThreads,
                s, w);
}

template <typename Args, typename Kernel>
int launch_ffma(Kernel kernel, const Args& a, size_t head_floats, int e_rows,
                int width, cudaStream_t s) {
  const size_t smem = (head_floats + static_cast<size_t>(e_rows + width) *
                                         kLda) * sizeof(float);
  const unsigned blocks = static_cast<unsigned>((a.n + kTile - 1) / kTile);
  return launch(kernel, smem, blocks, kWarps * 32, s, a, e_rows);
}

}  // namespace

extern "C" int fused_mlp_nerf_launch(const int64_t* p, int n, void* stream) {
  NerfArgs a;
  int dtype = 0;
  const int rc = decode_nerf(p, n, &a, &dtype);
  if (rc) return rc;
  if (a.n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e_cols = a.kx > a.ke ? a.kx : a.ke;
  if (dtype == 1) return launch_nerf_wg(a, e_cols, s);
  const int e_ld = tile_ld<float>(e_cols), h_ld = tile_ld<float>(a.width);
  const size_t smem = (2 * kKs * kWsLdF +
                       static_cast<size_t>(kRT) * (e_ld + h_ld)) *
                      sizeof(float);
  const unsigned blocks = static_cast<unsigned>((a.n + kRT - 1) / kRT);
  return launch(nerf_tf32_kernel, smem, blocks, kRTThreads, s, a, e_ld,
                h_ld);
}

extern "C" int fused_mlp_nof_launch(const int64_t* p, int n, void* stream) {
  NofArgs a;
  int dtype = 0;
  const int rc = decode_nof(p, n, &a, &dtype);
  if (rc) return rc;
  if (a.n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_mma(nof_mma_kernel, a, a.kin, a.width, s);
  return launch_ffma(nof_ffma_kernel, a, kMaxHeadOut * kTile, a.kin, a.width,
                     s);
}

extern "C" const char* fused_mlp_error(int code) {
  switch (code) {
    case -1: return "wrong argument count";
    case -2: return "unsupported network shape (depth 1..8, width 2..256, "
                    "even for the NeRF, as its extra layer's, inputs "
                    "1..256, NoF head 9 or 3 outputs)";
    case -3: return "a tile exceeds the 227 KB of shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
