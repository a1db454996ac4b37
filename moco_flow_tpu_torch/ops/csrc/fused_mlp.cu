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
// What the design does about it: the row-tile layers of pass_tile.cuh, the
// render pass's (render_pass.cu), with the embedded rows in place of the
// in-kernel PE. A block takes a tile of consecutive rows (128 on tensor
// cores in bf16, 64 on FFMA in fp32); rows past n are computed on zeros and
// never stored, so nothing is padded. The tile's direct inputs sit in E (x,
// then the extra feature once the trunk is done) and its activations in H,
// both in shared memory; the weights (~0.6M NeRF values) stream from L2,
// in bf16 as 64-deep slices staged with cp.async and shared by the block.

#include "pass_tile.cuh"

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
  Lin sigma, fin, ext, rgb;
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
// bf16: tensor cores
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
nerf_mma_kernel(const NerfArgs a, int e_ld, int h_ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  MmaCtx c = mma_ctx(smem, e_ld, h_ld, a.n);
  const int w = a.width;
  const int od = a.sigma_only ? 1 : 4;
  c.sigma = a.out + od - 1;
  c.rgb = a.out;
  c.out_rs = od;
  c.rgb_cs = 1;
  mma_load(c, a.x, a.kx);
  mma_trunk(c, a.layer, a.depth, a.kx, w);
  mma_layer(c, nullptr, 0, wbf(a.sigma.wh), w, 1, a.sigma.b, nullptr,
            kSigma);
  if (a.sigma_only) return;
  mma_layer(c, nullptr, 0, wbf(a.fin.wh), w, w, a.fin.b, nullptr,
            kLinear);
  if (a.ke) mma_load(c, a.extra, a.ke);  // the trunk is done with x
  mma_layer(c, wbf(a.ext.wpe), a.ke, wbf(a.ext.wh), w, a.n_ext,
            a.ext.b, nullptr, kReluPartialFirst);
  mma_layer(c, nullptr, 0, wbf(a.rgb.wh), a.n_ext, 3, a.rgb.b, nullptr,
            kRgb);
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
// fp32: FFMA
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
nerf_ffma_kernel(const NerfArgs a, int e_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* E = reinterpret_cast<float*>(smem);   // [e_rows][kLda]
  float* H = E + e_rows * kLda;                // [width][kLda]
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTile + r0;
  if (row0 >= a.n) return;  // no block barrier below: warps are independent
  const int w = a.width;
  const int od = a.sigma_only ? 1 : 4;
  ffma_load(E + r0, a.x, row0, a.n, a.kx, lane);
  ffma_trunk(H + r0, E + r0, a.layer, a.depth, a.kx, w, lane);
  float out[kRows];
  head(out, H + r0, w, a.sigma.wh, 1, lane);
  if (lane == 0) {
    const float bias = a.sigma.b[0];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (row0 + i < a.n)
        a.out[(row0 + i) * od + od - 1] = __fadd_rn(out[i], bias);
  }
  if (a.sigma_only) return;
  __syncwarp();  // the sigma head has read H before `final` overwrites it
  layer(H + r0, E + r0, 0, nullptr, a.fin.wh, w, a.fin.b, nullptr, w,
        nullptr, kNoRelu, lane);
  if (a.ke) ffma_load(E + r0, a.extra, row0, a.n, a.ke, lane);
  layer(H + r0, E + r0, a.ke, a.ext.wpe, a.ext.wh, w, a.ext.b, nullptr,
        a.n_ext, nullptr, kPartialFirst, lane);
  head(out, H + r0, a.n_ext, a.rgb.wh, 3, lane);
  if (lane < 3) {
    const float bias = a.rgb.b[lane];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (row0 + i < a.n)
        a.out[(row0 + i) * 4 + lane] = sigmoid(__fadd_rn(out[i], bias));
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
  if (!shape_ok(a->depth, a->width) || a->kx < 1 || a->kx > kMaxWidth ||
      a->ke < 0 || a->ke > kMaxWidth ||
      (!a->sigma_only && (a->n_ext < 1 || a->n_ext > kMaxWidth)))
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
  if (dtype == 1)
    return launch_mma(nerf_mma_kernel, a, e_cols, a.width, s);
  return launch_ffma(nerf_ffma_kernel, a, 0, e_cols, a.width, s);
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
                    "inputs 1..256, NoF head 9 or 3 outputs)";
    case -3: return "a tile exceeds the 227 KB of shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
