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
// The positions may also come from an xyz (3, N*S) input. No caller passes
// one: the NeRF forward of the training step (_nerf_fwd_call), which read
// it, is nerf_rays.cu's kernel #1.
//
// What bounds it on this card: compute. At full width (NeRF 8x256, NoF
// 4x128) a fine sample costs about 0.65M multiply-adds (0.59M in the NeRF,
// 0.06M in the NoF), about 1.3 MFLOP, against 4 bytes of depth read and
// 16 bytes of sigma + rgb written: ~65,000 FLOP per byte of device memory,
// far above the ~295 FLOP/byte at which the card stops being memory-bound.
//
// What the design does about it: no activation ever goes to device memory.
// A block carries a tile of consecutive (ray, sample) rows through all ~13
// layers with the activations in shared memory, updated in place layer by
// layer. The weights (~1.2 MB in bf16) do not fit in shared memory; they stay
// resident in the 50 MB L2 and stream through. Rays are never padded: rows
// past N*S are computed on zeros and never stored.
//
// Two kernels, one per storage type, on the row-tile layers of
// pass_tile.cuh: bf16 on tensor cores (mma_layer, 128 rows a block, weight
// slices staged with cp.async), fp32 as an FFMA loop (layer / head, 64 rows
// a block, 8 a warp). The wrapper passes every bf16 weight transposed and
// zero-padded to multiples of 16.
//
// Rounding points follow _nerf_tile/_nof_tile: the PE embedding, hidden
// activations and the output of `final` are stored in the storage type;
// biases, per-ray partials, heads and the quaternion transform are fp32.
// Elementwise steps use explicitly rounded intrinsics (__fmul_rn,
// __fadd_rn) so nvcc cannot fuse them into FMAs: the plain PyTorch version
// rounds after every operation, and a 1-ulp change in a warped position
// grows 512-fold through the top PE band. sinf/cosf are full precision (no
// --use_fast_math).

#include "pass_tile.cuh"

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
  const float* xyz;       // (3, N*S) positions, or null: xyz = o + d*z
  float* sigma;           // (N, S)
  float* rgb;             // (3, N, S) or null
  Net nof, nerf;
};

__device__ __forceinline__ float sample_x(const Args& a, int64_t g, int j) {
  if (a.xyz) return a.xyz[j * a.n_rays * a.s + g];
  const float* od = a.od + (g / a.s) * 6;
  return __fadd_rn(od[j], __fmul_rn(od[3 + j], a.z[g]));
}

// Packed PE of the block's rows into row-major E: [x, sin, cos, zeros to 16].
__device__ void mma_pe_fill(const MmaCtx& c, const float* bands, int kc) {
  const int kp = 3 + 2 * kc;
  for (int idx = c.tid; idx < kMmaRows * kc; idx += kMmaThreads) {
    const int r = idx % kMmaRows, f3j = idx / kMmaRows;
    const float v = __fmul_rn(bands[f3j / 3], c.X[(f3j % 3) * kMmaRows + r]);
    float s, co;
    sincosf(v, &s, &co);
    c.E[r * c.e_ld + 3 + f3j] = __float2bfloat16_rn(s);
    c.E[r * c.e_ld + 3 + kc + f3j] = __float2bfloat16_rn(co);
  }
  const int extra = 3 + pad16(kp) - kp;  // x columns, then zero padding
  for (int idx = c.tid; idx < kMmaRows * extra; idx += kMmaThreads) {
    const int r = idx % kMmaRows, j = idx / kMmaRows;
    if (j < 3)
      c.E[r * c.e_ld + j] = __float2bfloat16_rn(c.X[j * kMmaRows + r]);
    else
      c.E[r * c.e_ld + kp + j - 3] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMmaThreads, 1)
render_pass_mma_kernel(const Args a, int e_ld, int h_ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  MmaCtx c;
  c.X = reinterpret_cast<float*>(smem);
  c.O = c.X + 3 * kMmaRows;
  c.Ws = reinterpret_cast<bf16*>(c.O + kMaxHeadOut * kMmaRows);
  c.E = c.Ws + 2 * kMaxWidth * kWsLd;
  c.H = c.E + kMmaRows * e_ld;
  c.e_ld = e_ld;
  c.h_ld = h_ld;
  c.tid = threadIdx.x;
  c.lane = threadIdx.x & 31;
  c.warp_m = (threadIdx.x >> 5) & 7;
  c.warp_n = threadIdx.x >> 8;
  c.total = a.n_rays * a.s;
  c.row0 = static_cast<int64_t>(blockIdx.x) * kMmaRows;
  c.sigma = a.sigma;
  c.rgb = a.rgb;
  c.out_rs = 1;
  c.rgb_cs = c.total;
  for (int hh = 0; hh < 2; ++hh) {
    int64_t gi = c.row0 + c.warp_m * 16 + (c.lane >> 2) + 8 * hh;
    c.ray[hh] = (gi < c.total ? gi : c.total - 1) / a.s;
  }

  if (c.tid < kMmaRows) {   // xyz = o + d * z
    const int64_t gi = c.row0 + c.tid;
    for (int j = 0; j < 3; ++j)
      c.X[j * kMmaRows + c.tid] = gi < c.total ? sample_x(a, gi, j) : 0.f;
  }
  __syncthreads();

  if (a.has_nof) {
    const Net& n = a.nof;
    mma_pe_fill(c, n.bands, n.kc);
    for (int l = 0; l < n.depth; ++l) {
      const Layer& L = n.layer[l];
      mma_layer(c, static_cast<const bf16*>(L.wpe), 3 + 2 * n.kc,
                static_cast<const bf16*>(L.wh), n.width, n.width, L.b,
                L.partial, kReluPartialFirst);
    }
    const int n_out = static_cast<int>(reinterpret_cast<intptr_t>(n.h[2]));
    mma_layer(c, nullptr, 0, static_cast<const bf16*>(n.h[0]), n.width,
              n_out, static_cast<const float*>(n.h[1]), nullptr, kHeadO);
    if (c.tid < kMmaRows) {
      float o[9], x[3];
      for (int q = 0; q < n_out; ++q) o[q] = c.O[q * kMmaRows + c.tid];
      for (int j = 0; j < 3; ++j) x[j] = c.X[j * kMmaRows + c.tid];
      nof_head_apply(o, a.use_quat, x);
      for (int j = 0; j < 3; ++j) c.X[j * kMmaRows + c.tid] = x[j];
    }
    __syncthreads();
  }

  const Net& n = a.nerf;
  const int w = n.width;
  mma_pe_fill(c, n.bands, n.kc);
  for (int l = 0; l < n.depth; ++l) {
    const Layer& L = n.layer[l];
    mma_layer(c, static_cast<const bf16*>(L.wpe), 3 + 2 * n.kc,
              static_cast<const bf16*>(L.wh), w, w, L.b, nullptr,
              kReluPartialFirst);
  }
  mma_layer(c, nullptr, 0, static_cast<const bf16*>(n.h[0]), w, 1,
            static_cast<const float*>(n.h[1]), nullptr, kSigma);
  if (a.sigma_only) return;
  mma_layer(c, nullptr, 0, static_cast<const bf16*>(n.h[2]), w, w,
            static_cast<const float*>(n.h[3]), nullptr, kLinear);
  mma_layer(c, nullptr, 0, static_cast<const bf16*>(n.h[4]), w, w / 2,
            static_cast<const float*>(n.h[5]),
            static_cast<const float*>(n.h[6]), kReluBiasFirst);
  mma_layer(c, nullptr, 0, static_cast<const bf16*>(n.h[7]), w / 2, 3,
            static_cast<const float*>(n.h[8]), nullptr, kRgb);
}


// Packed PE of the warp's rows: E[0:3] = x, E[3:3+kc] = sin, then cos, with
// column f*3+j = bands[f] * x_j (frequency-major).
__device__ void pe_fill(float* E, const float* X, int r0, const float* bands,
                        int kc, int lane) {
  if (lane < 3 * kRows) {
    const int j = lane / kRows, i = lane % kRows;
    E[j * kLda + r0 + i] = X[j * kTile + r0 + i];
  }
  for (int idx = lane; idx < kc * kRows; idx += 32) {
    const int f3j = idx / kRows, i = idx % kRows;
    const float v = __fmul_rn(bands[f3j / 3], X[(f3j % 3) * kTile + r0 + i]);
    float s, c;
    sincosf(v, &s, &c);
    E[(3 + f3j) * kLda + r0 + i] = s;
    E[(3 + kc + f3j) * kLda + r0 + i] = c;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32)
render_pass_kernel(const Args a, int kp_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);   // [3][kTile] positions
  float* O = X + 3 * kTile;                    // [kMaxHeadOut][kTile]
  float* E = O + kMaxHeadOut * kTile;          // [kp_max][kLda]
  float* H = E + kp_max * kLda;                // [w_max][kLda]

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;
  const int64_t total = a.n_rays * a.s;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTile + r0;
  if (row0 >= total) return;  // no block barrier below: warps are independent

  int64_t ray[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t g = row0 + i < total ? row0 + i : total - 1;
    ray[i] = g / a.s;
  }
  if (lane < kRows) {   // xyz = o + d * z
    const int64_t g = row0 + lane;
    for (int j = 0; j < 3; ++j)
      X[j * kTile + r0 + lane] = g < total ? sample_x(a, g, j) : 0.f;
  }
  __syncwarp();

  if (a.has_nof) {
    const Net& n = a.nof;
    const int kp = 3 + 2 * n.kc;
    pe_fill(E, X, r0, n.bands, n.kc, lane);
    for (int l = 0; l < n.depth; ++l) {
      const Layer& L = n.layer[l];
      layer(H + r0, E + r0, kp, L.wpe, L.wh, n.width, L.b, L.partial,
            n.width, ray, kPartialFirst, lane);
    }
    const int n_out = static_cast<int>(reinterpret_cast<intptr_t>(n.h[2]));
    float out[kRows];
    head(out, H + r0, n.width, n.h[0], n_out, lane);
    if (lane < n_out) {
      const float bias = static_cast<const float*>(n.h[1])[lane];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        O[lane * kTile + r0 + i] = __fadd_rn(out[i], bias);
    }
    __syncwarp();
    if (lane < kRows) {
      const int r = r0 + lane;
      float x[3], o[9];
      for (int j = 0; j < 3; ++j) x[j] = X[j * kTile + r];
      for (int q = 0; q < n_out; ++q) o[q] = O[q * kTile + r];
      nof_head_apply(o, a.use_quat, x);
      for (int j = 0; j < 3; ++j) X[j * kTile + r] = x[j];
    }
    __syncwarp();
  }

  const Net& n = a.nerf;
  const int kp = 3 + 2 * n.kc;
  const int w = n.width;
  pe_fill(E, X, r0, n.bands, n.kc, lane);
  for (int l = 0; l < n.depth; ++l) {
    const Layer& L = n.layer[l];
    layer(H + r0, E + r0, kp, L.wpe, L.wh, w, L.b, nullptr, w, ray,
          kPartialFirst, lane);
  }
  float out[kRows];
  head(out, H + r0, w, n.h[0], 1, lane);          // sigma
  if (lane == 0) {
    const float bias = static_cast<const float*>(n.h[1])[0];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (row0 + i < total) a.sigma[row0 + i] = __fadd_rn(out[i], bias);
  }
  if (a.sigma_only) return;
  __syncwarp();  // the sigma head has read H before `final` overwrites it
  layer(H + r0, E + r0, 0, nullptr, n.h[2], w,
        static_cast<const float*>(n.h[3]), nullptr, w, ray, kNoRelu, lane);
  layer(H + r0, E + r0, 0, nullptr, n.h[4], w,
        static_cast<const float*>(n.h[5]), static_cast<const float*>(n.h[6]),
        w / 2, ray, kBiasFirst, lane);
  head(out, H + r0, w / 2, n.h[7], 3, lane);      // rgb
  if (lane < 3) {
    const float bias = static_cast<const float*>(n.h[8])[lane];
    float* dst = a.rgb + static_cast<int64_t>(lane) * total;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (row0 + i < total) dst[row0 + i] = sigmoid(__fadd_rn(out[i], bias));
  }
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


}  // namespace

// args (171 int64): dtype (0 float, 1 bf16), n_rays, S, sigma_only, has_nof,
// use_quat, od, z, sigma, rgb; then the NoF and the NeRF net blocks; then
// xyz (3, N*S) or 0. With xyz the pass reads the sample positions from it
// instead of o + d*z (od and z unused): the NeRF forward of the training
// step (ops/nerf_rays.py, moco_flow_tpu/ops/megakernel.py::_nerf_fwd_call).
// NoF head slots: w_head (W, 9|3), b_head, head_out.
// NeRF head slots: w_sigma (W, 1), b_sigma, w_final, b_final, w_extra
// (W, W/2), b_extra, p_extra (N, W/2) or 0, w_rgb (W/2, 3), b_rgb.
// Matrices are (K, N) row-major in fp32; in bf16 they are transposed and
// zero-padded: (pad16(N), pad16(K)). Biases and partials are fp32 and
// unpadded. Returns 0, a cudaError_t, or -1 bad arg count, -2 bad shape,
// -3 too much shared memory.
extern "C" int render_pass_launch(const int64_t* p, int n, void* stream) {
  if (n != 11 + 2 * (4 + 4 * kMaxLayers + 12)) return -1;
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
  a.xyz = static_cast<const float*>(P(p[10 + 2 * (4 + 4 * kMaxLayers + 12)]));
  if (a.n_rays <= 0 || a.s <= 0) return 0;
  const Net* nets[2] = {&a.nof, &a.nerf};
  int kp_max = 3 + 2 * a.nerf.kc, w_max = a.nerf.width;
  for (int i = a.has_nof ? 0 : 1; i < 2; ++i) {
    const Net& m = *nets[i];
    if (m.depth < 1 || m.depth > kMaxLayers || m.width < 2 ||
        m.width > kMaxWidth || m.kc < 3 || m.kc % 3)
      return -2;
    if (3 + 2 * m.kc > kp_max) kp_max = 3 + 2 * m.kc;
    if (m.width > w_max) w_max = m.width;
  }
  if (a.has_nof && (reinterpret_cast<intptr_t>(a.nof.h[2]) < 1 ||
                    reinterpret_cast<intptr_t>(a.nof.h[2]) > 9))
    return -2;
  const int64_t total = a.n_rays * a.s;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int e_ld = pad16(kp_max) + 8, h_ld = pad16(w_max) + 8;
    const size_t smem = (3 + kMaxHeadOut) * kMmaRows * sizeof(float) +
                        (2 * static_cast<size_t>(kMaxWidth) * kWsLd +
                         static_cast<size_t>(kMmaRows) * (e_ld + h_ld)) *
                            sizeof(bf16);
    const unsigned blocks =
        static_cast<unsigned>((total + kMmaRows - 1) / kMmaRows);
    return launch(render_pass_mma_kernel, smem, blocks, kMmaThreads, s, a,
                  e_ld, h_ld);
  }
  kp_max += kp_max & 1;
  const size_t smem = (3 + kMaxHeadOut) * kTile * sizeof(float) +
                      static_cast<size_t>(kp_max + w_max) * kLda *
                          sizeof(float);
  const unsigned blocks = static_cast<unsigned>((total + kTile - 1) / kTile);
  return launch(render_pass_kernel, smem, blocks, kWarps * 32, s, a, kp_max);
}

extern "C" const char* render_pass_error(int code) {
  switch (code) {
    case -1: return "wrong argument count";
    case -2: return "unsupported network shape (depth 1..16, width 2..256, "
                    "NoF head 1..9 outputs)";
    case -3: return "activations exceed the 227 KB of shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
