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
//   NoF (#9), bf16: the same wgmma tile on the NoF's pre-embedded rows,
//     which stay in E through the trunk (the skip layer reads them again);
//     the head into the tile's fp32 outputs O, then the warp, one row a
//     consumer thread. A NoF tile is ~10x less work than a NeRF tile, so
//     reading its inputs would stall the tensor cores: three warps of the
//     producer warpgroup load the next tile's rows into a second E buffer
//     while the consumers run this one, and a ring stage holds one 16 KB
//     slice (7 stages in flight).
//   NoF (#9), fp32: the split-TF32 product as #8's, but with each weight
//     split into its TF32 hi and lo parts once, by the wrapper, instead of
//     by every warp that reads it (rt_mm_presplit); the head into a
//     per-row fp32 buffer, then the warp.

#include "row_tile.cuh"
#include "wg_tile.cuh"

namespace {

constexpr int kMaxDepth = 8;             // ops/_args.py MAX_DEPTH

// out = E @ wpe + H @ wh + b: wpe against the layer's direct inputs (x,
// extra), wh against the previous activation; either may be null. fp32:
// the row-tile operand (K, pad16(N)) of row_tile.cuh; bf16: wg_tile.cuh's
// slice images (ops/_args.py wg_pack).
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
  int64_t n, lo;          // lo: fp32, the lo parts' distance (elements)
  int kin, depth, width, n_out, use_quat;
  const float* in;        // (n, kin) [xyz_emb, ind_emb]
  const float* xyz;       // (n, 3)
  float* out;             // (n, 3) warped
  Lin layer[kMaxDepth];
  Lin head;
};

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
// NoF (#9), bf16: the wgmma tile
// ===========================================================================

struct NofWgArgs {
  int64_t n;
  int kin, use_quat;
  const float* in;        // 16-byte aligned
  const float* xyz;
  float* out;
  int n_layers, stages, stage_bytes, h_blocks, e_blocks;
  wg::Layer layers[kMaxDepth + 1];   // trunk, head
};

// The tile's tail: positions X of E buffer 0, the head outputs O, positions
// of E buffer 1, then the mbarriers of the two E buffers (full, empty)
constexpr size_t kNofX = 3 * wg::kRows;                 // floats
constexpr size_t kNofWgTail =
    (2 * kNofX + wg::kHeadLd * wg::kRows) * sizeof(float) + 4 * 8;
constexpr int kNofLoaders = 96;  // warps 1-3 of the producer warpgroup
constexpr int kNofLoads = 3;     // float4 loads of a loader in flight
// registers a thread: the loaders need more than a producer's 40 (at 40
// and at 56 they spilled, and the tile ran 10-15% slower), which the
// consumers give up
constexpr int kNofProducerRegs = 72, kNofConsumerRegs = 216;

// cp.async.bulk.prefetch of [p, p + bytes) into L2, trimmed to whole
// 16-byte chunks inside the range
__device__ __forceinline__ void prefetch_l2(const float* p, int64_t bytes) {
  const uint64_t a = reinterpret_cast<uint64_t>(p);
  const uint64_t lo = (a + 15) & ~15ull, hi = (a + bytes) & ~15ull;
  if (hi > lo)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(lo),
                 "r"(static_cast<unsigned>(hi - lo))
                 : "memory");
}

// bf16 of v <- element (r, c) of the A operand at shared address A
__device__ __forceinline__ void put_s(unsigned A, int r, int c, float v) {
  const unsigned short h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(A + wg::a_off(r, c)),
               "h"(h)
               : "memory");
}

// The inputs of #9's tiles, a tile ahead of the consumers: the loaders
// (96 threads at the producer warpgroup's 72 registers) fill E buffer b
// (tile u of the block: b = u % 2) with the tile's (n, k) input rows,
// rounded to bf16, and X buffer b with their positions, once the
// consumers have released the buffer (e_empty[b]; its first phase: they
// zeroed it), then arrive on e_full[b]. The tile's inputs are one
// contiguous range, read 16 bytes a load (the wrapper passes them 16-byte
// aligned); rows past n are 0. E's columns past k keep the consumers'
// zeros: nothing else writes E. The next tile's range streams into L2
// meanwhile. Shared memory by 32-bit addresses, the tile counters 32-bit:
// the loader's state fits its registers.
__device__ __forceinline__ void nof_loader(const NofWgArgs& a, unsigned E0,
                                           unsigned e_bytes, unsigned X0,
                                           unsigned X1, unsigned bars,
                                           int n_tiles) {
  const int t = threadIdx.x - (128 - kNofLoaders), k = a.kin;
  const int n = static_cast<int>(a.n);
  // flat element e of a tile is (row, column) (e / k, e % k); a loader
  // steps its elements by 4 kNofLoaders = q k + m without a division
  const int q = 4 * kNofLoaders / k, m = 4 * kNofLoaders % k;
  int u = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++u) {
    const int b = u & 1, row0 = tile * wg::kRows;
    const int next = row0 + static_cast<int>(gridDim.x) * wg::kRows;
    if (t == 0 && next < n) {
      const int rows = min(n - next, wg::kRows);
      prefetch_l2(a.in + static_cast<int64_t>(next) * k, rows * k * 4);
      prefetch_l2(a.xyz + 3 * static_cast<int64_t>(next), rows * 12);
    }
    wg::wait_parity(bars + 8 * (2 + b), (u >> 1) & 1);   // e_empty[b]
    const unsigned E = E0 + b * e_bytes;
    const int avail = min(n - row0, wg::kRows) * k;      // elements
    const float* in = a.in + static_cast<int64_t>(row0) * k;
    int r = 4 * t / k, j = 4 * t % k;
    for (int e0 = 4 * t; e0 < wg::kRows * k;
         e0 += 4 * kNofLoads * kNofLoaders) {
      float4 v[kNofLoads];
#pragma unroll
      for (int l = 0; l < kNofLoads; ++l) {
        const int e = e0 + 4 * l * kNofLoaders;
        if (e + 3 < avail) {
          v[l] = __ldg(reinterpret_cast<const float4*>(in + e));
        } else {                           // past n, or the partial vector
          v[l].x = e < avail ? in[e] : 0.f;
          v[l].y = e + 1 < avail ? in[e + 1] : 0.f;
          v[l].z = e + 2 < avail ? in[e + 2] : 0.f;
          v[l].w = 0.f;
        }
      }
#pragma unroll
      for (int l = 0; l < kNofLoads; ++l) {
        const bool real = e0 + 4 * l * kNofLoaders < wg::kRows * k;
        const float f[4] = {v[l].x, v[l].y, v[l].z, v[l].w};
        int rr = r, jj = j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (real) put_s(E, rr, jj, f[i]);
          if (++jj == k) {
            jj = 0;
            ++rr;
          }
        }
        r += q;
        j += m;
        if (j >= k) {
          j -= k;
          ++r;
        }
      }
    }
    const float* xs = a.xyz + 3 * static_cast<int64_t>(row0);
    const int x_avail = 3 * min(n - row0, wg::kRows);
    const unsigned X = b ? X1 : X0;
    for (int i = t; i < 3 * wg::kRows; i += kNofLoaders) {
      const float x = i < x_avail ? __ldg(xs + i) : 0.f;
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(
                       X + 4 * ((i % 3) * wg::kRows + i / 3)),
                   "f"(x)
                   : "memory");
    }
    wg::fence_async_smem();               // E, before the consumers' wgmma
    wg::arrive(bars + 8 * b);             // e_full[b]
  }
}

// One layer of #9, the variants it runs: the ReLU trunk, then the head
// into O (wg::run instantiates every kernel's variants; these alone leave
// the consumers' registers room).
__device__ __forceinline__ void nof_run(wg::Ctx& c, const wg::Layer L) {
  if (L.ep == wg::kHeadO) {
    if (L.n_pad == 8) wg::layer_v<8, wg::kHeadO, false>(c, L);
    else wg::layer_v<16, wg::kHeadO, false>(c, L);
    return;
  }
  switch (L.n_pad) {
    case 8: wg::layer_v<8, wg::kRelu, false>(c, L); break;
    case 16: wg::layer_v<16, wg::kRelu, false>(c, L); break;
    case 32: wg::layer_v<32, wg::kRelu, false>(c, L); break;
    case 64: wg::layer_v<64, wg::kRelu, false>(c, L); break;
    case 128: wg::layer_v<128, wg::kRelu, false>(c, L); break;
    default: wg::layer_v<256, wg::kRelu, false>(c, L); break;
  }
}

__global__ void __launch_bounds__(wg::kThreads, 1)
nof_wg_kernel(const __grid_constant__ NofWgArgs a) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  wg::Ctx c;
  // E holds two buffers of e_blocks: the loaders fill one while the
  // consumers run the trunk on the other
  wg::setup(c, wg_smem, a.stages, a.h_blocks, 2 * a.e_blocks, kNofWgTail,
            a.stage_bytes);
  unsigned char* const E0 = c.E;
  const int e_bytes = a.e_blocks * wg::kBlockBytes;
  float* const X0 = c.X;
  float* const X1 = c.O + wg::kHeadLd * wg::kRows;
  const unsigned bars = wg::smem_u32(X1 + kNofX);   // e_full[2], e_empty[2]
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       bars + 8 * b),
                   "r"(kNofLoaders));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 256;\n" ::"r"(
          bars + 8 * (2 + b)));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int64_t n_tiles = (a.n + wg::kRows - 1) / wg::kRows;
  if (threadIdx.x < 128) {
    wg::producer<kNofProducerRegs>(c, a.layers, a.n_layers, n_tiles);
    if (threadIdx.x >= 128 - kNofLoaders)
      nof_loader(a, wg::smem_u32(E0), e_bytes, wg::smem_u32(X0),
                 wg::smem_u32(X1), bars, static_cast<int>(n_tiles));
  } else {
    // zeroes both buffers
    wg::consumer<kNofConsumerRegs>(c, a.h_blocks, 2 * a.e_blocks);
    for (int b = 0; b < 2; ++b) wg::arrive(bars + 8 * (2 + b));
    c.total = static_cast<int>(a.n);
    c.s = 1;
    int u = 0;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++u) {
      const int b = u & 1;
      c.row0 = static_cast<int>(tile * wg::kRows);
      c.E = E0 + b * e_bytes;
      wg::wait_parity(bars + 8 * b, (u >> 1) & 1);      // e_full[b]
      for (int l = 0; l < a.n_layers; ++l) nof_run(c, a.layers[l]);
      // the warp of the warpgroup's 64 rows (the head layer's barrier made
      // O visible), then buffer b goes back to the loaders
      if (c.tid < 64) {
        const int r = 64 * c.wgi + c.tid, g = c.row0 + r;
        if (g < c.total) {
          const float* X = b ? X1 : X0;
          float x[3];
          for (int j = 0; j < 3; ++j) x[j] = X[j * wg::kRows + r];
          nof_head_apply(c.O + r * wg::kHeadLd, a.use_quat, x);
          for (int j = 0; j < 3; ++j)
            a.out[3 * static_cast<int64_t>(g) + j] = x[j];
        }
      }
      wg::arrive(bars + 8 * (2 + b));                   // e_empty[b]
    }
  }
}

// ===========================================================================
// fp32: the split-TF32 product (#8, #9)
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

// #9: B split once in the wrapper (rt_mm_presplit), slices kd deep
__global__ void __launch_bounds__(kRTThreads, 1)
nof_tf32_kernel(const NofArgs a, int kd, int e_ld, int h_ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* O = reinterpret_cast<float*>(smem);   // [kRT][kMaxHeadOut]
  float* Ws = O + kRT * kMaxHeadOut;           // the staged weight slices
  float* E = Ws + 4 * kd * kWsLdF;             // [kRT][e_ld]
  float* H = E + kRT * e_ld;                   // [kRT][h_ld]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRT;
  const int w = a.width, n_out = a.n_out;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  tf32_load(E, e_ld, a.in, a.kin, row0, a.n);
  for (int l = 0; l < a.depth; ++l) {
    const Lin& L = a.layer[l];
    rt_mm_presplit(Ws, kd, Term<float>{E, e_ld, f(L.wpe), L.wpe ? a.kin : 0},
                   Term<float>{H, h_ld, f(L.wh), L.wh ? w : 0}, a.lo, w,
                   [&](int r, int c, float v0, float v1) {
                     st2(H + r * h_ld + c, fmaxf(__fadd_rn(v0, L.b[c]), 0.f),
                         fmaxf(__fadd_rn(v1, L.b[c + 1]), 0.f));
                   });
  }
  const float* hb = a.head.b;
  rt_mm_presplit(Ws, kd, Term<float>{H, h_ld, f(a.head.wh), w},
                 no_term<float>(), a.lo, n_out,
                 [&](int r, int c, float v0, float v1) {
                   O[r * kMaxHeadOut + c] = __fadd_rn(v0, hb[c]);
                   if (c + 1 < n_out)
                     O[r * kMaxHeadOut + c + 1] = __fadd_rn(v1, hb[c + 1]);
                 });
  for (int r = threadIdx.x; r < kRT; r += kRTThreads) {
    const int64_t g = row0 + r;
    if (g >= a.n) continue;
    float x[3];
    for (int j = 0; j < 3; ++j) x[j] = a.xyz[g * 3 + j];
    nof_head_apply(O + r * kMaxHeadOut, a.use_quat, x);
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
// NoF arguments: dtype, n, kin, depth, width, n_out, use_quat, lo; in;
// xyz; out; kMaxDepth x (wpe, wh, b); head (wpe, wh, b). fp32 matrices are
// their TF32 hi parts, each lo part lo elements further on.
constexpr int kNofArgs = 8 + 3 + 3 * kMaxDepth + 3;

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
  a->lo = rd.i();
  a->in = rd.ptr<const float*>();
  a->xyz = rd.ptr<const float*>();
  a->out = rd.ptr<float*>();
  for (int l = 0; l < kMaxDepth; ++l) read_lin(rd, &a->layer[l]);
  read_lin(rd, &a->head);
  if (!shape_ok(a->depth, a->width) || a->width % 2 || a->kin < 1 ||
      a->kin > kMaxWidth || a->n_out != (a->use_quat ? 9 : 3))
    return -2;
  return 0;
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

// #9 in bf16: the layer list of the wgmma tile, the ring's depth; rows in
// launches of at most wg::kMaxRows
int launch_nof_wg(const NofArgs& a, cudaStream_t s) {
  NofWgArgs w{};
  w.kin = a.kin;
  w.use_quat = a.use_quat;
  int n = 0;
  auto add = [&](const Lin& L, int n_out, int ep) {
    wg::Layer& d = w.layers[n++];
    d = wg::Layer{};
    d.img[0] = static_cast<const bf16*>(L.wpe);
    d.k[0] = L.wpe ? a.kin : 0;
    d.img[1] = static_cast<const bf16*>(L.wh);
    d.src[1] = 1;
    d.k[1] = L.wh ? a.width : 0;
    d.n = n_out;
    d.n_pad = wg::width_of(n_out);
    d.ep = ep;
    d.bias = L.b;
  };
  for (int l = 0; l < a.depth; ++l) add(a.layer[l], a.width, wg::kRelu);
  add(a.head, a.n_out, wg::kHeadO);
  w.n_layers = n;
  w.h_blocks = (wg::width_of(a.width) + 63) / 64;
  w.e_blocks = (a.kin + 63) / 64;
  // a ring stage holds the widest slice; E two buffers
  w.stage_bytes = 128 * wg::width_of(a.width);
  const size_t fixed = wg::smem_bytes(0, w.h_blocks, 2 * w.e_blocks,
                                      kNofWgTail, w.stage_bytes);
  w.stages = static_cast<int>((kMaxSmem - fixed) / w.stage_bytes);
  if (w.stages > wg::kMaxStages) w.stages = wg::kMaxStages;
  if (w.stages < 2) return -3;
  const size_t smem = wg::smem_bytes(w.stages, w.h_blocks, 2 * w.e_blocks,
                                     kNofWgTail, w.stage_bytes);
  for (int64_t r0 = 0; r0 < a.n; r0 += wg::kMaxRows) {
    w.n = a.n - r0 < wg::kMaxRows ? a.n - r0 : wg::kMaxRows;
    w.in = a.in + r0 * a.kin;
    w.xyz = a.xyz + 3 * r0;
    w.out = a.out + 3 * r0;
    const int rc = launch(nof_wg_kernel, smem,
                          wg::grid_of((w.n + wg::kRows - 1) / wg::kRows),
                          wg::kThreads, s, w);
    if (rc) return rc;
  }
  return 0;
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
  if (dtype == 1) return launch_nof_wg(a, s);
  // 16-deep slices, or 8 where those leave the tile too little room
  const int e_ld = tile_ld<float>(a.kin), h_ld = tile_ld<float>(a.width);
  auto bytes = [&](int kd) {
    return (static_cast<size_t>(kRT) * (kMaxHeadOut + e_ld + h_ld) +
            4 * kd * kWsLdF) * sizeof(float);
  };
  const int kd = bytes(kKs) <= kMaxSmem ? kKs : kKs / 2;
  const unsigned blocks = static_cast<unsigned>((a.n + kRT - 1) / kRT);
  return launch(nof_tf32_kernel, bytes(kd), blocks, kRTThreads, s, a, kd,
                e_ld, h_ld);
}

extern "C" const char* fused_mlp_error(int code) {
  switch (code) {
    case -1: return "wrong argument count";
    case -2: return "unsupported network shape (depth 1..8, width 2..256 "
                    "and even, as the NeRF's extra layer's, inputs 1..256, "
                    "NoF head 9 or 3 outputs)";
    case -3: return "a tile exceeds the 227 KB of shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
