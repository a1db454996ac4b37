// The NoF warp chain of the training step for Hopper (sm_90a), forward and
// backward.
//
// Replaces the TPU kernels moco_flow_tpu/ops/megakernel.py::_chain_fwd_call
// and ::_chain_bwd_call (via nof_chain_rays_t / _chain_op). Per sample the
// chain runs up to five NoF evaluations (_chain_stages): bw@ind -> cano;
// fw@ind -> recon (local chain); fw@chained -> bw@chained -> fw@ind ->
// chain_recon (global chain). One NoF evaluation and its VJP are
// nof_tile.cuh's, the body the single-warp kernels (nof_rays.cu) run too:
// the packed PE [x; sin; cos], a ReLU trunk with per-ray frame partials
// added at layer 0 and at the skip layer, and the log-quaternion (or offset)
// head. The backward runs
// the chain forward once, keeping every stage's input, activations and head
// output, then the per-warp VJPs in reverse (global, local, bw) as
// _chain_bwd_tile does: the quaternion VJP, the trunk VJP, weight gradients
// summed per net (bw, fw) and partial gradients per partial set.
//
// What bounds it on this card: compute. At full width (NoF 4x128, 33 packed
// PE inputs, 9 head outputs) one evaluation is about 59k multiply-adds, so
// the five-stage chain is ~0.6 MFLOP a sample against 12 bytes of xyz in and
// 36 bytes out (forward): thousands of FLOP per byte, far above the ~295
// FLOP/byte where the card stops being memory-bound. The backward adds the
// weight-gradient sums, which move each block's fp32 partial (~0.5 MB for
// both nets) once per tile.
//
// What the design does about it: a block carries a tile of R consecutive
// sample rows through every stage with all activations in shared memory;
// nothing but xyz, the per-ray partials and the outputs touches device
// memory in the forward. The weights (~0.1 MB a net) stay in L2. The
// backward is a persistent grid (one block per SM), each block adding its
// tiles' weight gradients into its own fp32 row of `part`; sum_rows then
// reduces the rows in a fixed order (deterministic). Rows past N*S are
// computed on zeros with zero cotangents and never stored. The bf16 build
// multiplies on tensor cores (mma.sync), the fp32 build with an FFMA loop
// (mlp_tile.cuh::gemm).

#include "nof_tile.cuh"

namespace {

using namespace mlp;

constexpr int kMaxStages = 5;
constexpr int kMaxSets = 4;
constexpr int kMaxPe = 4;

struct Chain {
  int64_t n_rays, s;
  int n_stages, use_quat, chain_local, chain_global, n_pe, nseg;
  int stage_net[kMaxStages], stage_set[kMaxStages];
  int in_src[kMaxStages];              // stage whose output feeds this one
  const float* xyz;                    // (3, N*S)
  const float* parts[kMaxSets][kMaxPe];  // per-ray partials (N, W) fp32
  Net net[2];                          // bw, fw
  float* out[3];                       // cano, recon, chain_recon (3, N*S)
  const float* gin[3];                 // their cotangents (backward)
  float* dx;                           // (3, N*S)
  float* part;                         // (G, total) per-block dW
  int64_t total;
  float* seg;                          // (sets * n_pe, N, nseg, W)
};

// ---------------------------------------------------------------------------
// Forward: one block per tile
// ---------------------------------------------------------------------------

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
chain_fwd_kernel(const Chain a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = 3 + 2 * a.net[0].kc;
  float* X0 = reinterpret_cast<float*>(smem);   // [R][3] stage input
  float* Xa = X0 + R * 3;                        // stage outputs
  float* Xb = Xa + R * 3;
  float* C = Xb + R * 3;                         // cano
  float* O = C + R * 3;                          // [R][kMaxOut]
  T* E = reinterpret_cast<T*>(O + R * kMaxOut);  // [R][kp]
  T* acts = E + R * kp + (kp & 1);               // [depth][R][W]
  Tile t{static_cast<int64_t>(blockIdx.x) * R, a.n_rays * a.s, a.s,
         blockIdx.x};
  load_rows(X0, a.xyz, t, R);
  __syncthreads();
  const float* in = X0;
  for (int si = 0; si < a.n_stages; ++si) {
    float* outb = in == Xa ? Xb : Xa;
    nof_forward<T, R>(a.net[a.stage_net[si]], a.parts[a.stage_set[si]],
                      a.use_quat, t, in, E, acts, O, outb);
    if (si == 0) {
      for (int i = threadIdx.x; i < R * 3; i += blockDim.x) C[i] = outb[i];
      store_rows(a.out[0], outb, t, R);
      in = C;
    } else if (a.chain_local && si == 1) {
      store_rows(a.out[1], outb, t, R);
      in = C;                                    // the global chain restarts
    } else {
      in = outb;
    }
    __syncthreads();
  }
  if (a.chain_global) store_rows(a.out[2], in, t, R);
}

// ---------------------------------------------------------------------------
// Backward: persistent grid, one fp32 dW row per block
// ---------------------------------------------------------------------------

template <typename T>
size_t bwd_bytes_per_row(const Chain& a) {
  const int W = a.net[0].width, kp = 3 + 2 * a.net[0].kc;
  const int D = a.net[0].depth, ns = a.n_stages;
  return sizeof(float) * (ns * (3 + kMaxOut) + 3 * 3 + kMaxOut + W + kp) +
         sizeof(T) * (ns * D * W + kp + kMaxOut + W);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
chain_bwd_kernel(const Chain a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.net[0].width, kp = 3 + 2 * a.net[0].kc;
  const int D = a.net[0].depth, ns = a.n_stages;
  float* Xin = reinterpret_cast<float*>(smem);  // [ns][R][3]
  float* Ost = Xin + ns * R * 3;                 // [ns][R][kMaxOut]
  float* Gc = Ost + ns * R * kMaxOut;            // [R][3] d cano
  float* Gt = Gc + R * 3;                        // [R][3]
  float* Gu = Gt + R * 3;                        // [R][3]
  Work w;
  w.dout = Gu + R * 3;                           // [R][kMaxOut]
  w.dh = w.dout + R * kMaxOut;                   // [R][W]
  w.de = w.dh + R * W;                           // [R][kp]
  T* acts = reinterpret_cast<T*>(w.de + R * kp);  // [ns][D][R][W]
  T* E = acts + static_cast<int64_t>(ns) * D * R * W;
  w.E = E;
  w.d9 = E + R * kp;
  w.dz = static_cast<T*>(w.d9) + R * kMaxOut;
  float* P = a.part + static_cast<int64_t>(blockIdx.x) * a.total;
  const int64_t n_rows = a.n_rays * a.s;
  const int64_t ntiles = (n_rows + R - 1) / R;
  const int glob0 = a.chain_local ? 2 : 1;
  const Segs sg{a.seg, a.n_rays, a.nseg, a.n_pe};
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    Tile t{tile * R, n_rows, a.s, tile};
    load_rows(Xin, a.xyz, t, R);
    load_rows(Gc, a.gin[0], t, R);
    __syncthreads();
    // the chain forward, keeping each stage's input, activations and head
    for (int si = 0; si < ns; ++si) {
      float* X = Xin + si * R * 3;
      nof_forward<T, R>(a.net[a.stage_net[si]], a.parts[a.stage_set[si]],
                        a.use_quat, t, X,
                        E, acts + static_cast<int64_t>(si) * D * R * W,
                        Ost + si * R * kMaxOut, Gu);
      for (int sj = si + 1; sj < ns; ++sj)
        if (a.in_src[sj] == si)
          for (int i = threadIdx.x; i < R * 3; i += blockDim.x)
            Xin[sj * R * 3 + i] = Gu[i];
      __syncthreads();
    }
    auto vjp = [&](int si, const float* G, float* dX) {
      const int net = a.stage_net[si];
      nof_backward<T, R>(sg, a.use_quat, a.net[net], a.stage_set[si], t,
                         Xin + si * R * 3,
                         acts + static_cast<int64_t>(si) * D * R * W,
                         Ost + si * R * kMaxOut, G, dX, P, w);
    };
    auto add_into_gc = [&]() {
      for (int i = threadIdx.x; i < R * 3; i += blockDim.x)
        Gc[i] = __fadd_rn(Gc[i], Gu[i]);
      __syncthreads();
    };
    if (a.chain_global) {
      load_rows(Gt, a.gin[2], t, R);
      __syncthreads();
      vjp(glob0 + 2, Gt, Gu);
      vjp(glob0 + 1, Gu, Gt);
      vjp(glob0, Gt, Gu);
      add_into_gc();
    }
    if (a.chain_local) {
      load_rows(Gt, a.gin[1], t, R);
      __syncthreads();
      vjp(1, Gt, Gu);
      add_into_gc();
    }
    vjp(0, Gc, Gu);
    store_rows(a.dx, Gu, t, R);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Arguments (int64): dtype (0 fp32, 1 bf16), n_rays, S, n_stages, use_quat,
// chain_local, chain_global, n_pe, nseg, blocks (backward grid), then
// stage_net[5], stage_set[5], in_src[5]; xyz; parts[4][4]; the bw and fw
// net blocks (mlp_tile.cuh read_net); out[3]; gin[3]; dx; part; total; seg;
// dw_out (total,); dparts_out (sets * n_pe, N, W).
constexpr int kArgs = 10 + 3 * kMaxStages + 1 + kMaxSets * kMaxPe +
                      2 * (5 + 8 * kMaxDepth + 5) + 3 + 3 + 6;

struct Decoded {
  Chain a;
  int dtype, blocks;
  float* dw_out;
  float* dparts_out;
};

int decode(const int64_t* p, int n, Decoded* d) {
  if (n != kArgs) return -1;
  Reader rd{p};
  Chain& a = d->a;
  d->dtype = static_cast<int>(rd.i());
  a.n_rays = rd.i();
  a.s = rd.i();
  a.n_stages = static_cast<int>(rd.i());
  a.use_quat = static_cast<int>(rd.i());
  a.chain_local = static_cast<int>(rd.i());
  a.chain_global = static_cast<int>(rd.i());
  a.n_pe = static_cast<int>(rd.i());
  a.nseg = static_cast<int>(rd.i());
  d->blocks = static_cast<int>(rd.i());
  for (int i = 0; i < kMaxStages; ++i) a.stage_net[i] = static_cast<int>(rd.i());
  for (int i = 0; i < kMaxStages; ++i) a.stage_set[i] = static_cast<int>(rd.i());
  for (int i = 0; i < kMaxStages; ++i) a.in_src[i] = static_cast<int>(rd.i());
  a.xyz = rd.ptr<const float*>();
  for (int k = 0; k < kMaxSets; ++k)
    for (int j = 0; j < kMaxPe; ++j) a.parts[k][j] = rd.ptr<const float*>();
  read_net(rd, &a.net[0]);
  read_net(rd, &a.net[1]);
  for (int k = 0; k < 3; ++k) a.out[k] = rd.ptr<float*>();
  for (int k = 0; k < 3; ++k) a.gin[k] = rd.ptr<const float*>();
  a.dx = rd.ptr<float*>();
  a.part = rd.ptr<float*>();
  a.total = rd.i();
  a.seg = rd.ptr<float*>();
  d->dw_out = rd.ptr<float*>();
  d->dparts_out = rd.ptr<float*>();
  const Net& b = a.net[0];
  const Net& f = a.net[1];
  if (!net_ok(b) || !net_ok(f) || b.width != f.width || b.kc != f.kc ||
      b.depth != f.depth || b.n_out != f.n_out || b.n_out < 1 ||
      a.n_stages < 1 || a.n_stages > kMaxStages || a.n_pe < 1 ||
      a.n_pe > kMaxPe)
    return -2;
  return 0;
}

size_t fwd_bytes(int dtype, int R, const Chain& a) {
  const int W = a.net[0].width, kp = 3 + 2 * a.net[0].kc;
  const size_t t = dtype == 1 ? sizeof(bf16) : sizeof(float);
  return sizeof(float) * R * (4 * 3 + kMaxOut) +
         t * (static_cast<size_t>(R) * kp + (kp & 1) +
              static_cast<size_t>(a.net[0].depth) * R * W);
}

size_t bwd_bytes(int dtype, int R, const Chain& a) {
  return R * (dtype == 1 ? bwd_bytes_per_row<bf16>(a)
                         : bwd_bytes_per_row<float>(a));
}

// the largest row tile whose shared memory fits (the backward's tiles
// stop at 32 rows)
int pick_rows(int dtype, const Chain& a, bool bwd) {
  constexpr int kRows[] = {64, 32, 16, 8};
  for (int R : kRows) {
    if (bwd && R > 32) continue;
    const size_t b = bwd ? bwd_bytes(dtype, R, a) : fwd_bytes(dtype, R, a);
    if (b + 64 <= static_cast<size_t>(kMaxSmem)) return R;
  }
  return 0;
}

template <typename T>
int launch_fwd(const Chain& a, int R, cudaStream_t s) {
  const int64_t n_rows = a.n_rays * a.s;
  const unsigned blocks = static_cast<unsigned>((n_rows + R - 1) / R);
  const size_t smem = fwd_bytes(sizeof(T) == 2 ? 1 : 0, R, a) + 64;
  switch (R) {
    case 64: return launch(chain_fwd_kernel<T, 64>, smem, blocks, s, a);
    case 32: return launch(chain_fwd_kernel<T, 32>, smem, blocks, s, a);
    case 16: return launch(chain_fwd_kernel<T, 16>, smem, blocks, s, a);
    case 8: return launch(chain_fwd_kernel<T, 8>, smem, blocks, s, a);
  }
  return -3;
}

template <typename T>
int launch_bwd(const Chain& a, int R, int blocks, cudaStream_t s) {
  const size_t smem = bwd_bytes(sizeof(T) == 2 ? 1 : 0, R, a) + 64;
  switch (R) {
    case 32: return launch(chain_bwd_kernel<T, 32>, smem, blocks, s, a);
    case 16: return launch(chain_bwd_kernel<T, 16>, smem, blocks, s, a);
    case 8: return launch(chain_bwd_kernel<T, 8>, smem, blocks, s, a);
  }
  return -3;
}

}  // namespace

// Rows per tile the forward (bwd = 0) or backward (bwd = 1) kernel uses for
// these arguments (the wrapper sizes the per-ray buffers with it); 0 if
// none fits, < 0 on bad arguments.
extern "C" int chain_tile_rows(const int64_t* p, int n, int bwd) {
  Decoded d;
  const int rc = decode(p, n, &d);
  return rc ? rc : pick_rows(d.dtype, d.a, bwd != 0);
}

extern "C" int chain_fwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  int rc = decode(p, n, &d);
  if (rc) return rc;
  if (d.a.n_rays <= 0 || d.a.s <= 0) return 0;
  const int R = pick_rows(d.dtype, d.a, false);
  if (!R) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d.dtype == 1 ? launch_fwd<bf16>(d.a, R, s)
                      : launch_fwd<float>(d.a, R, s);
}

// Backward: the chain kernel on `blocks` blocks (part holds that many rows,
// zeroed, seg zeroed), then dw_out = the rows of part summed in order and
// dparts_out = each ray's segment slots summed in order.
extern "C" int chain_bwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  int rc = decode(p, n, &d);
  if (rc) return rc;
  const Chain& a = d.a;
  if (a.n_rays <= 0 || a.s <= 0) return 0;
  const int R = pick_rows(d.dtype, a, true);
  if (!R || d.blocks < 1) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = d.dtype == 1 ? launch_bwd<bf16>(a, R, d.blocks, s)
                    : launch_bwd<float>(a, R, d.blocks, s);
  if (rc) return rc;
  sum_rows<<<reduce_blocks(a.total), kThreads, 0, s>>>(a.part, d.blocks,
                                                      a.total, d.dw_out);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const int W = a.net[0].width;
  const int64_t nq = static_cast<int64_t>(kMaxSets) * a.n_pe * a.n_rays;
  sum_segs<<<reduce_blocks(nq * W), kThreads, 0, s>>>(a.seg, a.nseg, W, nq,
                                                      d.dparts_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chain_error(int code) { return error_string(code); }
