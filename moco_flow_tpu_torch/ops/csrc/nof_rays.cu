// The single NoF warp over whole rays for Hopper (sm_90a), forward and
// backward.
//
// Replaces the TPU kernels moco_flow_tpu/ops/megakernel.py::_nof_fwd_call
// and ::_nof_bwd_call (via nof_fused_rays / _nof_op): one NoF evaluation a
// sample, the packed PE [x; sin; cos], the ReLU trunk with the per-ray frame
// partials at layer 0 and at the skip layer, and the quaternion head
// (_nof_tile, _nof_quat_fwd_t); the backward recomputes it and runs its VJP
// (_nof_bwd_tile, _nof_quat_bwd_t): dxyz, d(partials) summed per ray, every
// dW / db. The evaluation and its VJP are nof_tile.cuh's; this file only
// tiles the rows.
//
// Callers: the stage-3 step's NoF supervision and mask loss warp the whole
// correspondence set (2 x N_sampled points) as ONE "ray" of S = 2000
// samples, stage 2 will warp 200k points the same way, and the val render
// warps 16384 rays x 128 samples (forward only).
//
// What bounds it on this card: compute. At full width (NoF 4x128, 33 packed
// PE inputs, 9 head outputs) an evaluation is ~59k multiply-adds against
// 12 bytes of xyz in and 12 out (forward), far above the ~295 FLOP/byte
// where the card stops being memory-bound. The backward adds the
// weight-gradient adds into each block's fp32 partial row (~58k values a
// tile).
//
// What the design does about it: the rows are flat, rays x samples, and a
// tile is R consecutive rows, so a single long ray spreads over as many
// blocks as it has tiles (parallelism from the sample axis, not from rays).
// A tile's activations stay in shared memory; the weights (~0.1 MB) stay in
// L2. The backward is a persistent grid (one block per SM) whose blocks add
// their tiles' dW into their own fp32 row of `part`, reduced in a fixed
// order by sum_rows; a ray's partial gradient goes through one slot per
// (ray, tile), summed in order by sum_segs, however many tiles and blocks
// hold the ray. Both reductions are deterministic. Rows past N*S are
// computed on zeros with zero cotangents and never stored. The bf16 build
// multiplies on tensor cores (mma.sync), the fp32 build with an FFMA loop.

#include "nof_tile.cuh"

namespace {

using namespace mlp;

constexpr int kMaxPe = 4;

struct Warp {
  int64_t n_rays, s;
  int use_quat, n_pe, nseg;
  const float* xyz;                    // (3, N*S)
  const float* parts[kMaxPe];          // per-ray partials (N, W) fp32
  Net net;
  float* out;                          // (3, N*S) warped
  const float* gin;                    // (3, N*S) its cotangent (backward)
  float* dx;                           // (3, N*S)
  float* part;                         // (G, total) per-block dW
  int64_t total;
  float* seg;                          // (n_pe, N, nseg, W)
};

// ---------------------------------------------------------------------------
// Forward: one block per tile
// ---------------------------------------------------------------------------

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
nof_fwd_kernel(const Warp a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = 3 + 2 * a.net.kc;
  float* X = reinterpret_cast<float*>(smem);    // [R][3]
  float* Y = X + R * 3;                          // [R][3]
  float* O = Y + R * 3;                          // [R][kMaxOut]
  T* E = reinterpret_cast<T*>(O + R * kMaxOut);  // [R][kp]
  T* acts = E + R * kp + (kp & 1);               // [depth][R][W]
  Tile t{static_cast<int64_t>(blockIdx.x) * R, a.n_rays * a.s, a.s,
         blockIdx.x};
  load_rows(X, a.xyz, t, R);
  __syncthreads();
  nof_forward<T, R>(a.net, a.parts, a.use_quat, t, X, E, acts, O, Y);
  store_rows(a.out, Y, t, R);
}

// ---------------------------------------------------------------------------
// Backward: persistent grid, one fp32 dW row per block
// ---------------------------------------------------------------------------

template <typename T>
size_t bwd_bytes_per_row(const Warp& a) {
  const int W = a.net.width, kp = 3 + 2 * a.net.kc, D = a.net.depth;
  return sizeof(float) * (4 * 3 + 2 * kMaxOut + W + kp) +
         sizeof(T) * (D * W + kp + kMaxOut + W);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
nof_bwd_kernel(const Warp a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.net.width, kp = 3 + 2 * a.net.kc, D = a.net.depth;
  float* X = reinterpret_cast<float*>(smem);   // [R][3]
  float* G = X + R * 3;                         // [R][3] cotangent
  float* Y = G + R * 3;                         // [R][3] warped (unused)
  float* dX = Y + R * 3;                        // [R][3]
  float* O = dX + R * 3;                        // [R][kMaxOut]
  Work w;
  w.dout = O + R * kMaxOut;                     // [R][kMaxOut]
  w.dh = w.dout + R * kMaxOut;                  // [R][W]
  w.de = w.dh + R * W;                          // [R][kp]
  T* acts = reinterpret_cast<T*>(w.de + R * kp);  // [D][R][W]
  T* E = acts + static_cast<int64_t>(D) * R * W;
  w.E = E;
  w.d9 = E + R * kp;
  w.dz = static_cast<T*>(w.d9) + R * kMaxOut;
  float* P = a.part + static_cast<int64_t>(blockIdx.x) * a.total;
  const Segs sg{a.seg, a.n_rays, a.nseg, a.n_pe};
  const int64_t n_rows = a.n_rays * a.s;
  const int64_t ntiles = (n_rows + R - 1) / R;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    Tile t{tile * R, n_rows, a.s, tile};
    load_rows(X, a.xyz, t, R);
    load_rows(G, a.gin, t, R);
    __syncthreads();
    nof_forward<T, R>(a.net, a.parts, a.use_quat, t, X, E, acts, O, Y);
    nof_backward<T, R>(sg, a.use_quat, a.net, 0, t, X, acts, O, G, dX, P, w);
    store_rows(a.dx, dX, t, R);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Arguments (int64): dtype (0 fp32, 1 bf16), n_rays, S, use_quat, n_pe,
// nseg, blocks (backward grid); xyz; parts[4]; the net block (mlp_tile.cuh
// read_net); out; gin; dx; part; total; seg; dw_out (total,); dparts_out
// (n_pe, N, W).
constexpr int kArgs = 7 + 1 + kMaxPe + (5 + 8 * kMaxDepth + 5) + 8;

struct Decoded {
  Warp a;
  int dtype, blocks;
  float* dw_out;
  float* dparts_out;
};

int decode(const int64_t* p, int n, Decoded* d) {
  if (n != kArgs) return -1;
  Reader rd{p};
  Warp& a = d->a;
  d->dtype = static_cast<int>(rd.i());
  a.n_rays = rd.i();
  a.s = rd.i();
  a.use_quat = static_cast<int>(rd.i());
  a.n_pe = static_cast<int>(rd.i());
  a.nseg = static_cast<int>(rd.i());
  d->blocks = static_cast<int>(rd.i());
  a.xyz = rd.ptr<const float*>();
  for (int j = 0; j < kMaxPe; ++j) a.parts[j] = rd.ptr<const float*>();
  read_net(rd, &a.net);
  a.out = rd.ptr<float*>();
  a.gin = rd.ptr<const float*>();
  a.dx = rd.ptr<float*>();
  a.part = rd.ptr<float*>();
  a.total = rd.i();
  a.seg = rd.ptr<float*>();
  d->dw_out = rd.ptr<float*>();
  d->dparts_out = rd.ptr<float*>();
  if (!net_ok(a.net) || a.net.n_out < 1 || a.n_pe < 1 || a.n_pe > kMaxPe)
    return -2;
  return 0;
}

size_t fwd_bytes(int dtype, int R, const Warp& a) {
  const int W = a.net.width, kp = 3 + 2 * a.net.kc;
  const size_t t = dtype == 1 ? sizeof(bf16) : sizeof(float);
  return sizeof(float) * R * (2 * 3 + kMaxOut) +
         t * (static_cast<size_t>(R) * kp + (kp & 1) +
              static_cast<size_t>(a.net.depth) * R * W);
}

size_t bwd_bytes(int dtype, int R, const Warp& a) {
  return R * (dtype == 1 ? bwd_bytes_per_row<bf16>(a)
                         : bwd_bytes_per_row<float>(a));
}

// the largest row tile whose shared memory fits (the backward's tiles stop
// at 32 rows, as the chain's)
int pick_rows(int dtype, const Warp& a, bool bwd) {
  constexpr int kRows[] = {64, 32, 16, 8};
  for (int R : kRows) {
    if (bwd && R > 32) continue;
    const size_t b = bwd ? bwd_bytes(dtype, R, a) : fwd_bytes(dtype, R, a);
    if (b + 64 <= static_cast<size_t>(kMaxSmem)) return R;
  }
  return 0;
}

template <typename T>
int launch_fwd(const Warp& a, int R, cudaStream_t s) {
  const int64_t n_rows = a.n_rays * a.s;
  const unsigned blocks = static_cast<unsigned>((n_rows + R - 1) / R);
  const size_t smem = fwd_bytes(sizeof(T) == 2 ? 1 : 0, R, a) + 64;
  switch (R) {
    case 64: return launch(nof_fwd_kernel<T, 64>, smem, blocks, s, a);
    case 32: return launch(nof_fwd_kernel<T, 32>, smem, blocks, s, a);
    case 16: return launch(nof_fwd_kernel<T, 16>, smem, blocks, s, a);
    case 8: return launch(nof_fwd_kernel<T, 8>, smem, blocks, s, a);
  }
  return -3;
}

template <typename T>
int launch_bwd(const Warp& a, int R, int blocks, cudaStream_t s) {
  const size_t smem = bwd_bytes(sizeof(T) == 2 ? 1 : 0, R, a) + 64;
  switch (R) {
    case 32: return launch(nof_bwd_kernel<T, 32>, smem, blocks, s, a);
    case 16: return launch(nof_bwd_kernel<T, 16>, smem, blocks, s, a);
    case 8: return launch(nof_bwd_kernel<T, 8>, smem, blocks, s, a);
  }
  return -3;
}

}  // namespace

// Rows per tile the forward (bwd = 0) or backward (bwd = 1) kernel uses for
// these arguments (the wrapper sizes the per-ray slots with it); 0 if none
// fits, < 0 on bad arguments.
extern "C" int nof_rays_tile_rows(const int64_t* p, int n, int bwd) {
  Decoded d;
  const int rc = decode(p, n, &d);
  return rc ? rc : pick_rows(d.dtype, d.a, bwd != 0);
}

extern "C" int nof_rays_fwd_launch(const int64_t* p, int n, void* stream) {
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

// Backward: the kernel on `blocks` blocks (part holds that many rows,
// zeroed, seg zeroed), then dw_out = the rows of part summed in order and
// dparts_out = each ray's slots summed in order.
extern "C" int nof_rays_bwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  int rc = decode(p, n, &d);
  if (rc) return rc;
  const Warp& a = d.a;
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
  const int W = a.net.width;
  const int64_t nq = static_cast<int64_t>(a.n_pe) * a.n_rays;
  sum_segs<<<reduce_blocks(nq * W), kThreads, 0, s>>>(a.seg, a.nseg, W, nq,
                                                      d.dparts_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nof_rays_error(int code) { return error_string(code); }
