// The NoF warp chain of the training step for Hopper (sm_90a), forward.
//
// Replaces the TPU kernel moco_flow_tpu/ops/megakernel.py::_chain_fwd_call
// (via nof_chain_rays_t / _chain_op). Per sample the chain runs up to five
// NoF evaluations (_chain_stages): bw@ind -> cano; fw@ind -> recon (local
// chain); fw@chained -> bw@chained -> fw@ind -> chain_recon (global chain).
// One NoF evaluation is nof_tile.cuh's, the body the single-warp kernels
// (nof_rays.cu) run too: the packed PE [x; sin; cos], a ReLU trunk with
// per-ray frame partials added at layer 0 and at the skip layer, and the
// log-quaternion (or offset) head. The backward (_chain_bwd_call) is
// chain_bwd.cu.
//
// What bounds it on this card: compute. At full width (NoF 4x128, 33 packed
// PE inputs, 9 head outputs) one evaluation is about 59k multiply-adds, so
// the five-stage chain is ~0.6 MFLOP a sample against 12 bytes of xyz in and
// 36 bytes out: thousands of FLOP per byte, far above the ~295 FLOP/byte
// where the card stops being memory-bound.
//
// What the design does about it: a block carries a tile of R consecutive
// sample rows through every stage with all activations in shared memory;
// nothing but xyz, the per-ray partials and the outputs touches device
// memory. The weights (~0.1 MB a net) stay in L2. Rows past N*S are
// computed on zeros and never stored. The bf16 build multiplies on tensor
// cores (mma.sync), the fp32 build with an FFMA loop (mlp_tile.cuh::gemm).

#include "nof_tile.cuh"

namespace {

using namespace mlp;

constexpr int kMaxStages = 5;
constexpr int kMaxSets = 4;
constexpr int kMaxPe = 4;

struct Chain {
  int64_t n_rays, s;
  int n_stages, use_quat, chain_local, chain_global, n_pe;
  int stage_net[kMaxStages], stage_set[kMaxStages];
  int in_src[kMaxStages];              // stage whose output feeds this one
  const float* xyz;                    // (3, N*S)
  const float* parts[kMaxSets][kMaxPe];  // per-ray partials (N, W) fp32
  Net net[2];                          // bw, fw
  float* out[3];                       // cano, recon, chain_recon (3, N*S)
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
// Host side
// ---------------------------------------------------------------------------

// Arguments (int64): dtype (0 fp32, 1 bf16), n_rays, S, n_stages, use_quat,
// chain_local, chain_global, n_pe, then stage_net[5], stage_set[5],
// in_src[5]; xyz; parts[4][4]; the bw and fw net blocks (mlp_tile.cuh
// read_net); out[3].
constexpr int kArgs = 8 + 3 * kMaxStages + 1 + kMaxSets * kMaxPe +
                      2 * (5 + 8 * kMaxDepth + 5) + 3;

struct Decoded {
  Chain a;
  int dtype;
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
  for (int i = 0; i < kMaxStages; ++i) a.stage_net[i] = static_cast<int>(rd.i());
  for (int i = 0; i < kMaxStages; ++i) a.stage_set[i] = static_cast<int>(rd.i());
  for (int i = 0; i < kMaxStages; ++i) a.in_src[i] = static_cast<int>(rd.i());
  a.xyz = rd.ptr<const float*>();
  for (int k = 0; k < kMaxSets; ++k)
    for (int j = 0; j < kMaxPe; ++j) a.parts[k][j] = rd.ptr<const float*>();
  read_net(rd, &a.net[0]);
  read_net(rd, &a.net[1]);
  for (int k = 0; k < 3; ++k) a.out[k] = rd.ptr<float*>();
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

// the largest row tile whose shared memory fits
int pick_rows(int dtype, const Chain& a) {
  constexpr int kRows[] = {64, 32, 16, 8};
  for (int R : kRows)
    if (fwd_bytes(dtype, R, a) + 64 <= static_cast<size_t>(kMaxSmem)) return R;
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

}  // namespace

extern "C" int chain_fwd_launch(const int64_t* p, int n, void* stream) {
  Decoded d;
  int rc = decode(p, n, &d);
  if (rc) return rc;
  if (d.a.n_rays <= 0 || d.a.s <= 0) return 0;
  const int R = pick_rows(d.dtype, d.a);
  if (!R) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d.dtype == 1 ? launch_fwd<bf16>(d.a, R, s)
                      : launch_fwd<float>(d.a, R, s);
}

extern "C" const char* chain_error(int code) { return error_string(code); }
