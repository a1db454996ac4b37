// A card-only test entry point of wg_tile.cuh: one layer of the wgmma tile,
// out = a @ w + b for rows of a (rows, K) fp32 matrix (rounded to bf16) and
// one packed weight (ops/_args.py wg_pack), fp32 out (rows, n). The tests
// and chip_smoke.py hold it against the plain product before any kernel is
// built on the tile; no main path calls it.

#include "wg_tile.cuh"

namespace {

struct ProbeArgs {
  int64_t rows;
  const float* a;         // (rows, K)
  float* out;             // (rows, n)
  int stages;
  wg::Layer layer;
};

__global__ void __launch_bounds__(wg::kThreads, 1)
wg_probe_kernel(const __grid_constant__ ProbeArgs p) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  wg::Ctx c;
  wg::setup(c, wg_smem, p.stages, 4, 0, 0);
  const int64_t n_tiles = (p.rows + wg::kRows - 1) / wg::kRows;
  if (threadIdx.x < 128) {
    wg::producer(c, &p.layer, 1, n_tiles);
  } else {
    wg::consumer(c, 4, 0);
    c.total = static_cast<int>(p.rows);
    c.s = 1;
    c.out = p.out;
    c.out_ld = p.layer.n;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      c.row0 = static_cast<int>(tile * wg::kRows);
      wg::load_rows(c, c.H, p.a, p.layer.k[0]);
      switch (p.layer.n_pad) {   // the product and the kOut epilogue only
        case 8: wg::layer_v<8, wg::kOut, false>(c, p.layer); break;
        case 16: wg::layer_v<16, wg::kOut, false>(c, p.layer); break;
        case 32: wg::layer_v<32, wg::kOut, false>(c, p.layer); break;
        case 64: wg::layer_v<64, wg::kOut, false>(c, p.layer); break;
        case 128: wg::layer_v<128, wg::kOut, false>(c, p.layer); break;
        default: wg::layer_v<256, wg::kOut, false>(c, p.layer); break;
      }
    }
  }
}

}  // namespace

// args (int64): rows, K, n, a, w (the packed slices), b (n,) fp32, out.
// Returns 0, a cudaError_t, or -1 bad arg count, -2 bad shape.
extern "C" int wg_probe_launch(const int64_t* p, int n, void* stream) {
  if (n != 7) return -1;
  ProbeArgs a{};
  a.rows = p[0];
  const int k = static_cast<int>(p[1]), n_out = static_cast<int>(p[2]);
  if (k < 1 || k > 256 || !wg::width_of(n_out) || p[0] > wg::kMaxRows)
    return -2;
  a.a = reinterpret_cast<const float*>(p[3]);
  a.out = reinterpret_cast<float*>(p[6]);
  a.stages = 4;
  a.layer.img[0] = reinterpret_cast<const bf16*>(p[4]);
  a.layer.src[0] = 1;
  a.layer.k[0] = k;
  a.layer.n = n_out;
  a.layer.n_pad = wg::width_of(n_out);
  a.layer.ep = wg::kOut;
  a.layer.bias = reinterpret_cast<const float*>(p[5]);
  if (a.rows <= 0) return 0;
  return launch(wg_probe_kernel, wg::smem_bytes(a.stages, 4, 0, 0),
                wg::grid_of((a.rows + wg::kRows - 1) / wg::kRows),
                wg::kThreads, static_cast<cudaStream_t>(stream), a);
}
