// Deterministic long-K weight and bias gradients of the training backward
// kernels (#2 nerf_rays.cu, #6 chain_bwd.cu): the row-tile passes store each
// layer's input A (rows, m) and masked cotangent dz (rows, n) to a device
// scratch, and dW = A^T dz is one product whose depth K is every row of the
// call, not a tile's.
//
// K is cut into fixed splits of `split_rows` rows, chosen by block index;
// a block keeps its (m, n) output tile in registers over its split and
// writes one partial row, and wgrad_reduce sums the splits in order. So the
// result does not depend on timing, and no float atomicAdd is used. A job
// may list pieces (the rows of several stages that use the same net, or the
// hi/mid/lo bf16 parts of an fp32 operand): a block runs through its split
// of every piece, in order, into the same accumulators. A chunk of a call
// (wrappers cut calls above their scratch cap into chunks of whole rays,
// each a whole number of splits) writes its splits at `split0`, so a call
// in chunks gives the same bits as in one.
//
// Both products run on the tensor cores, in one kernel template
// (matrix_mma_kernel<T>). bf16: mma.sync m16n8k16, 128 x 128 output tiles,
// 64-row K chunks staged with cp.async (double-buffered) and read by
// ldmatrix.trans. fp32: the split-TF32 contract of the row-tile passes
// (row_tile.cuh::mma_split): a = a_hi + a_lo and d = d_hi + d_lo, each
// part rounded by cvt.rna; each 8-row k-step's a_hi d_lo + a_lo d_hi +
// a_hi d_hi is summed from zero on the tensor cores and added to the fp32
// running sum rounding to nearest. It runs on warpgroup wgmma over 128 x
// 128 tiles: 32-row K chunks are loaded into registers a chunk ahead and
// split once, as they land in shared memory, into hi and lo planes. Every
// output element sums its k-steps in row order, so no bit depends on the
// chunking. Bias
// gradients, the sigma row's gradient (a column sum weighted by the fp32
// d(sigma)) and the per-ray partials' gradients (segmented sums over a
// ray's rows) are sums in row order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int kMaxPieces = 4;
constexpr int kMaxJobs = 24;

struct Job {
  int m, n;            // output (m, n), row-major; a column sum has m = 1
  int lda, ldd;        // row strides of A and D, in elements
  int n_pieces;        // 0: the output is 0
  int d_f32;           // column sum: D is fp32 (else the storage type)
  int split;           // column sum: the pieces are hi, mid, lo of one D
  const void* a[kMaxPieces];
  const void* d[kMaxPieces];
  const float* w;      // column sum: per-row weights, or null
  int64_t out;         // offset of the output in a gradient row
};

struct Call {
  int bf16;            // storage type: 1 bf16, 0 fp32
  int64_t rows;        // the chunk's rows (a multiple of split_rows or the
                       // last, shorter split; a multiple of 128)
  int64_t real_rows;   // rows that hold samples (column sums stop there)
  int split_rows;      // a multiple of 128
  int64_t split0;      // the chunk's first split
  float* part;         // (splits, total) fp32
  int64_t total;
  int n_jobs;
  Job job[kMaxJobs];
};

// dW = sum over pieces and rows of A^T D, one partial row per split
int matrix_launch(const Call& c, cudaStream_t s);
// column sums, one partial row per split
int colsum_launch(const Call& c, cudaStream_t s);

// out[ray][c] = sum over pieces of the ray's rows [ray*S, (ray+1)*S) of D
// (storage type, row stride ld), in row order
struct SegJob {
  int n, ld, n_pieces;
  const void* d[kMaxPieces];
  float* out;          // (rays, n)
};
constexpr int kMaxSegJobs = 16;
struct SegCall {
  int bf16, n_jobs;
  int64_t n_rays, s;
  SegJob job[kMaxSegJobs];
};
int segsum_launch(const SegCall& c, cudaStream_t s);

}  // namespace wg
