// Warp-specialised row tile on Hopper's warpgroup tensor-core product
// (wgmma), the bf16 builds of the forward MLP kernels #7 (render_pass.cu)
// and #8 (fused_mlp.cu): a block carries a tile of 128 sample rows through
// an MLP with every activation in shared memory while the weights stream
// from L2.
//
// Block layout: three warpgroups (384 threads), one block an SM (~220 KB
// of shared memory), a persistent grid that walks the tiles. Warpgroup 0
// is the producer: one elected thread copies the weight slices, in the
// order the layers use them, tile after tile, into a ring of shared-memory
// stages (32 KB, or a kernel's largest slice) with cp.async.bulk, each
// completing on the stage's "full" mbarrier; so the next tile's first
// slices arrive while this one
// ends. Warpgroups 1 and 2 are the consumers and own rows 0-63 and 64-127
// of the tile; each runs every layer on its own rows with
// wgmma.mma_async m64nNk16 (bf16 operands, fp32 accumulation in registers)
// and hands each stage back on its "empty" mbarrier (one arrival per
// consumer warp). The two consumers run their products at the same time:
// one warpgroup's chain of wgmmas on one accumulator keeps the tensor
// cores about half busy on the H100 (measured), two keep them full.
// setmaxnreg moves registers from the producer (40) to the consumers (232:
// a 64 x 256 fp32 accumulator is 128 a thread; 2 x 128 x 232 + 128 x 40 =
// 64,512 of the 65,536, all that the 384 threads hold at launch; #9,
// whose producer warpgroup also loads inputs, splits them 72 / 216); the
// roles split once, in one if/else, and never meet at a block-wide barrier
// again.
//
// Operands, all bf16 in the 128-byte-swizzled K-major layout that wgmma
// reads through a matrix descriptor:
// - A: E (the layer's direct inputs: a packed PE, or pre-embedded rows) and
//   H (the previous activation), each [K / 64 blocks][128 rows][128 bytes];
//   16-byte chunk q of row r sits at chunk q ^ (r % 8). A consumer reads and
//   writes only its own 64 rows of them.
// - B: a weight slice, W^T rows n < n_pad, 64 deep (128 bytes), in the same
//   swizzle, as the wrapper packed it (ops/_args.py wg_pack: zero-padded,
//   swizzled, slices contiguous), so one bulk copy brings a slice without a
//   tensor map.
// N = n_pad in {8, 16, 32, 64, 128, 256} (outputs padded up to the next; the
// padded columns of W^T are zero, so padded outputs are exactly zero). A
// slice always takes its four k-steps: the image is zero past K, and E and
// H, zeroed at the start, hold finite values there.
//
// A layer, per consumer warpgroup: set the accumulators to the fp32 bias
// (plus the per-ray partial); issue every slice's wgmmas, handing the
// previous slice back once the next is issued (wait_group 1); wait_group 0;
// run the epilogue in registers (ReLU, or a head);
// store the result as bf16 into the warpgroup's own rows of H;
// fence.proxy.async so the next wgmma (async proxy) sees the stores; then a
// named barrier of the warpgroup's 128 threads. The in-place update of H is
// safe because the warpgroup's wgmmas that read H have completed (wait_group
// 0) in every warp before any warp of it stores: a named barrier of the
// warpgroup sits between the wait and the stores. No block-wide barrier
// runs per slice or per layer.
//
// Biases, per-ray partials, heads and the quaternion warp stay fp32, with
// explicitly rounded intrinsics; the sigma head is an fp32 dot of the bf16
// activation and the bf16-rounded weight row, fused into the last trunk
// layer's epilogue (the quad of lanes that holds a row sums it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pass_tile.cuh"

namespace {
namespace wg {

constexpr int kRows = 128;               // rows per tile (block)
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kBlockBytes = kRows * 128; // one 64-column block of E or H
constexpr int kStageBytes = 32768;       // a ring stage: one slice at N = 256
constexpr int kMaxStages = 8;            // ring stages of any kernel
constexpr int kMaxLayers = 40;
constexpr int kHeadLd = 16;              // O: NoF head outputs a row, padded
constexpr int64_t kMaxRows = (1ll << 31) - 256;   // rows of one launch

// wgmma width of a layer with n outputs (0 if n is out of range)
__host__ __device__ inline int width_of(int n) {
  if (n < 1 || n > 256) return 0;
  int w = 8;
  while (w < n) w *= 2;
  return w;
}

enum Epilogue {
  kRelu,          // relu((acc + partial) + b) -> H; + the sigma dot if set
  kReluBiasFirst, // relu((acc + b) + partial) -> H (the NeRF extra layer)
  kLinear,        // acc + b -> H (the NeRF final layer)
  kHeadO,         // acc + b -> O (the NoF head, fp32)
  kRgb,           // sigmoid(acc + b) -> rgb
  kOut,           // acc + b -> out (fp32; the layer probe)
};

// One layer: out = A_0 @ W_0 + A_1 @ W_1 (either term may be absent), then
// the epilogue. img[t]: the term's packed slices (ceil(k / 64) of them,
// n_pad rows of 128 bytes each); src[t]: 0 reads E, 1 reads H.
struct Layer {
  const bf16* img[2];
  int src[2];
  int k[2];
  int n, n_pad, ep, sigma;   // sigma: fuse the sigma dot (last trunk layer)
  const float* bias;         // (n,)
  const float* partial;      // (n_rays, n) per-ray partial, or null
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte offset of element (r, c) of an A operand (E or H)
__device__ __forceinline__ int a_off(int r, int c) {
  return (c >> 6) * kBlockBytes + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// matrix descriptor of a 128-byte-swizzled K-major tile at p (1024-byte
// aligned, 8-row groups 1024 bytes apart); a k-step of 16 adds 32 bytes,
// that is 2 to the descriptor
__device__ __forceinline__ uint64_t desc_at(unsigned addr) {
  return ((static_cast<uint64_t>(addr) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_of(const void* p) {
  return desc_at(smem_u32(p));
}

__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(bar), "r"(parity)
                 : "memory");
}

__device__ __forceinline__ void arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier of one consumer warpgroup (ids 1, 2; 0 is __syncthreads, 3
// the stagger of the first layer)
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kN> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kN) : "memory");
}

// keeps the compiler from moving accesses of the accumulator across the
// wgmma fence / wait around it
template <int kR> __device__ __forceinline__ void fence_acc(float (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 A and B from shared memory (descriptors),
// fp32 accumulators d; scale_d 0 overwrites d, 1 accumulates. Thread t of
// the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8 for d[4j + 2],
// d[4j + 3]) and columns 8j + 2 (t % 4) (+ 1 for the odd entries).
template <int kN> struct Mma;

template <> struct Mma<8> {
  template <int kR, int kOff = 0>
  __device__ __forceinline__ static void run(float (&d)[kR], uint64_t a,
                                             uint64_t b, int scale_d) {
    static_assert(kOff + 4 <= kR, "accumulators");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3 "
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]),
          "+f"(d[kOff + 3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Mma<16> {
  template <int kR, int kOff = 0>
  __device__ __forceinline__ static void run(float (&d)[kR], uint64_t a,
                                             uint64_t b, int scale_d) {
    static_assert(kOff + 8 <= kR, "accumulators");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]),
          "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]),
          "+f"(d[kOff + 6]), "+f"(d[kOff + 7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Mma<32> {
  template <int kR, int kOff = 0>
  __device__ __forceinline__ static void run(float (&d)[kR], uint64_t a,
                                             uint64_t b, int scale_d) {
    static_assert(kOff + 16 <= kR, "accumulators");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15 "
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]),
          "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]),
          "+f"(d[kOff + 6]), "+f"(d[kOff + 7]), "+f"(d[kOff + 8]),
          "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]),
          "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]),
          "+f"(d[kOff + 15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Mma<64> {
  template <int kR, int kOff = 0>
  __device__ __forceinline__ static void run(float (&d)[kR], uint64_t a,
                                             uint64_t b, int scale_d) {
    static_assert(kOff + 32 <= kR, "accumulators");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]),
          "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]),
          "+f"(d[kOff + 6]), "+f"(d[kOff + 7]), "+f"(d[kOff + 8]),
          "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]),
          "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]),
          "+f"(d[kOff + 15]), "+f"(d[kOff + 16]), "+f"(d[kOff + 17]),
          "+f"(d[kOff + 18]), "+f"(d[kOff + 19]), "+f"(d[kOff + 20]),
          "+f"(d[kOff + 21]), "+f"(d[kOff + 22]), "+f"(d[kOff + 23]),
          "+f"(d[kOff + 24]), "+f"(d[kOff + 25]), "+f"(d[kOff + 26]),
          "+f"(d[kOff + 27]), "+f"(d[kOff + 28]), "+f"(d[kOff + 29]),
          "+f"(d[kOff + 30]), "+f"(d[kOff + 31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Mma<128> {
  template <int kR, int kOff = 0>
  __device__ __forceinline__ static void run(float (&d)[kR], uint64_t a,
                                             uint64_t b, int scale_d) {
    static_assert(kOff + 64 <= kR, "accumulators");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]),
          "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]),
          "+f"(d[kOff + 6]), "+f"(d[kOff + 7]), "+f"(d[kOff + 8]),
          "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]),
          "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]),
          "+f"(d[kOff + 15]), "+f"(d[kOff + 16]), "+f"(d[kOff + 17]),
          "+f"(d[kOff + 18]), "+f"(d[kOff + 19]), "+f"(d[kOff + 20]),
          "+f"(d[kOff + 21]), "+f"(d[kOff + 22]), "+f"(d[kOff + 23]),
          "+f"(d[kOff + 24]), "+f"(d[kOff + 25]), "+f"(d[kOff + 26]),
          "+f"(d[kOff + 27]), "+f"(d[kOff + 28]), "+f"(d[kOff + 29]),
          "+f"(d[kOff + 30]), "+f"(d[kOff + 31]), "+f"(d[kOff + 32]),
          "+f"(d[kOff + 33]), "+f"(d[kOff + 34]), "+f"(d[kOff + 35]),
          "+f"(d[kOff + 36]), "+f"(d[kOff + 37]), "+f"(d[kOff + 38]),
          "+f"(d[kOff + 39]), "+f"(d[kOff + 40]), "+f"(d[kOff + 41]),
          "+f"(d[kOff + 42]), "+f"(d[kOff + 43]), "+f"(d[kOff + 44]),
          "+f"(d[kOff + 45]), "+f"(d[kOff + 46]), "+f"(d[kOff + 47]),
          "+f"(d[kOff + 48]), "+f"(d[kOff + 49]), "+f"(d[kOff + 50]),
          "+f"(d[kOff + 51]), "+f"(d[kOff + 52]), "+f"(d[kOff + 53]),
          "+f"(d[kOff + 54]), "+f"(d[kOff + 55]), "+f"(d[kOff + 56]),
          "+f"(d[kOff + 57]), "+f"(d[kOff + 58]), "+f"(d[kOff + 59]),
          "+f"(d[kOff + 60]), "+f"(d[kOff + 61]), "+f"(d[kOff + 62]),
          "+f"(d[kOff + 63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Mma<256> {
  template <int kR, int kOff = 0>
  __device__ __forceinline__ static void run(float (&d)[kR], uint64_t a,
                                             uint64_t b, int scale_d) {
    static_assert(kOff + 128 <= kR, "accumulators");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]),
          "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]),
          "+f"(d[kOff + 6]), "+f"(d[kOff + 7]), "+f"(d[kOff + 8]),
          "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]),
          "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]),
          "+f"(d[kOff + 15]), "+f"(d[kOff + 16]), "+f"(d[kOff + 17]),
          "+f"(d[kOff + 18]), "+f"(d[kOff + 19]), "+f"(d[kOff + 20]),
          "+f"(d[kOff + 21]), "+f"(d[kOff + 22]), "+f"(d[kOff + 23]),
          "+f"(d[kOff + 24]), "+f"(d[kOff + 25]), "+f"(d[kOff + 26]),
          "+f"(d[kOff + 27]), "+f"(d[kOff + 28]), "+f"(d[kOff + 29]),
          "+f"(d[kOff + 30]), "+f"(d[kOff + 31]), "+f"(d[kOff + 32]),
          "+f"(d[kOff + 33]), "+f"(d[kOff + 34]), "+f"(d[kOff + 35]),
          "+f"(d[kOff + 36]), "+f"(d[kOff + 37]), "+f"(d[kOff + 38]),
          "+f"(d[kOff + 39]), "+f"(d[kOff + 40]), "+f"(d[kOff + 41]),
          "+f"(d[kOff + 42]), "+f"(d[kOff + 43]), "+f"(d[kOff + 44]),
          "+f"(d[kOff + 45]), "+f"(d[kOff + 46]), "+f"(d[kOff + 47]),
          "+f"(d[kOff + 48]), "+f"(d[kOff + 49]), "+f"(d[kOff + 50]),
          "+f"(d[kOff + 51]), "+f"(d[kOff + 52]), "+f"(d[kOff + 53]),
          "+f"(d[kOff + 54]), "+f"(d[kOff + 55]), "+f"(d[kOff + 56]),
          "+f"(d[kOff + 57]), "+f"(d[kOff + 58]), "+f"(d[kOff + 59]),
          "+f"(d[kOff + 60]), "+f"(d[kOff + 61]), "+f"(d[kOff + 62]),
          "+f"(d[kOff + 63]), "+f"(d[kOff + 64]), "+f"(d[kOff + 65]),
          "+f"(d[kOff + 66]), "+f"(d[kOff + 67]), "+f"(d[kOff + 68]),
          "+f"(d[kOff + 69]), "+f"(d[kOff + 70]), "+f"(d[kOff + 71]),
          "+f"(d[kOff + 72]), "+f"(d[kOff + 73]), "+f"(d[kOff + 74]),
          "+f"(d[kOff + 75]), "+f"(d[kOff + 76]), "+f"(d[kOff + 77]),
          "+f"(d[kOff + 78]), "+f"(d[kOff + 79]), "+f"(d[kOff + 80]),
          "+f"(d[kOff + 81]), "+f"(d[kOff + 82]), "+f"(d[kOff + 83]),
          "+f"(d[kOff + 84]), "+f"(d[kOff + 85]), "+f"(d[kOff + 86]),
          "+f"(d[kOff + 87]), "+f"(d[kOff + 88]), "+f"(d[kOff + 89]),
          "+f"(d[kOff + 90]), "+f"(d[kOff + 91]), "+f"(d[kOff + 92]),
          "+f"(d[kOff + 93]), "+f"(d[kOff + 94]), "+f"(d[kOff + 95]),
          "+f"(d[kOff + 96]), "+f"(d[kOff + 97]), "+f"(d[kOff + 98]),
          "+f"(d[kOff + 99]), "+f"(d[kOff + 100]), "+f"(d[kOff + 101]),
          "+f"(d[kOff + 102]), "+f"(d[kOff + 103]), "+f"(d[kOff + 104]),
          "+f"(d[kOff + 105]), "+f"(d[kOff + 106]), "+f"(d[kOff + 107]),
          "+f"(d[kOff + 108]), "+f"(d[kOff + 109]), "+f"(d[kOff + 110]),
          "+f"(d[kOff + 111]), "+f"(d[kOff + 112]), "+f"(d[kOff + 113]),
          "+f"(d[kOff + 114]), "+f"(d[kOff + 115]), "+f"(d[kOff + 116]),
          "+f"(d[kOff + 117]), "+f"(d[kOff + 118]), "+f"(d[kOff + 119]),
          "+f"(d[kOff + 120]), "+f"(d[kOff + 121]), "+f"(d[kOff + 122]),
          "+f"(d[kOff + 123]), "+f"(d[kOff + 124]), "+f"(d[kOff + 125]),
          "+f"(d[kOff + 126]), "+f"(d[kOff + 127])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// The tiles of this block: blockIdx.x, + gridDim.x, ... below n_tiles (a
// persistent grid of one block an SM walks every tile).
__device__ __forceinline__ int tiles_of(int64_t n_tiles) {
  return static_cast<int>((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
}

// The shared ring of weight slices: stage s at buf + s * bytes (bytes: the
// kernel's largest slice, kStageBytes unless it says otherwise), its full
// and empty mbarriers at full + 8 s, empty + 8 s (shared addresses).
struct Ring {
  unsigned buf, full, empty, bytes;
  int stages, stage;
  unsigned phase;
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// The producer: every slice of every layer of each of the block's tiles, in
// the consumers' order.
__device__ __forceinline__ void produce(const Layer* layers, int n_layers,
                                        int tiles, Ring r) {
  for (int tile = 0; tile < tiles; ++tile)
  for (int l = 0; l < n_layers; ++l) {
    const Layer L = layers[l];   // by value: read once, kept in registers
    const unsigned bytes = static_cast<unsigned>(L.n_pad) * 128u;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          L.img[t]);
      for (int k0 = 0; k0 < L.k[t]; k0 += 64, src += bytes) {
        wait_parity(r.empty + 8 * r.stage, r.phase ^ 1u);
        const unsigned full = r.full + 8 * r.stage;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                full),
            "r"(bytes)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(r.buf + r.stage * r.bytes),
            "l"(src), "r"(bytes), "r"(full)
            : "memory");
        r.advance();
      }
    }
  }
}

// What a consumer thread works on.
struct Ctx {
  unsigned char* E;       // A operands (shared memory)
  unsigned char* H;
  float* X;               // [3][kRows] positions (#7)
  float* O;               // [kRows][kHeadLd] NoF head outputs (#7)
  Ring ring;
  int wgi, tid;           // consumer warpgroup (rows 64 wgi ..), thread in it
  // the tile's first row, the rows, samples a ray: 32-bit (the wrappers
  // keep rows below kMaxRows), which saves registers beside the
  // accumulators and makes the ray of a row a 32-bit division
  int row0, total, s;
  // outputs: sigma[g * sig_rs], rgb[c * rgb_cs + g * rgb_rs], the probe's
  // out[g * out_ld + c], for rows g < total
  float* sigma;
  int sig_rs;
  float* rgb;
  int rgb_cs, rgb_rs;
  float* out;
  int out_ld;
  const float* wsig;      // (W,) fp32 sigma row, rounded to bf16 in the dot
  const float* bsig;      // (1,)
};

// acc += the layer's product for the warpgroup's 64 rows. Every slice
// takes all four of its k-steps: the images are zero past K, and E and H
// hold finite values everywhere (zeroed at the start, then only finite).
template <int kN>
__device__ __forceinline__ void product(float (&acc)[kN / 2], Ctx& c,
                                        const Layer L) {
  fence_acc(acc);         // the accumulators' set-up before the first wgmma
  int prev = -1;          // the previous slice's stage, handed back later
  const bool warp_lane0 = (c.tid & 31) == 0;
#pragma unroll
  for (int t = 0; t < 2; ++t) {   // unrolled: L's arrays stay in registers
    const int K = L.k[t];
    const unsigned char* A = (L.src[t] ? c.H : c.E) + c.wgi * 64 * 128;
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += 64) {
      wait_parity(c.ring.full + 8 * c.ring.stage, c.ring.phase);
      const uint64_t da = desc_of(A + (k0 >> 6) * kBlockBytes);
      const uint64_t db = desc_at(c.ring.buf + c.ring.stage * c.ring.bytes);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q)
        Mma<kN>::run(acc, da + 2 * q, db + 2 * q, 1);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        if (warp_lane0) arrive(c.ring.empty + 8 * prev);
      }
      prev = c.ring.stage;
      c.ring.advance();
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (warp_lane0 && prev >= 0) arrive(c.ring.empty + 8 * prev);
}

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The accumulators' rows and columns: thread t holds rows rb and rb + 8
// (rb = 64 wgi + 16 (t / 32) + (t % 32) / 4; both are (t % 32) / 4 modulo 8)
// and columns 8j + 2 (t % 4) + {0, 1} in acc[4j + 2h + {0, 1}] (h: the row).
// A column past n reads column n - 1 and is set to exactly zero at the end,
// so nothing branches per element.
constexpr int kReluSigma = 100;   // kRelu with the sigma dot

// acc <- the bias (fp32) plus, with kPart, the per-ray partial: the fp32
// terms of the layer's pre-activation, which the product then accumulates
// onto (relu((dot + partial) + b) and relu((dot + b) + partial) of the
// plain versions, in another fp32 summation order). Setting the
// accumulators up before the product takes the loads out of the epilogue,
// which the tensor cores wait for; ptxas then issues a slice's wgmmas one
// at a time (its C7515 note), which costs less here than the loads did.
template <int kN, bool kPart>
__device__ __forceinline__ void init(float (&acc)[kN / 2], const Ctx& c,
                                     const Layer L) {
  const int lane = c.tid & 31, q = lane & 3;
  const int rb = 64 * c.wgi + 16 * (c.tid >> 5) + (lane >> 2);
  const float* part[2] = {nullptr, nullptr};
  if (kPart)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = c.row0 + rb + 8 * h;
      part[h] = L.partial + (g < c.total ? g : c.total - 1) / c.s * L.n;
    }
  if (L.n == kN) {   // every column real: pairs of columns, 8-byte loads
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 b = __ldg(reinterpret_cast<const float2*>(L.bias + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 v = b;
        if (kPart) {
          const float2 p =
              __ldg(reinterpret_cast<const float2*>(part[h] + col));
          v = make_float2(__fadd_rn(p.x, b.x), __fadd_rn(p.y, b.y));
        }
        acc[4 * j + 2 * h] = v.x;
        acc[4 * j + 2 * h + 1] = v.y;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = min(8 * j + 2 * q + e, L.n - 1);
      const float b = __ldg(L.bias + cl);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        acc[4 * j + 2 * h + e] =
            kPart ? __fadd_rn(__ldg(part[h] + cl), b) : b;
    }
}

// The epilogue kEp on the warpgroup's 64 rows (acc holds the whole
// pre-activation): ReLU or nothing, then H (bf16), O, rgb, sigma or out.
template <int kN, int kEp>
__device__ __forceinline__ void epilogue(float (&acc)[kN / 2], Ctx& c,
                                         const Layer L) {
  const int lane = c.tid & 31, q = lane & 3, sw = lane >> 2;
  const int rb = 64 * c.wgi + 16 * (c.tid >> 5) + sw;
  constexpr bool kReluEp = kEp == kRelu || kEp == kReluSigma ||
                           kEp == kReluBiasFirst;
  constexpr bool kToH = kReluEp || kEp == kLinear;
  const int n = L.n;
  int g[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) g[h] = c.row0 + rb + 8 * h;
  float sig[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int col = 8 * j + 2 * q;
    bool ok[2];
    float ws[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ok[e] = col + e < n;
      if (kEp == kReluSigma)
        ws[e] = ok[e] ? bf(__ldg(c.wsig + min(col + e, n - 1))) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rb + 8 * h;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float z = acc[4 * j + 2 * h + e];
        v[e] = ok[e] ? (kReluEp ? fmaxf(z, 0.f) : z) : 0.f;
      }
      if (kToH) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(
            c.H + (j >> 3) * kBlockBytes + r * 128 + (((j ^ sw) & 7) << 4) +
            4 * q) = p;
        if (kEp == kReluSigma)
          sig[h] = fmaf(__high2float(p), ws[1],
                        fmaf(__low2float(p), ws[0], sig[h]));
      } else if (kEp == kHeadO) {
        if (ok[0]) c.O[r * kHeadLd + col] = v[0];
        if (ok[1]) c.O[r * kHeadLd + col + 1] = v[1];
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!ok[e] || g[h] >= c.total) continue;
          if (kEp == kRgb)
            c.rgb[static_cast<int64_t>(col + e) * c.rgb_cs +
                  static_cast<int64_t>(g[h]) * c.rgb_rs] = sigmoid(v[e]);
          else
            c.out[static_cast<int64_t>(g[h]) * c.out_ld + col + e] = v[e];
        }
      }
    }
  }
  if (kEp == kReluSigma) {   // the quad of lanes 4i..4i+3 holds a row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = sig[h];
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
      if (q == 0 && g[h] < c.total)
        c.sigma[static_cast<int64_t>(g[h]) * c.sig_rs] =
            __fadd_rn(s, c.bsig[0]);
    }
  }
}

// One layer of the variant (kEp, kPart) for the warpgroup's 64 rows. The
// two warpgroups run their products at the same time: one warpgroup's
// chain of wgmmas on one accumulator keeps the tensor cores about half
// busy (on the H100, measured), two keep them full.
template <int kN, int kEp, bool kPart>
__device__ __forceinline__ void layer_v(Ctx& c, const Layer L) {
  float acc[kN / 2];
  init<kN, kPart>(acc, c, L);
  product<kN>(acc, c, L);
  // every warp has waited for the wgmmas that read H before any stores
  if (kEp == kRelu || kEp == kReluSigma || kEp == kReluBiasFirst ||
      kEp == kLinear)
    wg_sync(c.wgi);
  epilogue<kN, kEp>(acc, c, L);
  fence_async_smem();   // the stores, before the next wgmma reads them
  wg_sync(c.wgi);
}

// One layer: its variant. The NoF head has at most 16 outputs and the rgb
// head 8, so those variants exist only at those widths.
template <int kN>
__device__ __forceinline__ void layer_n(Ctx& c, const Layer L) {
  const int ep = L.ep;
  const bool part = L.partial != nullptr;
  if (ep == kRelu) {
    if (part) layer_v<kN, kRelu, true>(c, L);
    else if (L.sigma) layer_v<kN, kReluSigma, false>(c, L);
    else layer_v<kN, kRelu, false>(c, L);
  } else if (ep == kReluBiasFirst) {
    if (part) layer_v<kN, kReluBiasFirst, true>(c, L);
    else layer_v<kN, kReluBiasFirst, false>(c, L);
  } else if (ep == kLinear) {
    layer_v<kN, kLinear, false>(c, L);
  } else if (ep == kOut) {
    layer_v<kN, kOut, false>(c, L);
  } else if constexpr (kN <= 16) {
    if (ep == kHeadO) layer_v<kN, kHeadO, false>(c, L);
    else if constexpr (kN == 8) layer_v<kN, kRgb, false>(c, L);
  }
}

// One layer. L by value: its fields stay in registers instead of being
// read again from the kernel's parameters after every store or barrier.
__device__ __forceinline__ void run(Ctx& c, const Layer L) {
  switch (L.n_pad) {
    case 8: layer_n<8>(c, L); break;
    case 16: layer_n<16>(c, L); break;
    case 32: layer_n<32>(c, L); break;
    case 64: layer_n<64>(c, L); break;
    case 128: layer_n<128>(c, L); break;
    default: layer_n<256>(c, L); break;
  }
}

// The persistent grid: one block an SM, or fewer blocks than tiles.
inline unsigned grid_of(int64_t n_tiles) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  return static_cast<unsigned>(n_tiles < sms ? n_tiles : sms);
}

// The warpgroup's rows of E and H <- 0: whatever a product reads past a
// layer's K (up to its 64-column block) is then finite.
__device__ __forceinline__ void zero_rows(Ctx& c, int h_blocks,
                                          int e_blocks) {
  const int per_block = 64 * 128 / 16;   // 16-byte stores a block's rows
  for (int i = c.tid; i < (h_blocks + e_blocks) * per_block; i += 128) {
    const int blk = i / per_block, q = i % per_block;
    unsigned char* A = blk < h_blocks ? c.H + blk * kBlockBytes
                                      : c.E + (blk - h_blocks) * kBlockBytes;
    *reinterpret_cast<uint4*>(A + c.wgi * 64 * 128 + q * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Element (r, c) of E or H <- v (bf16), for the warpgroup's rows.
__device__ __forceinline__ void put(unsigned char* A, int r, int col,
                                    float v) {
  *reinterpret_cast<bf16*>(A + a_off(r, col)) = __float2bfloat16_rn(v);
}

// The warpgroup's rows of E <- rows [row0, row0 + 128) of an (n, k) fp32
// matrix, zeros past column k (to the end of its last 64-column block) and
// in the rows past n; ends with the fence and the warpgroup's barrier.
__device__ __forceinline__ void load_rows(Ctx& c, unsigned char* A,
                                          const float* src, int k) {
  const int kb = (k + 63) & ~63;
  for (int i0 = c.tid; i0 < 64 * kb; i0 += 8 * 128) {   // 8 loads in flight
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * 128, r = 64 * c.wgi + i / kb, j = i % kb;
      const int gi = c.row0 + r;
      v[u] = i < 64 * kb && j < k && gi < c.total
                 ? __ldg(src + static_cast<int64_t>(gi) * k + j)
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * 128;
      if (i < 64 * kb) put(A, 64 * c.wgi + i / kb, i % kb, v[u]);
    }
  }
  fence_async_smem();
  wg_sync(c.wgi);
}

// The warpgroup's rows of E <- the packed PE [x(3), sin(kc), cos(kc)] of
// X, column 3 + f*3 + j = sin(bands[f] * x_j), zeros to the block's end;
// ends with the fence and the warpgroup's barrier.
__device__ __forceinline__ void pe_fill(Ctx& c, const float* bands,
                                        int kc) {
  const int kp = 3 + 2 * kc, kb = (kp + 63) & ~63;
  for (int i = c.tid; i < 64 * kc; i += 128) {
    const int r = 64 * c.wgi + i % 64, f3j = i / 64;
    float s, co;
    sincosf(__fmul_rn(bands[f3j / 3], c.X[(f3j % 3) * kRows + r]), &s, &co);
    put(c.E, r, 3 + f3j, s);
    put(c.E, r, 3 + kc + f3j, co);
  }
  const int extra = 3 + kb - kp;   // x columns, then zero padding
  for (int i = c.tid; i < 64 * extra; i += 128) {
    const int r = 64 * c.wgi + i % 64, j = i / 64;
    if (j < 3) put(c.E, r, j, c.X[j * kRows + r]);
    else put(c.E, r, kp + j - 3, 0.f);
  }
  fence_async_smem();
  wg_sync(c.wgi);
}

// Shared memory of a kernel: the ring (stages x stage_bytes), H (h_blocks)
// and E (e_blocks) 64-column blocks, then `tail` bytes, then the barriers;
// the ring starts at the first 1024-byte boundary of the dynamic
// allocation.
__host__ __device__ inline size_t smem_bytes(int stages, int h_blocks,
                                             int e_blocks, size_t tail,
                                             int stage_bytes = kStageBytes) {
  return 1024 + static_cast<size_t>(stages) * stage_bytes +
         static_cast<size_t>(h_blocks + e_blocks) * kBlockBytes + tail +
         16 * kMaxStages;
}

// Carves the shared memory and initialises the barriers (block-wide; every
// thread calls it before the roles split). The kernel then splits the
// roles in one if/else that never joins again: threads 0-127 call
// producer(), the others consumer() and then the kernel's own layers.
__device__ __forceinline__ void setup(Ctx& c, unsigned char* smem,
                                      int stages, int h_blocks, int e_blocks,
                                      size_t tail,
                                      int stage_bytes = kStageBytes) {
  const unsigned base = smem_u32(smem);
  unsigned char* p = smem + (((base + 1023u) & ~1023u) - base);
  c.ring.buf = smem_u32(p);
  c.ring.bytes = stage_bytes;
  p += stages * stage_bytes;
  c.H = p;
  p += h_blocks * kBlockBytes;
  c.E = p;
  p += e_blocks * kBlockBytes;
  c.X = reinterpret_cast<float*>(p);   // the kernel's own tail
  c.O = c.X + 3 * kRows;
  p += tail;
  c.ring.full = smem_u32(p);
  c.ring.empty = c.ring.full + 8 * kMaxStages;
  c.ring.stages = stages;
  c.ring.stage = 0;
  c.ring.phase = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          c.ring.full + 8 * s));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 8;\n" ::"r"(
          c.ring.empty + 8 * s));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warpgroup: gives its registers up (to kRegs a thread), and
// one thread streams every slice.
template <int kRegs = 40>
__device__ __forceinline__ void producer(const Ctx& c, const Layer* layers,
                                         int n_layers, int64_t n_tiles) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  if (threadIdx.x == 0)
    produce(layers, n_layers, tiles_of(n_tiles), c.ring);
}

// A consumer warpgroup: takes the registers (kRegs a thread; 128 x the
// producer's + 256 x kRegs stays within the 64,512 the block holds at
// launch), and its rows of E and H, which it zeroes.
template <int kRegs = 232>
__device__ __forceinline__ void consumer(Ctx& c, int h_blocks, int e_blocks) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  c.wgi = (threadIdx.x >> 7) - 1;
  c.tid = threadIdx.x & 127;
  zero_rows(c, h_blocks, e_blocks);
}

}  // namespace wg
}  // namespace
