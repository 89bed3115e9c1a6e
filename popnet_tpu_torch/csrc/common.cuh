// Helpers shared by the kernels of csrc/: a strided walk over a frame in the
// order of its memory, asynchronous copies of it into shared memory, and the
// stage clocks of a build with -DPOPNET_STAGE_CLOCKS.
#pragma once

#include <cuda_runtime.h>

namespace popnet {

// The three dimensions of one frame of a strided tensor, sorted by source
// stride (fastest first), and where each lands in a dense shared-memory
// layout; copied `vec` elements at a time. Built on the host by
// memory_order(); walked on the card by Walk3.
struct Dims3 {
  int n[3];          // extents, fastest-moving source dimension first (in copies)
  long long src[3];  // source strides, in elements
  int dst[3];        // shared-memory strides, in elements
  int vec;           // elements per copy: 1, 2 or 4
};

// Sort the dimensions of a frame (extents n, source strides src, shared
// strides dst) by their source stride, so that threads numbered along the
// walk read neighbouring addresses whatever the layout; merge neighbours that
// form one run in both memories; and copy 16 (or 8) bytes at a time where the
// fastest run, the strides and the frame's address at `base` + b *
// frame_stride allow it, `max_vec` elements at most. Shared memory must start
// 16-byte aligned.
inline Dims3 memory_order(const int n[3], const long long src[3], const int dst[3],
                          const void* base, long long frame_stride, int max_vec = 4) {
  int o[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && src[o[j]] < src[o[j - 1]]; --j) {
      int t = o[j]; o[j] = o[j - 1]; o[j - 1] = t;
    }
  Dims3 d = {{1, 1, 1}, {0, 0, 0}, {0, 0, 0}, 1};
  int m = 0;
  for (int i = 0; i < 3; ++i) {
    const int j = o[i];
    if (n[j] == 1) continue;                       // moves nothing
    if (m > 0 && src[j] == d.n[m - 1] * d.src[m - 1] && dst[j] == d.n[m - 1] * d.dst[m - 1]) {
      d.n[m - 1] *= n[j];
      continue;
    }
    d.n[m] = n[j];
    d.src[m] = src[j];
    d.dst[m] = dst[j];
    ++m;
  }
  for (int v = max_vec; v > 1 && d.vec == 1; v /= 2) {
    bool ok = d.src[0] == 1 && d.dst[0] == 1 && d.n[0] % v == 0 && frame_stride % v == 0 &&
              reinterpret_cast<unsigned long long>(base) % (4 * v) == 0;
    for (int i = 1; i < 3; ++i) ok = ok && d.src[i] % v == 0 && d.dst[i] % v == 0;
    if (ok) {
      d.vec = v;
      d.n[0] /= v;
      d.src[0] = d.dst[0] = v;
    }
  }
  return d;
}

// A mixed-radix counter over Dims3 that starts at element `first` and
// advances by `step` elements, carrying the source and shared-memory offsets
// along: no division or multiplication inside the loop.
struct Walk3 {
  int d0, d1, d2, s0, s1, s2;
  long long src, dsrc, csrc1, csrc2;  // offset, its step, its change on a carry into d1, d2
  int dst, ddst, cdst1, cdst2;
  __device__ Walk3(const Dims3& g, int first, int step) {
    d0 = first % g.n[0]; d1 = (first / g.n[0]) % g.n[1]; d2 = first / (g.n[0] * g.n[1]);
    s0 = step % g.n[0]; s1 = (step / g.n[0]) % g.n[1]; s2 = step / (g.n[0] * g.n[1]);
    src = d0 * g.src[0] + d1 * g.src[1] + d2 * g.src[2];
    dsrc = s0 * g.src[0] + s1 * g.src[1] + s2 * g.src[2];
    csrc1 = g.src[1] - g.n[0] * g.src[0];
    csrc2 = g.src[2] - g.n[1] * g.src[1];
    dst = d0 * g.dst[0] + d1 * g.dst[1] + d2 * g.dst[2];
    ddst = s0 * g.dst[0] + s1 * g.dst[1] + s2 * g.dst[2];
    cdst1 = g.dst[1] - g.n[0] * g.dst[0];
    cdst2 = g.dst[2] - g.n[1] * g.dst[1];
  }
  __device__ bool more(const Dims3& g) const { return d2 < g.n[2]; }
  __device__ void next(const Dims3& g) {
    src += dsrc;
    dst += ddst;
    d0 += s0;
    d1 += s1;
    d2 += s2;
    if (d0 >= g.n[0]) { d0 -= g.n[0]; d1 += 1; src += csrc1; dst += cdst1; }
    if (d1 >= g.n[1]) { d1 -= g.n[1]; d2 += 1; src += csrc2; dst += cdst2; }
  }
};

template <int kBytes, bool kLimit>
__device__ __forceinline__ void cp_async_walk(unsigned base, const float* src, const Dims3& g,
                                              int limit) {
  for (Walk3 w(g, threadIdx.x, blockDim.x); w.more(g); w.next(g)) {
    if (kLimit && w.dst >= limit) continue;
    if (kBytes == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 4u * w.dst),
                   "l"(src + w.src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(base + 4u * w.dst),
                   "l"(src + w.src), "n"(kBytes));
  }
}

template <bool kLimit>
__device__ __forceinline__ void cp_async_dims(float* dst, const float* src, const Dims3& g,
                                              int limit) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  if (g.vec == 4)
    cp_async_walk<16, kLimit>(base, src, g, limit);
  else if (g.vec == 2)
    cp_async_walk<8, kLimit>(base, src, g, limit);
  else
    cp_async_walk<4, kLimit>(base, src, g, limit);
}

// Copy the frame at `src` into shared memory at `dst` through the walk: one
// asynchronous copy of g.vec elements per step, threads numbered in memory
// order, so a warp's copies fall on neighbouring addresses. Completes at
// cp_async_wait_all().
__device__ __forceinline__ void cp_async_frame(float* dst, const float* src, const Dims3& g) {
  cp_async_dims<false>(dst, src, g, 0);
}

// The same copy of only the elements whose shared-memory offset is below
// `limit`: the first rows of a walk built on the host for more rows, as a
// kernel whose bands differ in height takes them (find_peaks.cu).
__device__ __forceinline__ void cp_async_rows(float* dst, const float* src, const Dims3& g,
                                              int limit) {
  cp_async_dims<true>(dst, src, g, limit);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace popnet

// Stage clocks: a build with -DPOPNET_STAGE_CLOCKS records, per block,
// clock64() after a block barrier at each STAGE_STAMP(i) into a device
// array that popnet_stage_clocks copies out (chip_smoke.py phase 5 turns the
// differences into a breakdown of each kernel's time). The normal build
// compiles the stamps to nothing.
#ifdef POPNET_STAGE_CLOCKS
namespace popnet {
constexpr int kStampBlocks = 4096, kStamps = 8;
__device__ long long g_stage_clocks[kStampBlocks * kStamps];
}  // namespace popnet
#define STAGE_STAMP(i)                                                              \
  do {                                                                              \
    __syncthreads();                                                                \
    if (threadIdx.x == 0 && blockIdx.x < popnet::kStampBlocks)                      \
      popnet::g_stage_clocks[blockIdx.x * popnet::kStamps + (i)] = clock64();       \
  } while (0)
// The block's start or end on the card's global nanosecond timer, into
// stamp slot i (a kernel that records its blocks' spans uses the last two).
#define BLOCK_SPAN(i)                                                               \
  do {                                                                              \
    __syncthreads();                                                                \
    if (threadIdx.x == 0 && blockIdx.x < popnet::kStampBlocks) {                    \
      unsigned long long t;                                                         \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                        \
      popnet::g_stage_clocks[blockIdx.x * popnet::kStamps + (i)] = (long long)t;    \
    }                                                                               \
  } while (0)
extern "C" int popnet_stage_clocks(void* dst, int n) {
  if (n > popnet::kStampBlocks * popnet::kStamps) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(dst, popnet::g_stage_clocks, n * sizeof(long long));
}
// Zero the stamps, so that blocks beyond a smaller grid than the last one
// read as not run.
extern "C" int popnet_stage_clocks_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, popnet::g_stage_clocks);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(popnet::g_stage_clocks));
  return (int)e;
}
#else
#define STAGE_STAMP(i) \
  do {                 \
  } while (0)
#define BLOCK_SPAN(i) \
  do {                \
  } while (0)
#endif
