// Peak front end of the Open-Pose+ decode: cross NMS + threshold, top-M, and
// windowed 5x5 bicubic subpixel refine. Two kernels with one contract and one
// refine (refine_peak), so they agree bit for bit:
//
// find_peaks_kernel replaces popnet_tpu/ops/pallas_kernels.py
// find_peaks_pallas_bt (kernel _find_peaks_bt_kernel), the default peak refine
// of the TPU decode; find_peaks_row_kernel (below) replaces its per-frame twin
// find_peaks_pallas (kernel _find_peaks_kernel). The notes here are the first
// kernel's; the second has its own.
//
// Bound on the H100: operations. The kernel reads each (H, W) heat plane
// once (B*K*H*W*4 bytes, 12 MB at B=256, K=15, 28x28: about 4 us at the
// memory rate) and writes five (B, K, M) arrays. The refine of each of the M
// slots takes up to 40*5*5 + 40*40*5 multiply-adds over its 5x5 window
// (fewer at the borders, where empty slots refine at the corner), about
// twice the bytes' time at the float32 rate; the NMS pass and the top-M
// pick over its survivors add little (chip_smoke.py _bounds counts both).
// The work per plane is a chain of dependent block-wide reductions, so the
// real limit at this size is latency: 16 argmax rounds, each a
// shared-memory scan plus two barriers.
//
// Design: one block of 256 threads per (frame, joint) plane, 3840 blocks at
// the main-path shape, so every SM holds several planes at once and their
// latencies overlap. The plane and its NMS score map live in shared memory;
// each round is a strided scan, a warp-shuffle argmax on the key (value
// descending, flat index ascending) and one cross-warp step, which picks
// the same cell as the TPU kernel's two-level argmax (first row holding the
// max, then first column). The picked cell is killed by subtracting 1e30.
// The refine is separable, U (40x5) in shared memory: upA = U * patch
// (40x5), then up = upA * U^T (40x40), one warp per peak, warp-shuffle
// argmax over the window. Products and sums use __fmul_rn/__fadd_rn, in the
// order of the plain PyTorch version (ops/kernels.py find_peaks_plain), so
// the two agree bit for bit; the TPU kernel's patch @ Q rounds differently
// and is held to 1e-5 on the score.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPeaks = 32;
constexpr float kSent = -1e30f;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, bv, off);
    int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
}

// Windowed bicubic refine of the peak at (cx, cy) of the (H, W) plane `h` in
// shared memory, by one warp: the (size, size) patch with edge-clamped taps,
// upA = U * patch (S x size), then up = upA * U^T (S x S) restricted to the
// window the border leaves, and its argmax with the first-flat-index tie
// rule. `patch` and `upA` are the warp's scratch in shared memory. Lane 0
// ends with the value in bv and the flat index in bi. Products and sums are
// unfused, in the order of the plain PyTorch version.
__device__ __forceinline__ void refine_peak(const float* h, int H, int W, int cx, int cy,
                                            const float* Us, float* patch, float* upA,
                                            int win, int factor, int lane, float& bv,
                                            int& bi) {
  const int size = 2 * win + 1;
  const int S = size * factor;
  for (int q = lane; q < size * size; q += 32) {
    int i = q / size, j = q % size;
    int ty = min(max(cy + i - win, 0), H - 1);
    int tx = min(max(cx + j - win, 0), W - 1);
    patch[q] = h[ty * W + tx];
  }
  __syncwarp();
  for (int q = lane; q < S * size; q += 32) {
    int s = q / size, j = q % size;
    float acc = __fmul_rn(Us[s * size], patch[j]);
    for (int i = 1; i < size; ++i)
      acc = __fadd_rn(acc, __fmul_rn(Us[s * size + i], patch[i * size + j]));
    upA[q] = acc;
  }
  __syncwarp();
  const int kx0 = max(0, win - cx), kx1 = win + min(W - 1 - cx, win);
  const int ky0 = max(0, win - cy), ky1 = win + min(H - 1 - cy, win);
  bv = -INFINITY;
  bi = INT_MAX;
  for (int q = lane; q < S * S; q += 32) {
    int s = q / S, t = q % S;
    int sw = s / factor, tw = t / factor;
    if (sw < ky0 || sw > ky1 || tw < kx0 || tw > kx1) continue;
    float acc = __fmul_rn(upA[s * size], Us[t * size]);
    for (int j = 1; j < size; ++j)
      acc = __fadd_rn(acc, __fmul_rn(upA[s * size + j], Us[t * size + j]));
    if (better(acc, q, bv, bi)) { bv = acc; bi = q; }
  }
  warp_argmax(bv, bi);
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
find_peaks_kernel(const float* __restrict__ heat, long long sb, long long sk,
                  long long sy, long long sx, int K, int H, int W, int M,
                  float thresh, int win, int factor,
                  const float* __restrict__ U, int* __restrict__ px_out,
                  int* __restrict__ py_out, int* __restrict__ loc_out,
                  float* __restrict__ score_out, bool* __restrict__ valid_out) {
  extern __shared__ float smem[];
  const int HW = H * W;
  const int size = 2 * win + 1;
  const int S = size * factor;
  float* h = smem;                          // (H, W) heat plane
  float* sc = h + HW;                       // (H, W) NMS score map
  float* Us = sc + HW;                      // (S, size) upsample matrix
  float* patches = Us + S * size;           // kWarps x (size, size)
  float* upAs = patches + kWarps * size * size;  // kWarps x (S, size)
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int pk_x[kMaxPeaks], pk_y[kMaxPeaks];
  __shared__ float pk_v[kMaxPeaks];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int plane = blockIdx.x;
  const int b = plane / K, k = plane % K;
  const float* src = heat + b * sb + k * sk;
  for (int i = tid; i < HW; i += kThreads) {
    int y = i / W, x = i % W;
    h[i] = src[y * sy + x * sx];
  }
  for (int i = tid; i < S * size; i += kThreads) Us[i] = U[i];
  __syncthreads();

  // cross-footprint local max (off-map neighbours are -1e30) AND h > thresh
  for (int i = tid; i < HW; i += kThreads) {
    int y = i / W, x = i % W;
    float v = h[i];
    float up = y > 0 ? h[i - W] : kSent;
    float down = y < H - 1 ? h[i + W] : kSent;
    float left = x > 0 ? h[i - 1] : kSent;
    float right = x < W - 1 ? h[i + 1] : kSent;
    float mx = fmaxf(fmaxf(up, down), fmaxf(left, right));
    sc[i] = (v >= mx && v > thresh) ? v : kSent;
  }
  __syncthreads();

  // top-M: M rounds of argmax with the first-flat-index tie rule
  for (int pick = 0; pick < M; ++pick) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < HW; i += kThreads) {
      float v = sc[i];
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    warp_argmax(bv, bi);
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      bv = red_v[0];
      bi = red_i[0];
      for (int w = 1; w < kWarps; ++w)
        if (better(red_v[w], red_i[w], bv, bi)) { bv = red_v[w]; bi = red_i[w]; }
      pk_x[pick] = bi % W;
      pk_y[pick] = bi / W;
      pk_v[pick] = bv;
      sc[bi] = __fsub_rn(sc[bi], 1e30f);
    }
    __syncthreads();
  }

  const long long obase = (long long)plane * M;
  if (tid < M) {
    bool ok = pk_v[tid] > -1e29f;
    if (!ok) { pk_x[tid] = 0; pk_y[tid] = 0; }   // invalid slots refine at (0, 0)
    px_out[obase + tid] = pk_x[tid];
    py_out[obase + tid] = pk_y[tid];
    valid_out[obase + tid] = ok;
  }
  __syncthreads();

  // windowed bicubic refine, one warp per peak
  float* patch = patches + warp * size * size;
  float* upA = upAs + warp * S * size;
  for (int m = warp; m < M; m += kWarps) {
    float bv;
    int bi;
    refine_peak(h, H, W, pk_x[m], pk_y[m], Us, patch, upA, win, factor, lane, bv, bi);
    if (lane == 0) {
      loc_out[obase + m] = bi;
      score_out[obase + m] = bv;
    }
  }
}

// find_peaks_row_kernel: the same function by another design.
//
// Replaces: popnet_tpu/ops/pallas_kernels.py find_peaks_pallas (kernel
// _find_peaks_kernel: one grid cell per frame, all K planes inside).
//
// Bound on the H100: operations, as for find_peaks_kernel (the same bytes and
// the same needed arithmetic). What the first design pays above that bound is
// latency: M block-wide argmax rounds over the whole plane with two barriers
// each, and a refine of every one of the M slots although the empty ones all
// refine the same corner cell.
//
// Design: one block per frame, one warp per joint plane, no block barrier
// after the load. The warp keeps its plane in shared memory, runs the NMS
// once and compacts the surviving cells (ballot + popcount, so the list is in
// ascending flat index) into a list of 16-bit cell indices. Each top-M round
// is then a scan of that short list and one xor-shuffle argmax on (value
// descending, flat index ascending): the pick of the first design. Each pick
// is refined at once by refine_peak; when the survivors run out, the corner
// cell (0, 0) is refined once and its result fills every empty slot.
constexpr int kRowWarps = 16;
constexpr unsigned short kPicked = 0xFFFF;

__global__ void __launch_bounds__(kRowWarps * 32)
find_peaks_row_kernel(const float* __restrict__ heat, long long sb, long long sk,
                      long long sy, long long sx, int K, int H, int W, int M,
                      float thresh, int win, int factor, int list_stride,
                      const float* __restrict__ U, int* __restrict__ px_out,
                      int* __restrict__ py_out, int* __restrict__ loc_out,
                      float* __restrict__ score_out, bool* __restrict__ valid_out) {
  extern __shared__ float smem[];
  const int HW = H * W;
  const int size = 2 * win + 1;
  const int S = size * factor;
  const int nwarps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Us = smem;                                         // (S, size)
  float* h = Us + S * size + warp * HW;                     // this warp's plane
  float* patch = Us + S * size + nwarps * HW + warp * size * size;
  float* upA = Us + S * size + nwarps * (HW + size * size) + warp * S * size;
  unsigned short* list = reinterpret_cast<unsigned short*>(
      Us + S * size + nwarps * (HW + size * size + S * size)) + warp * list_stride;

  for (int i = tid; i < S * size; i += blockDim.x) Us[i] = U[i];
  __syncthreads();

  const int b = blockIdx.x;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int k = warp; k < K; k += nwarps) {
    const float* src = heat + b * sb + k * sk;
    for (int i = lane; i < HW; i += 32) h[i] = src[(i / W) * sy + (i % W) * sx];
    __syncwarp();

    // NMS + threshold once; survivors compacted in ascending flat index
    int n = 0;
    for (int base = 0; base < HW; base += 32) {
      const int i = base + lane;
      bool pass = false;
      if (i < HW) {
        int y = i / W, x = i % W;
        float v = h[i];
        float up = y > 0 ? h[i - W] : kSent;
        float down = y < H - 1 ? h[i + W] : kSent;
        float left = x > 0 ? h[i - 1] : kSent;
        float right = x < W - 1 ? h[i + 1] : kSent;
        float mx = fmaxf(fmaxf(up, down), fmaxf(left, right));
        pass = v >= mx && v > thresh;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, pass);
      if (pass) list[n + __popc(bal & lt_mask)] = (unsigned short)i;
      n += __popc(bal);
    }
    __syncwarp();

    const long long obase = ((long long)b * K + k) * M;
    int m = 0;
    for (; m < M; ++m) {
      float bv = -INFINITY;
      int bi = INT_MAX, bq = -1;
      for (int q = lane; q < n; q += 32) {
        const unsigned short c = list[q];
        if (c == kPicked) continue;
        const float v = h[c];
        if (better(v, (int)c, bv, bi)) { bv = v; bi = c; bq = q; }
      }
      const int mine = bi;
      for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (bi == INT_MAX) break;                 // no survivor left
      if (mine == bi) list[bq] = kPicked;
      const int cx = bi % W, cy = bi / W;
      float rv;
      int ri;
      refine_peak(h, H, W, cx, cy, Us, patch, upA, win, factor, lane, rv, ri);
      if (lane == 0) {
        px_out[obase + m] = cx;
        py_out[obase + m] = cy;
        valid_out[obase + m] = true;
        loc_out[obase + m] = ri;
        score_out[obase + m] = rv;
      }
    }
    if (m < M) {                                // empty slots all refine at (0, 0)
      float rv;
      int ri;
      refine_peak(h, H, W, 0, 0, Us, patch, upA, win, factor, lane, rv, ri);
      rv = __shfl_sync(0xffffffffu, rv, 0);
      ri = __shfl_sync(0xffffffffu, ri, 0);
      for (int e = m + lane; e < M; e += 32) {
        px_out[obase + e] = 0;
        py_out[obase + e] = 0;
        valid_out[obase + e] = false;
        loc_out[obase + e] = ri;
        score_out[obase + e] = rv;
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int popnet_find_peaks(const void* heat, long long sb, long long sk,
                                 long long sy, long long sx, int B, int K, int H,
                                 int W, int M, float thresh, int win, int factor,
                                 const void* U, void* px, void* py, void* loc,
                                 void* score, void* valid, void* stream) {
  if (M < 1 || M > kMaxPeaks || H < 1 || W < 1 || B * K < 1) return (int)cudaErrorInvalidValue;
  const int size = 2 * win + 1, S = size * factor;
  size_t smem = sizeof(float) * (2 * (size_t)H * W + (size_t)S * size +
                                 kWarps * ((size_t)size * size + (size_t)S * size));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(find_peaks_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  find_peaks_kernel<<<B * K, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)heat, sb, sk, sy, sx, K, H, W, M, thresh, win, factor,
      (const float*)U, (int*)px, (int*)py, (int*)loc, (float*)score, (bool*)valid);
  return (int)cudaGetLastError();
}

extern "C" int popnet_find_peaks_row(const void* heat, long long sb, long long sk,
                                     long long sy, long long sx, int B, int K, int H,
                                     int W, int M, float thresh, int win, int factor,
                                     const void* U, void* px, void* py, void* loc,
                                     void* score, void* valid, void* stream) {
  if (M < 1 || M > kMaxPeaks || H < 1 || W < 1 || B < 1 || K < 1 || H * W >= kPicked)
    return (int)cudaErrorInvalidValue;
  const int size = 2 * win + 1, S = size * factor;
  const int nwarps = K < kRowWarps ? K : kRowWarps;
  const int list_stride = (H * W + 1) & ~1;                 // keeps each list 4-byte aligned
  size_t smem = sizeof(float) * ((size_t)S * size +
                                 nwarps * ((size_t)H * W + (size_t)size * size +
                                           (size_t)S * size)) +
                sizeof(unsigned short) * (size_t)nwarps * list_stride;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(find_peaks_row_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  find_peaks_row_kernel<<<B, nwarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)heat, sb, sk, sy, sx, K, H, W, M, thresh, win, factor, list_stride,
      (const float*)U, (int*)px, (int*)py, (int*)loc, (float*)score, (bool*)valid);
  return (int)cudaGetLastError();
}
