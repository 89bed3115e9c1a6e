// Peak front end of the Open-Pose+ decode: cross NMS + threshold, top-M by
// M rounds of block-wide argmax, and windowed 5x5 bicubic subpixel refine.
//
// Replaces: popnet_tpu/ops/pallas_kernels.py find_peaks_pallas_bt (kernel
// _find_peaks_bt_kernel), the default peak refine of the TPU decode, and its
// per-row twin find_peaks_pallas.
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
    const int cx = pk_x[m], cy = pk_y[m];
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
    float bv = -INFINITY;
    int bi = INT_MAX;
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
    if (lane == 0) {
      loc_out[obase + m] = bi;
      score_out[obase + m] = bv;
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
