// Cross-footprint local-maximum mask of heat planes: the first stage of the
// PoP-Net decode's integer peak search.
//
// Replaces: popnet_tpu/ops/pallas_kernels.py peak_local_max_pallas (kernel
// _peak_mask_kernel), reached through peak_mask.
//
// Bound on the H100: bytes. Each cell is read once (4 bytes) and its flag
// written once (1 byte); the four compares per cell are nothing beside that.
// At B*K = 3840 planes of 28x28 that is 15 MB, a few microseconds at the
// memory rate.
//
// Design: one thread per column (b, k, x) of a plane, walking down its H
// cells with the cell above and the cell itself kept in registers, so a cell
// costs three loads (below, left, right), no index arithmetic and no branch;
// the divisions that find (b, k, x) are paid once per column. Planes and flags
// go through their strides, so no transpose or copy is made at the decode's
// NHWC interface. The serving path hands the kernel channels-last memory (its
// CNN runs in that format), tests hand it NCHW memory: the launcher looks at
// the strides and numbers the columns in the order of the memory, channel
// fastest or x fastest, so that a warp reads one run of a row either way; the
// wrapper allocates the flags in the same order. A neighbour off the plane
// counts as -inf. Compares and not fmaxf, so a NaN neighbour clears the flag
// as the maximum of the plain version does. `thresh` folds the `h > thresh`
// of the caller in; -inf gives the TPU kernel's own contract (no threshold).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
peak_mask_kernel(const float* __restrict__ heat, long long sb, long long sk, long long sy,
                 long long sx, int K, int H, int W, int columns, bool channel_fastest,
                 float thresh, bool* __restrict__ out, long long ob, long long ok,
                 long long oy, long long ox) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= columns) return;
  int b, k, x;
  if (channel_fastest) {
    k = i % K; x = i / K % W; b = i / (K * W);
  } else {
    x = i % W; k = i / W % K; b = i / (W * K);
  }
  const float* p = heat + b * sb + k * sk + x * sx;
  bool* o = out + b * ob + k * ok + x * ox;
  const float ninf = -INFINITY;
  const bool has_left = x > 0, has_right = x < W - 1;
  float up = ninf, v = *p;
  for (int y = 0; y < H; ++y) {
    const float down = y < H - 1 ? p[sy] : ninf;
    const float left = has_left ? p[-sx] : ninf;
    const float right = has_right ? p[sx] : ninf;
    // thresh = -inf keeps every cell but NaN, which the four compares drop already
    *o = (v >= up) & (v >= down) & (v >= left) & (v >= right) & (v > thresh || thresh == ninf);
    up = v;
    v = down;
    p += sy;
    o += oy;
  }
}

}  // namespace

extern "C" int popnet_peak_mask(const void* heat, long long sb, long long sk,
                                long long sy, long long sx, int B, int K, int H, int W,
                                float thresh, void* out, long long ob, long long ok,
                                long long oy, long long ox, void* stream) {
  if (B < 1 || K < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long columns = (long long)B * K * W;
  if (columns > 2147483647LL - kThreads) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((columns + kThreads - 1) / kThreads);
  peak_mask_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)heat, sb, sk, sy, sx, K, H, W, (int)columns, sk < sx, thresh, (bool*)out,
      ob, ok, oy, ox);
  return (int)cudaGetLastError();
}
