// Depth readouts of the Open-Pose+ decode: two kernels that each replace a
// TPU kernel, and one launch that runs both for the decode.
//
// window_readout replaces popnet_tpu/ops/pallas_kernels.py
// window_readout_pallas (kernel _window_readout_kernel): the heat-weighted
// pose-depth readout (sum z*relu(h) + 1e-9*sum z) / (sum relu(h) + 1e-9*n)
// over the inclusive window clip(c-1)..clip(c+1), which shrinks at the
// borders and collapses to the edge cell for centres off the map.
//
// point_readout replaces pallas_kernels.py point_readout_pallas (kernel
// _point_readout_kernel): img[b, cy, cx] for pre-clipped points; a point
// off the image reads 0, as the TPU kernel's one-hot product gives.
//
// readouts is what the decode launches: both readouts of decoded joints in
// one kernel, from the CNN's normalized z map and the normalized input
// image. One range of blocks does the windows, the other the points; each
// thread takes its centre or point from the joints (trunc(x / downsample)
// for a window, trunc(clip(x, 0, Wi - 1)) for a point) and undoes the
// normalization on each value it reads, v * std then + mean with two
// roundings (__fmul_rn, __fadd_rn), as eager PyTorch computes it. So no
// full-size denormalized copy of the image (51 MB at B=256) or of the z map
// is ever made, and the decode's readout stage is one launch instead of
// the affine passes and index ops around two kernels. Cells outside a
// clipped window count as +0.0, not as the denormalized 0, and a point off
// the image reads 0, as in the plain version.
//
// Bound on the H100: bytes, and at these sizes latency. A window needs at
// most 3x3 cells of z and heat per (b, p, k), about 5 MB at B=256, P=16,
// K=15, instead of the 24 MB of whole maps the TPU kernel keeps in VMEM; a
// point one value plus its two coordinates. Both do a handful of flops per
// byte. The floor of one such launch is two dependent trips to memory: the
// joint (or the index), then the cells or the value it names; the launch
// itself costs about as much as both (chip_smoke.py's launch floor).
//
// Design: a thread per window and two points per thread, reading what it
// needs straight from the tensors through their strides (the maps stay in
// whatever layout the CNN left them, no transpose or copy), z and image in
// float32 or bfloat16 (widened exactly). For radius 1, the decode's, the
// window is a compile-time 3x3: a thread loads its centre once and then
// issues all 18 z and heat loads at once, from addresses clamped onto the
// map, and takes a zero for each cell outside the clipped window (the plain
// version adds the same zeros, and a sum that starts at +0.0 is unchanged by
// adding +0.0). Other radii walk the clipped window in loops. Sums run
// column by column, each column top to bottom, with __fmul_rn/__fadd_rn/
// __fdiv_rn, in the order of the plain PyTorch versions (ops/kernels.py), so
// the two agree bit for bit. A thread's two points are a block's stride
// apart, so each of their loads is one coalesced access for the warp, and
// all index loads go out before any value load. blockIdx.x is the frame, so
// no thread divides by the points per frame, and offsets inside a frame are
// 32-bit (a frame that spans 2^31 elements or more is refused).
//
// The standalone kernels keep their contracts: window_readout and
// point_readout read maps that are already in metres, and take the builds of
// the same device code without the affine (a compile-time switch: v * 1 + 0
// would turn -0.0 into +0.0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 128;      // a frame of the main path: 2 window blocks, 1 point block
constexpr int kPointsPerThread = 2;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// The input normalization undone: v * scale, then + shift, rounded after
// each step as eager PyTorch rounds them; nothing for the plain build.
struct Affine {
  float scale, shift;
};
template <bool kAffine>
__device__ __forceinline__ float denorm(float v, Affine a) {
  if constexpr (kAffine)
    return __fadd_rn(__fmul_rn(v, a.scale), a.shift);
  else
    return v;
}

// The heat-weighted readout of one window centred at (cxn, cyn) of the (H,
// W) planes at zp (z, any strides) and hp (heat). R = 1: the 3x3 window
// unrolled; R = 0: any radius, in loops.
template <int R, bool kAffine, typename TZ>
__device__ __forceinline__ float window_value(const TZ* zp, int zy, int zx, const float* hp,
                                              int hy, int hx, int cxn, int cyn, int H, int W,
                                              int radius, Affine a) {
  const int r = R > 0 ? R : radius;
  const int x0 = min(max(cxn - r, 0), W - 1), x1 = min(max(cxn + r, 0), W - 1);
  const int y0 = min(max(cyn - r, 0), H - 1), y1 = min(max(cyn + r, 0), H - 1);
  float s_zh = 0.0f, s_h = 0.0f, s_z = 0.0f;
  if constexpr (R > 0) {
    constexpr int S = 2 * R + 1;
    float zv[S][S], hv[S][S];
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
      const int xz = min(x0 + dx, W - 1) * zx, xh = min(x0 + dx, W - 1) * hx;
#pragma unroll
      for (int dy = 0; dy < S; ++dy) {
        const int yc = min(y0 + dy, H - 1);
        zv[dx][dy] = widen(zp[yc * zy + xz]);
        hv[dx][dy] = hp[yc * hy + xh];
      }
    }
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
      float c_zh = 0.0f, c_h = 0.0f, c_z = 0.0f;
#pragma unroll
      for (int dy = 0; dy < S; ++dy) {
        const bool inside = x0 + dx <= x1 && y0 + dy <= y1;
        const float zc = inside ? denorm<kAffine>(zv[dx][dy], a) : 0.0f;
        const float hc = inside ? fmaxf(hv[dx][dy], 0.0f) : 0.0f;
        c_zh = __fadd_rn(c_zh, __fmul_rn(zc, hc));
        c_h = __fadd_rn(c_h, hc);
        c_z = __fadd_rn(c_z, zc);
      }
      s_zh = __fadd_rn(s_zh, c_zh);
      s_h = __fadd_rn(s_h, c_h);
      s_z = __fadd_rn(s_z, c_z);
    }
  } else {
    for (int x = x0; x <= x1; ++x) {
      float c_zh = 0.0f, c_h = 0.0f, c_z = 0.0f;
      for (int y = y0; y <= y1; ++y) {
        const float zv = denorm<kAffine>(widen(zp[y * zy + x * zx]), a);
        const float hv = fmaxf(hp[y * hy + x * hx], 0.0f);
        c_zh = __fadd_rn(c_zh, __fmul_rn(zv, hv));
        c_h = __fadd_rn(c_h, hv);
        c_z = __fadd_rn(c_z, zv);
      }
      s_zh = __fadd_rn(s_zh, c_zh);
      s_h = __fadd_rn(s_h, c_h);
      s_z = __fadd_rn(s_z, c_z);
    }
  }
  const float cnt = (float)((y1 - y0 + 1) * (x1 - x0 + 1));
  return __fdiv_rn(__fadd_rn(s_zh, __fmul_rn(1e-9f, s_z)), __fadd_rn(s_h, __fmul_rn(1e-9f, cnt)));
}

// img[y, x] of one (H, W) image (row and column strides sy, sx); 0 off the
// image.
template <bool kAffine, typename TI>
__device__ __forceinline__ float point_value(const TI* img, int sy, int sx, int x, int y, int H,
                                             int W, Affine a) {
  const bool in = x >= 0 && x < W && y >= 0 && y < H;
  return in ? denorm<kAffine>(widen(img[y * sy + x * sx]), a) : 0.0f;
}

// A frame per blockIdx.x; blockIdx.y numbers kThreads of its P*K outputs.
template <int R>
__global__ void __launch_bounds__(kThreads)
window_readout_kernel(const float* __restrict__ z, long long zb, int zy, int zx, int zk,
                      const float* __restrict__ heat, long long hb, int hy, int hx, int hk,
                      const int* __restrict__ cx, const int* __restrict__ cy, int PK, int K,
                      int H, int W, int radius, float* __restrict__ out) {
  const int i = blockIdx.y * kThreads + threadIdx.x, b = blockIdx.x;
  if (i >= PK) return;
  const long long n = (long long)b * PK + i;
  const int k = i % K;
  out[n] = window_value<R, false>(z + b * zb + k * zk, zy, zx, heat + b * hb + k * hk, hy, hx,
                                  cx[n], cy[n], H, W, radius, Affine{});
}

// A frame per blockIdx.x; blockIdx.y numbers kThreads * kPointsPerThread of
// its P points.
__global__ void __launch_bounds__(kThreads)
point_readout_kernel(const float* __restrict__ img, long long sb, int sy, int sx,
                     const int* __restrict__ cx, const int* __restrict__ cy, int P, int H,
                     int W, float* __restrict__ out) {
  const int b = blockIdx.x, first = blockIdx.y * (kThreads * kPointsPerThread) + threadIdx.x;
  const long long row = (long long)b * P;
  int x[kPointsPerThread], y[kPointsPerThread];
#pragma unroll
  for (int i = 0; i < kPointsPerThread; ++i) {
    const int p = first + i * kThreads;
    x[i] = p < P ? cx[row + p] : -1;
    y[i] = p < P ? cy[row + p] : -1;
  }
#pragma unroll
  for (int i = 0; i < kPointsPerThread; ++i) {
    const int p = first + i * kThreads;
    const float v = point_value<false>(img + b * sb, sy, sx, x[i], y[i], H, W, Affine{});
    if (p < P) out[row + p] = v;
  }
}

// Both readouts of joints (B, P, K, >=2) in one launch. A frame per
// blockIdx.x; blockIdx.y below `window_blocks` numbers kThreads of its P*K
// windows (z_pose), above it kThreads * kPointsPerThread of its points
// (z_raw).
struct Joints {
  const float* p;
  long long sb;
  int sp, sk, sc;
};

template <int R, typename TZ, typename TI>
__global__ void __launch_bounds__(kThreads)
readouts_kernel(const TZ* __restrict__ z, long long zb, int zy, int zx, int zk,
                const float* __restrict__ heat, long long hb, int hy, int hx, int hk,
                Joints jt, const TI* __restrict__ img, long long ib, int iy, int ix, int PK,
                int K, int H, int W, int Hi, int Wi, int radius, float downsample, Affine a,
                int window_blocks, float* __restrict__ z_pose, float* __restrict__ z_raw) {
  const int b = blockIdx.x;
  const float* joints = jt.p + b * jt.sb;
  if ((int)blockIdx.y < window_blocks) {
    const int i = blockIdx.y * kThreads + threadIdx.x;
    if (i >= PK) return;
    const int p = i / K, k = i - p * K;
    const float* j = joints + p * jt.sp + k * jt.sk;
    const int cxn = (int)__fdiv_rn(j[0], downsample), cyn = (int)__fdiv_rn(j[jt.sc], downsample);
    z_pose[(long long)b * PK + i] =
        window_value<R, true>(z + b * zb + k * zk, zy, zx, heat + b * hb + k * hk, hy, hx, cxn,
                              cyn, H, W, radius, a);
    return;
  }
  const int first = (blockIdx.y - window_blocks) * (kThreads * kPointsPerThread) + threadIdx.x;
  float jx[kPointsPerThread], jy[kPointsPerThread];
#pragma unroll
  for (int i = 0; i < kPointsPerThread; ++i) {
    const int q = min(first + i * kThreads, PK - 1);
    const int p = q / K, k = q - p * K;
    const float* j = joints + p * jt.sp + k * jt.sk;
    jx[i] = j[0];
    jy[i] = j[jt.sc];
  }
#pragma unroll
  for (int i = 0; i < kPointsPerThread; ++i) {
    const int q = first + i * kThreads;
    const int x = (int)fminf(fmaxf(jx[i], 0.0f), (float)(Wi - 1));
    const int y = (int)fminf(fmaxf(jy[i], 0.0f), (float)(Hi - 1));
    const float v = point_value<true>(img + b * ib, iy, ix, x, y, Hi, Wi, a);
    if (q < PK) z_raw[(long long)b * PK + q] = v;
  }
}

unsigned blocks_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

// The grid of B frames, `chunks` blocks each: false where it is too large.
bool grid_fits(long long B, long long chunks) { return B <= 0x7fffffffLL && chunks <= 65535; }

// Offsets inside one frame are 32-bit: false where a frame of these extents
// and strides spans 2^31 elements or more.
bool frame_fits(std::initializer_list<long long> extents,
                std::initializer_list<long long> strides) {
  long long span = 0;
  const long long* s = strides.begin();
  for (long long e : extents) {
    const long long st = *s++;
    span += (e - 1) * (st < 0 ? -st : st);
  }
  return span < 0x7fffffffLL;
}

template <int R, typename TZ, typename TI>
cudaError_t launch_readouts(const void* z, const long long* zs, const void* heat,
                            const long long* hs, Joints jt, const void* img,
                            const long long* is, int B, int P, int K, int H, int W, int Hi,
                            int Wi, int radius, float downsample, Affine a, void* z_pose,
                            void* z_raw, cudaStream_t stream) {
  const int PK = P * K;
  const unsigned wb = blocks_for(PK, kThreads), pb = blocks_for(PK, kThreads * kPointsPerThread);
  readouts_kernel<R, TZ, TI><<<dim3(B, wb + pb), kThreads, 0, stream>>>(
      (const TZ*)z, zs[0], (int)zs[1], (int)zs[2], (int)zs[3], (const float*)heat, hs[0],
      (int)hs[1], (int)hs[2], (int)hs[3], jt, (const TI*)img, is[0], (int)is[1], (int)is[2], PK,
      K, H, W, Hi, Wi, radius, downsample, a, (int)wb, (float*)z_pose, (float*)z_raw);
  return cudaGetLastError();
}

template <int R, typename TZ>
cudaError_t launch_readouts_img(int img_bf16, const void* z, const long long* zs,
                                const void* heat, const long long* hs, Joints jt,
                                const void* img, const long long* is, int B, int P, int K,
                                int H, int W, int Hi, int Wi, int radius, float downsample,
                                Affine a, void* z_pose, void* z_raw, cudaStream_t stream) {
  return img_bf16 ? launch_readouts<R, TZ, __nv_bfloat16>(z, zs, heat, hs, jt, img, is, B, P, K,
                                                          H, W, Hi, Wi, radius, downsample, a,
                                                          z_pose, z_raw, stream)
                  : launch_readouts<R, TZ, float>(z, zs, heat, hs, jt, img, is, B, P, K, H, W,
                                                  Hi, Wi, radius, downsample, a, z_pose, z_raw,
                                                  stream);
}

template <int R>
cudaError_t launch_readouts_z(int z_bf16, int img_bf16, const void* z, const long long* zs,
                              const void* heat, const long long* hs, Joints jt, const void* img,
                              const long long* is, int B, int P, int K, int H, int W, int Hi,
                              int Wi, int radius, float downsample, Affine a, void* z_pose,
                              void* z_raw, cudaStream_t stream) {
  return z_bf16 ? launch_readouts_img<R, __nv_bfloat16>(img_bf16, z, zs, heat, hs, jt, img, is,
                                                        B, P, K, H, W, Hi, Wi, radius,
                                                        downsample, a, z_pose, z_raw, stream)
                : launch_readouts_img<R, float>(img_bf16, z, zs, heat, hs, jt, img, is, B, P, K,
                                                H, W, Hi, Wi, radius, downsample, a, z_pose,
                                                z_raw, stream);
}

}  // namespace

extern "C" int popnet_window_readout(const void* z, long long zb, long long zy,
                                     long long zx, long long zk, const void* heat,
                                     long long hb, long long hy, long long hx,
                                     long long hk, const void* cx, const void* cy,
                                     int B, int P, int K, int H, int W, int radius,
                                     void* out, void* stream) {
  const long long PK = (long long)P * K;
  if (B < 1 || PK < 1 || H < 1 || W < 1 || !grid_fits(B, blocks_for(PK, kThreads)) ||
      !frame_fits({H, W, K}, {zy, zx, zk}) || !frame_fits({H, W, K}, {hy, hx, hk}))
    return (int)cudaErrorInvalidValue;
  auto* kernel = radius == 1 ? window_readout_kernel<1> : window_readout_kernel<0>;
  kernel<<<dim3(B, blocks_for(PK, kThreads)), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)z, zb, (int)zy, (int)zx, (int)zk, (const float*)heat, hb, (int)hy, (int)hx,
      (int)hk, (const int*)cx, (const int*)cy, (int)PK, K, H, W, radius, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int popnet_point_readout(const void* img, long long sb, long long sy,
                                    long long sx, const void* cx, const void* cy,
                                    int B, int P, int H, int W, void* out,
                                    void* stream) {
  const unsigned chunks = blocks_for(P, kThreads * kPointsPerThread);
  if (B < 1 || P < 1 || H < 1 || W < 1 || !grid_fits(B, chunks) || !frame_fits({H, W}, {sy, sx}))
    return (int)cudaErrorInvalidValue;
  point_readout_kernel<<<dim3(B, chunks), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, sb, (int)sy, (int)sx, (const int*)cx, (const int*)cy, P, H, W,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int popnet_readouts(const void* z, long long zb, long long zy, long long zx,
                               long long zk, int z_bf16, const void* heat, long long hb,
                               long long hy, long long hx, long long hk, const void* joints,
                               long long jb, long long jp, long long jk, long long jc,
                               const void* img, long long ib, long long iy, long long ix,
                               int img_bf16, int B, int P, int K, int H, int W, int Hi, int Wi,
                               int radius, float downsample, float scale, float shift,
                               void* z_pose, void* z_raw, void* stream) {
  const long long PK = (long long)P * K;
  if (B < 1 || PK < 1 || H < 1 || W < 1 || Hi < 1 || Wi < 1 ||
      !grid_fits(B, blocks_for(PK, kThreads) + blocks_for(PK, kThreads * kPointsPerThread)) ||
      !frame_fits({H, W, K}, {zy, zx, zk}) || !frame_fits({H, W, K}, {hy, hx, hk}) ||
      !frame_fits({P, K, 2}, {jp, jk, jc}) || !frame_fits({Hi, Wi}, {iy, ix}))
    return (int)cudaErrorInvalidValue;
  const long long zs[4] = {zb, zy, zx, zk}, hs[4] = {hb, hy, hx, hk}, is[3] = {ib, iy, ix};
  const Joints jt = {(const float*)joints, jb, (int)jp, (int)jk, (int)jc};
  const Affine a = {scale, shift};
  auto* launch = radius == 1 ? launch_readouts_z<1> : launch_readouts_z<0>;
  return (int)launch(z_bf16, img_bf16, z, zs, heat, hs, jt, img, is, B, P, K, H, W, Hi, Wi,
                     radius, downsample, a, z_pose, z_raw, (cudaStream_t)stream);
}
