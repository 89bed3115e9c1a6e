// Depth readouts of the Open-Pose+ decode, two kernels in one library.
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
// Bound on the H100: bytes, and at these sizes latency. window_readout
// needs at most 3x3 cells of z and heat per (b, p, k), about 5 MB at
// B=256, P=16, K=15, instead of the 24 MB of whole maps the TPU kernel
// keeps in VMEM; point_readout needs one float per point (B*P*4 bytes) plus
// the indices. Both do a handful of flops per byte. The floor of one such
// launch is two dependent trips to memory: the window centre, then the
// cells it names.
//
// Design: one thread per output, reading the cells it needs straight from
// the tensors through their strides (the maps stay in whatever layout the
// CNN left them, no transpose or copy), so neighbouring threads (joints k
// of one person) read neighbouring channels. For radius 1, the decode's, the
// window is a compile-time 3x3: a thread loads its centre once and then
// issues all 18 z and heat loads at once, from addresses clamped onto the
// map, and takes a zero for each cell outside the clipped window (the plain
// version adds the same zeros, and a sum that starts at +0.0 is unchanged by
// adding +0.0). Other radii walk the clipped window in loops. Sums run
// column by column, each column top to bottom, with __fmul_rn/__fadd_rn/
// __fdiv_rn, in the order of the plain PyTorch versions (ops/kernels.py), so
// the two agree bit for bit. Threads index the outputs in 32-bit arithmetic
// where the count allows, to keep the 64-bit divisions out.

#include <climits>
#include <cuda_runtime.h>

namespace {

// R = 1: the 3x3 window unrolled; R = 0: any radius, in loops.
template <int R>
__global__ void window_readout_kernel(const float* __restrict__ z, long long zb,
                                      long long zy, long long zx, long long zk,
                                      const float* __restrict__ heat, long long hb,
                                      long long hy, long long hx, long long hk,
                                      const int* __restrict__ cx,
                                      const int* __restrict__ cy, long long n_out,
                                      int P, int K, int H, int W, int radius,
                                      float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_out) return;
  int k;
  long long b;
  if (n_out <= INT_MAX) {
    const unsigned u = (unsigned)n;
    k = (int)(u % (unsigned)K);
    b = u / (unsigned)(P * K);
  } else {
    k = (int)(n % K);
    b = n / ((long long)P * K);
  }
  const int r = R > 0 ? R : radius;
  const int cxn = cx[n], cyn = cy[n];
  const int x0 = min(max(cxn - r, 0), W - 1), x1 = min(max(cxn + r, 0), W - 1);
  const int y0 = min(max(cyn - r, 0), H - 1), y1 = min(max(cyn + r, 0), H - 1);
  const float* zp = z + b * zb + k * zk;
  const float* hp = heat + b * hb + k * hk;
  float s_zh = 0.0f, s_h = 0.0f, s_z = 0.0f;
  if constexpr (R > 0) {
    constexpr int S = 2 * R + 1;
    float zv[S][S], hv[S][S];
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
      const long long xz = min(x0 + dx, W - 1) * zx, xh = min(x0 + dx, W - 1) * hx;
#pragma unroll
      for (int dy = 0; dy < S; ++dy) {
        const int yc = min(y0 + dy, H - 1);
        zv[dx][dy] = zp[yc * zy + xz];
        hv[dx][dy] = hp[yc * hy + xh];
      }
    }
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
      float c_zh = 0.0f, c_h = 0.0f, c_z = 0.0f;
#pragma unroll
      for (int dy = 0; dy < S; ++dy) {
        const bool inside = x0 + dx <= x1 && y0 + dy <= y1;
        const float zc = inside ? zv[dx][dy] : 0.0f;
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
        const float zv = zp[y * zy + x * zx];
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
  out[n] = __fdiv_rn(__fadd_rn(s_zh, __fmul_rn(1e-9f, s_z)),
                     __fadd_rn(s_h, __fmul_rn(1e-9f, cnt)));
}

__global__ void point_readout_kernel(const float* __restrict__ img, long long sb,
                                     long long sy, long long sx,
                                     const int* __restrict__ cx,
                                     const int* __restrict__ cy, long long n_out,
                                     int P, int H, int W, float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_out) return;
  const int x = cx[n], y = cy[n];
  const bool in = x >= 0 && x < W && y >= 0 && y < H;
  out[n] = in ? img[(n / P) * sb + y * sy + x * sx] : 0.0f;
}

constexpr int kThreads = 256;
constexpr int kWindowThreads = 128;  // 480 blocks at the main path's 61,440 outputs: 3-4 an SM

unsigned blocks_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

extern "C" int popnet_window_readout(const void* z, long long zb, long long zy,
                                     long long zx, long long zk, const void* heat,
                                     long long hb, long long hy, long long hx,
                                     long long hk, const void* cx, const void* cy,
                                     int B, int P, int K, int H, int W, int radius,
                                     void* out, void* stream) {
  const long long n = (long long)B * P * K;
  if (n < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  auto* kernel = radius == 1 ? window_readout_kernel<1> : window_readout_kernel<0>;
  kernel<<<blocks_for(n, kWindowThreads), kWindowThreads, 0, (cudaStream_t)stream>>>(
      (const float*)z, zb, zy, zx, zk, (const float*)heat, hb, hy, hx, hk,
      (const int*)cx, (const int*)cy, n, P, K, H, W, radius, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int popnet_point_readout(const void* img, long long sb, long long sy,
                                    long long sx, const void* cx, const void* cy,
                                    int B, int P, int H, int W, void* out,
                                    void* stream) {
  const long long n = (long long)B * P;
  if (n < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  point_readout_kernel<<<blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, sb, sy, sx, (const int*)cx, (const int*)cy, n, P, H, W,
      (float*)out);
  return (int)cudaGetLastError();
}
