// PAF line-integral scoring of every (src, dst) peak pair of every limb.
//
// Replaces: popnet_tpu/ops/pallas_kernels.py paf_sample_pallas (kernel
// _paf_sample_kernel) together with the pair geometry and scoring around it
// in popnet_tpu/decode/device.py score_limb_pairs_batched (method="pallas").
// The kernel computes d, |d| and u from the peaks itself, so the six
// (B, L, M*M) geometry arrays of the TPU path never exist.
//
// Bound on the H100: operations. Inputs are the PAF maps (B*H*W*2L*4 bytes,
// 22.5 MB at B=256, 28x28, L=14), the peaks and their validity; outputs are
// the (B, L, M, M) scores and ok flags (4.6 MB): about 8 us at the memory
// rate. Each of the B*L*M*M*T line points takes 16 taps * 2 channels
// multiply-adds, 8 cubic weights and its coordinates and projection, about
// 170 operations, 1.5 GFLOP at the main-path shape: about 23 us at the
// float32 rate (chip_smoke.py _bounds).
//
// Design: one block per (frame, limb), one thread per src-major pair (M*M =
// 256 threads). The block first builds the limb's two planes edge-padded by
// 2 in shared memory (2 x 32 x 32 floats) straight from the (B, H, W, 2L)
// map through its strides, so the PAF bytes are read once per limb and no
// padded copy is written to device memory. Each thread then walks its T=10
// rounded line points with 4x4 Keys-cubic taps (a = -0.75) from shared
// memory; a tap outside the padded plane contributes 0, it is not clamped.
// Rounding is rintf (half to even, as jnp.round). Products and sums use
// __fmul_rn/__fadd_rn/__fdiv_rn and IEEE sqrtf in the order of the plain
// PyTorch version (ops/kernels.py paf_score_plain), so the two agree bit for
// bit. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float cubic_weight(float frac, int j) {
  // Keys cubic, a = -0.75, for the tap at offset j - 1 from floor
  const float a = -0.75f;
  float tt = fabsf(__fsub_rn(frac, (float)(j - 1)));
  float t2 = __fmul_rn(tt, tt);
  float t3 = __fmul_rn(tt, t2);
  float near_w = __fadd_rn(__fsub_rn(__fmul_rn(1.25f, t3), __fmul_rn(2.25f, t2)), 1.0f);
  float far_w = __fsub_rn(
      __fadd_rn(__fsub_rn(__fmul_rn(a, t3), __fmul_rn(-3.75f, t2)), __fmul_rn(-6.0f, tt)),
      -3.0f);
  return tt <= 1.0f ? near_w : (tt < 2.0f ? far_w : 0.0f);
}

__global__ void paf_score_kernel(const float* __restrict__ paf, long long sb,
                                 long long sy, long long sx, long long sc,
                                 const float* __restrict__ peaks,
                                 const bool* __restrict__ peak_valid,
                                 const int* __restrict__ limbs, int K, int L,
                                 int M, int H, int W, int T, float factor,
                                 float thresh, float len_ref,
                                 float* __restrict__ score_out,
                                 bool* __restrict__ ok_out) {
  extern __shared__ float pl[];  // (2, H + 4, W + 4), edge-padded by 2
  const int Hp = H + 4, Wp = W + 4, HWp = Hp * Wp;
  const int b = blockIdx.x / L, l = blockIdx.x % L;
  const float* src_map = paf + b * sb + (2 * l) * sc;
  for (int i = threadIdx.x; i < 2 * HWp; i += blockDim.x) {
    int c = i / HWp, r = i % HWp;
    int y = min(max(r / Wp - 2, 0), H - 1);
    int x = min(max(r % Wp - 2, 0), W - 1);
    pl[i] = src_map[c * sc + y * sy + x * sx];
  }
  __syncthreads();

  const int ks = limbs[2 * l], kd = limbs[2 * l + 1];
  for (int p = threadIdx.x; p < M * M; p += blockDim.x) {
    const int ms = p / M, md = p % M;
    const float* ps = peaks + ((long long)(b * K + ks) * M + ms) * 3;
    const float* pd = peaks + ((long long)(b * K + kd) * M + md) * 3;
    const float sxv = ps[0], syv = ps[1];
    const float dx = __fsub_rn(pd[0], sxv), dy = __fsub_rn(pd[1], syv);
    const float dist =
        __fadd_rn(sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))), 1e-8f);
    const float ux = __fdiv_rn(dx, dist), uy = __fdiv_rn(dy, dist);
    float acc = 0.0f, cnt = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float ts = (float)((double)t / (double)(T - 1));
      const float pxi = rintf(__fadd_rn(sxv, __fmul_rn(dx, ts)));
      const float pyi = rintf(__fadd_rn(syv, __fmul_rn(dy, ts)));
      const float lx = __fsub_rn(__fdiv_rn(__fadd_rn(pxi, 0.5f), factor), 0.5f);
      const float ly = __fsub_rn(__fdiv_rn(__fadd_rn(pyi, 0.5f), factor), 0.5f);
      const float x0 = floorf(lx), y0 = floorf(ly);
      const float fx = __fsub_rn(lx, x0), fy = __fsub_rn(ly, y0);
      const int x0i = (int)x0, y0i = (int)y0;
      float wy[4];
      for (int j = 0; j < 4; ++j) wy[j] = cubic_weight(fy, j);
      float vx = 0.0f, vy = 0.0f;
      for (int jx = 0; jx < 4; ++jx) {
        const int qx = x0i + 1 + jx;
        float colx = 0.0f, coly = 0.0f;
        for (int jy = 0; jy < 4; ++jy) {
          const int qy = y0i + 1 + jy;
          const bool in = qx >= 0 && qx < Wp && qy >= 0 && qy < Hp;
          const float v0 = in ? pl[qy * Wp + qx] : 0.0f;
          const float v1 = in ? pl[HWp + qy * Wp + qx] : 0.0f;
          colx = __fadd_rn(colx, __fmul_rn(wy[jy], v0));
          coly = __fadd_rn(coly, __fmul_rn(wy[jy], v1));
        }
        const float wx = cubic_weight(fx, jx);
        vx = __fadd_rn(vx, __fmul_rn(wx, colx));
        vy = __fadd_rn(vy, __fmul_rn(wx, coly));
      }
      const float proj = __fadd_rn(__fmul_rn(vx, ux), __fmul_rn(vy, uy));
      acc = __fadd_rn(acc, proj);
      cnt = __fadd_rn(cnt, proj > thresh ? 1.0f : 0.0f);
    }
    const float mean = __fdiv_rn(acc, (float)T);
    const float penalty = fminf(__fsub_rn(__fdiv_rn(len_ref, dist), 1.0f), 0.0f);
    const float score = __fadd_rn(mean, penalty);
    const bool ok = cnt > (float)(0.8 * T) && score > 0.0f &&
                    peak_valid[(b * K + ks) * M + ms] && peak_valid[(b * K + kd) * M + md];
    const long long o = ((long long)(b * L + l) * M + ms) * M + md;
    score_out[o] = score;
    ok_out[o] = ok;
  }
}

}  // namespace

extern "C" int popnet_paf_score(const void* paf, long long sb, long long sy,
                                long long sx, long long sc, const void* peaks,
                                const void* peak_valid, const void* limbs, int B,
                                int K, int L, int M, int H, int W, int T,
                                float factor, float thresh, float len_ref,
                                void* score, void* ok, void* stream) {
  if (B * L < 1 || M < 1 || T < 2 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int threads = M * M < 1024 ? ((M * M + 31) / 32) * 32 : 1024;
  const size_t smem = sizeof(float) * 2 * (size_t)(H + 4) * (W + 4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paf_score_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paf_score_kernel<<<B * L, threads, smem, (cudaStream_t)stream>>>(
      (const float*)paf, sb, sy, sx, sc, (const float*)peaks, (const bool*)peak_valid,
      (const int*)limbs, K, L, M, H, W, T, factor, thresh, len_ref, (float*)score,
      (bool*)ok);
  return (int)cudaGetLastError();
}
