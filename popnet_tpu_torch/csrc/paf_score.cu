// PAF line-integral scoring of every (src, dst) peak pair of every limb.
//
// Replaces: popnet_tpu/ops/pallas_kernels.py paf_sample_pallas (kernel
// _paf_sample_kernel) together with the pair geometry and scoring around it
// in popnet_tpu/decode/device.py score_limb_pairs_batched (method="pallas").
// The kernel computes d, |d| and u from the peaks itself, so the six
// (B, L, M*M) geometry arrays of the TPU path never exist.
//
// Bound on the H100: bytes. Inputs are the PAF maps (B*H*W*2L*4 bytes,
// 22.5 MB at B=256, 28x28, L=14), the peaks and their validity; outputs are
// the (B, L, M, M) scores and ok flags (4.6 MB): about 8 us at the memory
// rate (COCO at B=64, 46x46, L=19: 20.6 MB of maps, about 7 us). A pair's
// score is a function of its two coordinates alone, and on the main path
// most slots are empty and share one coordinate (K1's contract), so a limb
// holds about 8 distinct coordinate pairs of its 256:
// their line integrals (10 points x 16 taps x 2 channels, 8 cubic weights,
// about 1700 operations each) take well under the bytes' time
// (chip_smoke.py _bounds). What the kernel pays above the bound: the copy of
// the maps into shared memory, the integrals of the frames with the most
// people (up to 237 distinct pairs a frame against 110 on average), and the
// fill of the 3584 outputs a frame (chip_smoke.py phase 5, stage clocks).
//
// Design: one block of 16 warps per frame and group of limbs. A frame's
// maps go to shared memory whole when they fit one block (G = 1: every
// depth shape; two blocks fit an SM, so 256 frames fill 132 SMs in one
// wave). Larger maps (COCO: 46x46 with 19 limbs, 321.6 KB) are split over G
// blocks a frame, each holding the channels of consecutive limbs
// [l0, l1) = [ceil(g L / G), ceil((g + 1) L / G)): the host takes the
// smallest G whose largest group fits 227 KB (G = 2 at COCO, 10 + 9 limbs,
// 169.3 KB of maps a block). A pair's integral reads its own limb's two
// channels only, so the split changes no bit of any result.
// - Load: the group's (H, W, 2(l1 - l0)) maps go to shared memory in one
//   pass of cp.async copies, threads numbered in the order of the memory the
//   strides show, 16 bytes a copy where the strides allow (one contiguous
//   87.8 KB range on the depth path; 8 bytes a copy from each 152-byte pixel
//   of the COCO maps; common.cuh), stored [y][x][c] so that a tap reads a
//   limb's two channels as one 8-byte word. The copy shape comes from the
//   host, one for the groups of ceil(L / G) limbs and one for those of
//   floor(L / G), at the copy width that every group's address allows.
//   The edge pad is not stored: a tap clamps its cell into the map, and
//   reads 0 beyond the 2-cell pad, as the padded planes of the TPU kernel
//   give. (Padding all 28 depth channels to 32x32 would take 114.7 KB, one
//   block an SM.)
// - While the copies fly, a warp per joint maps each slot to the first slot
//   whose (x, y) has the same bit patterns (__match_any_sync on the bits, so
//   +0.0 and -0.0 or two NaNs of other payloads stay apart) and lists the
//   distinct coordinates; every block of a frame does so for all K joints
//   (a few hundred cycles). Equal inputs through the same arithmetic give the
//   same bits, so integrating each distinct (src, dst) pair once is exact
//   for any input, not only for K1's output.
// - Integrals: a warp takes three distinct pairs at a time, a lane per line
//   point (10 lanes a pair),
//   and the pair's lanes hand their projections by shuffles to be summed in
//   point order, acc = acc + proj, as the plain version sums them.
// - Fill: every (limb, ms, md) takes its distinct pair's score and flag;
//   ok also needs both of its own slots valid. The writes are coalesced.
// Rounding is rintf (half to even, as jnp.round). Products and sums use
// __fmul_rn/__fadd_rn/__fdiv_rn and IEEE sqrtf in the order of the plain
// PyTorch version (ops/kernels.py paf_score_plain), so the two agree bit for
// bit. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxPeaks = 32;
constexpr unsigned kFull = 0xffffffffu;

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

// Projection onto u of the PAF vector (channels ch, ch + 1 of the (H, W, C)
// maps `pafs`) at line point ts of the segment from (sx, sy) along (dx, dy):
// 4x4 Keys-cubic taps of the maps edge-padded by 2, a tap beyond the pad
// reading 0.
__device__ __forceinline__ float line_point(const float* pafs, int H, int W, int C, int ch,
                                            float sx, float sy, float dx, float dy,
                                            float ux, float uy, float ts, float factor) {
  const float pxi = rintf(__fadd_rn(sx, __fmul_rn(dx, ts)));
  const float pyi = rintf(__fadd_rn(sy, __fmul_rn(dy, ts)));
  const float lx = __fsub_rn(__fdiv_rn(__fadd_rn(pxi, 0.5f), factor), 0.5f);
  const float ly = __fsub_rn(__fdiv_rn(__fadd_rn(pyi, 0.5f), factor), 0.5f);
  const float x0 = floorf(lx), y0 = floorf(ly);
  const float fx = __fsub_rn(lx, x0), fy = __fsub_rn(ly, y0);
  const int x0i = (int)x0, y0i = (int)y0;
  int xo[4], yo[4];
  bool xin[4], yin[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {              // padded cell q = x0 + 1 + j is map cell q - 2
    const int qx = x0i + 1 + j, qy = y0i + 1 + j;
    xin[j] = qx >= 0 && qx < W + 4;
    yin[j] = qy >= 0 && qy < H + 4;
    xo[j] = min(max(qx - 2, 0), W - 1) * C + ch;
    yo[j] = min(max(qy - 2, 0), H - 1) * W * C;
  }
  float wx[4], wy[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wx[j] = cubic_weight(fx, j);
    wy[j] = cubic_weight(fy, j);
  }
  float vx = 0.0f, vy = 0.0f;
#pragma unroll
  for (int jx = 0; jx < 4; ++jx) {
    float colx = 0.0f, coly = 0.0f;
#pragma unroll
    for (int jy = 0; jy < 4; ++jy) {
      const float2 v = xin[jx] && yin[jy]
                           ? *reinterpret_cast<const float2*>(pafs + yo[jy] + xo[jx])
                           : make_float2(0.0f, 0.0f);
      colx = __fadd_rn(colx, __fmul_rn(wy[jy], v.x));
      coly = __fadd_rn(coly, __fmul_rn(wy[jy], v.y));
    }
    vx = __fadd_rn(vx, __fmul_rn(wx[jx], colx));
    vy = __fadd_rn(vy, __fmul_rn(wx[jx], coly));
  }
  return __fadd_rn(__fmul_rn(vx, ux), __fmul_rn(vy, uy));
}

// The first limb of group g when L limbs are split into G groups: ceil(g L / G).
__host__ __device__ __forceinline__ int group_start(int g, int L, int G) {
  return (g * L + G - 1) / G;
}

// Shared memory of one block, for a group of L limbs, in this order (4-byte
// items first, so every part stays aligned).
struct Layout {
  int paf, res, xd, yd, woff, nd, lim, map, resok, pv, bytes;
  __host__ __device__ Layout(int K, int L, int M, int H, int W) {
    int o = 0;
    paf = o;   o += 4 * H * W * 2 * L;   // (H, W, 2L) maps of the group's limbs
    res = o;   o += 4 * L * M * M;       // score of each distinct (src, dst) pair, (L, M, M)
    xd = o;    o += 4 * K * M;           // distinct coordinates of each joint, in slot order
    yd = o;    o += 4 * K * M;
    woff = o;  o += 4 * (L + 1);         // first distinct pair of each limb
    nd = o;    o += 4 * K;               // distinct coordinates per joint
    lim = o;   o += 4 * 2 * L;           // (src, dst) joint of each limb
    map = o;   o += K * M;               // slot -> its distinct coordinate
    resok = o; o += L * M * M;           // count > 0.8 T of each distinct pair
    pv = o;    o += K * M;               // peak_valid
    bytes = o;
  }
};

__global__ void __launch_bounds__(kThreads, 2)
paf_score_kernel(const float* __restrict__ paf, long long sb, long long sc, popnet::Dims3 g_hi,
                 popnet::Dims3 g_lo, const float* __restrict__ peaks,
                 const bool* __restrict__ peak_valid, const int* __restrict__ limbs, int K,
                 int L, int ngroups, int M, int H, int W, int T, float factor, float thresh,
                 float len_ref, float* __restrict__ score_out, bool* __restrict__ ok_out) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  // this block's frame and group of limbs; one group a frame (every depth
  // shape) takes no division
  int b = blockIdx.x, l0 = 0, nl = L, Lg = L;       // Lg: limbs of the largest group
  if (ngroups > 1) {
    b = blockIdx.x / ngroups;
    const int grp = blockIdx.x - b * ngroups;
    l0 = group_start(grp, L, ngroups);
    nl = group_start(grp + 1, L, ngroups) - l0;
    Lg = (L + ngroups - 1) / ngroups;
  }
  const Layout ly(K, Lg, M, H, W);
  float* pafs = reinterpret_cast<float*>(smem + ly.paf);
  float* res = reinterpret_cast<float*>(smem + ly.res);
  float* xd = reinterpret_cast<float*>(smem + ly.xd);
  float* yd = reinterpret_cast<float*>(smem + ly.yd);
  int* woff = reinterpret_cast<int*>(smem + ly.woff);
  int* nd = reinterpret_cast<int*>(smem + ly.nd);
  int* lim = reinterpret_cast<int*>(smem + ly.lim);
  unsigned char* map = reinterpret_cast<unsigned char*>(smem + ly.map);
  unsigned char* resok = reinterpret_cast<unsigned char*>(smem + ly.resok);
  bool* pv = reinterpret_cast<bool*>(smem + ly.pv);

  const int C = 2 * nl, MM = M * M;                   // this block's channels and limbs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  STAGE_STAMP(0);
  // the limbs and this warp's first joint's peaks are read before the
  // copies start, so their loads do not queue behind the maps
  const int limb_joint = tid < 2 * nl ? limbs[2 * l0 + tid] : 0;
  float x0 = 0.0f, y0 = 0.0f;
  bool v0 = false;
  if (warp < K && lane < M) {
    const long long o = ((long long)b * K + warp) * M + lane;
    x0 = peaks[o * 3];
    y0 = peaks[o * 3 + 1];
    v0 = peak_valid[o];
  }
  // the walk straight from the parameters: a struct chosen at run time would
  // be copied to the stack and re-read at every step of the walk
  const float* frame = paf + b * sb + 2 * l0 * sc;
  if (nl == Lg)
    popnet::cp_async_frame(pafs, frame, g_hi);
  else
    popnet::cp_async_frame(pafs, frame, g_lo);
  STAGE_STAMP(1);

  // while the maps fly: a warp per joint, a lane per slot
  if (tid < 2 * nl) lim[tid] = limb_joint;
  for (int k = warp; k < K; k += nwarps) {
    const bool on = lane < M;
    float x = x0, y = y0;
    bool v = v0;
    if (k != warp && on) {
      const long long o = ((long long)b * K + k) * M + lane;
      x = peaks[o * 3];
      y = peaks[o * 3 + 1];
      v = peak_valid[o];
    }
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(x) << 32) | __float_as_uint(y);
    const unsigned slots = __ballot_sync(kFull, on);
    int first = lane;                                   // the first slot with my bits
    if (on) first = __ffs(__match_any_sync(slots, key)) - 1;
    const bool distinct = on && first == lane;
    const unsigned reps = __ballot_sync(kFull, distinct);
    const int a = __popc(reps & ((1u << lane) - 1u));   // rank among the distinct slots
    const int mine = __shfl_sync(kFull, a, first);
    if (distinct) { xd[k * M + a] = x; yd[k * M + a] = y; }
    if (on) { map[k * M + lane] = (unsigned char)mine; pv[k * M + lane] = v; }
    if (lane == 0) nd[k] = __popc(reps);
  }
  __syncthreads();
  if (warp == 0) {                                    // distinct pairs per limb, scanned
    int w = lane < nl ? nd[lim[2 * lane]] * nd[lim[2 * lane + 1]] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += v;
    }
    if (lane < nl) woff[lane + 1] = w;
    if (lane == 0) woff[0] = 0;
  }
  STAGE_STAMP(2);
  popnet::cp_async_wait_all();
  __syncthreads();
  STAGE_STAMP(3);

  // line integrals of the distinct pairs: G pairs a warp, a lane per point
  const int G = 32 / T, t = lane % T, gi = lane / T;
  const float ts = (float)((double)t / (double)(T - 1));
  const int total = woff[nl];
  const int limb_end = lane < nl ? woff[lane + 1] : INT_MAX;  // lane l: end of limb l's pairs
  for (int base = warp * G; base < total; base += nwarps * G) {
    const int item = base + gi;
    const bool act = gi < G && item < total;
    int l = 0, a = 0, d = 0;
    for (int g = 0; g < G; ++g) {                    // the limb of each of the G pairs
      const int lg = __popc(__ballot_sync(kFull, limb_end <= base + g));
      if (g == gi) l = lg;
    }
    float proj = 0.0f, dist = 1.0f;
    if (act) {
      const int ks = lim[2 * l], kd = lim[2 * l + 1];
      const int r = item - woff[l];
      a = r / nd[kd];
      d = r - a * nd[kd];
      const float sx = xd[ks * M + a], sy = yd[ks * M + a];
      const float dx = __fsub_rn(xd[kd * M + d], sx), dy = __fsub_rn(yd[kd * M + d], sy);
      dist = __fadd_rn(sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))), 1e-8f);
      const float ux = __fdiv_rn(dx, dist), uy = __fdiv_rn(dy, dist);
      proj = line_point(pafs, H, W, C, 2 * l, sx, sy, dx, dy, ux, uy, ts, factor);
    }
    float acc = 0.0f, cnt = 0.0f;                     // in point order, as the plain sums
    for (int tt = 0; tt < T; ++tt) {
      const float p = __shfl_sync(kFull, proj, min(gi * T + tt, 31));
      acc = __fadd_rn(acc, p);
      cnt = __fadd_rn(cnt, p > thresh ? 1.0f : 0.0f);
    }
    if (act && t == 0) {
      const float mean = __fdiv_rn(acc, (float)T);
      const float penalty = fminf(__fsub_rn(__fdiv_rn(len_ref, dist), 1.0f), 0.0f);
      const float score = __fadd_rn(mean, penalty);
      res[l * MM + a * M + d] = score;
      resok[l * MM + a * M + d] = cnt > (float)(0.8 * T) && score > 0.0f;
    }
  }
  __syncthreads();
  STAGE_STAMP(4);

  // every (limb, ms, md) of the group takes its distinct pair's result, md fastest
  popnet::Dims3 f = {{M, M, nl}, {0, 0, 0}, {0, 0, 0}, 1};
  const long long obase = ((long long)b * L + l0) * MM;
  int o = tid;
  for (popnet::Walk3 w(f, tid, blockDim.x); w.more(f); w.next(f), o += blockDim.x) {
    const int md = w.d0, ms = w.d1, l = w.d2;
    const int ks = lim[2 * l], kd = lim[2 * l + 1];
    const int r = l * MM + map[ks * M + ms] * M + map[kd * M + md];
    score_out[obase + o] = res[r];
    ok_out[obase + o] = resok[r] && pv[ks * M + ms] && pv[kd * M + md];
  }
  STAGE_STAMP(5);
}

constexpr size_t kMaxSmem = 227 * 1024;   // the dynamic shared memory a block may have

// Blocks a frame (groups of limbs) at these sizes: the smallest G whose
// largest group's layout fits kMaxSmem, or 0 where one limb does not fit.
int groups_for(int K, int L, int M, int H, int W) {
  if (8LL * H * W > (long long)kMaxSmem) return 0;   // one limb's two channels alone
  for (int G = 1; G <= L; ++G)
    if ((size_t)Layout(K, (L + G - 1) / G, M, H, W).bytes <= kMaxSmem) return G;
  return 0;
}

// The walk of a group of nl limbs' channels of a frame of the maps into its
// dense (H, W, 2 nl) layout, at most max_vec elements a copy.
popnet::Dims3 group_dims(const float* paf, long long sb, long long sy, long long sx,
                         long long sc, int l0, int nl, int H, int W, int max_vec = 4) {
  const int n[3] = {H, W, 2 * nl};
  const long long src[3] = {sy, sx, sc};
  const int dst[3] = {W * 2 * nl, 2 * nl, 1};
  return popnet::memory_order(n, src, dst, paf + 2 * l0 * sc, sb, max_vec);
}

// The walks of the groups of ceil(L / G) and of floor(L / G) limbs, at the
// widest copy that the address of every group allows.
void frame_walks(const float* paf, long long sb, long long sy, long long sx, long long sc,
                 int L, int G, int H, int W, popnet::Dims3* hi, popnet::Dims3* lo) {
  const int Lg = (L + G - 1) / G;
  int vec = 4, l0_hi = 0, l0_lo = 0;
  for (int g = 0; g < G; ++g) {
    const int l0 = group_start(g, L, G), nl = group_start(g + 1, L, G) - l0;
    const int v = group_dims(paf, sb, sy, sx, sc, l0, nl, H, W).vec;
    vec = v < vec ? v : vec;
    (nl == Lg ? l0_hi : l0_lo) = l0;
  }
  *hi = group_dims(paf, sb, sy, sx, sc, l0_hi, Lg, H, W, vec);
  *lo = L % G == 0 ? *hi : group_dims(paf, sb, sy, sx, sc, l0_lo, Lg - 1, H, W, vec);
}

cudaError_t allow_smem(size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(paf_score_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(paf_score_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

}  // namespace

// The groups of limbs (blocks a frame) that paf_score_kernel takes at these
// sizes into *groups, 0 where no G holds them, and the shared memory a block
// needs then into *bytes (with one limb a block where no G holds them).
extern "C" int popnet_paf_score_groups(int K, int L, int M, int H, int W, void* groups,
                                       void* bytes) {
  if (K < 1 || L < 1 || M < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int G = groups_for(K, L, M, H, W);
  *(int*)groups = G;
  *(long long*)bytes = G ? Layout(K, (L + G - 1) / G, M, H, W).bytes
                         : 8LL * H * W + Layout(K, 1, M, 0, 0).bytes;
  return 0;
}

// Elements per copy with which paf_score_kernel brings the groups of a frame
// of these maps into shared memory (1, 2 or 4).
extern "C" int popnet_paf_score_copy_width(const void* paf, long long sb, long long sy,
                                           long long sx, long long sc, int K, int L, int M,
                                           int H, int W) {
  const int G = groups_for(K, L, M, H, W);
  if (G == 0) return 0;
  popnet::Dims3 hi, lo;
  frame_walks((const float*)paf, sb, sy, sx, sc, L, G, H, W, &hi, &lo);
  return hi.vec;
}

extern "C" int popnet_paf_score(const void* paf, long long sb, long long sy,
                                long long sx, long long sc, const void* peaks,
                                const void* peak_valid, const void* limbs, int B,
                                int K, int L, int M, int H, int W, int T,
                                float factor, float thresh, float len_ref,
                                void* score, void* ok, void* stream) {
  if (B < 1 || K < 1 || L < 1 || L > 32 || M < 1 || M > kMaxPeaks || T < 2 || T > 32 ||
      H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int G = groups_for(K, L, M, H, W);
  if (G == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(K, (L + G - 1) / G, M, H, W).bytes;
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  popnet::Dims3 hi, lo;
  frame_walks((const float*)paf, sb, sy, sx, sc, L, G, H, W, &hi, &lo);
  paf_score_kernel<<<(unsigned)B * G, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)paf, sb, sc, hi, lo, (const float*)peaks, (const bool*)peak_valid,
      (const int*)limbs, K, L, G, M, H, W, T, factor, thresh, len_ref, (float*)score,
      (bool*)ok);
  return (int)cudaGetLastError();
}

// Blocks of paf_score_kernel that one SM holds at these sizes.
extern "C" int popnet_paf_score_blocks_per_sm(int K, int L, int M, int H, int W, void* out) {
  const int G = groups_for(K, L, M, H, W);
  if (G == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(K, (L + G - 1) / G, M, H, W).bytes;
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor((int*)out, paf_score_kernel,
                                                            kThreads, smem);
}
