// Peak front end of the Open-Pose+ decode: cross NMS + threshold, top-M, and
// windowed 5x5 bicubic subpixel refine. Two kernels with one contract and one
// refine (refine_window), so they agree bit for bit:
//
// find_peaks_kernel replaces popnet_tpu/ops/pallas_kernels.py
// find_peaks_pallas_bt (kernel _find_peaks_bt_kernel), the default peak refine
// of the TPU decode; find_peaks_row_kernel (below) replaces its per-frame twin
// find_peaks_pallas (kernel _find_peaks_kernel). The notes here are the first
// kernel's; the second has its own.
//
// Bound on the H100: bytes, counted as the inputs need them. The kernel
// reads each (H, W) heat plane once (B*K*H*W*4 bytes, 12 MB at B=256, K=15,
// 28x28: about 3.6 us at the memory rate) and writes five (B, K, M) arrays.
// Each valid slot's refine over its 5x5 window is up to 40*5*5 + 40*40*5
// multiply-adds (fewer at the borders), and every plane with an empty slot
// needs one refine at the corner (0, 0), whose result all its empty slots
// share; on the main path a plane holds about 1.7 peaks, so that is about
// 0.15 GFLOP, 2.2 us at the float32 rate (chip_smoke.py _bounds). What the
// kernel pays above the bound is instruction issue: the refine's products
// and sums (46% of a block's time on the main path), the strided load (25%)
// and the per-plane top-M (16%) (chip_smoke.py phase 5, stage clocks).
//
// Design: one block of 16 warps per frame, holding all K planes (two blocks
// fit an SM, so 256 frames fill 132 SMs in one wave).
// - Load: the frame goes to shared memory in one pass of cp.async copies,
//   threads numbered in the order of the memory the strides show (channel
//   fastest on the serving path's channels-last maps, x fastest on NCHW), so
//   each warp reads neighbouring addresses whatever the layout
//   (common.cuh). Planes are stored [k][y][x] with an odd plane stride, so
//   the copies of neighbouring channels land in different banks.
// - NMS: a thread per column (k, x) walks down the rows with the cells above
//   and below in registers (three shared-memory reads a cell) and sets a bit
//   per survivor in its plane's mask.
// - Top-M: a warp per plane compacts the mask into a list of survivors in
//   ascending flat index and picks from it by warp reductions on (value
//   descending, flat index ascending): the pick of the TPU kernel. Its picks,
//   and one corner refine if its survivors run out, go on a work list.
// - Refine: every warp takes refines from the work list, so warps do not
//   idle on frames with many people. A lane owns the upsampled columns
//   t = c + 8i (c = lane % 8) with U[t, 0..4] in registers and the rows
//   s = r + 4j (r = lane / 8): upA = U * patch for the window's rows goes to
//   shared memory in rows padded to 8 floats, and each row comes back as one
//   16-byte and one 4-byte broadcast read feeding five independent output
//   chains. The window's rows and columns are clipped by loop bounds; there
//   is no division inside the loops. Within a lane outputs come in ascending
//   flat index, so a strict > keeps the first of equal values, and the warp
//   reduction keeps the first-flat-index tie rule.
// Products and sums use __fmul_rn/__fadd_rn in the order of the plain
// PyTorch version (ops/kernels.py find_peaks_plain), so the two agree bit for
// bit; the TPU kernel's patch @ Q rounds differently and is held to 1e-5 on
// the score.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxPeaks = 32;
constexpr float kSent = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned short kPicked = 0xFFFF;
// The refine the decode runs: a (2*2+1)^2 patch upsampled 8x, a 40x40 window.
constexpr int kWin = 2, kFactor = 8;
constexpr int kSize = 2 * kWin + 1, kS = kSize * kFactor;
constexpr int kRow = 8;                              // U and upA rows padded to 8 floats
constexpr int kRowGroups = 32 / kFactor;             // a warp: 8 columns x 4 rows of lanes
constexpr int kStepsPerCell = kFactor / kRowGroups;  // a lane's rows in one cell row
static_assert(32 % kFactor == 0 && kFactor % kRowGroups == 0, "lane layout of the refine");
static_assert(kSize == 5, "a padded row is read as a float4 and one float");

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The order of float values as unsigned integers, -0.0 equal to +0.0.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Argmax across the warp on (value descending, index ascending) over the
// lanes' (bv, bi), by two warp reductions; every lane ends with the result.
// The same choice as better() for any values but NaN, which no caller holds.
__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
  const unsigned kv = order_key(bv);
  const unsigned top = __reduce_max_sync(kFull, kv);
  const unsigned first = __reduce_min_sync(kFull, kv == top ? (unsigned)bi : 0xFFFFFFFFu);
  const int from = __ffs(__ballot_sync(kFull, kv == top && (unsigned)bi == first)) - 1;
  bv = __shfl_sync(kFull, bv, from);
  bi = (int)first;
}

// A padded row of 5 floats (16-byte aligned) in two shared-memory reads.
__device__ __forceinline__ void row5(const float* p, float (&a)[kSize]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w; a[4] = p[4];
}

// U (S, size) into shared memory with rows padded to kRow floats.
__device__ __forceinline__ void load_u(const float* __restrict__ U, float* Us) {
  for (int i = threadIdx.x; i < kS * kSize; i += blockDim.x)
    Us[(i / kSize) * kRow + i % kSize] = U[i];
}

// This lane's columns of the upsample matrix: u[i][j] = U[c + 8i, j].
__device__ __forceinline__ void lane_columns(const float* Us, int lane,
                                             float (&u)[kSize][kSize]) {
  const int c = lane % kFactor;
#pragma unroll
  for (int i = 0; i < kSize; ++i) row5(Us + (c + kFactor * i) * kRow, u[i]);
}

// Windowed bicubic refine of the peak at (cx, cy) of the (H, W) plane `h` in
// shared memory, by one warp: upA = U * patch (edge-clamped taps) for the
// window's rows into the warp's scratch `upA` (S padded rows), then up =
// upA * U^T restricted to the window the border leaves, and its argmax with
// the first-flat-index tie rule. Every lane ends with the value in bv and
// the flat index in bi. Products and sums are unfused, in the order of the
// plain PyTorch version.
__device__ __forceinline__ void refine_window(const float* h, int H, int W, int cx, int cy,
                                              const float* Us,
                                              const float (&u)[kSize][kSize], float* upA,
                                              int lane, float& bv, int& bi) {
  const int kx0 = max(0, kWin - cx), kx1 = kWin + min(W - 1 - cx, kWin);
  const int ky0 = max(0, kWin - cy), ky1 = kWin + min(H - 1 - cy, kWin);
  int row[kSize];
#pragma unroll
  for (int i = 0; i < kSize; ++i) row[i] = min(max(cy + i - kWin, 0), H - 1) * W;
  const int s0 = ky0 * kFactor, n_up = (ky1 - ky0 + 1) * kFactor * kSize;
  for (int q = lane; q < n_up; q += 32) {
    const int s = s0 + q / kSize, j = q % kSize;
    const int col = min(max(cx + j - kWin, 0), W - 1);
    float us[kSize];
    row5(Us + s * kRow, us);
    float acc = __fmul_rn(us[0], h[row[0] + col]);
#pragma unroll
    for (int i = 1; i < kSize; ++i) acc = __fadd_rn(acc, __fmul_rn(us[i], h[row[i] + col]));
    upA[s * kRow + j] = acc;
  }
  __syncwarp();
  const int c = lane % kFactor, r = lane / kFactor;
  bv = -INFINITY;
  bi = INT_MAX;
  for (int step = ky0 * kStepsPerCell; step < (ky1 + 1) * kStepsPerCell; ++step) {
    const int s = r + kRowGroups * step;
    float a[kSize];
    row5(upA + s * kRow, a);
#pragma unroll
    for (int i = 0; i < kSize; ++i) {
      if (i < kx0 || i > kx1) continue;            // the same for every lane
      float acc = __fmul_rn(a[0], u[i][0]);
#pragma unroll
      for (int j = 1; j < kSize; ++j) acc = __fadd_rn(acc, __fmul_rn(a[j], u[i][j]));
      if (acc > bv) { bv = acc; bi = s * kS + c + kFactor * i; }
    }
  }
  warp_argmax(bv, bi);
  __syncwarp();                                     // upA is free for the next refine
}

// The survivor key of a cell: (y << 8) | x orders cells as their flat index.
__device__ __forceinline__ unsigned short cell_key(int y, int x) {
  return (unsigned short)((y << 8) | x);
}

// NMS + threshold of one plane `h` by one warp, survivors compacted into
// `list` as keys in ascending flat index; returns their number (the same in
// every lane).
__device__ __forceinline__ int nms_survivors(const float* h, int H, int W, float thresh,
                                             unsigned short* list, int lane) {
  const int HW = H * W;
  const unsigned lt_mask = (1u << lane) - 1u;
  int n = 0, y = lane / W, x = lane - y * W;       // (y, x) of cell i, carried along
  for (int base = 0; base < HW; base += 32) {
    const int i = base + lane;
    bool pass = false;
    if (i < HW) {
      float v = h[i];
      float up = y > 0 ? h[i - W] : kSent;
      float down = y < H - 1 ? h[i + W] : kSent;
      float left = x > 0 ? h[i - 1] : kSent;
      float right = x < W - 1 ? h[i + 1] : kSent;
      float mx = fmaxf(fmaxf(up, down), fmaxf(left, right));
      pass = v >= mx && v > thresh;
    }
    const unsigned bal = __ballot_sync(kFull, pass);
    if (pass) list[n + __popc(bal & lt_mask)] = cell_key(y, x);
    n += __popc(bal);
    for (x += 32; x >= W; x -= W) ++y;
  }
  __syncwarp();
  return n;
}

// NMS + threshold of all K planes by the block: a thread per column (k, x)
// walks down the rows with the cells above and below in registers, and each
// survivor sets its bit in its plane's mask of mw words. The same test as
// nms_survivors.
__device__ __forceinline__ void nms_masks(const float* planes, int P, int K, int H, int W,
                                          float thresh, unsigned* masks, int mw) {
  for (int col = threadIdx.x; col < K * W; col += blockDim.x) {
    const int k = col / W, x = col - k * W;
    const float* h = planes + k * P;
    unsigned* mask = masks + k * mw;
    float up = kSent, v = h[x];
    for (int y = 0, i = x; y < H; ++y, i += W) {
      const float down = y < H - 1 ? h[i + W] : kSent;
      const float left = x > 0 ? h[i - 1] : kSent;
      const float right = x < W - 1 ? h[i + 1] : kSent;
      const float mx = fmaxf(fmaxf(up, down), fmaxf(left, right));
      if (v >= mx && v > thresh) atomicOr(mask + (i >> 5), 1u << (i & 31));
      up = v;
      v = down;
    }
  }
}

// The survivors of a plane's mask, by one warp, into `list` as keys in
// ascending flat index; returns their number (the same in every lane).
__device__ __forceinline__ int mask_survivors(const unsigned* mask, int mw, int W,
                                              unsigned short* list, int lane) {
  int n = 0;
  for (int w0 = 0; w0 < mw; w0 += 32) {
    const int w = w0 + lane;
    unsigned bits = w < mw ? mask[w] : 0u;
    const int count = __popc(bits);
    int upto = count;                               // inclusive scan over the lanes
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, upto, off);
      if (lane >= off) upto += v;
    }
    for (int pos = n + upto - count; bits; bits &= bits - 1, ++pos) {
      const int cell = w * 32 + __ffs(bits) - 1, y = cell / W;
      list[pos] = cell_key(y, cell - y * W);
    }
    n += __shfl_sync(kFull, upto, 31);
  }
  __syncwarp();
  return n;
}

// The next top-M pick from the survivor list: the key of the best unpicked
// survivor on (value descending, flat index ascending), marked picked;
// INT_MAX when none is left. The same in every lane.
__device__ __forceinline__ int pick_next(const float* h, int W, unsigned short* list, int n,
                                         int lane) {
  float bv = -INFINITY;
  int bi = INT_MAX, bq = -1;
  for (int q = lane; q < n; q += 32) {
    const int c = list[q];
    if (c == kPicked) continue;
    const float v = h[(c >> 8) * W + (c & 0xFF)];
    if (better(v, c, bv, bi)) { bv = v; bi = c; bq = q; }
  }
  const int mine = bi;
  warp_argmax(bv, bi);
  if (bi != INT_MAX && mine == bi) list[bq] = kPicked;
  __syncwarp();
  return bi;
}

constexpr int kWarps = 16;

// Shared memory of find_peaks_kernel, in bytes, each part 16-byte aligned:
// U, the work list, the NMS masks, the K planes, and a scratch area that
// holds each warp's survivor list during the pick and its upA during the
// refine.
__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }
__host__ __device__ inline int plane_stride(int H, int W) { return (H * W) | 1; }
__host__ __device__ inline int mask_words(int H, int W) { return (H * W + 31) / 32; }
__host__ __device__ inline int list_stride(int H, int W) { return (H * W + 1) & ~1; }
struct PeakLayout {
  int work, masks, planes, scratch, per_warp, bytes;
  __host__ __device__ PeakLayout(int K, int H, int W, int M) {
    const int us = align16(4 * kS * kRow);
    per_warp = align16(max(2 * list_stride(H, W), 4 * kS * kRow));
    work = us;
    masks = work + align16(8 * K * (M + 1));
    planes = masks + align16(4 * K * mask_words(H, W));
    scratch = planes + align16(4 * K * plane_stride(H, W));
    bytes = scratch + kWarps * per_warp;
  }
};

__global__ void __launch_bounds__(kWarps * 32, 2)
find_peaks_kernel(const float* __restrict__ heat, long long sb, popnet::Dims3 g, int K,
                  int H, int W, int M, float thresh, const float* __restrict__ U,
                  int* __restrict__ px_out, int* __restrict__ py_out,
                  int* __restrict__ loc_out, float* __restrict__ score_out,
                  bool* __restrict__ valid_out) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const PeakLayout ly(K, H, W, M);
  float* Us = reinterpret_cast<float*>(smem);                   // (S, kRow)
  int2* work = reinterpret_cast<int2*>(smem + ly.work);         // K * (M + 1) refines
  unsigned* masks = reinterpret_cast<unsigned*>(smem + ly.masks);
  float* planes = reinterpret_cast<float*>(smem + ly.planes);   // K x (H, W), stride P
  char* scratch = smem + ly.scratch + (threadIdx.x >> 5) * ly.per_warp;
  __shared__ int n_work, next_work;

  const int P = plane_stride(H, W), mw = mask_words(H, W);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  STAGE_STAMP(0);
  popnet::cp_async_frame(planes, heat + b * sb, g);
  load_u(U, Us);
  for (int i = tid; i < K * mw; i += blockDim.x) masks[i] = 0u;
  if (tid == 0) { n_work = 0; next_work = 0; }
  popnet::cp_async_wait_all();
  __syncthreads();
  STAGE_STAMP(1);
  nms_masks(planes, P, K, H, W, thresh, masks, mw);
  __syncthreads();
  STAGE_STAMP(2);

  // a warp per plane: top-M over the survivors (lane m keeps pick m), its
  // slots written at once, and its refines put on the work list: one per
  // pick, and one at the corner for all the empty slots
  unsigned short* list = reinterpret_cast<unsigned short*>(scratch);
  for (int k = warp; k < K; k += kWarps) {
    const float* h = planes + k * P;
    const int n = mask_survivors(masks + k * mw, mw, W, list, lane);
    int m = 0, mine = 0;
    for (; m < M; ++m) {
      const int key = pick_next(h, W, list, n, lane);
      if (key == INT_MAX) break;
      if (lane == m) mine = key;
    }
    const long long o = ((long long)b * K + k) * M;
    if (lane < M) {
      px_out[o + lane] = lane < m ? mine & 0xFF : 0;
      py_out[o + lane] = lane < m ? mine >> 8 : 0;
      valid_out[o + lane] = lane < m;
    }
    int first = lane == 0 ? atomicAdd(&n_work, m < M ? m + 1 : m) : 0;
    first = __shfl_sync(kFull, first, 0);
    if (lane < m) work[first + lane] = make_int2(k | (lane << 8), mine);
    else if (lane == m && m < M) work[first + m] = make_int2(k | (m << 8) | (1 << 16), 0);
  }
  __syncthreads();
  STAGE_STAMP(3);

  // every warp takes refines from the work list
  float u[kSize][kSize];
  lane_columns(Us, lane, u);
  float* upA = reinterpret_cast<float*>(scratch);
  const int nw = n_work;
  for (;;) {
    int e = lane == 0 ? atomicAdd(&next_work, 1) : 0;
    e = __shfl_sync(kFull, e, 0);
    if (e >= nw) break;
    const int2 w = work[e];
    const int k = w.x & 0xFF, m = (w.x >> 8) & 0xFF;
    float bv;
    int bi;
    refine_window(planes + k * P, H, W, w.y & 0xFF, w.y >> 8, Us, u, upA, lane, bv, bi);
    const long long o = ((long long)b * K + k) * M;
    const int end = (w.x >> 16) ? M : m + 1;          // a corner refine fills every empty slot
    for (int s = m + lane; s < end; s += 32) {
      loc_out[o + s] = bi;
      score_out[o + s] = bv;
    }
  }
  STAGE_STAMP(4);
}

// find_peaks_row_kernel: the same function by another design.
//
// Replaces: popnet_tpu/ops/pallas_kernels.py find_peaks_pallas (kernel
// _find_peaks_kernel: one grid cell per frame, all K planes inside).
//
// Bound on the H100: operations, as for find_peaks_kernel (the same bytes and
// the same needed arithmetic).
//
// Design: one block per frame, one warp per joint plane, no block barrier
// after the load. The warp loads its plane into shared memory (x fastest,
// whatever the strides), runs the NMS once over rows of 32 cells
// (nms_survivors), picks top-M by the same pick_next as find_peaks_kernel and
// refines each pick at once by the same refine_window; when the survivors run
// out, the corner cell (0, 0) is refined once and its result fills every
// empty slot. What it pays beyond the first kernel: each warp's refines run
// one after another, and its load crosses the channels-last memory.
constexpr int kRowWarps = 16;

__global__ void __launch_bounds__(kRowWarps * 32)
find_peaks_row_kernel(const float* __restrict__ heat, long long sb, long long sk,
                      long long sy, long long sx, int K, int H, int W, int M,
                      float thresh, const float* __restrict__ U,
                      int* __restrict__ px_out, int* __restrict__ py_out,
                      int* __restrict__ loc_out, float* __restrict__ score_out,
                      bool* __restrict__ valid_out) {
  extern __shared__ float4 row_smem4[];
  const int HW = H * W;
  const int nwarps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Us = reinterpret_cast<float*>(row_smem4);          // (S, kRow)
  float* upA = Us + kS * kRow * (1 + warp);                 // this warp's (S, kRow)
  float* h = Us + kS * kRow * (1 + nwarps) + warp * HW;     // this warp's plane
  unsigned short* list = reinterpret_cast<unsigned short*>(
      Us + kS * kRow * (1 + nwarps) + nwarps * HW) + warp * list_stride(H, W);

  load_u(U, Us);
  __syncthreads();
  float u[kSize][kSize];
  lane_columns(Us, lane, u);

  const int b = blockIdx.x;
  for (int k = warp; k < K; k += nwarps) {
    const float* src = heat + b * sb + k * sk;
    for (int i = lane; i < HW; i += 32) h[i] = src[(i / W) * sy + (i % W) * sx];
    __syncwarp();
    const int n = nms_survivors(h, H, W, thresh, list, lane);
    const long long obase = ((long long)b * K + k) * M;
    int m = 0;
    for (; m < M; ++m) {
      const int key = pick_next(h, W, list, n, lane);
      if (key == INT_MAX) break;                  // no survivor left
      const int cx = key & 0xFF, cy = key >> 8;
      float rv;
      int ri;
      refine_window(h, H, W, cx, cy, Us, u, upA, lane, rv, ri);
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
      refine_window(h, H, W, 0, 0, Us, u, upA, lane, rv, ri);
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

// A frame of the planes as find_peaks_kernel walks it into its [k][y][x]
// layout (plane stride P).
popnet::Dims3 frame_dims(const void* heat, long long sb, long long sk, long long sy,
                         long long sx, int K, int H, int W) {
  const int n[3] = {K, H, W};
  const long long src[3] = {sk, sy, sx};
  const int dst[3] = {plane_stride(H, W), W, 1};
  return popnet::memory_order(n, src, dst, heat, sb);
}

bool bad_args(int B, int K, int H, int W, int M, int win, int factor) {
  return win != kWin || factor != kFactor || M < 1 || M > kMaxPeaks || H < 1 || W < 1 ||
         H > 255 || W > 255 || B < 1 || K < 1 || K > 255;
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int popnet_find_peaks(const void* heat, long long sb, long long sk,
                                 long long sy, long long sx, int B, int K, int H,
                                 int W, int M, float thresh, int win, int factor,
                                 const void* U, void* px, void* py, void* loc,
                                 void* score, void* valid, void* stream) {
  if (bad_args(B, K, H, W, M, win, factor)) return (int)cudaErrorInvalidValue;
  const size_t smem = PeakLayout(K, H, W, M).bytes;
  cudaError_t e = allow_smem((const void*)find_peaks_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  find_peaks_kernel<<<B, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)heat, sb, frame_dims(heat, sb, sk, sy, sx, K, H, W), K, H, W, M, thresh,
      (const float*)U, (int*)px, (int*)py, (int*)loc, (float*)score, (bool*)valid);
  return (int)cudaGetLastError();
}

// Elements per copy with which find_peaks_kernel brings a frame of these
// planes into shared memory (1, 2 or 4).
extern "C" int popnet_find_peaks_copy_width(const void* heat, long long sb, long long sk,
                                            long long sy, long long sx, int K, int H, int W) {
  return frame_dims(heat, sb, sk, sy, sx, K, H, W).vec;
}

// Blocks of find_peaks_kernel that one SM holds at these sizes.
extern "C" int popnet_find_peaks_blocks_per_sm(int K, int H, int W, int M, void* out) {
  const size_t smem = PeakLayout(K, H, W, M).bytes;
  cudaError_t e = allow_smem((const void*)find_peaks_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor((int*)out, find_peaks_kernel,
                                                            kWarps * 32, smem);
}

extern "C" int popnet_find_peaks_row(const void* heat, long long sb, long long sk,
                                     long long sy, long long sx, int B, int K, int H,
                                     int W, int M, float thresh, int win, int factor,
                                     const void* U, void* px, void* py, void* loc,
                                     void* score, void* valid, void* stream) {
  if (bad_args(B, K, H, W, M, win, factor)) return (int)cudaErrorInvalidValue;
  const int nwarps = K < kRowWarps ? K : kRowWarps;
  const size_t smem = sizeof(float) * ((size_t)kS * kRow * (1 + nwarps) + (size_t)nwarps * H * W) +
                      sizeof(unsigned short) * (size_t)nwarps * list_stride(H, W);
  cudaError_t e = allow_smem((const void*)find_peaks_row_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  find_peaks_row_kernel<<<B, nwarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)heat, sb, sk, sy, sx, K, H, W, M, thresh, (const float*)U, (int*)px,
      (int*)py, (int*)loc, (float*)score, (bool*)valid);
  return (int)cudaGetLastError();
}
