// Peak front end of the Open-Pose+ decode: cross NMS + threshold, top-M, and
// windowed 5x5 bicubic subpixel refine. Three kernels with one contract and
// one refine (refine_window), so they agree bit for bit:
//
// find_peaks_kernel replaces popnet_tpu/ops/pallas_kernels.py
// find_peaks_pallas_bt (kernel _find_peaks_bt_kernel), the default peak refine
// of the TPU decode; find_peaks_row_kernel (below) replaces its per-frame twin
// find_peaks_pallas (kernel _find_peaks_kernel); find_peaks_plane_kernel
// (the last) takes the maps the first two cannot hold. The notes here are
// the first kernel's; the others have their own.
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
// fit an SM, so 256 frames fill 132 SMs in one wave). Where the K planes do
// not fit one block's 227 KB (18 planes from 46x47 on, every COCO
// evaluation canvas that is not square), the wrapper launches
// find_peaks_row_kernel, which takes a frame's planes in rounds.
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

#include <cooperative_groups.h>
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
// plain PyTorch version. kPatch: `h` is the 5x5 patch of edge-clamped taps
// itself (row stride 5), copied out of the plane beforehand.
template <bool kPatch = false>
__device__ __forceinline__ void refine_window(const float* h, int H, int W, int cx, int cy,
                                              const float* Us,
                                              const float (&u)[kSize][kSize], float* upA,
                                              int lane, float& bv, int& bi) {
  const int kx0 = max(0, kWin - cx), kx1 = kWin + min(W - 1 - cx, kWin);
  const int ky0 = max(0, kWin - cy), ky1 = kWin + min(H - 1 - cy, kWin);
  int row[kSize];
#pragma unroll
  for (int i = 0; i < kSize; ++i)
    row[i] = kPatch ? i * kSize : min(max(cy + i - kWin, 0), H - 1) * W;
  const int s0 = ky0 * kFactor, n_up = (ky1 - ky0 + 1) * kFactor * kSize;
  for (int q = lane; q < n_up; q += 32) {
    const int s = s0 + q / kSize, j = q % kSize;
    const int col = kPatch ? j : min(max(cx + j - kWin, 0), W - 1);
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

// NMS + threshold of all K planes by the block: a thread per column (k, x)
// walks down the rows with the cells above and below in registers, and each
// survivor sets its bit in its plane's mask of mw words: v >= each of its
// four neighbours (kSent off the plane) and v > thresh.
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

// The next top-M pick from a plane's survivor mask (mw words), by one warp:
// the key of the best survivor left on (value descending, flat index
// ascending), its bit cleared; INT_MAX when none is left. The same in every
// lane, and the same choice as pick_next over a list of these survivors.
__device__ __forceinline__ int pick_next_mask(const float* h, int W, unsigned* mask, int mw,
                                              int lane) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int w = lane; w < mw; w += 32)
    for (unsigned bits = mask[w]; bits; bits &= bits - 1) {
      const int i = w * 32 + __ffs(bits) - 1;
      const float v = h[i];
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
  const int mine = bi;
  warp_argmax(bv, bi);
  if (bi == INT_MAX) return INT_MAX;
  if (mine == bi) mask[bi >> 5] &= ~(1u << (bi & 31));
  __syncwarp();
  const int y = bi / W;
  return cell_key(y, bi - y * W);
}

// Top-M of one plane by one warp, next() giving its picks in order (lane m
// keeps pick m): the plane's slots o .. o + M - 1 of px, py and valid
// written at once, and its refines put on the work list: one per pick, and
// one at the corner for all the empty slots. An item is (tag | slot << 8 |
// corner << 16, the pick's key); the tag names the plane to run_refines.
template <typename Next>
__device__ __forceinline__ void pick_plane(Next next, int M, int tag, long long o, int* n_work,
                                           int2* work, int* __restrict__ px_out,
                                           int* __restrict__ py_out,
                                           bool* __restrict__ valid_out, int lane) {
  int m = 0, mine = 0;
  for (; m < M; ++m) {
    const int key = next();
    if (key == INT_MAX) break;
    if (lane == m) mine = key;
  }
  if (lane < M) {
    px_out[o + lane] = lane < m ? mine & 0xFF : 0;
    py_out[o + lane] = lane < m ? mine >> 8 : 0;
    valid_out[o + lane] = lane < m;
  }
  int first = lane == 0 ? atomicAdd(n_work, m < M ? m + 1 : m) : 0;
  first = __shfl_sync(kFull, first, 0);
  if (lane < m) work[first + lane] = make_int2(tag | (lane << 8), mine);
  else if (lane == m && m < M) work[first + m] = make_int2(tag | (m << 8) | (1 << 16), 0);
}

// The warp takes refines from the work list (nw items) until it is empty:
// item (tag, slot m) refines plane `tag` at planes + tag * P and writes loc
// and score at output row o_base + tag * o_step, slot m (a corner refine
// fills every slot from m on).
__device__ __forceinline__ void run_refines(const float* planes, int P, int H, int W, int M,
                                            const float* Us, const float (&u)[kSize][kSize],
                                            float* upA, const int2* work, int nw,
                                            int* next_work, long long o_base, long long o_step,
                                            int* __restrict__ loc_out,
                                            float* __restrict__ score_out, int lane) {
  for (;;) {
    int e = lane == 0 ? atomicAdd(next_work, 1) : 0;
    e = __shfl_sync(kFull, e, 0);
    if (e >= nw) break;
    const int2 w = work[e];
    const int t = w.x & 0xFF, m = (w.x >> 8) & 0xFF;
    float bv;
    int bi;
    refine_window(planes + t * P, H, W, w.y & 0xFF, w.y >> 8, Us, u, upA, lane, bv, bi);
    const long long o = o_base + t * o_step;
    const int end = (w.x >> 16) ? M : m + 1;          // a corner refine fills every empty slot
    for (int s = m + lane; s < end; s += 32) {
      loc_out[o + s] = bi;
      score_out[o + s] = bv;
    }
  }
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
  BLOCK_SPAN(6);
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
    pick_plane([&] { return pick_next(h, W, list, n, lane); }, M, k,
               ((long long)b * K + k) * M, &n_work, work, px_out, py_out, valid_out, lane);
  }
  __syncthreads();
  STAGE_STAMP(3);

  // every warp takes refines from the work list
  float u[kSize][kSize];
  lane_columns(Us, lane, u);
  run_refines(planes, P, H, W, M, Us, u, reinterpret_cast<float*>(scratch), work, n_work,
              &next_work, (long long)b * K * M, M, loc_out, score_out, lane);
  STAGE_STAMP(4);
  BLOCK_SPAN(7);
}

// find_peaks_row_kernel: the same function by another design.
//
// Replaces: popnet_tpu/ops/pallas_kernels.py find_peaks_pallas (kernel
// _find_peaks_kernel: one grid cell per frame, all K planes inside).
//
// Bound on the H100: bytes, as for find_peaks_kernel (the same bytes and the
// same needed arithmetic).
//
// Design: a cluster of 2 CTAs of 6 warps per frame; CTA r owns the planes
// k = r, r + 2, r + 4, ... (8 and 7 at K = 15), about 37 KB of shared memory
// at 28x28. The registers let 5 CTAs share an SM, and the card places all
// 256 clusters of the main path at once: one wave, 12 warps a frame.
// (Measured slower: clusters of 8 and of 4 CTAs, of which the card placed
// at most 992 CTAs at once; CTAs of 4 and 7 warps; and CTAs that copy their
// own planes from the frame without distributed shared memory, which pulls
// each frame through L2 once per CTA.)
// - Load: CTA r reads its band of ceil(H/2) rows of every channel once, in
//   the order of the frame's memory, and stores each value straight into its
//   plane in the shared memory of the CTA that owns the channel (distributed
//   shared memory); one cluster barrier. Channels-last bands (the serving
//   path's) are read 16 bytes at a time as one flat run; other layouts are
//   walked (common.cuh memory_order/Walk3, sorted on the host). No thread
//   divides by W: rows and columns come from counters. Where the planes a
//   CTA owns do not fit its shared memory at once, it takes them in rounds,
//   the whole cluster with it.
// - NMS: a thread per column of the CTA's planes walks down the rows into
//   survivor masks (nms_masks, as find_peaks_kernel).
// - Top-M: a warp per plane picks from its mask by warp reductions
//   (pick_next_mask: the choice of pick_next). Its picks, and one corner
//   refine if its survivors run out, go on the frame's work list, in the
//   shared memory of the cluster's first CTA.
// - Refine: all 12 warps of the frame take refines from that list, whatever
//   CTA owns the plane: a warp copies the pick's 5x5 patch of edge-clamped
//   taps out of the owner's shared memory and refines it (refine_window on
//   the patch). A frame's refines are spread over 12 warps on 2 SMs, not
//   queued on the warp of its busiest plane.
constexpr int kCluster = 2;        // CTAs a frame
constexpr int kRowThreads = 192;   // warps a CTA at most: 6
constexpr int kSlotBits = 7;       // a work item's tag: owner << kSlotBits | the owner's slot
static_assert((kCluster << kSlotBits) <= 256, "a tag fits the work item's 8 bits");
constexpr int kMaxSmem = 227 * 1024 - 16;   // dynamic, beside the two counters

// Shared memory of find_peaks_row_kernel, in bytes, each part 16-byte
// aligned: U, the work list of a round's R * kCluster planes (the frame's
// list: rank 0's is used), R planes of `stride` floats, their NMS masks, and
// each warp's upA and 5x5 patch.
constexpr int kPatchFloats = 32;
struct RowLayout {
  int work, planes, stride, masks, scratch, per_warp, bytes;
  __host__ __device__ RowLayout(int R, int H, int W, int M, int warps) {
    stride = (H * W + 3) & ~3;
    work = align16(4 * kS * kRow);
    planes = work + align16(8 * R * kCluster * (M + 1));
    masks = planes + 4 * R * stride;
    scratch = masks + align16(4 * R * mask_words(H, W));
    per_warp = 4 * (kS * kRow + kPatchFloats);
    bytes = scratch + warps * per_warp;
  }
};

// How a CTA of find_peaks_row_kernel loads its band into the owners' planes.
enum RowLoad {
  kWalk = 0,  // walked in memory order
  kFlat = 1,  // as one flat run, where the band's pixels hold their channels side by side
};

// The band `g` of a frame at `src`, read once by the CTA's threads in the
// order of its memory, every value stored into its plane in the shared
// memory of the CTA that owns its channel: the walk's shared offset is c <<
// 16 | cell for channel c of the round (owner c % 2, slot c / 2), and the
// band's first cell is `cell0`; cells from HW on (rows past the plane's
// last, in the last band) are neither read nor stored. Four loads in
// flight a thread.
__device__ __forceinline__ void push_walk(const float* __restrict__ src, const popnet::Dims3& g,
                                          float* planes, int stride, int cell0, int HW,
                                          cooperative_groups::cluster_group& cluster) {
  constexpr int kBatch = 4;
  popnet::Walk3 w(g, threadIdx.x, blockDim.x);
  while (w.more(g)) {
    float v[kBatch];
    int d[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      d[i] = -1;
      if (w.more(g)) {
        if (cell0 + (w.dst & 0xFFFF) < HW) {
          v[i] = src[w.src];
          d[i] = w.dst;
        }
        w.next(g);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (d[i] < 0) continue;
      const int c = d[i] >> 16;
      cluster.map_shared_rank(planes, c % kCluster)[(c / kCluster) * stride + cell0 +
                                                    (d[i] & 0xFFFF)] = v[i];
    }
  }
}

// A band of n4 * 4 floats whose pixels hold their channels side by side
// (pixel stride sx, a multiple of 4; rows back to back), read 16 bytes at a
// time, four reads in flight a thread, each value stored into its plane in
// the shared memory of the CTA that owns its channel; channels from nc on
// (the unused ones between pixels) are read but not stored. Pixel p of the
// band is cell cell0 + p; p and the channel advance by counters, no
// division inside the loop.
__device__ __forceinline__ void push_flat(const float* __restrict__ src, int n4, int sx, int nc,
                                          float* planes, int stride, int cell0,
                                          cooperative_groups::cluster_group& cluster) {
  constexpr int kBatch = 4;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const int step = 4 * (int)blockDim.x, dp = step / sx, dc = step - dp * sx;
  const int e0 = 4 * (int)threadIdx.x;
  int p = e0 / sx, c = e0 - p * sx;
  for (int q = threadIdx.x; q < n4; q += kBatch * blockDim.x) {
    float4 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (q + i * (int)blockDim.x < n4) v[i] = src4[q + i * blockDim.x];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (q + i * (int)blockDim.x < n4) {
        const float f[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int l = 0; l < 4; ++l)
          if (c + l < nc)
            cluster.map_shared_rank(planes, (c + l) % kCluster)[((c + l) / kCluster) * stride +
                                                                cell0 + p] = f[l];
      }
      c += dc;
      p += dp;
      if (c >= sx) { c -= sx; ++p; }
    }
  }
}

// The warp takes refines from its frame's work list (nw items, in rank 0 of
// the cluster) until it is empty, wherever the plane lies: item (tag owner
// << kSlotBits | j, slot m) refines plane j of CTA `owner`, whose 5x5 patch
// of edge-clamped taps the warp first copies into `patch`; loc and score go
// to output row o_frame + (owner + kCluster * j) * M, slot m (a corner
// refine fills every slot from m on).
__device__ __forceinline__ void run_cluster_refines(
    cooperative_groups::cluster_group& cluster, const float* planes, int stride, int H, int W,
    int M, const float* Us, const float (&u)[kSize][kSize], float* upA, float* patch,
    const int2* work, int nw, int* next_work, long long o_frame, int* __restrict__ loc_out,
    float* __restrict__ score_out, int lane) {
  for (;;) {
    int e = lane == 0 ? atomicAdd(next_work, 1) : 0;
    e = __shfl_sync(kFull, e, 0);
    if (e >= nw) break;
    const int2 w = work[e];
    const int owner = (w.x & 0xFF) >> kSlotBits, j = w.x & ((1 << kSlotBits) - 1);
    const int m = (w.x >> 8) & 0xFF;
    const int cx = w.y & 0xFF, cy = w.y >> 8;
    if (lane < kSize * kSize) {
      const int i = lane / kSize, c = lane - i * kSize;
      const float* h = cluster.map_shared_rank(planes, owner) + j * stride;
      patch[lane] = h[min(max(cy + i - kWin, 0), H - 1) * W + min(max(cx + c - kWin, 0), W - 1)];
    }
    __syncwarp();
    float bv;
    int bi;
    refine_window<true>(patch, H, W, cx, cy, Us, u, upA, lane, bv, bi);
    const long long o = o_frame + (long long)(owner + kCluster * j) * M;
    const int end = (w.x >> 16) ? M : m + 1;          // a corner refine fills every empty slot
    for (int s = m + lane; s < end; s += 32) {
      loc_out[o + s] = bi;
      score_out[o + s] = bv;
    }
  }
}

// g_full and g_last: with kWalk the walks of a band of a full and of the
// last round; kFlat needs neither.
template <int kLoad>
__global__ void __launch_bounds__(kRowThreads, 5)
find_peaks_row_kernel(const float* __restrict__ heat, long long sb, long long sk,
                      long long sy, long long sx, popnet::Dims3 g_full, popnet::Dims3 g_last,
                      int K, int H, int W, int M, int R, float thresh,
                      const float* __restrict__ U,
                      int* __restrict__ px_out, int* __restrict__ py_out,
                      int* __restrict__ loc_out, float* __restrict__ score_out,
                      bool* __restrict__ valid_out) {
  extern __shared__ float4 row_smem4[];
  char* smem = reinterpret_cast<char*>(row_smem4);
  const int warps = blockDim.x >> 5;
  const RowLayout ly(R, H, W, M, warps);
  float* Us = reinterpret_cast<float*>(smem);                   // (S, kRow)
  int2* work = reinterpret_cast<int2*>(smem + ly.work);         // R * kCluster * (M + 1)
  float* planes = reinterpret_cast<float*>(smem + ly.planes);   // R x (H, W), stride ly.stride
  unsigned* masks = reinterpret_cast<unsigned*>(smem + ly.masks);
  float* upA = reinterpret_cast<float*>(smem + ly.scratch + (threadIdx.x >> 5) * ly.per_warp);
  float* patch = upA + kS * kRow;
  __shared__ int n_work, next_work;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % kCluster, b = blockIdx.x / kCluster;
  const int band = (H + kCluster - 1) / kCluster, y0 = rank * band;      // this CTA's rows
  const int slots = (K + kCluster - 1) / kCluster, mw = mask_words(H, W);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  // the frame's work list and its counters, in the shared memory of rank 0
  int2* f_work = cluster.map_shared_rank(work, 0);
  int* f_n_work = cluster.map_shared_rank(&n_work, 0);
  int* f_next = cluster.map_shared_rank(&next_work, 0);
  BLOCK_SPAN(6);
  load_u(U, Us);

  for (int s0 = 0; s0 < slots; s0 += R) {           // rounds: the same count in every CTA
    const int c0 = s0 * kCluster;                     // the round's channels c0 .. c0 + nc - 1
    const int nc = min(K - c0, R * kCluster);
    const int own = nc > rank ? (nc - rank + kCluster - 1) / kCluster : 0;
    if (tid == 0) { n_work = 0; next_work = 0; }
    for (int i = tid; i < own * mw; i += blockDim.x) masks[i] = 0u;
    STAGE_STAMP(0);
    if (s0 == 0) cluster.sync();      // every CTA of the frame runs
    if (y0 < H) {
      const float* base = heat + b * sb + c0 * sk + y0 * sy;
      if constexpr (kLoad == kFlat)
        push_flat(base, min(band, H - y0) * W * (int)sx / 4, (int)sx, nc, planes, ly.stride,
                  y0 * W, cluster);
      else
        push_walk(base, s0 + R < slots ? g_full : g_last, planes, ly.stride, y0 * W, H * W,
                  cluster);
    }
    cluster.sync();
    STAGE_STAMP(1);
    nms_masks(planes, ly.stride, own, H, W, thresh, masks, mw);
    __syncthreads();
    STAGE_STAMP(2);

    // a warp per plane: top-M, and its refines on the frame's work list
    const long long o_base = ((long long)b * K + c0 + rank) * M;
    for (int j = warp; j < own; j += warps) {
      const float* h = planes + j * ly.stride;
      unsigned* mask = masks + j * mw;
      pick_plane([&] { return pick_next_mask(h, W, mask, mw, lane); }, M,
                 rank << kSlotBits | j, o_base + (long long)j * kCluster * M, f_n_work, f_work,
                 px_out, py_out, valid_out, lane);
    }
    // every warp of the frame takes refines from its list, whatever CTA owns the plane
    cluster.sync();                   // the frame's list is complete
    STAGE_STAMP(3);
    float u[kSize][kSize];
    lane_columns(Us, lane, u);
    run_cluster_refines(cluster, planes, ly.stride, H, W, M, Us, u, upA, patch, f_work,
                        *f_n_work, f_next, ((long long)b * K + c0) * M, loc_out, score_out, lane);
    cluster.sync();                   // no CTA reads another's planes or list after this
    STAGE_STAMP(4);
  }
  BLOCK_SPAN(7);
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

// The planes a CTA of find_peaks_row_kernel holds at once (R) and its warps:
// every plane it owns and 6 warps where they fit, else fewer planes a round,
// then fewer warps. False where not even one plane and one warp fit.
bool row_config(int K, int H, int W, int M, int& R, int& warps, size_t& smem) {
  const int slots = (K + kCluster - 1) / kCluster;
  for (warps = kRowThreads / 32; warps >= 1; --warps)
    for (R = slots; R >= 1; --R) {
      smem = RowLayout(R, H, W, M, warps).bytes;
      if (smem <= (size_t)kMaxSmem) return true;
    }
  return false;
}

// The walk over one CTA's band of find_peaks_row_kernel: nc channels of a
// round, ceil(H/2) rows, W columns, sorted by the source strides; its shared
// offsets are c << 16 | cell, one float a copy.
popnet::Dims3 band_dims(const void* heat, long long sb, long long sk, long long sy,
                        long long sx, int nc, int H, int W) {
  const int n[3] = {nc, (H + kCluster - 1) / kCluster, W};
  const long long src[3] = {sk, sy, sx};
  const int dst[3] = {1 << 16, W, 1};
  return popnet::memory_order(n, src, dst, heat, sb, 1);
}

template <int kLoad>
cudaError_t launch_row_kernel(const cudaLaunchConfig_t& cfg, const void* heat, long long sb,
                              long long sk, long long sy, long long sx, popnet::Dims3 g_full,
                              popnet::Dims3 g_last, int K, int H, int W, int M, int R,
                              float thresh, const void* U, void* px, void* py, void* loc,
                              void* score, void* valid) {
  cudaError_t e = allow_smem((const void*)find_peaks_row_kernel<kLoad>, cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, find_peaks_row_kernel<kLoad>, (const float*)heat, sb, sk, sy,
                            sx, g_full, g_last, K, H, W, M, R, thresh, (const float*)U,
                            (int*)px, (int*)py, (int*)loc, (float*)score, (bool*)valid);
}

// readable: the bytes from `heat` to the end of its storage, so that the
// flat load may read a whole pixel's run of channels at the frame's end.
int launch_row(const void* heat, long long sb, long long sk, long long sy,
               long long sx, long long readable, int B, int K, int H, int W, int M,
               float thresh, int win, int factor, const void* U, void* px, void* py, void* loc,
               void* score, void* valid, void* stream) {
  int R, warps;
  size_t smem;
  if (bad_args(B, K, H, W, M, win, factor) || !row_config(K, H, W, M, R, warps, smem))
    return (int)cudaErrorInvalidValue;
  const int slots = (K + kCluster - 1) / kCluster, rounds = (slots + R - 1) / R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * kCluster);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if (sk == 1 && sx % 4 == 0 && sx >= K && sy == W * sx && rounds == 1 && sb % 4 == 0 &&
             reinterpret_cast<unsigned long long>(heat) % 16 == 0 &&
             ((long long)(B - 1) * sb + (long long)H * W * sx) * 4 <= readable) {
    const popnet::Dims3 g = {};
    e = launch_row_kernel<kFlat>(cfg, heat, sb, sk, sy, sx, g, g, K, H, W, M, R, thresh, U, px,
                                 py, loc, score, valid);
  } else {
    const popnet::Dims3 g_full = band_dims(heat, sb, sk, sy, sx, R * kCluster, H, W);
    const popnet::Dims3 g_last =
        band_dims(heat, sb, sk, sy, sx, K - (rounds - 1) * R * kCluster, H, W);
    e = launch_row_kernel<kWalk>(cfg, heat, sb, sk, sy, sx, g_full, g_last, K, H, W, M, R,
                                 thresh, U, px, py, loc, score, valid);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// find_peaks_plane_kernel: the same function for the maps the other two
// cannot take: a side over 255 cells (their survivor keys hold a cell in 16
// bits, cell_key) or a plane larger than a CTA of find_peaks_row_kernel
// holds (row_config).
//
// Replaces, for those maps: popnet_tpu/ops/pallas_kernels.py
// find_peaks_pallas and find_peaks_pallas_bt, which take maps of any size.
//
// Bound on the H100: bytes, as for find_peaks_kernel; this kernel also
// writes and reads back its survivors (4 bytes each), a few per plane on
// heat maps.
//
// Design, simple rather than fast: one CTA of 8 warps per (frame, plane),
// reading the plane from global memory at its strides.
// - NMS: a thread per cell, the same four-neighbour test and threshold;
//   each warp appends its survivors' 32-bit flat indices to the plane's
//   region of a global scratch buffer with one atomic.
// - Top-M: M rounds of block reductions over the survivors on (value
//   descending, flat index ascending) as one 64-bit key, the pick of the
//   TPU kernel; the pick's entry is struck from the list.
// - Refine: a warp per pick (and one at the corner (0, 0) for all the
//   empty slots, as find_peaks_kernel): it copies the pick's 5x5 patch of
//   edge-clamped taps into shared memory and runs refine_window on it, the
//   device function of the other two kernels (its coordinates are ints).
constexpr int kPlaneThreads = 256;
constexpr int kPlaneWarps = kPlaneThreads / 32;

// (value descending, flat index ascending) as one key: a larger key is a
// better pick; 0 is no survivor (order_key of any float but NaN is above 0).
__device__ __forceinline__ unsigned long long pick_key(float v, int i) {
  return (unsigned long long)order_key(v) << 32 | (0xFFFFFFFFu - (unsigned)i);
}

__device__ __forceinline__ unsigned long long max_key(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// The largest key over the block; every thread ends with it. `red` holds
// kPlaneWarps + 1 keys of shared memory.
__device__ __forceinline__ unsigned long long block_max_key(unsigned long long k,
                                                           unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) k = max_key(k, __shfl_xor_sync(kFull, k, off));
  if (lane == 0) red[warp] = k;
  __syncthreads();
  if (warp == 0) {
    k = lane < kPlaneWarps ? red[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1) k = max_key(k, __shfl_xor_sync(kFull, k, off));
    if (lane == 0) red[kPlaneWarps] = k;
  }
  __syncthreads();
  k = red[kPlaneWarps];
  __syncthreads();                                  // red is free for the next reduction
  return k;
}

__global__ void __launch_bounds__(kPlaneThreads)
find_peaks_plane_kernel(const float* __restrict__ heat, long long sb, long long sk, long long sy,
                        long long sx, int K, int H, int W, int M, float thresh,
                        const float* __restrict__ U, int* __restrict__ survivors,
                        int* __restrict__ px_out, int* __restrict__ py_out,
                        int* __restrict__ loc_out, float* __restrict__ score_out,
                        bool* __restrict__ valid_out) {
  __shared__ __align__(16) float Us[kS * kRow];
  __shared__ __align__(16) float upA[kPlaneWarps][kS * kRow];
  __shared__ float patch[kPlaneWarps][kPatchFloats];
  __shared__ unsigned long long red[kPlaneWarps + 1];
  __shared__ int picks[kMaxPeaks];
  __shared__ int n_surv;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long plane = blockIdx.x;
  const float* h = heat + (plane / K) * sb + (plane % K) * sk;
  const int HW = H * W;
  int* list = survivors + plane * HW;
  load_u(U, Us);
  if (tid == 0) n_surv = 0;
  __syncthreads();

  // NMS: v >= each of its four neighbours (kSent off the plane) and v > thresh
  for (int base = 0; base < HW; base += kPlaneThreads) {
    const int i = base + tid;
    bool keep = false;
    if (i < HW) {
      const int y = i / W, x = i - y * W;
      const float* p = h + y * sy + x * sx;
      const float v = *p;
      const float up = y > 0 ? p[-sy] : kSent, down = y < H - 1 ? p[sy] : kSent;
      const float left = x > 0 ? p[-sx] : kSent, right = x < W - 1 ? p[sx] : kSent;
      keep = v >= fmaxf(fmaxf(up, down), fmaxf(left, right)) && v > thresh;
    }
    const unsigned ballot = __ballot_sync(kFull, keep);
    int first = 0;
    if (lane == 0 && ballot) first = atomicAdd(&n_surv, __popc(ballot));
    first = __shfl_sync(kFull, first, 0);
    if (keep) list[first + __popc(ballot & ((1u << lane) - 1))] = i;
  }
  __syncthreads();
  const int n = n_surv;

  // top-M: the best survivor left, M times; its entry struck (-1)
  int m = 0;
  for (; m < M; ++m) {
    unsigned long long mine = 0;
    int q_mine = -1;
    for (int q = tid; q < n; q += kPlaneThreads) {
      const int i = list[q];
      if (i < 0) continue;
      const int y = i / W;
      const unsigned long long key = pick_key(h[y * sy + (i - y * W) * sx], i);
      if (key > mine) { mine = key; q_mine = q; }
    }
    const unsigned long long best = block_max_key(mine, red);
    if (best == 0) break;                           // the same in every thread
    if (mine == best) {                              // keys are unique: one thread
      list[q_mine] = -1;
      picks[m] = (int)(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFu));
    }
    __syncthreads();
  }
  const long long o = plane * M;
  if (tid < M) {
    const int i = tid < m ? picks[tid] : 0, y = i / W;
    px_out[o + tid] = i - y * W;
    py_out[o + tid] = y;
    valid_out[o + tid] = tid < m;
  }

  // refines: a warp per pick, and one at the corner for every empty slot
  float u[kSize][kSize];
  lane_columns(Us, lane, u);
  const int items = m < M ? m + 1 : m;
  for (int j = warp; j < items; j += kPlaneWarps) {
    const int i = j < m ? picks[j] : 0, cy = i / W, cx = i - cy * W;
    if (lane < kSize * kSize) {
      const int r = lane / kSize, c = lane - r * kSize;
      patch[warp][lane] = h[min(max(cy + r - kWin, 0), H - 1) * sy +
                            min(max(cx + c - kWin, 0), W - 1) * sx];
    }
    __syncwarp();
    float bv;
    int bi;
    refine_window<true>(patch[warp], H, W, cx, cy, Us, u, upA[warp], lane, bv, bi);
    for (int s = j + lane; s < (j < m ? j + 1 : M); s += 32) {
      loc_out[o + s] = bi;
      score_out[o + s] = bv;
    }
  }
}

bool plane_bad_args(int B, int K, int H, int W, int M, int win, int factor) {
  return win != kWin || factor != kFactor || M < 1 || M > kMaxPeaks || H < 1 || W < 1 ||
         B < 1 || K < 1 || (long long)H * W > INT_MAX || (long long)B * K > INT_MAX;
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

// Dynamic shared memory of a find_peaks_kernel block at these sizes, in
// bytes; above 227 KB the kernel cannot launch, and ops/kernels.py
// find_peaks takes find_peaks_row_kernel instead.
extern "C" long long popnet_find_peaks_smem(int K, int H, int W, int M) {
  return PeakLayout(K, H, W, M).bytes;
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

// Blocks of find_peaks_row_kernel (6 warps, half a frame) that one SM holds
// at these sizes.
extern "C" int popnet_find_peaks_row_blocks_per_sm(int K, int H, int W, int M, void* out) {
  int R, warps;
  size_t smem;
  if (!row_config(K, H, W, M, R, warps, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)find_peaks_row_kernel<kFlat>, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      (int*)out, find_peaks_row_kernel<kFlat>, warps * 32, smem);
}

// Clusters of find_peaks_row_kernel (a frame each) that the card places at
// once at these sizes.
extern "C" int popnet_find_peaks_row_clusters(int K, int H, int W, int M, void* out) {
  int R, warps;
  size_t smem;
  if (!row_config(K, H, W, M, R, warps, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)find_peaks_row_kernel<kFlat>, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters((int*)out, find_peaks_row_kernel<kFlat>, &cfg);
}

extern "C" int popnet_find_peaks_row(const void* heat, long long sb, long long sk,
                                     long long sy, long long sx, long long readable, int B,
                                     int K, int H, int W, int M, float thresh, int win,
                                     int factor, const void* U, void* px, void* py, void* loc,
                                     void* score, void* valid, void* stream) {
  return launch_row(heat, sb, sk, sy, sx, readable, B, K, H, W, M, thresh, win, factor, U, px,
                    py, loc, score, valid, stream);
}

// Dynamic shared memory of a find_peaks_row_kernel CTA at these sizes, in
// bytes, or -1 where that kernel cannot take them (a side over 255 cells,
// or not one plane and one warp in a CTA); ops/kernels.py find_peaks then
// takes find_peaks_plane_kernel.
extern "C" long long popnet_find_peaks_row_smem(int K, int H, int W, int M) {
  int R, warps;
  size_t smem;
  if (bad_args(1, K, H, W, M, kWin, kFactor) || !row_config(K, H, W, M, R, warps, smem))
    return -1;
  return (long long)smem;
}

// survivors: B * K * H * W ints of scratch on the card.
extern "C" int popnet_find_peaks_plane(const void* heat, long long sb, long long sk,
                                       long long sy, long long sx, int B, int K, int H, int W,
                                       int M, float thresh, int win, int factor, const void* U,
                                       void* survivors, void* px, void* py, void* loc,
                                       void* score, void* valid, void* stream) {
  if (plane_bad_args(B, K, H, W, M, win, factor)) return (int)cudaErrorInvalidValue;
  find_peaks_plane_kernel<<<(unsigned)B * K, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      (const float*)heat, sb, sk, sy, sx, K, H, W, M, thresh, (const float*)U, (int*)survivors,
      (int*)px, (int*)py, (int*)loc, (float*)score, (bool*)valid);
  return (int)cudaGetLastError();
}
