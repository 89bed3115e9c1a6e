// Greedy person assembly of the Open-Pose+ decode, one launch per batch:
// per-limb 1-1 matching, the sequential union-merge into a slot table, and
// the filter and pack of the survivors.
//
// Replaces: popnet_tpu/decode/assemble_pallas.py assemble_ids_pallas (kernel
// _assemble_kernel).
//
// Bound on the H100: bytes by the count (a frame reads L*M*M pair scores and
// K*M peak scores and writes max_people*K ids and one count: 16 KB at L=14,
// M=16, K=15), but that is about a microsecond a batch. The real floor is
// latency: stage 2 is a chain of dependent steps, one per accepted
// connection (at most 16 a frame on the main path). Frames are independent,
// so the batch costs about its longest frame as long as every frame has its
// own block in flight. What a block pays above that floor (chip_smoke.py
// phase 5 stage clocks): a merge step is a chain of dependent instructions
// issued by one warp, some 500 cycles, so the frame with the most
// connections sets the kernel's time; then one trip to memory, the picks,
// and the pack.
//
// Design: one block per frame, a warp per limb (at most 16 warps); every warp
// stays to the end, so the stage clocks' block barriers are safe.
// - Load: each warp reads its limb's (M, M) scores straight into registers
//   (M = 16: a lane holds half a row, two 16-byte loads; any other M up to
//   32, padded to 32: a lane holds a row), and its two joint ids; the block
//   stages the frame's peak scores in shared memory. All of these loads are
//   in flight at once.
// - Stage 1, match: the warp keeps a bit per candidate pair (value above
//   -inf) and repeats: each lane's best live pair, then the warp's by two
//   reductions, on the value's order key (+0.0 and -0.0 equal) and then on
//   the lowest flat index; the pick kills its row and column. That is the
//   masked argmax with row-major ties of the plain version, and equally the
//   walk of the pairs sorted by (value descending, flat index ascending) that
//   takes a pair when its row and column are free (assemble_pallas.py:49-51):
//   each round is one accepted connection, and the limb ends when no live
//   pair remains. M is a template constant (16, or 32 for every other M), so
//   rows and columns come from shifts. Each pick goes out as one 16-byte
//   record (i, j, joints, value, both peak scores); the records are then
//   copied into one list, limb-major and in pick order, at offsets summed
//   from the per-limb counts.
// - Stage 2, merge, warp 0: for each record of the list, lanes test 32 slots
//   at a time (only slots created so far can be alive) and a ballot finds the
//   first and second live slot that holds peak i at the source joint or j at
//   the destination joint. The lane that read the first slot keeps its
//   score, count and destination id and applies the case to it itself (new
//   slot, set destination, merge, and the reference's `already` and
//   `overlap` quirks), so a step reads shared memory once and its chain is a
//   load, a ballot and the update (a merge of two slots, rare on the main
//   path, also reads both rows, lanes 0..K-1 each owning a joint). Slots
//   not made yet read as not alive, so the ballot needs no bound. The next
//   record is loaded while this one runs. Rows of the slot table have an
//   odd stride, so a ballot's 32 reads fall in 32 banks. Float32 sums keep
//   the plain version's order, (a + b) + connection score.
// - Stage 3, pack: warp 0 computes mean = score / max(count, 1) as an IEEE
//   division, keeps alive slots with count >= min_parts and mean >=
//   min_score and ranks them by ballot prefix counts (creation order); then
//   the block writes every output row once, the survivors' and then -1 rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of one block, in 4-byte words.
struct Layout {
  int P, P32, KS;  // slots (L * M), P rounded up to 32, slot-table row stride (K made odd)
  int stage, list, ids, score, count, alive, ps, cnt, sel, kept, words;
  __host__ __device__ Layout(int K, int L, int M, int max_people) {
    P = L * M;
    P32 = (P + 31) & ~31;
    KS = K | 1;
    stage = 0;              // (L, M) records by limb, int4
    list = stage + 4 * P;   // the records in one list, int4
    ids = list + 4 * P;     // (P32, KS) slot table of peak ids
    score = ids + P32 * KS; // (P32) slot score
    count = score + P32;    // (P32) slot joint count
    alive = count + P32;    // (P32) slot alive flag, 0 until the slot is made
    ps = alive + P32;       // (K, M) peak scores
    cnt = ps + K * M;       // (L) connections per limb
    sel = cnt + L;          // the survivors' slots, in rank order
    kept = sel + (max_people < P ? max_people : P);
    words = kept + 1;
  }
};

// An order key of a float: the unsigned order of the keys is the order of
// the values, and +0.0 and -0.0 have one key. Not for NaN.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));   // -0.0 + 0.0 = +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A lane's share of one limb's (M, M) scores: PER consecutive pairs of the
// (MP, MP) grid from flat index lane * PER, and a bit for each candidate.
template <int MP>
struct LimbPairs {
  static constexpr int PER = MP * MP / 32;
  static constexpr int SHIFT = MP == 16 ? 4 : 5;
  float v[PER];
  unsigned live;

  __device__ void load(const float* __restrict__ sl, int M, bool vec, int lane) {
    const int q0 = lane * PER, row = q0 >> SHIFT, c0 = q0 & (MP - 1);
    if (MP == 16 && vec) {
      const float4* p = reinterpret_cast<const float4*>(sl + q0);
#pragma unroll
      for (int h = 0; h < PER / 4; ++h) {
        const float4 f = p[h];
        v[4 * h] = f.x; v[4 * h + 1] = f.y; v[4 * h + 2] = f.z; v[4 * h + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e)
        v[e] = row < M && c0 + e < M ? sl[row * M + c0 + e] : -INFINITY;
    }
  }

  __device__ void mark() {
    live = 0;
#pragma unroll
    for (int e = 0; e < PER; ++e) live |= (v[e] > -INFINITY ? 1u : 0u) << e;
  }
};

// Stage 1 for one limb: greedy 1-1 matching; its m-th accepted connection
// goes to stage[m]. Returns the number accepted.
template <int MP>
__device__ int match_limb(LimbPairs<MP>& s, int lane, int M, int src_t, int dst_t,
                          const float* ps, int4* stage) {
  constexpr int PER = LimbPairs<MP>::PER, SHIFT = LimbPairs<MP>::SHIFT;
  const int q0 = lane * PER, row = q0 >> SHIFT, c0 = q0 & (MP - 1);
  int n = 0;
  while (__any_sync(kFull, s.live != 0)) {
    // the lane's best live pair: a strict > keeps the first of equal values
    float bv = -INFINITY;
    int be = 0;
#pragma unroll
    for (int e = 0; e < PER; ++e)
      if (((s.live >> e) & 1u) && s.v[e] > bv) { bv = s.v[e]; be = e; }
    const unsigned key = s.live ? order_key(bv) : 0u;
    const unsigned top = __reduce_max_sync(kFull, key);
    const unsigned q = s.live && key == top ? (unsigned)(q0 + be) : 0xffffffffu;
    const unsigned win = __reduce_min_sync(kFull, q);
    const int r = (int)(win >> SHIFT), c = (int)(win & (MP - 1));
    const float wv = __shfl_sync(kFull, bv, (int)(win / PER));
    if (lane == 0)
      stage[n] = make_int4(r | c << 8 | src_t << 16 | dst_t << 24, __float_as_int(wv),
                           __float_as_int(ps[src_t * M + r]), __float_as_int(ps[dst_t * M + c]));
    if (row == r) s.live = 0;
    const int ce = c - c0;
    if (ce >= 0 && ce < PER) s.live &= ~(1u << ce);
    ++n;
  }
  return n;
}

template <int MP>
__global__ void __launch_bounds__(kMaxWarps * 32)
assemble_kernel(const float* __restrict__ peak_score, const float* __restrict__ s_masked,
                const int* __restrict__ limbs, int K, int L, int M, int max_people,
                int min_parts, float min_score, bool vec, int* __restrict__ ids_out,
                int* __restrict__ counts_out) {
  extern __shared__ __align__(16) int smem[];
  const Layout lay(K, L, M, max_people);
  int4* stage = reinterpret_cast<int4*>(smem + lay.stage);
  int4* list = reinterpret_cast<int4*>(smem + lay.list);
  int* ids = smem + lay.ids;
  float* score = reinterpret_cast<float*>(smem + lay.score);
  int* count = smem + lay.count;
  int* alive = smem + lay.alive;
  float* ps = reinterpret_cast<float*>(smem + lay.ps);
  int* cnt = smem + lay.cnt;
  int* sel = smem + lay.sel;
  const int KS = lay.KS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int b = blockIdx.x;
  STAGE_STAMP(0);

  // ---- load: the first limb's scores into registers, peak scores staged ----
  // every global load of the first limb is issued before any is waited on
  const float* sb = s_masked + (long long)b * L * M * M;
  const float* pb = peak_score + (long long)b * K * M;
  const float p0 = tid < K * M ? pb[tid] : 0.0f;
  LimbPairs<MP> s;
  int l = warp, src_t = 0, dst_t = 0;
  if (l < L) {
    s.load(sb + (long long)l * M * M, M, vec, lane);
    src_t = limbs[2 * l];
    dst_t = limbs[2 * l + 1];
  }
  if (tid < K * M) ps[tid] = p0;
  for (int q = tid + blockDim.x; q < K * M; q += blockDim.x) ps[q] = pb[q];
  for (int q = tid; q < lay.P32; q += blockDim.x) alive[q] = 0;
  if (l < L) s.mark();
  __syncthreads();
  STAGE_STAMP(1);

  // ---- stage 1: greedy 1-1 matching, a warp per limb -------------------------
  for (; l < L; l += nwarps) {
    const int n = match_limb<MP>(s, lane, M, src_t, dst_t, ps, stage + l * M);
    if (lane == 0) cnt[l] = n;
    if (l + nwarps < L) {
      s.load(sb + (long long)(l + nwarps) * M * M, M, vec, lane);
      src_t = limbs[2 * (l + nwarps)];
      dst_t = limbs[2 * (l + nwarps) + 1];
      s.mark();
    }
  }
  __syncthreads();
  // one list, limb-major: a limb's records after those of the limbs before it
  for (int m = warp; m < L; m += nwarps) {
    int off = 0;
    for (int x = lane; x < m; x += 32) off += cnt[x];
    off = __reduce_add_sync(kFull, off);
    for (int e = lane; e < cnt[m]; e += 32) list[off + e] = stage[m * M + e];
  }
  int total = 0;
  for (int x = lane; x < L; x += 32) total += cnt[x];
  total = __reduce_add_sync(kFull, total);
  __syncthreads();
  STAGE_STAMP(2);

  // ---- stage 2: sequential union-merge over the list, warp 0 ----------------
  int ncre = 0;
  if (warp == 0) {
    int4 next = total > 0 ? list[0] : make_int4(0, 0, 0, 0);
    for (int t = 0; t < total; ++t) {
      const int4 cn = next;
      if (t + 1 < total) next = list[t + 1];
      const int i = cn.x & 0xff, j = (cn.x >> 8) & 0xff;
      const int src_t = (cn.x >> 16) & 0xff, dst_t = (cn.x >> 24) & 0xff;
      const float v = __int_as_float(cn.y), ps_src = __int_as_float(cn.z),
                  ps_dst = __int_as_float(cn.w);
      // the first and second live slot that holds i at src_t or j at dst_t
      // (a slot not made yet is not alive); the lane that read the first
      // keeps its score, count and destination id and updates it itself, the
      // second's are shuffled to every lane (a merge of two slots, rare)
      int a0 = -1, a1 = -1, ct0 = 0, ct1 = 0, y0 = 0;
      float sc0 = 0.0f, sc1 = 0.0f;
      bool own0 = false;
      for (int base = 0; base < ncre && a1 < 0; base += 32) {
        const int p = base + lane;
        const int live = alive[p], x = ids[p * KS + src_t], y = ids[p * KS + dst_t];
        const float sc = score[p];
        const int ct = count[p];
        unsigned bal = __ballot_sync(kFull, live && (x == i || y == j));
        if (bal && a0 < 0) {
          const int f = __ffs(bal) - 1;
          a0 = base + f;
          if (lane == f) {
            own0 = true;
            sc0 = sc;
            ct0 = ct;
            y0 = y;
          }
          bal &= bal - 1;
        }
        if (bal) {
          const int f = __ffs(bal) - 1;
          a1 = base + f;
          sc1 = __shfl_sync(kFull, sc, f);
          ct1 = __shfl_sync(kFull, ct, f);
        }
      }
      bool set_dst = false;
      if (a0 < 0) {                                    // new slot
        if (lane < K) ids[ncre * KS + lane] = lane == dst_t ? j : (lane == src_t ? i : -1);
        if (lane == 0) {
          score[ncre] = __fadd_rn(__fadd_rn(ps_src, ps_dst), v);
          count[ncre] = 2;
          alive[ncre] = 1;
        }
        ++ncre;
      } else if (a1 < 0) {                             // one slot: add the destination
        set_dst = own0 && y0 != j;
      } else {                                         // the connection joins two slots
        const int r0 = lane < K ? ids[a0 * KS + lane] : -1;
        const int r1 = lane < K ? ids[a1 * KS + lane] : -1;
        if (__any_sync(kFull, r0 >= 0 && r1 >= 0)) {   // they overlap
          set_dst = own0;
        } else {
          if (lane < K) ids[a0 * KS + lane] = r0 + r1 + 1;
          if (own0) {
            score[a0] = __fadd_rn(__fadd_rn(sc0, sc1), v);
            count[a0] = ct0 + ct1;
            alive[a1] = 0;
          }
        }
      }
      if (set_dst) {
        ids[a0 * KS + dst_t] = j;
        score[a0] = __fadd_rn(__fadd_rn(sc0, ps_dst), v);
        count[a0] = ct0 + 1;
      }
      __syncwarp();
    }
  }
  STAGE_STAMP(3);

  // ---- stage 3: filter and rank in creation order, then write every row -----
  if (warp == 0) {
    int kept = 0;
    const unsigned lt_mask = (1u << lane) - 1u;
    for (int base = 0; base < ncre; base += 32) {
      const int p = base + lane;
      bool survive = false;
      if (p < ncre && alive[p] && count[p] >= min_parts) {
        const int c = count[p] > 1 ? count[p] : 1;
        survive = __fdiv_rn(score[p], (float)c) >= min_score;
      }
      const unsigned bal = __ballot_sync(kFull, survive);
      const int rank = kept + __popc(bal & lt_mask);
      if (survive && rank < max_people) sel[rank] = p;
      kept += __popc(bal);
    }
    if (lane == 0) {
      kept = kept < max_people ? kept : max_people;
      smem[lay.kept] = kept;
      counts_out[b] = kept;
    }
  }
  __syncthreads();
  const int kept = smem[lay.kept];
  int* out = ids_out + (long long)b * max_people * K;
  if (lane < K)
    for (int r = warp; r < max_people; r += nwarps)
      out[r * K + lane] = r < kept ? ids[sel[r] * KS + lane] : -1;
  STAGE_STAMP(4);
}

size_t smem_bytes(int K, int L, int M, int max_people) {
  return 4 * (size_t)Layout(K, L, M, max_people).words;
}

int threads_for(int L) { return 32 * (L < kMaxWarps ? L : kMaxWarps); }

// The kernel for M: 16 with its shifts; every other M up to 32 padded to 32.
const void* kernel_for(int M) {
  return M == 16 ? (const void*)assemble_kernel<16> : (const void*)assemble_kernel<32>;
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool sizes_ok(int K, int L, int M, int max_people) {
  return K >= 1 && K <= 32 && L >= 1 && L <= 4096 && M >= 1 && M <= 32 && max_people >= 1 &&
         smem_bytes(K, L, M, max_people) <= 227 * 1024;
}

}  // namespace

extern "C" int popnet_assemble(const void* peak_score, const void* s_masked,
                               const void* limbs, int B, int K, int L, int M,
                               int max_people, int min_parts, float min_score,
                               void* ids, void* counts, void* stream) {
  if (B < 1 || !sizes_ok(K, L, M, max_people)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, L, M, max_people);
  cudaError_t e = allow_smem(kernel_for(M), smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = reinterpret_cast<uintptr_t>(s_masked) % 16 == 0;
  const dim3 grid(B), block(threads_for(L));
  cudaStream_t st = (cudaStream_t)stream;
  if (M == 16)
    assemble_kernel<16><<<grid, block, smem, st>>>(
        (const float*)peak_score, (const float*)s_masked, (const int*)limbs, K, L, M,
        max_people, min_parts, min_score, vec, (int*)ids, (int*)counts);
  else
    assemble_kernel<32><<<grid, block, smem, st>>>(
        (const float*)peak_score, (const float*)s_masked, (const int*)limbs, K, L, M,
        max_people, min_parts, min_score, vec, (int*)ids, (int*)counts);
  return (int)cudaGetLastError();
}

// Blocks of the assembly kernel that one SM holds at these sizes.
extern "C" int popnet_assemble_blocks_per_sm(int K, int L, int M, int max_people, void* out) {
  if (!sizes_ok(K, L, M, max_people)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, L, M, max_people);
  cudaError_t e = allow_smem(kernel_for(M), smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor((int*)out, kernel_for(M),
                                                            threads_for(L), smem);
}
