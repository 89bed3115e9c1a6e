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
// latency: stage 2 is a chain of up to L*M dependent steps per frame, each at
// least one shared-memory round trip. Frames are independent, so the batch
// costs one frame's chain as long as every frame has its own block in flight.
//
// Design: one block per frame; the slot table never leaves shared memory.
// Stage 1, one warp per limb: the limb's (M, M) scores sit in shared memory;
// M rounds of a warp argmax on (value descending, flat index ascending) over
// the pairs whose row and column are still free (two bit masks in registers),
// which is the masked argmax with row-major ties of the plain version. A limb
// stops at its first round without a candidate.
// Stage 2, warp 0 alone, so the chain needs no block barrier: for each
// accepted connection, lanes test 32 slots at a time (only slots created so
// far can be alive) and a ballot finds the first and second live slot that
// holds peak i at the source joint or j at the destination joint; lanes 0..K-1
// then apply the case (new slot, set destination, merge, and the reference's
// `already` and `overlap` quirks) to the row. Connections that were not
// accepted are skipped. Float32 sums keep the plain version's order,
// (a + b) + connection score.
// Stage 3, warp 0: mean = score / max(count, 1) as an IEEE division, keep
// alive slots with count >= min_parts and mean >= min_score, rank them by
// ballot prefix counts (creation order) and write the first max_people rows.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
assemble_kernel(const float* __restrict__ peak_score, const float* __restrict__ s_masked,
                const int* __restrict__ limbs, int K, int L, int M, int max_people,
                int min_parts, float min_score, int* __restrict__ ids_out,
                int* __restrict__ counts_out) {
  extern __shared__ float smem[];
  const int P = L * M;
  float* s = smem;                                   // (L, M, M) pair scores
  float* ps = s + L * M * M;                         // (K, M) peak scores
  float* cv = ps + K * M;                            // (P) connection score, -inf = none
  float* score = cv + P;                             // (P) slot score
  int* ci = reinterpret_cast<int*>(score + P);       // (P) connection source peak
  int* cj = ci + P;                                  // (P) connection destination peak
  int* count = cj + P;                               // (P) slot joint count
  int* alive = count + P;                            // (P) slot alive flag
  int* ids = alive + P;                              // (P, K) slot table of peak ids
  int* limb = ids + P * K;                           // (L, 2)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const float* sb = s_masked + (long long)b * L * M * M;
  for (int q = tid; q < L * M * M; q += kThreads) s[q] = sb[q];
  for (int q = tid; q < K * M; q += kThreads) ps[q] = peak_score[(long long)b * K * M + q];
  for (int q = tid; q < 2 * L; q += kThreads) limb[q] = limbs[q];
  int* out = ids_out + (long long)b * max_people * K;
  for (int q = tid; q < max_people * K; q += kThreads) out[q] = -1;
  __syncthreads();

  // ---- stage 1: greedy 1-1 matching, one warp per limb --------------------
  for (int l = warp; l < L; l += kWarps) {
    const float* sl = s + l * M * M;
    unsigned row_used = 0, col_used = 0;
    int m = 0;
    for (; m < M; ++m) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int q = lane; q < M * M; q += 32) {
        const int r = q / M, c = q % M;
        if ((row_used >> r) & 1u || (col_used >> c) & 1u) continue;
        const float v = sl[q];
        if (better(v, q, bv, bi)) { bv = v; bi = q; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_xor_sync(kFull, bv, off);
        int oi = __shfl_xor_sync(kFull, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (!(bv > -INFINITY)) break;                  // no candidate left in this limb
      const int r = bi / M, c = bi % M;
      if (lane == 0) { ci[l * M + m] = r; cj[l * M + m] = c; cv[l * M + m] = bv; }
      row_used |= 1u << r;
      col_used |= 1u << c;
    }
    for (int e = m + lane; e < M; e += 32) cv[l * M + e] = -INFINITY;
  }
  __syncthreads();
  if (warp != 0) return;

  // ---- stage 2: sequential union-merge, warp 0 ----------------------------
  int ncre = 0;
  for (int t = 0; t < P; ++t) {
    const float v = cv[t];
    if (!isfinite(v)) continue;
    const int l = t / M;
    const int src_t = limb[2 * l], dst_t = limb[2 * l + 1];
    const int i = ci[t], j = cj[t];
    int a0 = -1, a1 = -1;
    for (int base = 0; base < ncre && a1 < 0; base += 32) {
      const int p = base + lane;
      const bool match = p < ncre && alive[p] &&
                         (ids[p * K + src_t] == i || ids[p * K + dst_t] == j);
      unsigned bal = __ballot_sync(kFull, match);
      if (bal && a0 < 0) { a0 = base + __ffs(bal) - 1; bal &= bal - 1; }
      if (bal && a1 < 0) a1 = base + __ffs(bal) - 1;
    }
    bool set_dst = false;
    if (a0 < 0) {                                    // new slot
      if (lane < K) ids[ncre * K + lane] = lane == src_t ? i : (lane == dst_t ? j : -1);
      if (lane == 0) {
        score[ncre] = __fadd_rn(__fadd_rn(ps[src_t * M + i], ps[dst_t * M + j]), v);
        count[ncre] = 2;
        alive[ncre] = 1;
      }
      ++ncre;
    } else if (a1 >= 0) {                            // the connection joins two slots
      const int r0 = lane < K ? ids[a0 * K + lane] : -1;
      const int r1 = lane < K ? ids[a1 * K + lane] : -1;
      const bool overlap = __any_sync(kFull, r0 >= 0 && r1 >= 0);
      if (overlap) {
        set_dst = true;
      } else {
        if (lane < K) ids[a0 * K + lane] = r0 + r1 + 1;
        if (lane == 0) {
          score[a0] = __fadd_rn(__fadd_rn(score[a0], score[a1]), v);
          count[a0] += count[a1];
          alive[a1] = 0;
        }
      }
    } else {                                         // one slot: add the destination
      set_dst = ids[a0 * K + dst_t] != j;
    }
    __syncwarp();
    if (set_dst && lane == 0) {
      ids[a0 * K + dst_t] = j;
      score[a0] = __fadd_rn(__fadd_rn(score[a0], ps[dst_t * M + j]), v);
      count[a0] += 1;
    }
    __syncwarp();
  }

  // ---- stage 3: filter and pack in creation order -------------------------
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
    if (survive && rank < max_people)
      for (int k = 0; k < K; ++k) out[rank * K + k] = ids[p * K + k];
    kept += __popc(bal);
  }
  if (lane == 0) counts_out[b] = kept < max_people ? kept : max_people;
}

}  // namespace

extern "C" int popnet_assemble(const void* peak_score, const void* s_masked,
                               const void* limbs, int B, int K, int L, int M,
                               int max_people, int min_parts, float min_score,
                               void* ids, void* counts, void* stream) {
  if (B < 1 || K < 1 || K > 32 || L < 1 || M < 1 || M > 32 || max_people < 1)
    return (int)cudaErrorInvalidValue;
  const size_t P = (size_t)L * M;
  size_t smem = 4 * ((size_t)L * M * M + (size_t)K * M + 6 * P + P * K + 2 * (size_t)L);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(assemble_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  assemble_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)peak_score, (const float*)s_masked, (const int*)limbs, K, L, M,
      max_people, min_parts, min_score, (int*)ids, (int*)counts);
  return (int)cudaGetLastError();
}
