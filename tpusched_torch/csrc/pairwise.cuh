// The pairwise (topology spread + inter-pod affinity) arithmetic of one
// (pod, node) cell against a pair state, shared by K4's pairwise variant
// (scan.cu) and K11 (pairwise.cu) so both evaluate exactly alike:
// tpusched/kernels/pairwise.py:504 pairwise_row, which is :342
// pairwise_from_counts restricted to one pod, with the symmetric
// anti-affinity column of :303 symmetric_anti_block, and the two
// normalisers of tpusched/kernels/score.py:118,131.
//
// Where trouble is likely, and what this code does about it:
//  * Counts are small integers held in f32, exact below 2^24, so every
//    comparison (skew, presence, "no member matches") is exact.
//  * The spread penalty and the inter-pod raw score are sums over the
//    pod's constraint slots in slot order from 0.0f, as the JAX loop adds
//    them; the normalisers compute (hi - x) * 100 / max(hi - lo, 1e-9) as
//    a product, then an IEEE divide (the build uses --fmad=false, so no
//    multiply-add is contracted into an FMA; ROADMAP C1 is the JAX
//    engine's own contraction on the CPU).
//  * A spread constraint with no eligible node has min = +inf from the
//    block reduction, which the JAX code replaces by 0: so does min_or_0.
//  * match_tot counts members on key-less nodes too (the oracle's
//    match.any()); domain counts do not.
//  * A padding signature slot (sigs.valid false, key -1) has every domain
//    -1 in `dom` (sig_domains), so it adds nothing and gathers nothing.
//  * The symmetric column is an int32 sum over signatures of
//    match[s, M+p] * (int)anti[s, dom[s, n]], as JAX contracts it.
#pragma once

#include <math.h>

namespace tpusched {

constexpr int MAX_C = 16;              // spread constraints per pod
constexpr signed char DO_NOT_SCHEDULE = 0;

// The per-pod term arrays and per-signature tables of one snapshot.
struct PairTerms {
  int N, S, C, IT, X, M;        // X = M + P members
  const int* dom;               // [S, N] domain id, -1 without the key
  const bool* match;            // [S, X] signature x member match
  const bool* node_valid;       // [N]
  const bool* aff_ok;           // [P, N] required node affinity
  const int* ts_sig;            // [P, C]
  const bool* ts_valid;         // [P, C]
  const signed char* ts_when;   // [P, C]
  const float* ts_max_skew;     // [P, C]
  const int* ia_sig;            // [P, IT]
  const bool* ia_valid;         // [P, IT]
  const bool* ia_anti;          // [P, IT]
  const bool* ia_required;      // [P, IT]
  const float* ia_weight;       // [P, IT]
};

// Tenant b's slice of a batch's terms (every array gains a leading [B]
// axis; the pod count is X - M).
__device__ __forceinline__ PairTerms tenant_terms(PairTerms t, long long b) {
  if (b == 0) return t;
  const long long P = t.X - t.M, N = t.N, S = t.S;
  t.dom += b * S * N;
  t.match += b * S * t.X;
  t.node_valid += b * N;
  t.aff_ok += b * P * N;
  t.ts_sig += b * P * t.C;
  t.ts_valid += b * P * t.C;
  t.ts_when += b * P * t.C;
  t.ts_max_skew += b * P * t.C;
  t.ia_sig += b * P * t.IT;
  t.ia_valid += b * P * t.IT;
  t.ia_anti += b * P * t.IT;
  t.ia_required += b * P * t.IT;
  t.ia_weight += b * P * t.IT;
  return t;
}

// Node n's share of spread constraint (p, signature s)'s two reductions:
// lo = min count over eligible nodes (valid, node affinity, key),
// hi = max count over nodes with the key (JAX max_count_sig; nodes
// without it count 0, which the caller's start value hi = 0 covers).
__device__ __forceinline__ void spread_extent(const PairTerms& t,
                                              const float* counts, int p,
                                              int s, int n, float& lo,
                                              float& hi) {
  const long long N = t.N;
  const int d = t.dom[s * N + n];
  if (d < 0) return;
  const float nc = counts[s * N + d];
  hi = fmaxf(hi, nc);
  if (t.node_valid[n] && t.aff_ok[(long long)p * N + n]) lo = fminf(lo, nc);
}

__device__ __forceinline__ float min_or_0(float lo) {
  return isinf(lo) ? 0.0f : lo;
}

// pairwise_row at node n for pod p against (counts, anti, match_tot):
// returns spread_ok & ia_ok (ia_ok includes !symmetric_block), and writes
// the spread penalty and the inter-pod raw score, ia_ok alone where
// ia_ok_out is not NULL and spread_ok alone where spread_ok_out is not
// NULL. cmin/cmax: each spread slot's reduced (lo, hi); only valid
// slots' entries are read.
__device__ __forceinline__ bool pair_node(const PairTerms& t,
                                          const float* counts,
                                          const float* anti,
                                          const float* match_tot, int p,
                                          int n, const float* cmin,
                                          const float* cmax, float* pen_out,
                                          float* raw_out,
                                          bool* ia_ok_out = nullptr,
                                          bool* spread_ok_out = nullptr) {
  const long long N = t.N;
  bool ok = true;   // spread_ok
  bool ia = true;   // ia_ok
  float pen = 0.0f;
  for (int c = 0; c < t.C; ++c) {
    const long long pc = (long long)p * t.C + c;
    if (!t.ts_valid[pc]) continue;
    const int s = max(t.ts_sig[pc], 0);
    const int d = t.dom[s * N + n];
    const bool hk = d >= 0;
    const float nc = hk ? counts[s * N + d] : 0.0f;
    if (t.ts_when[pc] == DO_NOT_SCHEDULE) {
      ok = ok && hk && (nc + 1.0f - min_or_0(cmin[c]) <= t.ts_max_skew[pc]);
    } else {
      pen = pen + (hk ? nc : cmax[c]);
    }
  }
  float raw = 0.0f;
  for (int it = 0; it < t.IT; ++it) {
    const long long pt = (long long)p * t.IT + it;
    const int s = max(t.ia_sig[pt], 0);
    const int d = t.dom[s * N + n];
    const bool hk = d >= 0;
    const bool node_has = hk && counts[s * N + d] > 0.0f;
    const bool valid = t.ia_valid[pt];
    const bool anti_t = t.ia_anti[pt];
    const bool req = t.ia_required[pt];
    if (valid && req) {
      const bool all_zero = match_tot[s] <= 0.0f;
      const bool self = t.match[(long long)s * t.X + t.M + p];
      const bool pos_ok = node_has || (all_zero && self && hk);
      ia = ia && (anti_t ? !node_has : pos_ok);
    }
    const float w = anti_t ? -t.ia_weight[pt] : t.ia_weight[pt];
    raw = raw + ((valid && !req && node_has) ? w : 0.0f);
  }
  int blocked = 0;
  for (int s = 0; s < t.S; ++s) {
    if (!t.match[(long long)s * t.X + t.M + p]) continue;
    const int d = t.dom[s * N + n];
    if (d >= 0) blocked += (int)anti[s * N + d];
  }
  *pen_out = pen;
  *raw_out = raw;
  ia = ia && blocked <= 0;
  if (ia_ok_out) *ia_ok_out = ia;
  if (spread_ok_out) *spread_ok_out = ok;
  return ok && ia;
}

// score.inverse_normalize: lower penalty -> higher score, all equal -> 100.
__device__ __forceinline__ float inverse_norm(float pen, float lo, float hi) {
  return hi > lo ? (hi - pen) * 100.0f / fmaxf(hi - lo, 1e-9f) : 100.0f;
}

// score.minmax_normalize: (raw - min) * 100 / (max - min), max == min -> 0.
__device__ __forceinline__ float minmax_norm(float raw, float lo, float hi) {
  return hi > lo ? (raw - lo) * 100.0f / fmaxf(hi - lo, 1e-9f) : 0.0f;
}

// Block-wide (min of lo, max of hi), the result in every thread. min and
// max are exact, so the reduction order does not matter. Ends with a
// barrier, so the scratch (WARPS floats each) is free for the next call.
template <int WARPS>
__device__ __forceinline__ void block_min_max(float& lo, float& hi,
                                              float* s_lo, float* s_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
  for (int w = 1; w < WARPS; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }
  __syncthreads();
}

// The spread slots' (min, max) of pod p, into s_cmin / s_cmax (shared,
// MAX_C each), nodes [lo_n, hi_n) of this thread, stride `step`.
template <int WARPS>
__device__ __forceinline__ void spread_extents(const PairTerms& t,
                                               const float* counts, int p,
                                               int n0, int n1, int step,
                                               float* s_lo, float* s_hi,
                                               float* s_cmin, float* s_cmax) {
  for (int c = 0; c < t.C; ++c) {
    const long long pc = (long long)p * t.C + c;
    if (!t.ts_valid[pc]) continue;  // uniform across the block
    const int s = max(t.ts_sig[pc], 0);
    float lo = INFINITY, hi = 0.0f;
    for (int n = n0; n < n1; n += step) spread_extent(t, counts, p, s, n, lo, hi);
    block_min_max<WARPS>(lo, hi, s_lo, s_hi);
    if (threadIdx.x == 0) {
      s_cmin[c] = lo;
      s_cmax[c] = hi;
    }
  }
  __syncthreads();
}

}  // namespace tpusched
