// The pairwise (topology spread + inter-pod affinity) arithmetic of one
// (pod, node) cell against a pair state, shared by K4's pairwise variant
// (scan.cu), K11 (pairwise.cu) and K22 (explain.cu) so all evaluate
// exactly alike:
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

// pairwise_row at KB nodes n[k] of pod p against (counts, anti,
// match_tot), the cells with live bit k set (a dead cell is skipped):
// bit k of spread_ok / ia_ok is that cell's spread verdict / inter-pod
// verdict (ia_ok includes !symmetric_block), and pen_out[k] / raw_out[k]
// its spread penalty and inter-pod raw score. cmin/cmax: each spread
// slot's reduced (lo, hi); only valid slots' entries are read. Each cell
// takes the same operations in the same order (spread slots in slot
// order, inter-pod terms in term order, the symmetric column over
// signatures) whatever KB is, so its bits do not depend on KB. The pod's
// terms are read once for the KB cells, and each term's KB domain and
// count loads are independent, so they are in flight together (K11 takes
// four cells a thread; pair_node is one).
template <int KB>
__device__ __forceinline__ void pair_cells(
    const PairTerms& t, const float* counts, const float* anti,
    const float* match_tot, int p, const int* n, unsigned live,
    const float* cmin, const float* cmax, float* pen_out, float* raw_out,
    unsigned& spread_ok, unsigned& ia_ok) {
  const long long N = t.N;
  unsigned ok = (1u << KB) - 1u, ia = ok;
  float pen[KB], raw[KB];
  int blocked[KB], d[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    pen[k] = 0.0f;
    raw[k] = 0.0f;
    blocked[k] = 0;
  }
  for (int c = 0; c < t.C; ++c) {
    const long long pc = (long long)p * t.C + c;
    if (!t.ts_valid[pc]) continue;
    const long long s = max(t.ts_sig[pc], 0);
    const bool dns = t.ts_when[pc] == DO_NOT_SCHEDULE;
    const float skew = t.ts_max_skew[pc], lo = min_or_0(cmin[c]);
    const float hi = cmax[c];
#pragma unroll
    for (int k = 0; k < KB; ++k)
      d[k] = (live >> k) & 1u ? t.dom[s * N + n[k]] : -1;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const bool hk = d[k] >= 0;
      const float nc = hk ? counts[s * N + d[k]] : 0.0f;
      if (dns) {
        if (!(hk && (nc + 1.0f - lo <= skew))) ok &= ~(1u << k);
      } else {
        pen[k] = pen[k] + (hk ? nc : hi);
      }
    }
  }
  for (int it = 0; it < t.IT; ++it) {
    const long long pt = (long long)p * t.IT + it;
    const long long s = max(t.ia_sig[pt], 0);
    const bool valid = t.ia_valid[pt];
    const bool anti_t = t.ia_anti[pt];
    const bool req = t.ia_required[pt];
    const float w = anti_t ? -t.ia_weight[pt] : t.ia_weight[pt];
#pragma unroll
    for (int k = 0; k < KB; ++k)
      d[k] = (live >> k) & 1u ? t.dom[s * N + n[k]] : -1;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const bool hk = d[k] >= 0;
      const bool node_has = hk && counts[s * N + d[k]] > 0.0f;
      if (valid && req) {
        // Read after the cell's count load: read ahead of the domain
        // loads, these two held K4's one-cell chain and K22 back
        // (2-13 % on the card).
        const bool all_zero = match_tot[s] <= 0.0f;
        const bool self = t.match[s * t.X + t.M + p];
        const bool pos_ok = node_has || (all_zero && self && hk);
        if (!(anti_t ? !node_has : pos_ok)) ia &= ~(1u << k);
      }
      raw[k] = raw[k] + ((valid && !req && node_has) ? w : 0.0f);
    }
  }
  for (int s = 0; s < t.S; ++s) {
    if (!t.match[(long long)s * t.X + t.M + p]) continue;
#pragma unroll
    for (int k = 0; k < KB; ++k)
      d[k] = (live >> k) & 1u ? t.dom[s * N + n[k]] : -1;
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (d[k] >= 0) blocked[k] += (int)anti[s * N + d[k]];
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    pen_out[k] = pen[k];
    raw_out[k] = raw[k];
    if (blocked[k] > 0) ia &= ~(1u << k);
  }
  spread_ok = ok;
  ia_ok = ia;
}

// pair_cells at the one node n: returns spread_ok & ia_ok, and writes
// ia_ok alone where ia_ok_out is not NULL and spread_ok alone where
// spread_ok_out is not NULL.
__device__ __forceinline__ bool pair_node(const PairTerms& t,
                                          const float* counts,
                                          const float* anti,
                                          const float* match_tot, int p,
                                          int n, const float* cmin,
                                          const float* cmax, float* pen_out,
                                          float* raw_out,
                                          bool* ia_ok_out = nullptr,
                                          bool* spread_ok_out = nullptr) {
  unsigned ok, ia;
  pair_cells<1>(t, counts, anti, match_tot, p, &n, 1u, cmin, cmax, pen_out,
                raw_out, ok, ia);
  if (ia_ok_out) *ia_ok_out = ia;
  if (spread_ok_out) *spread_ok_out = ok;
  return ok & ia;
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

constexpr int EXT_GROUP = 4;  // spread slots a walk

// Pod p's spread slots' extents (spread_extent's lo and hi) over a CTA of
// THREADS threads, EXT_GROUP slots a walk over this thread's nodes, each
// slot's two values reduced over its warp by shuffles into s_part
// ([THREADS / 32, 2, MAX_C], shared); after one barrier for all of the
// pod's slots, warp 0 reduces the warps' partials into `ext` (ext[c] =
// lo, ext[MAX_C + c] = hi, shared; only valid slots are written), which
// the CTA reads after a second. min and max are exact: any order gives
// the same bits.
template <int THREADS>
__device__ __forceinline__ void row_spread_extents(const PairTerms& t,
                                                   const float* counts, int p,
                                                   float* s_part,
                                                   float* ext) {
  constexpr int WARPS = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c0 = 0; c0 < t.C; c0 += EXT_GROUP) {
    unsigned live = 0u;  // uniform: the pod's slots
    int sig[EXT_GROUP];
    float lo[EXT_GROUP], hi[EXT_GROUP];
#pragma unroll
    for (int k = 0; k < EXT_GROUP; ++k) {
      const int c = c0 + k;
      const long long pc = (long long)p * t.C + c;
      const bool v = c < t.C && t.ts_valid[pc];
      live |= (unsigned)v << k;
      sig[k] = v ? max(t.ts_sig[pc], 0) : 0;
      lo[k] = INFINITY;
      hi[k] = 0.0f;
    }
    if (!live) continue;
    for (int n = tid; n < t.N; n += THREADS) {
#pragma unroll
      for (int k = 0; k < EXT_GROUP; ++k)
        if ((live >> k) & 1u)
          spread_extent(t, counts, p, sig[k], n, lo[k], hi[k]);
    }
#pragma unroll
    for (int k = 0; k < EXT_GROUP; ++k) {
      if (!((live >> k) & 1u)) continue;
      for (int off = 16; off > 0; off >>= 1) {
        lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
        hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
      }
      if (lane == 0) {
        s_part[warp * 2 * MAX_C + c0 + k] = lo[k];
        s_part[warp * 2 * MAX_C + MAX_C + c0 + k] = hi[k];
      }
    }
  }
  if (t.C == 0) return;  // no slot: nothing to reduce or read
  __syncthreads();
  const int c = lane % MAX_C;
  if (warp == 0 && lane < 2 * MAX_C && c < t.C &&
      t.ts_valid[(long long)p * t.C + c]) {
    const bool is_lo = lane < MAX_C;
    float x = s_part[lane];
    for (int w = 1; w < WARPS; ++w) {
      const float y = s_part[w * 2 * MAX_C + lane];
      x = is_lo ? fminf(x, y) : fmaxf(x, y);
    }
    ext[lane] = x;
  }
  __syncthreads();
}

}  // namespace tpusched
