// K22: the decision-provenance probe's [P, N] pass.
//
// Replaces tpusched/kernels/explain.py:94 explain_probe up to its top-k:
// every (valid pod, valid node) cell's first failing filter in
// FILTER_REASONS order (cordon, taint, node affinity, resources, and with
// signatures spread, then inter-pod), the per-pod tallies and feasible
// counts, and the six SCORE_TERMS, each times the solve's effective
// weight, with their sum masked to -inf where the cell is infeasible. The
// top-k of that row is K6's (row_topk); the terms of the chosen cells are
// this file's second entry point.
//
// explain_cells: one CTA a pod row, two passes over N.
//   1. The row normalisers: the maxima of where(valid, na_raw, 0) and
//      where(valid, tt_count, 0) (score.node_affinity_score's
//      default_normalize and taint_toleration_score), and with signatures
//      each spread slot's (min, max) count and the (min, max) over valid
//      nodes of the spread penalty and the inter-pod raw score
//      (inverse_normalize, minmax_normalize); pairwise.cuh's
//      row_spread_extents and pair_node, K11's arithmetic, against the
//      running members' pair state.
//      They are saved to norms [P, 6 + 2C] for the second entry point.
//   2. Every cell: the first failing predicate (counts in registers, then
//      a warp-shuffle and shared-memory integer sum: exact in any order),
//      and the terms lr, ba (cell.cuh's least_requested and
//      balanced_allocation), na, tt, ts (w_ts * 100 at S = 0) and ia (0
//      at S = 0), summed left to right; masked[p, n] = the sum or -inf.
// explain_terms: a thread a chosen cell (p, j): the six terms at node
// topi[p, j] from the saved normalisers, zero where the slot has no
// candidate (topv = -inf).
//
// The [P, N, 6] term tensor that the JAX program builds (1.26 GB at
// 10 240 x 5 120) is never written: only masked (4 bytes a cell) and the
// [P, kb, 6] terms leave the kernels.
//
// Bound: bytes. A cell reads aff_ok (1 byte), na_raw and tt_count (4
// each) twice, once a pass, and writes masked (4): the least the work
// needs is 13 bytes a cell, 0.68 GB at 10 240 x 5 120, 0.2 ms at 3.35
// TB/s. The per-cell taint, resource and (S > 0) pairwise loops read the
// node's and the pod's rows, which stay in L1/L2.
#include <math.h>

#include "cell.cuh"
#include "kernels.h"
#include "pairwise.cuh"

namespace {

using tpusched::MAX_R;
using tpusched::PairTerms;
using tpusched::ResW;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NREASON = 6;
constexpr int EFFECT_NO_SCHEDULE = 0;
constexpr int EFFECT_NO_EXECUTE = 2;

// The per-pod and per-node arrays of the probe besides the pair state.
struct Probe {
  int P, N, R, TN, VT;
  const float* alloc;           // [N, R]
  const float* used;            // [N, R]
  const float* req;             // [P, R]
  const float* rw;              // [R]
  const bool* pod_valid;        // [P]
  const bool* node_valid;       // [N]
  const bool* schedulable;      // [N]
  const bool* tolerates_unsched;  // [P]
  const int* taint_ids;         // [N, TN]
  const signed char* taint_effect;  // [VT]
  const bool* tolerated;        // [P, VT]
  const bool* aff_ok;           // [P, N]
  const float* na_raw;          // [P, N]
  const float* tt_count;        // [P, N]
  const float* w_lr;            // [P] each: effective weights
  const float* w_ba;
  const float* w_na;
  const float* w_tt;
  const float* w_ts;
  const float* w_ia;
};

// The row normalisers saved by explain_cells (norms row layout).
struct Norms {
  float na_mx, tt_mx, plo, phi, rlo, rhi;
};

__device__ __forceinline__ bool taint_ok(const Probe& q, int p, int n) {
  for (int j = 0; j < q.TN; ++j) {
    const int tid = q.taint_ids[(long long)n * q.TN + j];
    if (tid < 0) continue;
    const int eff = q.taint_effect[tid];
    if ((eff == EFFECT_NO_SCHEDULE || eff == EFFECT_NO_EXECUTE) &&
        !q.tolerated[(long long)p * q.VT + tid])
      return false;
  }
  return true;
}

// The six terms of cell (p, n) and their left-to-right sum.
__device__ __forceinline__ float cell_terms(const Probe& q, const ResW& w,
                                            const float* rq, int p, int n,
                                            const Norms& nm, bool pair,
                                            float pen, float raw,
                                            float* t) {
  const float* u = q.used + (long long)n * q.R;
  const float* a = q.alloc + (long long)n * q.R;
  const long long cell = (long long)p * q.N + n;
  t[0] = q.w_lr[p] * tpusched::cell_lr(u, a, rq, q.R, w);
  t[1] = q.w_ba[p] * tpusched::cell_ba(u, a, rq, q.R, w);
  t[2] = q.w_na[p] * (nm.na_mx > 0.0f
                          ? q.na_raw[cell] * 100.0f / fmaxf(nm.na_mx, 1e-9f)
                          : 0.0f);
  t[3] = q.w_tt[p] *
         (nm.tt_mx > 0.0f
              ? (nm.tt_mx - q.tt_count[cell]) * 100.0f /
                    fmaxf(nm.tt_mx, 1e-9f)
              : 100.0f);
  if (pair) {
    t[4] = q.w_ts[p] * tpusched::inverse_norm(pen, nm.plo, nm.phi);
    t[5] = q.w_ia[p] * tpusched::minmax_norm(raw, nm.rlo, nm.rhi);
  } else {
    t[4] = q.w_ts[p] * 100.0f;
    t[5] = 0.0f;
  }
  float s = 0.0f;
  for (int k = 0; k < 6; ++k) s = s + t[k];
  return s;
}

__device__ __forceinline__ int block_sum(int v, int* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  int tot = 0;
  for (int k = 0; k < WARPS; ++k) tot += s_red[k];
  __syncthreads();
  return tot;
}

__global__ void __launch_bounds__(THREADS)
explain_cells_kernel(Probe q, PairTerms t, const float* __restrict__ counts,
                     const float* __restrict__ anti,
                     const float* __restrict__ match_tot,
                     int* __restrict__ tallies, int* __restrict__ feasible,
                     float* __restrict__ masked, float* __restrict__ norms) {
  __shared__ float s_lo[WARPS], s_hi[WARPS];
  __shared__ float s_part[WARPS * 2 * tpusched::MAX_C];
  __shared__ float s_ext[2 * tpusched::MAX_C];  // [lo, hi] a spread slot
  const float* s_cmin = s_ext;
  const float* s_cmax = s_ext + tpusched::MAX_C;
  __shared__ int s_red[WARPS];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = q.N;
  const bool pair = t.S > 0;
  const long long row = (long long)p * N;
  const int NW = 6 + 2 * t.C;
  if (pair) tpusched::row_spread_extents<THREADS>(t, counts, p, s_part, s_ext);
  // Pass 1: the row normalisers.
  float na_mx = -INFINITY, tt_mx = -INFINITY;
  float plo = INFINITY, phi = -INFINITY, rlo = INFINITY, rhi = -INFINITY;
  for (int n = tid; n < N; n += THREADS) {
    const bool v = q.node_valid[n];
    na_mx = fmaxf(na_mx, v ? q.na_raw[row + n] : 0.0f);
    tt_mx = fmaxf(tt_mx, v ? q.tt_count[row + n] : 0.0f);
    if (pair && v) {
      float pen, raw;
      tpusched::pair_node(t, counts, anti, match_tot, p, n, s_cmin, s_cmax,
                          &pen, &raw);
      plo = fminf(plo, pen);
      phi = fmaxf(phi, pen);
      rlo = fminf(rlo, raw);
      rhi = fmaxf(rhi, raw);
    }
  }
  float dummy = INFINITY;
  tpusched::block_min_max<WARPS>(dummy, na_mx, s_lo, s_hi);
  dummy = INFINITY;
  tpusched::block_min_max<WARPS>(dummy, tt_mx, s_lo, s_hi);
  tpusched::block_min_max<WARPS>(plo, phi, s_lo, s_hi);
  tpusched::block_min_max<WARPS>(rlo, rhi, s_lo, s_hi);
  const Norms nm{na_mx, tt_mx, plo, phi, rlo, rhi};
  if (tid == 0) {
    float* o = norms + (long long)p * NW;
    o[0] = na_mx;
    o[1] = tt_mx;
    o[2] = plo;
    o[3] = phi;
    o[4] = rlo;
    o[5] = rhi;
    for (int c = 0; c < t.C; ++c) {
      o[6 + c] = pair ? s_cmin[c] : 0.0f;
      o[6 + t.C + c] = pair ? s_cmax[c] : 0.0f;
    }
  }

  // Pass 2: every cell.
  ResW w;
  tpusched::load_resw(w, q.rw, q.R);
  float rq[MAX_R];
  for (int r = 0; r < q.R; ++r) rq[r] = q.req[(long long)p * q.R + r];
  const bool pv = q.pod_valid[p];
  const bool cordon_tol = q.tolerates_unsched[p];
  int cnt[NREASON + 1] = {0, 0, 0, 0, 0, 0, 0};
  for (int n = tid; n < N; n += THREADS) {
    float pen = 0.0f, raw = 0.0f;
    bool spread_ok = true, ia_ok = true;
    if (pair) {
      tpusched::pair_node(t, counts, anti, match_tot, p, n, s_cmin, s_cmax,
                          &pen, &raw, &ia_ok, &spread_ok);
    }
    float terms[6];
    const float total = cell_terms(q, w, rq, p, n, nm, pair, pen, raw, terms);
    int reason = -1;  // -1: not in the universe
    if (pv && q.node_valid[n]) {
      const float* u = q.used + (long long)n * q.R;
      const float* a = q.alloc + (long long)n * q.R;
      if (!(q.schedulable[n] || cordon_tol)) {
        reason = 0;
      } else if (!taint_ok(q, p, n)) {
        reason = 1;
      } else if (!q.aff_ok[row + n]) {
        reason = 2;
      } else if (!tpusched::cell_fits(u, a, rq, q.R)) {
        reason = 3;
      } else if (!spread_ok) {
        reason = 4;
      } else if (!ia_ok) {
        reason = 5;
      } else {
        reason = NREASON;  // feasible
      }
      cnt[reason] += 1;
    }
    masked[row + n] = reason == NREASON ? total : -INFINITY;
  }
  for (int k = 0; k <= NREASON; ++k) {
    const int tot = block_sum(cnt[k], s_red);
    if (tid == 0) {
      if (k < NREASON) {
        tallies[(long long)p * NREASON + k] = tot;
      } else {
        feasible[p] = tot;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
explain_terms_kernel(Probe q, PairTerms t, const float* __restrict__ counts,
                     const float* __restrict__ anti,
                     const float* __restrict__ match_tot,
                     const float* __restrict__ norms, int kb,
                     const int* __restrict__ topi,
                     const float* __restrict__ topv,
                     float* __restrict__ terms_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)q.P * kb) return;
  const int p = (int)(i / kb);
  float* out = terms_out + i * 6;
  if (!(topv[i] > -INFINITY)) {
    for (int k = 0; k < 6; ++k) out[k] = 0.0f;
    return;
  }
  const int n = topi[i];
  const bool pair = t.S > 0;
  const float* o = norms + (long long)p * (6 + 2 * t.C);
  const Norms nm{o[0], o[1], o[2], o[3], o[4], o[5]};
  float pen = 0.0f, raw = 0.0f;
  if (pair) {
    tpusched::pair_node(t, counts, anti, match_tot, p, n, o + 6,
                        o + 6 + t.C, &pen, &raw);
  }
  ResW w;
  tpusched::load_resw(w, q.rw, q.R);
  float rq[MAX_R];
  for (int r = 0; r < q.R; ++r) rq[r] = q.req[(long long)p * q.R + r];
  float tm[6];
  cell_terms(q, w, rq, p, n, nm, pair, pen, raw, tm);
  for (int k = 0; k < 6; ++k) out[k] = tm[k];
}

Probe make_probe(int P, int N, int R, int TN, int VT, const float* alloc,
                 const float* used, const float* req, const float* rw,
                 const bool* pod_valid, const bool* node_valid,
                 const bool* schedulable, const bool* tolerates_unsched,
                 const int* taint_ids, const signed char* taint_effect,
                 const bool* tolerated, const bool* aff_ok,
                 const float* na_raw, const float* tt_count,
                 const float* w_lr, const float* w_ba, const float* w_na,
                 const float* w_tt, const float* w_ts, const float* w_ia) {
  return Probe{P,        N,          R,         TN,           VT,
               alloc,    used,       req,       rw,           pod_valid,
               node_valid, schedulable, tolerates_unsched, taint_ids,
               taint_effect, tolerated, aff_ok, na_raw,   tt_count,
               w_lr,     w_ba,       w_na,      w_tt,         w_ts,
               w_ia};
}

}  // namespace

#define PROBE_PARAMS                                                        \
  int R, int TN, int VT, const float *alloc, const float *used,            \
      const float *req, const float *rw, const bool *pod_valid,            \
      const bool *node_valid2, const bool *schedulable,                    \
      const bool *tolerates_unsched, const int *taint_ids,                 \
      const signed char *taint_effect, const bool *tolerated,              \
      const bool *aff_ok2, const float *na_raw, const float *tt_count,     \
      const float *w_lr, const float *w_ba, const float *w_na,             \
      const float *w_tt, const float *w_ts, const float *w_ia
#define PROBE_ARGS                                                          \
  P, N, R, TN, VT, alloc, used, req, rw, pod_valid, node_valid2,           \
      schedulable, tolerates_unsched, taint_ids, taint_effect, tolerated,  \
      aff_ok2, na_raw, tt_count, w_lr, w_ba, w_na, w_tt, w_ts, w_ia

extern "C" int tpusched_explain_cells(
    int P, int N, int S, int C, int IT, int M, const int* dom,
    const bool* match, const bool* node_valid, const bool* aff_ok,
    const int* ts_sig, const bool* ts_valid, const signed char* ts_when,
    const float* ts_max_skew, const int* ia_sig, const bool* ia_valid,
    const bool* ia_anti, const bool* ia_required, const float* ia_weight,
    const float* counts, const float* anti, const float* match_tot,
    PROBE_PARAMS, int* tallies, int* feasible, float* masked, float* norms,
    void* stream) {
  if (R > MAX_R || C > tpusched::MAX_C) return (int)cudaErrorInvalidValue;
  PairTerms t{N,      S,        C,         IT,          M + P,      M,
              dom,    match,    node_valid, aff_ok,     ts_sig,     ts_valid,
              ts_when, ts_max_skew, ia_sig, ia_valid,   ia_anti,
              ia_required, ia_weight};
  Probe q = make_probe(PROBE_ARGS);
  explain_cells_kernel<<<P, THREADS, 0, (cudaStream_t)stream>>>(
      q, t, counts, anti, match_tot, tallies, feasible, masked, norms);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_explain_terms(
    int P, int N, int S, int C, int IT, int M, const int* dom,
    const bool* match, const bool* node_valid, const bool* aff_ok,
    const int* ts_sig, const bool* ts_valid, const signed char* ts_when,
    const float* ts_max_skew, const int* ia_sig, const bool* ia_valid,
    const bool* ia_anti, const bool* ia_required, const float* ia_weight,
    const float* counts, const float* anti, const float* match_tot,
    PROBE_PARAMS, const float* norms, int kb, const int* topi,
    const float* topv, float* terms, void* stream) {
  if (R > MAX_R || C > tpusched::MAX_C) return (int)cudaErrorInvalidValue;
  PairTerms t{N,      S,        C,         IT,          M + P,      M,
              dom,    match,    node_valid, aff_ok,     ts_sig,     ts_valid,
              ts_when, ts_max_skew, ia_sig, ia_valid,   ia_anti,
              ia_required, ia_weight};
  Probe q = make_probe(PROBE_ARGS);
  const long long cells = (long long)P * kb;
  explain_terms_kernel<<<(unsigned)((cells + THREADS - 1) / THREADS), THREADS,
                         0, (cudaStream_t)stream>>>(
      q, t, counts, anti, match_tot, norms, kb, topi, topv, terms);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_shape_limits(int* out) {
  out[0] = MAX_R;
  out[1] = tpusched::MAX_C;
  return 0;
}
