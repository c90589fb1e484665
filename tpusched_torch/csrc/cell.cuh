// The arithmetic of one (pod, node) cell against the dynamic node state,
// shared by K4 (scan.cu) and K5 (cycle.cu) so both round exactly alike:
// filter.resource_fit, score.least_requested and
// score.balanced_allocation in the JAX op order (sums over R left to
// right from 0, `x*100/y` as a product then an IEEE divide; the build
// uses --fmad=false, so nothing is contracted into an FMA). Each loop
// over the resources runs to R (RES_LOOP). With RB = MAX_R (K4) it is
// unrolled to MAX_R and guarded by r < R, so the per-resource values stay
// in registers and the R divides of a cell overlap; with RB = R, the
// exact count as a template parameter (K5), it is unrolled to R and the
// guard folds away; with RB = 0 (K22) it stays rolled. The operations and
// their order are those of a loop to R each way.
#pragma once

#include <math.h>

namespace tpusched {

constexpr int MAX_R = 8;

// for (int r = 0; r < R; ++r): unrolled to RB (R <= RB) when RB > 0,
// not unrolled when RB = 0.
#define RES_LOOP(r, R)                                                     \
  _Pragma("unroll (RB > 0 ? RB : 1)") for (int r = 0;                      \
                                           r < (RB > 0 ? RB : (R)); ++r)   \
    if (RB == 0 || r < (R))

// Resource-weight constants of one solve: rw, the BalancedAllocation
// selector sel (rw > 0), wsum = max(sum rw, 1e-9) and k = max(sum sel, 1).
struct ResW {
  float rw[MAX_R];
  float sel[MAX_R];
  float wsum;
  float k;
};

template <int RB = 0>
__device__ __forceinline__ void load_resw(ResW& w, const float* rw, int R) {
  w.wsum = 0.0f;
  w.k = 0.0f;
  RES_LOOP(r, R) {
    w.rw[r] = rw[r];
    w.sel[r] = w.rw[r] > 0.0f ? 1.0f : 0.0f;
    w.wsum = w.wsum + w.rw[r];
    w.k = w.k + w.sel[r];
  }
  w.wsum = fmaxf(w.wsum, 1e-9f);
  w.k = fmaxf(w.k, 1.0f);
}

// NodeResourcesFit: forall r: used + req <= alloc.
template <int RB = 0>
__device__ __forceinline__ bool cell_fits(const float* u, const float* a,
                                          const float* rq, int R) {
  RES_LOOP(r, R)
    if (!(u[r] + rq[r] <= a[r])) return false;
  return true;
}

// score.least_requested of one cell:
// sum_r w_r * max((alloc-used-req)*100/alloc, 0) / wsum.
template <int RB = 0>
__device__ __forceinline__ float cell_lr(const float* u, const float* a,
                                         const float* rq, int R,
                                         const ResW& w) {
  float lr = 0.0f;
  RES_LOOP(r, R) {
    float free_r = (a[r] - u[r]) - rq[r];
    float pr = a[r] > 0.0f ? free_r * 100.0f / a[r] : 0.0f;
    pr = pr < 0.0f ? 0.0f : pr;
    lr = lr + pr * w.rw[r];
  }
  return lr / w.wsum;
}

// score.balanced_allocation of one cell: (1 - stddev of the selected
// fractions) * 100.
template <int RB = 0>
__device__ __forceinline__ float cell_ba(const float* u, const float* a,
                                         const float* rq, int R,
                                         const ResW& w) {
  float frac[MAX_R];
  float mean = 0.0f;
  RES_LOOP(r, R) {
    float f = a[r] > 0.0f ? (u[r] + rq[r]) / a[r] : 1.0f;
    f = fminf(fmaxf(f, 0.0f), 1.0f);
    frac[r] = f;
    mean = mean + f * w.sel[r];
  }
  mean = mean / w.k;
  float var = 0.0f;
  RES_LOOP(r, R) {
    float d = frac[r] - mean;
    var = var + (d * d) * w.sel[r];
  }
  var = var / w.k;
  return (1.0f - sqrtf(var)) * 100.0f;
}

// w_lr * LeastRequested + w_ba * BalancedAllocation, defined for every
// cell, feasible or not.
template <int RB = 0>
__device__ __forceinline__ float cell_dynamic(const float* u, const float* a,
                                              const float* rq, int R,
                                              const ResW& w, float w_lr,
                                              float w_ba) {
  return w_lr * cell_lr<RB>(u, a, rq, R, w) +
         w_ba * cell_ba<RB>(u, a, rq, R, w);
}

// The no-signature cell score in batched_cycle's association:
// ((w_lr*LR + w_ba*BA) + static) + w_ts*100.
template <int RB = 0>
__device__ __forceinline__ float cell_score(const float* u, const float* a,
                                            const float* rq, int R,
                                            const ResW& w, float w_lr,
                                            float w_ba, float st,
                                            float w_ts) {
  float s = cell_dynamic<RB>(u, a, rq, R, w, w_lr, w_ba);
  s = s + st;
  s = s + w_ts * 100.0f;
  return s;
}

// (v1, i1) ranks before (v2, i2): larger value, then lower index (the
// order of lax.top_k and of a stable descending sort).
__device__ __forceinline__ bool beats(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ unsigned tie_hash(unsigned seed, unsigned p) {
  unsigned x = seed * 2654435761u + p * 2246822519u;
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  return x;
}

}  // namespace tpusched
