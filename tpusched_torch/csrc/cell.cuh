// The arithmetic of one (pod, node) cell against the dynamic node state,
// shared by K4 (scan.cu) and K5 (cycle.cu) so both round exactly alike:
// filter.resource_fit, score.least_requested and
// score.balanced_allocation in the JAX op order (sums over R left to
// right from 0, `x*100/y` as a product then an IEEE divide; the build
// uses --fmad=false, so nothing is contracted into an FMA).
#pragma once

#include <math.h>

namespace tpusched {

constexpr int MAX_R = 8;

// Resource-weight constants of one solve: rw, the BalancedAllocation
// selector sel (rw > 0), wsum = max(sum rw, 1e-9) and k = max(sum sel, 1).
struct ResW {
  float rw[MAX_R];
  float sel[MAX_R];
  float wsum;
  float k;
};

__device__ __forceinline__ void load_resw(ResW& w, const float* rw, int R) {
  w.wsum = 0.0f;
  w.k = 0.0f;
  for (int r = 0; r < R; ++r) {
    w.rw[r] = rw[r];
    w.sel[r] = w.rw[r] > 0.0f ? 1.0f : 0.0f;
    w.wsum = w.wsum + w.rw[r];
    w.k = w.k + w.sel[r];
  }
  w.wsum = fmaxf(w.wsum, 1e-9f);
  w.k = fmaxf(w.k, 1.0f);
}

// NodeResourcesFit: forall r: used + req <= alloc.
__device__ __forceinline__ bool cell_fits(const float* u, const float* a,
                                          const float* rq, int R) {
  for (int r = 0; r < R; ++r)
    if (!(u[r] + rq[r] <= a[r])) return false;
  return true;
}

// w_lr * LeastRequested + w_ba * BalancedAllocation, defined for every
// cell, feasible or not.
__device__ __forceinline__ float cell_dynamic(const float* u, const float* a,
                                              const float* rq, int R,
                                              const ResW& w, float w_lr,
                                              float w_ba) {
  // least_requested: sum_r w_r * max((alloc-used-req)*100/alloc, 0) / wsum
  float lr = 0.0f;
  for (int r = 0; r < R; ++r) {
    float free_r = (a[r] - u[r]) - rq[r];
    float pr = a[r] > 0.0f ? free_r * 100.0f / a[r] : 0.0f;
    pr = pr < 0.0f ? 0.0f : pr;
    lr = lr + pr * w.rw[r];
  }
  lr = lr / w.wsum;
  // balanced_allocation: (1 - stddev of the selected fractions) * 100
  float frac[MAX_R];
  float mean = 0.0f;
  for (int r = 0; r < R; ++r) {
    float f = a[r] > 0.0f ? (u[r] + rq[r]) / a[r] : 1.0f;
    f = fminf(fmaxf(f, 0.0f), 1.0f);
    frac[r] = f;
    mean = mean + f * w.sel[r];
  }
  mean = mean / w.k;
  float var = 0.0f;
  for (int r = 0; r < R; ++r) {
    float d = frac[r] - mean;
    var = var + (d * d) * w.sel[r];
  }
  var = var / w.k;
  float ba = (1.0f - sqrtf(var)) * 100.0f;
  return w_lr * lr + w_ba * ba;
}

// The no-signature cell score in batched_cycle's association:
// ((w_lr*LR + w_ba*BA) + static) + w_ts*100.
__device__ __forceinline__ float cell_score(const float* u, const float* a,
                                            const float* rq, int R,
                                            const ResW& w, float w_lr,
                                            float w_ba, float st,
                                            float w_ts) {
  float s = cell_dynamic(u, a, rq, R, w, w_lr, w_ba);
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
