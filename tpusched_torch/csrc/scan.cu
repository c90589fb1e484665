// K4: the parity scan, one persistent CTA.
//
// Replaces tpusched/kernels/assign.py:426 solve_sequential (its lax.scan
// over pods with pod_cycle :311 and pick_node :365, filter.resource_fit,
// score.least_requested and score.balanced_allocation inside) for
// snapshots without signatures, gangs or preemption. With no signature
// the spread and inter-pod normalisers are the constants 100 and 0, so
// the score of pod p on node n is, in assign.py:324-330's association,
//   ((((w_lr*LR + w_ba*BA) + static[p,n]) + w_ts*100) + w_ia*0).
//
// Bound: latency, not bytes. Pod i+1 scores against the `used` that pod
// i's commit left, so the P pods form a chain of P dependent block-wide
// argmaxes; the bytes (mask + static rows, 5 bytes a cell, 0.26 GB at
// 10240 x 5120) would take 0.08 ms at 3.35 TB/s. The design keeps the
// whole chain inside one CTA of 1024 threads: no launch or grid-wide
// barrier per pod, `used` and `alloc` in shared memory when 2*N*R floats
// fit (123 KB at N = 5120, R = 3), each thread owning a contiguous chunk
// of nodes so that "lowest index among the maxima" and the seeded
// tie rank are chunk-local scans plus one block combine. Spreading one
// pod's nodes over a thread-block cluster (DSMEM) is a later step.
#include <math.h>
#include <limits.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_R = 8;
constexpr int SMEM_LIMIT = 220 * 1024;

__device__ __forceinline__ unsigned tie_hash(unsigned seed, unsigned p) {
  unsigned x = seed * 2654435761u + p * 2246822519u;
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  return x;
}

// (v1, i1) beats (v2, i2): larger score, then lower node index.
__device__ __forceinline__ bool beats(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

struct PodCtx {
  float rq[MAX_R];
  float w_lr, w_ba, w_ts, w_ia;
  const bool* mask;
  const float* st;
};

// Feasibility and score of one (pod, node) cell; returns false when the
// node is infeasible (static mask or resource fit).
__device__ __forceinline__ bool cell(const PodCtx& c, int n, int R,
                                     const float* used, const float* alloc,
                                     const float* rw, const float* sel,
                                     float wsum, float k, float* out) {
  if (!c.mask[n]) return false;
  const float* u = used + (long long)n * R;
  const float* a = alloc + (long long)n * R;
  for (int r = 0; r < R; ++r)
    if (!(u[r] + c.rq[r] <= a[r])) return false;
  // least_requested: sum_r w_r * max((alloc-used-req)*100/alloc, 0) / wsum
  float lr = 0.0f;
  for (int r = 0; r < R; ++r) {
    float free_r = (a[r] - u[r]) - c.rq[r];
    float pr = a[r] > 0.0f ? free_r * 100.0f / a[r] : 0.0f;
    pr = pr < 0.0f ? 0.0f : pr;
    lr = lr + pr * rw[r];
  }
  lr = lr / wsum;
  // balanced_allocation: (1 - stddev of the selected fractions) * 100
  float frac[MAX_R];
  float mean = 0.0f;
  for (int r = 0; r < R; ++r) {
    float f = a[r] > 0.0f ? (u[r] + c.rq[r]) / a[r] : 1.0f;
    f = fminf(fmaxf(f, 0.0f), 1.0f);
    frac[r] = f;
    mean = mean + f * sel[r];
  }
  mean = mean / k;
  float var = 0.0f;
  for (int r = 0; r < R; ++r) {
    float d = frac[r] - mean;
    var = var + (d * d) * sel[r];
  }
  var = var / k;
  float ba = (1.0f - sqrtf(var)) * 100.0f;
  float s = c.w_lr * lr + c.w_ba * ba;
  s = s + c.st[n];
  s = s + c.w_ts * 100.0f;
  s = s + c.w_ia * 0.0f;
  *out = s;
  return true;
}

__global__ void __launch_bounds__(THREADS)
parity_scan_kernel(int P, int N, int R, const int* __restrict__ order,
                   const bool* __restrict__ mask,
                   const float* __restrict__ static_score,
                   const float* __restrict__ alloc_g,
                   const float* __restrict__ requests,
                   const float* __restrict__ w_lr,
                   const float* __restrict__ w_ba,
                   const float* __restrict__ w_ts,
                   const float* __restrict__ w_ia,
                   const float* __restrict__ rw_g, int seeded,
                   unsigned seed, float* used_g, int* __restrict__ assigned,
                   float* __restrict__ chosen, int use_smem) {
  extern __shared__ float smem[];
  __shared__ float s_val[WARPS];
  __shared__ int s_idx[WARPS];
  __shared__ int s_cnt[WARPS];
  __shared__ float s_best;
  __shared__ int s_pick;
  __shared__ int s_total;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* used = used_g;
  const float* alloc = alloc_g;
  if (use_smem) {
    float* su = smem;
    float* sa = smem + (long long)N * R;
    for (int i = tid; i < N * R; i += THREADS) {
      su[i] = used_g[i];
      sa[i] = alloc_g[i];
    }
    used = su;
    alloc = sa;
  }
  float rw[MAX_R], sel[MAX_R];
  float wsum = 0.0f, k = 0.0f;
  for (int r = 0; r < R; ++r) {
    rw[r] = rw_g[r];
    sel[r] = rw[r] > 0.0f ? 1.0f : 0.0f;
    wsum = wsum + rw[r];
    k = k + sel[r];
  }
  wsum = fmaxf(wsum, 1e-9f);
  k = fmaxf(k, 1.0f);
  const int chunk = (N + THREADS - 1) / THREADS;
  const int lo = min(tid * chunk, N), hi = min(lo + chunk, N);
  __syncthreads();

  for (int i = 0; i < P; ++i) {
    const int p = order[i];
    PodCtx c;
    for (int r = 0; r < R; ++r) c.rq[r] = requests[(long long)p * R + r];
    c.w_lr = w_lr[p];
    c.w_ba = w_ba[p];
    c.w_ts = w_ts[p];
    c.w_ia = w_ia[p];
    c.mask = mask + (long long)p * N;
    c.st = static_score + (long long)p * N;

    // Chunk-local best: the first feasible node, then strictly greater.
    float best = -INFINITY;
    int bidx = INT_MAX;
    for (int n = lo; n < hi; ++n) {
      float s;
      if (cell(c, n, R, used, alloc, rw, sel, wsum, k, &s) &&
          (bidx == INT_MAX || s > best)) {
        best = s;
        bidx = n;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, best, off);
      int oi = __shfl_down_sync(0xffffffffu, bidx, off);
      if (beats(ov, oi, best, bidx)) {
        best = ov;
        bidx = oi;
      }
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = bidx;
    }
    __syncthreads();
    if (warp == 0) {
      best = s_val[lane];
      bidx = s_idx[lane];
      for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_down_sync(0xffffffffu, best, off);
        int oi = __shfl_down_sync(0xffffffffu, bidx, off);
        if (beats(ov, oi, best, bidx)) {
          best = ov;
          bidx = oi;
        }
      }
      if (lane == 0) {
        s_best = best;
        s_pick = bidx;
      }
    }
    __syncthreads();
    const float mx = s_best;
    const bool found = s_pick != INT_MAX;

    if (seeded && found) {
      // The h-th tie in node order, h = tie_hash(seed, p) % #ties: count
      // the chunk's ties, exclusive-scan the counts, and let the thread
      // whose range holds h walk its chunk to it.
      int cnt = 0;
      for (int n = lo; n < hi; ++n) {
        float s;
        if (cell(c, n, R, used, alloc, rw, sel, wsum, k, &s) && s == mx)
          ++cnt;
      }
      int incl = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      if (lane == 31) s_cnt[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        int w = s_cnt[lane];
        int wincl = w;
        for (int off = 1; off < 32; off <<= 1) {
          int o = __shfl_up_sync(0xffffffffu, wincl, off);
          if (lane >= off) wincl += o;
        }
        s_cnt[lane] = wincl - w;  // exclusive prefix over warps
        if (lane == 31) s_total = wincl;
      }
      __syncthreads();
      const int excl = s_cnt[warp] + incl - cnt;
      const unsigned total = (unsigned)max(s_total, 1);
      const int h = (int)(tie_hash(seed, (unsigned)p) % total);
      if (h >= excl && h < excl + cnt) {
        int want = h - excl;
        for (int n = lo; n < hi; ++n) {
          float s;
          if (cell(c, n, R, used, alloc, rw, sel, wsum, k, &s) && s == mx) {
            if (want == 0) {
              s_pick = n;
              break;
            }
            --want;
          }
        }
      }
      __syncthreads();
    }

    if (tid == 0) {
      if (found) {
        const int n = s_pick;
        for (int r = 0; r < R; ++r)
          used[(long long)n * R + r] = used[(long long)n * R + r] + c.rq[r];
        assigned[p] = n;
        chosen[p] = mx;
      } else {
        assigned[p] = -1;
        chosen[p] = -INFINITY;
      }
    }
    __syncthreads();
  }

  if (use_smem) {
    for (int i = tid; i < N * R; i += THREADS) used_g[i] = used[i];
  }
}

}  // namespace

extern "C" int tpusched_parity_scan(int P, int N, int R, const int* order,
                                    const bool* mask,
                                    const float* static_score,
                                    const float* alloc,
                                    const float* requests,
                                    const float* w_lr, const float* w_ba,
                                    const float* w_ts, const float* w_ia,
                                    const float* rw, int seeded,
                                    unsigned int seed, float* used,
                                    int* assigned, float* chosen,
                                    void* stream) {
  if (R > MAX_R) return (int)cudaErrorInvalidValue;
  long long bytes = 2LL * N * R * (long long)sizeof(float);
  int use_smem = bytes <= SMEM_LIMIT ? 1 : 0;
  size_t dyn = use_smem ? (size_t)bytes : 0;
  if (dyn > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        parity_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  parity_scan_kernel<<<1, THREADS, dyn, (cudaStream_t)stream>>>(
      P, N, R, order, mask, static_score, alloc, requests, w_lr, w_ba, w_ts,
      w_ia, rw, seeded, seed, used, assigned, chosen, use_smem);
  return (int)cudaGetLastError();
}
