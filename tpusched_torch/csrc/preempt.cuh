// K15: one preemptor's victim search, as a device function for one CTA of
// PRE_THREADS threads. Replaces tpusched/kernels/preempt.py:232 _tableau
// and :317 preempt_step; K4's preemption variant (scan.cu) calls it for
// each pod that fails Filter, and preempt.cu's standalone entry point for
// one pod.
//
// The victims (running pods) come sorted by (node, eviction cost), so a
// node's victims form one segment [seg_start, ...] of the order. For the
// preemptor's priority, requests, allowed nodes and the current usage:
//   elig[i]   = node_s[i] < N && !evicted[perm[i]]
//               && vprio_s[i] + margin < p_prio      (f32 add, then compare)
//   viol[i]   = elig && pdb >= 0 && (# eligible victims of the same budget
//               in [seg_start[i], i]) > remaining[pdb]
//   within    = the eligible victims' requests (R columns), cost and
//               violations summed from the segment's start to i
//   fits[i]   = elig && forall r: (used[n] - within_req) + p_req <= alloc[n]
// and the pick is the lexicographic minimum of (within_viol, within_cost,
// position) over the fitting victims on allowed, valid nodes. That is
// JAX's two-stage selection (per node the fewest violations then the
// least cost; across nodes the fewest violations, then the least cost,
// ties to the lowest node; in the node the first position with both
// minima), since the order is sorted by node: no [N] scratch is needed.
// No fitting prefix: best position -1 (JAX: node 0, can = false).
//
// The f32 sums restart at each segment, in a fixed order that the plain
// version (kernels/preempt.segment_prefix) repeats:
//  * thread t owns the contiguous chunk [t*c, (t+1)*c) of the victims,
//    c = ceil(M / PRE_THREADS), and sums it in order from 0.0f, again
//    from 0.0f at each segment start;
//  * the chunk tails go through a segmented Hillis-Steele scan in shared
//    memory (step d: a chunk without a segment start adds the tail d
//    back, d = 1, 2, ..., 512);
//  * the elements before a chunk's first segment start add the carry of
//    the chunks before (0 for chunk 0).
// A victim's sum then holds its own segment's rounding only. JAX's and
// the oracle's association (a prefix over all M victims, minus its value
// at seg_start - 1) cancels a sum that reaches ~1e14 bytes at config 5's
// full size, an error of ~1e7 bytes a term: a pod could then land on a
// node its victims do not free enough for, and near-equal costs rank by
// the order of adds (ROADMAP C5). The capacity freed on the chosen node
// is the chosen victim's within_req itself, the value the fit was tested
// with, so `(used - freed) + p_req <= alloc` holds after the update.
//  * The PDB counts are exact integers: a thread counts each budget's
//    eligible victims of a segment that starts in its chunk as it goes,
//    and walks the segment (O(segment), a handful at config 5's eight
//    running pods a node) for a victim whose segment began before.
//  * The violation counts take the same segmented scan, in integers.
//
// Bound: latency. Per preemptor: two passes over the [M] victims (40 a
// thread at M = 40960), ~33 bytes a victim (1.4 MB, 0.0004 ms at 3.35
// TB/s), and about 25 block-wide barriers (20 in the scan). One SM moves
// all of it, so the passes must be coalesced: the victim table and the
// scratch are stored thread-interleaved (Victims below); reading each
// thread's contiguous chunk in place would cost 32 sectors a warp load.
#pragma once

#include <limits.h>
#include <math.h>

#include "cell.cuh"

namespace tpusched {

constexpr int PRE_THREADS = 1024;
constexpr int PRE_WARPS = PRE_THREADS / 32;
constexpr int PRE_K = MAX_R + 1;  // prefix columns: R requests, then cost
constexpr int PRE_MAX_GP = 16;    // budgets counted per segment in a thread

// The sorted victim table (kernels/preempt.PreemptCtx) and K15's device
// scratch, in the thread-interleaved layout: victim i (in sorted order)
// sits at vat(i) = (i % chunk) * PRE_THREADS + i / chunk of arrays padded
// to Mp = chunk * PRE_THREADS, so that when every thread takes the j-th
// victim of its contiguous chunk the warp's loads are consecutive
// (coalesced). [.., R] columns are stored column by column, [R][Mp].
struct Victims {
  int M, N, R, GP, chunk;  // chunk = ceil(M / PRE_THREADS)
  const int* perm;       // [Mp] sorted position -> running pod
  const int* node_s;     // [Mp] node of the sorted victim (N: none)
  const int* seg_start;  // [Mp]
  const float* cost_s;   // [Mp]
  const float* vprio_s;  // [Mp]
  const float* req_s;    // [R][Mp]
  const int* pdb_s;      // [Mp] budget (-1: none)
  float margin;
  unsigned char* elig;   // [Mp] scratch
  float* cum;            // [R + 1][Mp] scratch: segment sums (requests, cost)
  int* cum_viol;         // [Mp] scratch: segment sums of violations
};

__device__ __forceinline__ long long vat(const Victims& v, int i) {
  return (long long)(i % v.chunk) * PRE_THREADS + i / v.chunk;
}

struct PreemptSmem {
  float tot[PRE_K][PRE_THREADS];
  int vtot[PRE_THREADS];
  unsigned char starts[PRE_THREADS];  // a segment starts in the chunk
  int w_viol[PRE_WARPS];
  float w_cost[PRE_WARPS];
  int w_pos[PRE_WARPS];
  int best_pos;
};

__device__ __forceinline__ bool lex_less(int v1, float c1, int p1, int v2,
                                         float c2, int p2) {
  if (v1 != v2) return v1 < v2;
  if (c1 != c2) return c1 < c2;
  return p1 < p2;
}

__device__ __forceinline__ void lex_shfl(int& v, float& c, int& p) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, v, off);
    const float oc = __shfl_down_sync(0xffffffffu, c, off);
    const int op = __shfl_down_sync(0xffffffffu, p, off);
    if (lex_less(ov, oc, op, v, c, p)) {
      v = ov;
      c = oc;
      p = op;
    }
  }
}

// Eligibility of the victim at a (K15's layout): on a node, not evicted,
// of lower effective priority than the preemptor by the margin. The
// victim table is read-only (__ldg); `evicted` changes during a scan.
__device__ __forceinline__ bool elig_at(const Victims& v, long long a,
                                        const unsigned char* evicted,
                                        float p_prio) {
  return __ldg(v.node_s + a) < v.N && !evicted[__ldg(v.perm + a)] &&
         __ldg(v.vprio_s + a) + v.margin < p_prio;
}

// The search; every thread of the CTA calls it and gets the chosen
// prefix's last position (-1: none). allowed [N]: the pod's static (and
// pairwise) feasibility before any eviction. used/alloc: [N, R], shared
// or device memory. remaining [GP]: each budget's disruptions left.
// Thread t's victims are i = t * chunk + j for j < chunk (and i < M), at
// j * PRE_THREADS + t.
__device__ __forceinline__ int preempt_search(
    const Victims& v, PreemptSmem& sh, float p_prio, const float* rq,
    const unsigned char* allowed, const bool* node_valid, const float* used,
    const float* alloc, const unsigned char* evicted,
    const float* remaining) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = v.M, R = v.R, K = R + 1;
  const long long Mp = (long long)v.chunk * PRE_THREADS;
  const int lo = min(tid * v.chunk, M);
  const int cnt = min(lo + v.chunk, M) - lo;
  // Same-budget counts of the segment that started in this chunk; a
  // victim before the chunk's first segment start (its segment began in
  // an earlier chunk), or any victim when budgets exceed PRE_MAX_GP,
  // walks its segment instead.
  const bool counted = v.GP <= PRE_MAX_GP;
  int per_gp[PRE_MAX_GP];

  // Eligibility, violations and the chunk's running sums, restarting at
  // segment starts (carries from earlier chunks later).
  float acc[PRE_K];
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  int vacc = 0;
  int first = cnt;  // the chunk's first segment start (j)
#pragma unroll 4
  for (int j = 0; j < cnt; ++j) {
    const int i = lo + j;
    const long long a = (long long)j * PRE_THREADS + tid;
    const bool e = elig_at(v, a, evicted, p_prio);
    v.elig[a] = e;
    const int g = __ldg(v.pdb_s + a);
    const int s0 = __ldg(v.seg_start + a);
    if (s0 == i) {
      if (first == cnt) first = j;
      for (int k = 0; k < K; ++k) acc[k] = 0.0f;
      vacc = 0;
      if (counted)
        for (int q = 0; q < v.GP; ++q) per_gp[q] = 0;
    }
    if (e && g >= 0) {
      int same = 0;
      if (counted && j >= first) {
        same = ++per_gp[g];
      } else {
        for (int q = s0; q <= i; ++q) {
          const long long b = vat(v, q);
          same += __ldg(v.pdb_s + b) == g && elig_at(v, b, evicted, p_prio);
        }
      }
      vacc += (float)same > remaining[g];
    }
    for (int r = 0; r < R; ++r) {
      acc[r] = acc[r] + (e ? __ldg(v.req_s + r * Mp + a) : 0.0f);
      v.cum[r * Mp + a] = acc[r];
    }
    acc[R] = acc[R] + (e ? __ldg(v.cost_s + a) : 0.0f);
    v.cum[R * Mp + a] = acc[R];
    v.cum_viol[a] = vacc;
  }
  for (int k = 0; k < K; ++k) sh.tot[k][tid] = acc[k];
  sh.vtot[tid] = vacc;
  sh.starts[tid] = first < cnt;
  __syncthreads();
  for (int d = 1; d < PRE_THREADS; d <<= 1) {
    const bool add = tid >= d;
    const bool own = sh.starts[tid];
    const bool join = add && !own;
    float t[PRE_K];
    for (int k = 0; k < K; ++k)
      t[k] = join ? sh.tot[k][tid - d] + sh.tot[k][tid] : sh.tot[k][tid];
    const int tv = join ? sh.vtot[tid - d] + sh.vtot[tid] : sh.vtot[tid];
    const bool ts = add ? sh.starts[tid - d] || own : own;
    __syncthreads();
    for (int k = 0; k < K; ++k) sh.tot[k][tid] = t[k];
    sh.vtot[tid] = tv;
    sh.starts[tid] = ts;
    __syncthreads();
  }
  // The victims before the chunk's first segment start continue a
  // segment from earlier chunks: add its carry.
  if (first > 0 && tid > 0) {
    for (int j = 0; j < first; ++j) {
      const long long a = (long long)j * PRE_THREADS + tid;
      for (int k = 0; k < K; ++k)
        v.cum[k * Mp + a] = sh.tot[k][tid - 1] + v.cum[k * Mp + a];
      v.cum_viol[a] += sh.vtot[tid - 1];
    }
  }
  __syncthreads();

  // The fitting prefixes on allowed nodes; lexicographic minimum.
  int bv = INT_MAX, bp = INT_MAX;
  float bc = INFINITY;
#pragma unroll 4
  for (int j = 0; j < cnt; ++j) {
    const long long a = (long long)j * PRE_THREADS + tid;
    if (!v.elig[a]) continue;
    const int n = __ldg(v.node_s + a);
    if (!(allowed[n] && node_valid[n])) continue;
    bool fit = true;
    for (int r = 0; r < R; ++r) {
      const long long nr = (long long)n * R + r;
      fit = fit && (used[nr] - v.cum[r * Mp + a]) + rq[r] <= alloc[nr];
    }
    if (!fit) continue;
    const float wc = v.cum[R * Mp + a];
    const int wv = v.cum_viol[a];
    if (lex_less(wv, wc, lo + j, bv, bc, bp)) {
      bv = wv;
      bc = wc;
      bp = lo + j;
    }
  }
  lex_shfl(bv, bc, bp);
  if (lane == 0) {
    sh.w_viol[warp] = bv;
    sh.w_cost[warp] = bc;
    sh.w_pos[warp] = bp;
  }
  __syncthreads();
  if (warp == 0) {
    bv = sh.w_viol[lane];
    bc = sh.w_cost[lane];
    bp = sh.w_pos[lane];
    lex_shfl(bv, bc, bp);
    if (lane == 0) sh.best_pos = bp == INT_MAX ? -1 : bp;
  }
  __syncthreads();
  return sh.best_pos;
}

// One thread, after a search that found best position bp >= 0: the
// eligible victims of its segment up to bp, in sorted order;
// on_victim(m, budget) is called for each (running pod m). freed gets
// bp's segment sums of their requests (the caller subtracts the row from
// the node's usage in one step, as JAX subtracts its `freed` row).
// Returns bp's node.
template <typename F>
__device__ int preempt_take(const Victims& v, int bp, float* freed,
                            F&& on_victim) {
  const long long Mp = (long long)v.chunk * PRE_THREADS;
  const long long b = vat(v, bp);
  for (int r = 0; r < v.R; ++r) freed[r] = v.cum[r * Mp + b];
  for (int i = v.seg_start[b]; i <= bp; ++i) {
    const long long a = vat(v, i);
    if (v.elig[a]) on_victim(v.perm[a], v.pdb_s[a]);
  }
  return v.node_s[b];
}

}  // namespace tpusched
