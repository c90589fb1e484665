// K15: one preemptor's victim search, as a device function for one CTA of
// PRE_THREADS threads. Replaces tpusched/kernels/preempt.py:232 _tableau
// and :317 preempt_step; K4's preemption variant (scan.cu) calls it for
// each pod that fails Filter, and preempt.cu's standalone entry point for
// one pod.
//
// The victims (running pods) come sorted by (node, eviction cost), so a
// node's victims form one segment of the order, positions off[n] ..
// off[n + 1] - 1. For the preemptor's priority, requests, allowed nodes
// and the current usage, victim j of node n (position i = off[n] + j):
//   elig[i]   = !evicted[perm[i]] && vprio_s[i] + margin < p_prio
//               (f32 add, then compare)
//   viol[i]   = elig && pdb >= 0 && (# eligible victims of the same budget
//               in the segment up to i) > remaining[pdb]
//   within    = the eligible victims' requests (R columns), cost and
//               violations summed from the segment's start to i
//   fits[i]   = elig && forall r: (used[n] - within_req) + p_req <= alloc[n]
// and the pick is the lexicographic minimum of (within_viol, within_cost,
// position) over the fitting victims on allowed, valid nodes. That is
// JAX's two-stage selection (per node the fewest violations then the
// least cost; across nodes the fewest violations, then the least cost,
// ties to the lowest node; in the node the first position with both
// minima), since position order is node order. No fitting prefix: best
// position -1 (JAX: node 0, can = false).
//
// The f32 sums restart at each segment, in blocks of PRE_BLOCK rows: a
// block is summed left to right from 0.0, the block totals are added
// left to right, and a prefix is the totals before its block plus its
// block's own sum (kernels/preempt.segment_prefix). The first block is a
// plain left-to-right sum from 0.0, the order of the auction's 16-long
// prefixes (vprefix); the blocks keep a long segment's error to a few
// dozen roundings where a left-to-right sum's grows with its length. A
// victim's sum holds its own segment's rounding only.
// JAX's and the oracle's association (a prefix over all M victims, minus
// its value at the segment's start) cancels a sum that reaches ~1e14
// bytes at config 5's full size, an error of ~1e7 bytes a term: a pod
// could then land on a node its victims do not free enough for, and
// near-equal costs rank by the order of adds (ROADMAP C5). The capacity
// freed on the chosen node is the chosen prefix's within_req itself, the
// value the fit was tested with, so `(used - freed) + p_req <= alloc`
// holds after the update.
//
// Design: node-major. Thread t takes nodes n = t, t + 1024, ...; a node
// that is not allowed or not valid is skipped before any victim is read.
// The thread walks the node's segment left to right and carries, in
// registers, the sums, the violation count and the PDB counts (up to
// PRE_SLOTS budgets a node; a victim of a further budget counts its
// segment again, exactly). Along a segment the fit, the violations and
// the cost only grow (the costs are shifted positive; f32 adds of
// non-negative terms never decrease a sum), so the first fitting prefix
// is the node's lexicographic minimum and ends the walk; so does a prefix
// that already ranks at or after the thread's best. One block reduction
// of (violations, cost, position, node) gives the pick: two barriers a
// search, no per-search scratch, no scan.
//
// Layout: the first V victims of every node lie in [V, N] planes (victim
// j of node n at j * N + n), so that a warp taking 32 consecutive nodes
// reads its j-th victims coalesced: one 16-byte load of (priority, cost,
// budget, running pod) and R request loads, issued together; victims
// past V (a node with a longer segment) are read in the sorted order
// itself (kernels/preempt.precompute builds both). The table is exact
// for any segment length. Eviction state is read in the sorted order
// (ev_s, which the take keeps beside the [M] evicted flags), so no load
// waits on another's result. The sums live in registers for R <= 4
// (PRE_R); more resources take a second instantiation that keeps them in
// local memory.
//
// Bound: latency. Per preemptor the bytes are the victims of the allowed
// nodes up to their first fit, ~(R + 4) * 4 bytes a victim (<= 1.1 MB at
// M = 40 960, 0.0003 ms at 3.35 TB/s); the walk is a chain of L2 loads,
// one round trip a victim, over ~5 nodes a thread at N = 5 120.
#pragma once

#include <limits.h>
#include <math.h>

#include "cell.cuh"

namespace tpusched {

constexpr int PRE_THREADS = 1024;
constexpr int PRE_WARPS = PRE_THREADS / 32;
constexpr int PRE_SLOTS = 4;   // budgets a node counted in registers
constexpr int PRE_R = 4;       // resources summed in registers (else MAX_R)
constexpr int PRE_BLOCK = 16;  // rows a block of the segment sums

// The victim table (kernels/preempt.PreemptCtx): the node offsets, the
// [V, N] planes and the sorted order.
struct Victims {
  int M, N, R, GP, V;
  float margin;
  const int* off;         // [N + 1] first position of each node's segment
  const int4* pl_vic;     // [V, N] (vprio, cost as f32 bits, pdb, perm)
  const float* pl_req;    // [R, V, N]
  const int* perm;        // [M] sorted position -> running pod
  const float* cost_s;    // [M]
  const float* vprio_s;   // [M]
  const float* req_s;     // [M, R]
  const int* pdb_s;       // [M] budget (-1: none)
};

// The eligible victims of budget g among the first j + 1 of the segment
// that starts at s (ev_s: evicted, in the sorted order).
static __device__ __noinline__ int same_budget(const Victims& v, int s,
                                               int j, int g, float p_prio,
                                               const unsigned char* ev_s) {
  int c = 0;
  for (int i = s; i <= s + j; ++i)
    c += __ldg(v.pdb_s + i) == g && !ev_s[i] &&
         __ldg(v.vprio_s + i) + v.margin < p_prio;
  return c;
}

struct PreemptSmem {
  int w_viol[PRE_WARPS];
  float w_cost[PRE_WARPS];
  int w_pos[PRE_WARPS];
  int w_node[PRE_WARPS];
  int best_pos, best_node;
};

__device__ __forceinline__ bool lex_less(int v1, float c1, int p1, int v2,
                                         float c2, int p2) {
  if (v1 != v2) return v1 < v2;
  if (c1 != c2) return c1 < c2;
  return p1 < p2;
}

__device__ __forceinline__ void lex_shfl(int& v, float& c, int& p, int& n) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, v, off);
    const float oc = __shfl_down_sync(0xffffffffu, c, off);
    const int op = __shfl_down_sync(0xffffffffu, p, off);
    const int on = __shfl_down_sync(0xffffffffu, n, off);
    if (lex_less(ov, oc, op, v, c, p)) {
      v = ov;
      c = oc;
      p = op;
      n = on;
    }
  }
}

// The eligible same-budget count of a victim of budget g >= 0, from the
// node's slots: (g << 16) | count, -1 when free. 0 when g has no slot
// and none is free (or a count would pass 16 bits): the caller counts
// the segment again.
__device__ __forceinline__ int slot_count(int (&slot)[PRE_SLOTS], int g) {
  if (g >= 0x7fff) return 0;
#pragma unroll
  for (int q = 0; q < PRE_SLOTS; ++q) {
    if (slot[q] >= 0 && (slot[q] >> 16) == g) {
      if ((slot[q] & 0xffff) == 0xffff) return 0;
      return (++slot[q]) & 0xffff;
    }
  }
#pragma unroll
  for (int q = 0; q < PRE_SLOTS; ++q) {
    if (slot[q] < 0) {
      slot[q] = (g << 16) | 1;
      return 1;
    }
  }
  return 0;
}

// Each thread's walk over its nodes: the lexicographic minimum (bv, bc,
// bp) of its fitting prefixes and bp's node bn. RR >= R: with RR = PRE_R
// the loops over the requests unroll and the sums stay in registers;
// with RR = MAX_R they run to R, the sums in local memory. One walk
// unrolled to MAX_R for every R (r < R guarding it) spilled more and ran
// parity (h) 31 % slower on an H100 (PERF.md).
template <int RR>
__device__ __forceinline__ void preempt_walk(
    const Victims& v, float p_prio, const float* rq,
    const unsigned char* allowed, const bool* node_valid, const float* used,
    const float* alloc, const unsigned char* ev_s, const float* remaining,
    int& bv, float& bc, int& bp, int& bn) {
  const int R = v.R, N = v.N, V = v.V;
  const int RB = RR == PRE_R ? RR : R;
  for (int n = threadIdx.x; n < N; n += PRE_THREADS) {
    const bool ok = allowed[n] && node_valid[n];
    const int s = __ldg(v.off + n);
    const int len = __ldg(v.off + n + 1) - s;
    if (!ok) continue;
    const float* u = used + (long long)n * R;
    const float* a = alloc + (long long)n * R;
    // A prefix is blk + run: blk the block totals, run the sum inside
    // the current PRE_BLOCK-row block.
    float blk[RR], run[RR];
#pragma unroll
    for (int r = 0; r < RB; ++r) blk[r] = run[r] = 0.0f;
    float blk_c = 0.0f, run_c = 0.0f;
    int viol = 0;
    int slot[PRE_SLOTS];
#pragma unroll
    for (int q = 0; q < PRE_SLOTS; ++q) slot[q] = -1;
    for (int j = 0; j < len; ++j) {
      const int i = s + j;
      float vp, vc;
      int g;
      float x[RR];
      if (j < V) {
        const long long c = (long long)j * N + n;
        const int4 q = __ldg(v.pl_vic + c);
        vp = __int_as_float(q.x);
        vc = __int_as_float(q.y);
        g = q.z;
#pragma unroll
        for (int r = 0; r < RB; ++r)
          x[r] = r < R ? __ldg(v.pl_req + (long long)r * V * N + c) : 0.0f;
      } else {
        vp = __ldg(v.vprio_s + i);
        vc = __ldg(v.cost_s + i);
        g = __ldg(v.pdb_s + i);
#pragma unroll
        for (int r = 0; r < RB; ++r)
          x[r] = r < R ? __ldg(v.req_s + (long long)i * R + r) : 0.0f;
      }
      if (!ev_s[i] && vp + v.margin < p_prio) {
        if (g >= 0) {
          int same = slot_count(slot, g);
          if (same == 0) same = same_budget(v, s, j, g, p_prio, ev_s);
          viol += (float)same > remaining[g];
        }
        bool fit = true;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < R) {
            run[r] = run[r] + x[r];
            fit = fit && (u[r] - (blk[r] + run[r])) + rq[r] <= a[r];
          }
        }
        run_c = run_c + vc;
        const float cost = blk_c + run_c;
        if (fit) {
          if (lex_less(viol, cost, i, bv, bc, bp)) {
            bv = viol;
            bc = cost;
            bp = i;
            bn = n;
          }
          break;
        }
        // Every later prefix of the node has as many violations and as
        // large a cost, at a later position.
        if (viol > bv || (viol == bv && cost >= bc)) break;
      }
      if ((j + 1) % PRE_BLOCK == 0) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          blk[r] = blk[r] + run[r];
          run[r] = 0.0f;
        }
        blk_c = blk_c + run_c;
        run_c = 0.0f;
      }
    }
  }
}

// The search; every thread of the CTA calls it. Returns the chosen
// prefix's last position (-1: none) and sets *node to its node. allowed
// [N]: the pod's static (and pairwise) feasibility before any eviction.
// used/alloc: [N, R], shared or device memory. ev_s [M]: the victims
// evicted so far, in the sorted order. remaining [GP]: each budget's
// disruptions left.
__device__ __forceinline__ int preempt_search(
    const Victims& v, PreemptSmem& sh, float p_prio, const float* rq,
    const unsigned char* allowed, const bool* node_valid, const float* used,
    const float* alloc, const unsigned char* ev_s, const float* remaining,
    int* node) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int bv = INT_MAX, bp = INT_MAX, bn = -1;
  float bc = INFINITY;
  if (v.R <= PRE_R)
    preempt_walk<PRE_R>(v, p_prio, rq, allowed, node_valid, used, alloc,
                        ev_s, remaining, bv, bc, bp, bn);
  else
    preempt_walk<MAX_R>(v, p_prio, rq, allowed, node_valid, used, alloc,
                        ev_s, remaining, bv, bc, bp, bn);
  lex_shfl(bv, bc, bp, bn);
  if (lane == 0) {
    sh.w_viol[warp] = bv;
    sh.w_cost[warp] = bc;
    sh.w_pos[warp] = bp;
    sh.w_node[warp] = bn;
  }
  __syncthreads();
  if (warp == 0) {
    bv = sh.w_viol[lane];
    bc = sh.w_cost[lane];
    bp = sh.w_pos[lane];
    bn = sh.w_node[lane];
    lex_shfl(bv, bc, bp, bn);
    if (lane == 0) {
      sh.best_pos = bp == INT_MAX ? -1 : bp;
      sh.best_node = bn;
    }
  }
  __syncthreads();
  *node = sh.best_node;
  return sh.best_pos;
}

// One thread, after a search that found position bp >= 0 on node n: the
// eligible victims of n's segment up to bp, in sorted order, are marked
// in ev_s, and on_victim(m, budget) is called for each (running pod m).
// freed gets their requests summed in the search's order, the search's
// sum at bp (the caller subtracts the row from the node's usage in one
// step, as JAX subtracts its `freed` row).
template <typename F>
__device__ void preempt_take(const Victims& v, int n, int bp, float p_prio,
                             unsigned char* ev_s, float* freed,
                             F&& on_victim) {
  float blk[MAX_R], run[MAX_R];
  for (int r = 0; r < v.R; ++r) blk[r] = run[r] = 0.0f;
  const int s = v.off[n];
  for (int i = s; i <= bp; ++i) {
    if (!ev_s[i] && v.vprio_s[i] + v.margin < p_prio) {
      for (int r = 0; r < v.R; ++r)
        run[r] = run[r] + v.req_s[(long long)i * v.R + r];
      ev_s[i] = 1;
      on_victim(v.perm[i], v.pdb_s[i]);
    }
    if ((i - s + 1) % PRE_BLOCK == 0) {
      for (int r = 0; r < v.R; ++r) {
        blk[r] = blk[r] + run[r];
        run[r] = 0.0f;
      }
    }
  }
  for (int r = 0; r < v.R; ++r) freed[r] = blk[r] + run[r];
}

}  // namespace tpusched
