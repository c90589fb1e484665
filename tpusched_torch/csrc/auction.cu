// K16-K18: the fast mode's batched preemption auction.
//
// Replaces tpusched/kernels/preempt.py:366 preempt_auction, which each
// preemption round (tpusched/kernels/assign.py:1215 _preempt_rounds) lets
// C bidders (C = 1024 at the headline) bid for victim prefixes on the
// node-major victim table (precompute_nv: per node its first V = 16
// victims by ascending eviction cost).
//
// K16 auction_tables (:488-545): per lane l and node n, one thread: the
// victims eligible at the lane's priority threshold (not evicted, vprio +
// margin < thr[l]; L = 2 quantile buckets + the optimistic lane at +inf),
// the V-long inclusive prefixes of their requests and cost (f32, summed
// from 0.0 left to right) and of their PDB violations (int32; a victim
// violates when the eligible same-budget victims at or before it on its
// node outnumber its budget's remaining disruptions, JAX's [V, V]
// triangular contraction as an integer count). Bound: bytes, the victim
// table read once per lane and the [L, N, V, R + 2] tables written.
//
// K17 (:486-562), two entry points:
//  * auction_ok, one CTA per bidder row: ok[c, n] = the bidder's static
//    mask row & its pairwise verdict & valid node & active bidder, and
//    whether any is set (the auction's thresholds need the active bidders
//    first);
//  * auction_rank: need = (used[n] + p_req[c]) - alloc[n]; in a lane, pos
//    = max over r of #{v : cum_req[l, n, v, r] < need[r]}, feas = need <=
//    cum_req[l, n, V - 1], and the cost and violations at min(pos, V - 1).
//    The bidder's bucket lane ranks unless no allowed node is feasible
//    there and one is in the optimistic lane; over the allowed feasible
//    nodes with the fewest violations bid = -cost (else -inf), the row K6
//    ranks. could[c] = any allowed node is feasible in the optimistic
//    lane. A cluster of Q CTAs (1-16) takes a tile of 32 bidders of one
//    tenant, taken in (bucket lane, index) order (a counting sort of the
//    tenant's lanes in each CTA), so that a tile's bidders mostly share
//    one bucket lane; CTA q takes every Q-th chunk of 64 nodes. For each
//    chunk the CTA copies in the lanes its bidders want, once for the
//    whole tile: K16's [L, N, V, R] layout keeps a chunk of one lane
//    contiguous, read in 32-word runs by cp.async into node rows padded to
//    an odd length (a warp's 32 nodes read one entry from 32 banks), the
//    next stage landing while this one is evaluated. A thread then serves
//    one node for 8 bidders: pos is a count of V compares a resource
//    (FSET.BF and FADD, no search), each table value read once for the 8.
//    Two passes: pass 1 evaluates the bucket lane and the optimistic lane
//    of each allowed cell, for the row's two any-flags and the fewest
//    violations in each lane, reduced over the warp, the CTA and the
//    cluster (DSMEM reads after a cluster barrier); the row's lane and
//    minimum follow without another read. Pass 2 evaluates the chosen
//    lane and writes each bid once, a warp's 32 nodes of a row
//    coalesced. Every step is a compare, a pick or an integer minimum:
//    the same bits in any order. Bound: bytes (ok read and bid written
//    once, the tables read once a tile and pass) or the compares that the
//    function needs (for each allowed cell two lane evaluations of R
//    binary searches over V values: 2 * R * ceil(log2(V + 1))), the
//    larger; at fast (h)'s first round that is bytes.
//
// K18 auction_claim (:564-679), one thread-block cluster of Q CTAs a
// tenant (Q from the wrapper's policy, kernels/preempt.claim_cluster_size),
// a warp a bidder: `iters` claim iterations deal each unclaimed bidder
// with an available candidate its (active-rank mod #available + 1)-th
// available candidate (active-rank: its place among the bidders that
// bid, in bidder order), and per node the lowest rank wins; then each
// bidder's exact validation on its claimed node. Layout: CTA q owns a
// contiguous range of bidders, a warp a run of them (bidder order is
// CTA, warp, slot order), and a lane K / 32 candidates of a bidder
// (k = i * 32 + lane, read once straight from K6's [C, K] rows, which
// coalesce for a warp; a warp's first two bidders stay in registers,
// the rest are read again each iteration). Each CTA keeps `taken` as an
// N-bit mask; `best` [N] is split by node range over the CTAs, two
// buffers that take turns. Per iteration: availability by a ballot a
// chunk of 32 candidates and popc; the active ranks by a scan of the
// warps' counts and the CTAs' totals exchanged by st.async into mbarrier
// slots (K4's exchange, csrc/cluster.cuh); the target-th available
// candidate by the ballots' counts and a bit find; atomicMin of the
// bidder's rank into the owner CTA's best through DSMEM; a cluster
// barrier; the winner test against the owner's best; each CTA sets the
// taken bit of every node whose best holds a rank (the winners' nodes)
// and resets its other buffer (the next iteration's records release the
// reset to the cluster before anyone's atomicMin). All integer work,
// exact in any order. Validation, a warp a bidder and lane v victim v:
// true-priority eligibility by ballot, lane v's V-long request prefix
// through v from 0.0 left to right, the first fitting prefix by ballot
// and bit find, the kept victims written by their lanes and the
// per-budget evictions as integer atomic adds; the freed capacity is the
// first fitting lane's prefix (the value the fit was tested with). The
// ranks must lie below INT_MAX (a node's best holds INT_MAX while no
// bidder wants it). Bound: latency (iters x (one exchange, one cluster
// barrier, the DSMEM atomics and reads)); the bytes ([C, K] candidates,
// the claimed rows of the victim table) take under a microsecond.
//
// Tenant axis (tpusched/tenants.py:75 solve_many, JAX's vmap of
// _preempt_rounds): each entry point takes B first and every array gains
// a leading [B] axis. K16 runs B * L * N threads, tenant b's cells
// reading its own victim table, evictions, lanes and budgets; K17 runs
// B * C rows (auction_ok) or B * ceil(C / 32) clusters (auction_rank),
// row b * C + c reading tenant b's mask rows (rows index its own [Pm,
// N]), lane tables, usage and capacity; K18 runs one cluster a
// tenant (grid B * Q, cluster b tenant b), offsetting every array to its
// tenant (b = 0 for one cluster).
#include <limits.h>
#include <math.h>

#include "cluster.cuh"
#include "kernels.h"

namespace {

using tpusched::cluster_ctas;
using tpusched::cluster_index;
using tpusched::cluster_rank;
using tpusched::mbar_expect;
using tpusched::mbar_init;
using tpusched::mbar_init_fence;
using tpusched::mbar_wait;
using tpusched::st_async;

constexpr int ROW_THREADS = 256;
constexpr int CLAIM_SMEM_LIMIT = 200 * 1024;
constexpr int MAXR = 8;

__global__ void __launch_bounds__(ROW_THREADS)
auction_tables_kernel(int B, int L, int N, int V, int R, int M, int GP,
                      const float* __restrict__ vreq,
                      const float* __restrict__ vcost,
                      const float* __restrict__ vprio,
                      const int* __restrict__ vpdb,
                      const bool* __restrict__ vvalid,
                      const int* __restrict__ vidx,
                      const bool* __restrict__ evicted,
                      const float* __restrict__ thr,
                      const float* __restrict__ remaining, float margin,
                      float* __restrict__ cum_req,
                      float* __restrict__ cum_cost,
                      int* __restrict__ cum_viol) {
  const long long i = (long long)blockIdx.x * ROW_THREADS + threadIdx.x;
  const long long LN = (long long)L * N;
  if (i >= B * LN) return;
  // Tenant b's cell (l, n): its victim table's node rows, evictions,
  // lanes and budgets.
  const long long b = i / LN;
  const int l = (int)((i % LN) / N), n = (int)(i % N);
  evicted += b * M;
  remaining += b * GP;
  const float th = thr[b * L + l];
  const long long row = (b * N + n) * V;
  unsigned elig = 0u;
  for (int v = 0; v < V; ++v) {
    const bool vv = vvalid[row + v];
    bool ev = false;
    if (vv && M > 0) ev = evicted[min(max(vidx[row + v], 0), M - 1)];
    if (vv && !ev && vprio[row + v] + margin < th) elig |= 1u << v;
  }
  float acc[MAXR];
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  float cost = 0.0f;
  int viol = 0;
  const long long out = ((b * L + l) * N + n) * V;
  for (int v = 0; v < V; ++v) {
    const bool el = (elig >> v) & 1u;
    for (int r = 0; r < R; ++r) {
      acc[r] = acc[r] + (el ? vreq[(row + v) * R + r] : 0.0f);
      cum_req[(out + v) * R + r] = acc[r];
    }
    cost = cost + (el ? vcost[row + v] : 0.0f);
    cum_cost[out + v] = cost;
    const int g = vpdb[row + v];
    if (GP > 0 && el && g >= 0) {
      int cnt = 0;
      for (int w = 0; w <= v; ++w)
        cnt += ((elig >> w) & 1u) && vpdb[row + w] == g;
      viol += (float)cnt > remaining[g];
    }
    cum_viol[out + v] = viol;
  }
}

__global__ void __launch_bounds__(ROW_THREADS)
auction_ok_kernel(int C, int N, int Pm, const bool* __restrict__ mask,
                  const int* __restrict__ rows,
                  const bool* __restrict__ pair_ok,
                  const bool* __restrict__ pre_active,
                  const bool* __restrict__ node_valid, bool* __restrict__ ok,
                  bool* __restrict__ any_ok) {
  // Row c of tenant b: its own mask rows and nodes.
  const long long b = blockIdx.x / C;
  const int c = blockIdx.x % C;
  node_valid += b * N;
  const long long src = (b * Pm + (rows ? rows[blockIdx.x] : c)) * N;
  const long long dst = (long long)blockIdx.x * N;
  const bool act = pre_active[blockIdx.x];
  bool any = false;
  for (int n = threadIdx.x; n < N; n += ROW_THREADS) {
    const bool o = act && mask[src + n] && node_valid[n] &&
                   (pair_ok == nullptr || pair_ok[dst + n]);
    ok[dst + n] = o;
    any |= o;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) any_ok[blockIdx.x] = any;
}

// K17's ranking: a cluster of Q CTAs takes a tile of RANK_TILE bidders of
// one tenant (the tenant's bidders ordered by bucket lane, so that a
// tile's bidders mostly share one), CTA q the node chunks q, q + Q, ...
// (RANK_NODES nodes a chunk). Thread t serves node t % RANK_NODES of a
// chunk for the RANK_BPT bidders of its group t / RANK_NODES, so a warp
// holds 32 nodes of one group's bidders: ok and bid stay coalesced, and
// the group's bidders share every table value a thread reads.
constexpr int RANK_THREADS = 256;
constexpr int RANK_NODES = 64;                    // nodes a chunk
constexpr int RANK_STRIDE = RANK_NODES + 1;       // used and alloc rows
constexpr int RANK_GROUPS = RANK_THREADS / RANK_NODES;
constexpr int RANK_BPT = 8;                       // bidders a thread
constexpr int RANK_TILE = RANK_GROUPS * RANK_BPT; // bidders a cluster
constexpr int RANK_WARPS = RANK_THREADS / 32;
constexpr int RANK_SORT_LANES = 4;  // lanes the bidder order packs
constexpr unsigned RANK_FULL = 0xffffffffu;

// One stage of the pipeline: one lane's tables for one chunk in shared
// memory, node by node as K16 writes them ([V, R] requests, then [V]
// costs and [V] violations a node), each node's rows an odd number of
// words apart so that a warp's 32 nodes read the same entry from 32
// banks; then the chunk's used and alloc as [R] rows of RANK_STRIDE. Two
// stages take turns.
__host__ __device__ constexpr int rank_req_stride(int V, int R) {
  return V * R + 1 - (V * R) % 2;
}

__host__ __device__ constexpr int rank_v_stride(int V) {
  return V + 1 - V % 2;
}

__host__ __device__ constexpr long long rank_stage_words(int V, int R) {
  return (long long)RANK_NODES * (rank_req_stride(V, R) + 2 * rank_v_stride(V))
         + 2LL * R * RANK_STRIDE;
}

__host__ __device__ constexpr long long rank_smem_bytes(int V, int R) {
  return 2 * rank_stage_words(V, R) * 4;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// w / d for 0 <= w < 2^22 and 1 <= d <= 256, by the reciprocal `inv` =
// 1.0f / d: (w + 0.5) / d stays at least 1 / 512 from an integer, far
// beyond the product's rounding.
__device__ __forceinline__ int rank_div(int w, float inv) {
  return __float2int_rz(((float)w + 0.5f) * inv);
}

// Start copying lane l's tables of nodes [n0, n0 + nn), and their used
// and alloc, into stage buffer `buf` (cp.async, landing while the other
// stage is evaluated). Each table's chunk is contiguous in global memory
// and is read in 32-word runs, one run a warp instruction; a word lands
// in its node's padded row.
__device__ __forceinline__ void rank_stage(
    int l, int n0, int nn, int N, int V, int R, float inv_vr, float inv_v,
    float inv_r, const float* __restrict__ cum_req,
    const float* __restrict__ cum_cost, const int* __restrict__ cum_viol,
    const float* __restrict__ used, const float* __restrict__ alloc,
    float* buf) {
  const int VR = V * R, sr = rank_req_stride(V, R), sv = rank_v_stride(V);
  const long long base = (long long)l * N + n0;
  const float* gr = cum_req + base * VR;
  const float* gc = cum_cost + base * V;
  const int* gv = cum_viol + base * V;
  float* s_cost = buf + RANK_NODES * sr;
  float* s_viol = s_cost + RANK_NODES * sv;
  float* s_used = s_viol + RANK_NODES * sv;
  float* s_alloc = s_used + R * RANK_STRIDE;
  for (int w = threadIdx.x; w < nn * VR; w += RANK_THREADS) {
    const int n = rank_div(w, inv_vr);
    cp_async4(buf + n * sr + (w - n * VR), gr + w);
  }
  for (int w = threadIdx.x; w < nn * V; w += RANK_THREADS) {
    const int n = rank_div(w, inv_v), v = w - n * V;
    cp_async4(s_cost + n * sv + v, gc + w);
    cp_async4(s_viol + n * sv + v, gv + w);
  }
  for (int w = threadIdx.x; w < nn * R; w += RANK_THREADS) {
    const int n = rank_div(w, inv_r), r = w - n * R;
    cp_async4(s_used + r * RANK_STRIDE + n, used + (long long)n0 * R + w);
    cp_async4(s_alloc + r * RANK_STRIDE + n, alloc + (long long)n0 * R + w);
  }
}

// 1.0f where a < b, else 0.0f (false for NaN, as `<` is): one FSET.BF,
// so that a count of compares is an FSET and an FADD a value, both on the
// FP32 pipe (the count, at most 32, is exact in f32).
__device__ __forceinline__ float lt_one(float a, float b) {
  float d;
  asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// One staged lane at a thread's node for its RANK_BPT bidders.
struct RankEval {
  int pos[RANK_BPT];  // max over r of #{v : cum_req[v, r] < need[r]}
  unsigned feas;      // bit i: need_i <= cum_req[V - 1] in every resource
};

// The staged lane `buf` at this thread's node j for its RANK_BPT bidders
// (the plain version's count, a compare a table value, no search). Each
// table value is read once from shared memory for all the thread's
// bidders.
__device__ __forceinline__ RankEval rank_eval(int j, int V, int R,
                                              const float* buf,
                                              const float* preq) {
  const int sr = rank_req_stride(V, R), sv = rank_v_stride(V);
  const float* s_used = buf + RANK_NODES * (sr + 2 * sv);
  const float* s_alloc = s_used + R * RANK_STRIDE;
  const float* row = buf + j * sr;
  RankEval e;
  e.feas = (1u << RANK_BPT) - 1u;
#pragma unroll
  for (int i = 0; i < RANK_BPT; ++i) e.pos[i] = 0;
  for (int r = 0; r < R; ++r) {
    const float u = s_used[r * RANK_STRIDE + j];
    const float a = s_alloc[r * RANK_STRIDE + j];
    float need[RANK_BPT], cnt[RANK_BPT];
#pragma unroll
    for (int i = 0; i < RANK_BPT; ++i) {
      need[i] = (u + preq[i * MAXR + r]) - a;
      cnt[i] = 0.0f;
    }
    const float* col = row + r;
#pragma unroll 4
    for (int v = 0; v < V; ++v) {
      const float x = col[v * R];
#pragma unroll
      for (int i = 0; i < RANK_BPT; ++i) cnt[i] += lt_one(x, need[i]);
    }
    const float last = col[(V - 1) * R];
#pragma unroll
    for (int i = 0; i < RANK_BPT; ++i) {
      e.pos[i] = max(e.pos[i], (int)cnt[i]);
      if (!(need[i] <= last)) e.feas &= ~(1u << i);
    }
  }
  return e;
}

__global__ void __launch_bounds__(RANK_THREADS)
auction_rank_kernel(int C, int L, int N, int V, int R,
                    const float* __restrict__ cum_req,
                    const float* __restrict__ cum_cost,
                    const int* __restrict__ cum_viol,
                    const int* __restrict__ lane, const bool* __restrict__ ok,
                    const float* __restrict__ used,
                    const float* __restrict__ alloc,
                    const float* __restrict__ p_req, float* __restrict__ bid,
                    bool* __restrict__ could) {
  extern __shared__ float rank_smem[];
  const long long sw = rank_stage_words(V, R);
  // Per slot: its bidder row c (-1 past C), requests, lanes and minimum.
  __shared__ int s_row[RANK_TILE];
  __shared__ float s_preq[RANK_TILE * MAXR];
  __shared__ int s_lane[RANK_TILE];   // the bucket lane; -1 past C
  __shared__ int s_pick[RANK_TILE];   // the lane that ranks; -1 past C
  __shared__ int s_mv[RANK_TILE];     // the fewest violations there
  __shared__ int s_wl[RANK_TILE + 1];  // a pass's wanted lanes, ascending
  __shared__ int s_nw;
  __shared__ unsigned long long s_scan[RANK_WARPS + 1];
  __shared__ int4 s_wpart[RANK_WARPS][RANK_BPT];
  __shared__ int4 s_part[RANK_TILE];  // this CTA's share, read by the cluster

  const int Q = cluster_ctas(), q = cluster_rank();
  const int tiles = (C + RANK_TILE - 1) / RANK_TILE;
  const int cl = blockIdx.x / Q;
  // Tile (cl % tiles) of tenant b: its lane tables, usage and capacity.
  const long long b = cl / tiles;
  const int c0 = (cl % tiles) * RANK_TILE;  // the tile's first place
  const long long lnv = (long long)L * N * V;
  cum_req += b * lnv * R;
  cum_cost += b * lnv;
  cum_viol += b * lnv;
  used += b * N * R;
  alloc += b * N * R;
  const long long row0 = b * C;  // row b * C + c of lane, ok, p_req, bid
  const int tid = threadIdx.x, lid = tid & 31, warp = tid >> 5;
  const int j = tid % RANK_NODES, g = tid / RANK_NODES;
  // The tile's bidders: places [c0, c0 + RANK_TILE) of the tenant's
  // bidders in (bucket lane, index) order, so that a tile's bidders
  // mostly share one bucket lane and its chunks stage that lane alone
  // (a counting sort: each thread counts a run of bidders' lanes in
  // 16-bit fields of one word, then a block scan); in index order where
  // the lanes do not fit the word.
  if (tid < RANK_TILE) s_row[tid] = -1;
  if (L <= RANK_SORT_LANES && C < 65536) {
    const int per = (C + RANK_THREADS - 1) / RANK_THREADS;
    const int lo = min(C, tid * per), hi = min(C, lo + per);
    auto field = [&](int c) {
      return 16 * min(max(lane[row0 + c], 0), L - 1);
    };
    unsigned long long cnt = 0;
    for (int c = lo; c < hi; ++c) cnt += 1ull << field(c);
    unsigned long long inc = cnt;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long o = __shfl_up_sync(RANK_FULL, inc, off);
      if (lid >= off) inc += o;
    }
    if (lid == 31) s_scan[warp] = inc;
    __syncthreads();
    if (tid == 0) {
      unsigned long long acc = 0;
      for (int w = 0; w < RANK_WARPS; ++w) {
        const unsigned long long x = s_scan[w];
        s_scan[w] = acc;
        acc += x;
      }
      s_scan[RANK_WARPS] = acc;
    }
    __syncthreads();
    unsigned long long run = s_scan[warp] + inc - cnt;
    const unsigned long long total = s_scan[RANK_WARPS];
    for (int c = lo; c < hi; ++c) {
      const int f = field(c);
      int place = (int)((run >> f) & 0xffffull);
      for (int k = 0; k < f; k += 16) place += (int)((total >> k) & 0xffffull);
      run += 1ull << f;
      if (place >= c0 && place < c0 + RANK_TILE) s_row[place - c0] = c;
    }
  } else if (tid < RANK_TILE && c0 + tid < C) {
    s_row[tid] = c0 + tid;
  }
  __syncthreads();
  if (tid < RANK_TILE)
    s_lane[tid] = s_row[tid] < 0 ? -1 : lane[row0 + s_row[tid]];
  for (int e = tid; e < RANK_TILE * MAXR; e += RANK_THREADS) {
    const int sl = e / MAXR, r = e % MAXR, c = s_row[sl];
    s_preq[e] = (c >= 0 && r < R) ? p_req[(row0 + c) * R + r] : 0.0f;
  }
  const float inv_vr = 1.0f / (float)(V * R), inv_v = 1.0f / (float)V;
  const float inv_r = 1.0f / (float)R;
  const int sr = rank_req_stride(V, R), sv = rank_v_stride(V);
  __syncthreads();
  const float* preq = s_preq + g * RANK_BPT * MAXR;
  const int* grow = s_row + g * RANK_BPT;
  const int* glane = s_lane + g * RANK_BPT;
  const int chunks = (N + RANK_NODES - 1) / RANK_NODES;
  const int mine = q < chunks ? (chunks - q + Q - 1) / Q : 0;
  // Bit i: bidder i of this thread's group may take node n0 + j.
  auto ok_bits = [&](int n0) {
    unsigned m = 0u;
#pragma unroll
    for (int i = 0; i < RANK_BPT; ++i) {
      const int c = grow[i];
      if (n0 + j < N && c >= 0 && ok[(row0 + c) * N + n0 + j]) m |= 1u << i;
    }
    return m;
  };
  // One pass over this CTA's chunks and the pass's wanted lanes, in
  // stages (a chunk's wanted lanes in ascending order, then the next
  // chunk's): stage i + 1 is copied in while stage i is evaluated, one
  // barrier a stage. eval(l, n0, buf, okm) evaluates one stage.
  auto run_pass = [&](auto want, auto eval) {
    __syncthreads();
    if (tid == 0) {
      int nw = 0;
      for (int l = 0; l < L && nw <= RANK_TILE; ++l) {
        bool w = false;
        for (int sl = 0; sl < RANK_TILE; ++sl) w = w || want(sl, l);
        if (w) s_wl[nw++] = l;
      }
      s_nw = nw;
    }
    __syncthreads();
    const int nw = s_nw, stages = mine * nw;
    if (stages == 0) return;
    auto start = [&](int i) {
      const int n0 = (q + (i / nw) * Q) * RANK_NODES;
      rank_stage(s_wl[i % nw], n0, min(RANK_NODES, N - n0), N, V, R, inv_vr,
                 inv_v, inv_r, cum_req, cum_cost, cum_viol, used, alloc,
                 rank_smem + (i & 1) * sw);
      cp_async_commit();
    };
    start(0);
    unsigned okm = ok_bits(q * RANK_NODES);
    for (int i = 0; i < stages; ++i) {
      cp_async_wait_all();
      __syncthreads();  // stage i landed; stage i - 1's buffer is free
      if (i + 1 < stages) start(i + 1);
      const int n0 = (q + (i / nw) * Q) * RANK_NODES;
      // The next chunk's ok bits load while this stage is evaluated.
      const bool last = i % nw == nw - 1;
      const unsigned okn = last && i + 1 < stages
                               ? ok_bits(n0 + Q * RANK_NODES) : okm;
      eval(s_wl[i % nw], n0, rank_smem + (i & 1) * sw, okm);
      okm = okn;
    }
  };

  // Pass 1: each allowed cell in its bidder's bucket lane and in the
  // optimistic lane L - 1, each lane staged once a chunk for the tile:
  // whether any is feasible in each, and the fewest violations of each.
  unsigned any_b = 0u, any_o = 0u;
  int mv_b[RANK_BPT], mv_o[RANK_BPT];
#pragma unroll
  for (int i = 0; i < RANK_BPT; ++i) mv_b[i] = mv_o[i] = INT_MAX;
  run_pass(
      [&](int sl, int l) {
        return s_lane[sl] >= 0 && (s_lane[sl] == l || l == L - 1);
      },
      [&](int l, int n0, const float* buf, unsigned okm) {
        unsigned evm = 0u;
#pragma unroll
        for (int i = 0; i < RANK_BPT; ++i)
          if (glane[i] == l || l == L - 1) evm |= 1u << i;
        evm &= okm;
        if (!__any_sync(RANK_FULL, evm != 0u)) return;
        const int* s_viol =
            reinterpret_cast<const int*>(buf + RANK_NODES * (sr + sv)) +
            j * sv;
        const RankEval e = rank_eval(j, V, R, buf, preq);
        const unsigned fm = evm & e.feas;
#pragma unroll
        for (int i = 0; i < RANK_BPT; ++i) {
          if (!((fm >> i) & 1u)) continue;
          const int vi = s_viol[min(e.pos[i], V - 1)];
          if (glane[i] == l) {
            any_b |= 1u << i;
            mv_b[i] = min(mv_b[i], vi);
          }
          if (l == L - 1) {
            any_o |= 1u << i;
            mv_o[i] = min(mv_o[i], vi);
          }
        }
      });
  // The row flags and minima: over the warp's nodes, the group's warps,
  // then the cluster's CTAs (integer work, exact in any order).
#pragma unroll
  for (int i = 0; i < RANK_BPT; ++i) {
    const unsigned fb = __ballot_sync(RANK_FULL, (any_b >> i) & 1u);
    const unsigned fo = __ballot_sync(RANK_FULL, (any_o >> i) & 1u);
    const int mb = __reduce_min_sync(RANK_FULL, mv_b[i]);
    const int mo = __reduce_min_sync(RANK_FULL, mv_o[i]);
    if (lid == 0)
      s_wpart[warp][i] = make_int4((fb != 0u) | ((fo != 0u) << 1), mb, mo, 0);
  }
  __syncthreads();
  if (tid < RANK_TILE) {
    const int gw = (tid / RANK_BPT) * (RANK_NODES / 32), i = tid % RANK_BPT;
    int4 p = s_wpart[gw][i];
    for (int w = 1; w < RANK_NODES / 32; ++w) {
      const int4 o = s_wpart[gw + w][i];
      p = make_int4(p.x | o.x, min(p.y, o.y), min(p.z, o.z), 0);
    }
    s_part[tid] = p;
  }
  tpusched::cluster_sync();  // every CTA's share is in its shared memory
  if (tid < RANK_TILE) {
    int4 p = s_part[tid];
    for (int qq = 0; qq < Q; ++qq) {
      if (qq == q) continue;
      const int4 o = *tpusched::cluster_ptr(&s_part[tid], qq);
      p = make_int4(p.x | o.x, min(p.y, o.y), min(p.z, o.z), 0);
    }
    const int lb = s_lane[tid], c = s_row[tid];
    const bool ab = p.x & 1, ao = p.x & 2;
    // The bucket lane ranks unless only the optimistic lane is feasible.
    const int pick = (!ab && ao) ? L - 1 : lb;
    s_pick[tid] = lb < 0 ? -1 : pick;
    s_mv[tid] = pick == lb ? p.y : p.z;
    if (q == 0 && c >= 0) could[row0 + c] = ao;
  }
  tpusched::cluster_arrive();  // done with the other CTAs' shares

  // Pass 2: each cell in its row's lane; bid = -cost on the allowed
  // feasible nodes with the row's fewest violations, else -inf, written
  // once (a warp's 32 nodes of a row coalesced).
  const int* gpick = s_pick + g * RANK_BPT;
  const int* gmv = s_mv + g * RANK_BPT;
  run_pass(
      [&](int sl, int l) { return s_pick[sl] == l; },
      [&](int l, int n0, const float* buf, unsigned okm) {
        unsigned wm = 0u;
#pragma unroll
        for (int i = 0; i < RANK_BPT; ++i)
          if (gpick[i] == l && n0 + j < N) wm |= 1u << i;
        if (!__any_sync(RANK_FULL, wm != 0u)) return;
        const float* s_cost = buf + RANK_NODES * sr + j * sv;
        const int* s_viol =
            reinterpret_cast<const int*>(buf + RANK_NODES * (sr + sv)) +
            j * sv;
        const unsigned evm = wm & okm;
        RankEval e;
        e.feas = 0u;
        if (__any_sync(RANK_FULL, evm != 0u)) e = rank_eval(j, V, R, buf, preq);
        const unsigned fm = evm & e.feas;
#pragma unroll
        for (int i = 0; i < RANK_BPT; ++i) {
          if (!((wm >> i) & 1u)) continue;
          float bv = -INFINITY;
          if ((fm >> i) & 1u) {
            const int at = min(e.pos[i], V - 1);
            if (s_viol[at] == gmv[i]) bv = -s_cost[at];
          }
          bid[(row0 + grow[i]) * N + n0 + j] = bv;
        }
      });
  tpusched::cluster_wait();  // no CTA leaves while its share may be read
}

// K18's claim state and layout. A tenant's cluster of Q CTAs splits its C
// bidders into contiguous ranges of ceil(C / Q) a CTA, and each CTA's
// range into contiguous runs of BPW bidders a warp, so that bidder order
// is (CTA, warp, slot) order. Each lane holds K / 32 of a bidder's
// candidates (k = i * 32 + lane): the node index (clamped) and whether
// the bid is finite; a warp keeps its first CLAIM_REG bidders' in
// registers, loaded once, and reloads the others' (coalesced) each
// iteration. (Four a warp in CTAs of 512 threads, 128 registers a thread
// and no spill, ran slower on an H100 than two a warp in CTAs of 1 024,
// 64 registers and 32 bytes of spill; PERF.md.)
constexpr int CLAIM_KPL = 8;   // candidates a lane holds: K <= 256
constexpr int CLAIM_REG = 2;   // bidders a warp keeps in registers
constexpr int CLAIM_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned char CLAIMED = 1, HAS = 2;

// The dynamic shared memory of one CTA: taken [NW] bits of every node,
// best [2][NPC] over the CTA's own node range (two buffers that take
// turns), then per bidder of the CTA its availability ballots [KPL],
// target, #available and wanted node, and its flags.
struct ClaimSmem {
  unsigned* taken;
  int* best;
  unsigned* avail;
  int* target;
  int* navail;
  int* want;
  unsigned char* flag;
};

__host__ __device__ inline long long claim_smem_bytes(int N, int C, int Q,
                                                      int K) {
  const long long NW = (N + 31) / 32, NPC = ((N + Q - 1) / Q + 31) / 32 * 32;
  const long long CPC = (C + Q - 1) / Q, KPL = (K + 31) / 32;
  return 4 * NW + 8 * NPC + CPC * (4 * KPL + 13);
}

__global__ void __launch_bounds__(CLAIM_THREADS, 1)
auction_claim_kernel(int C, int K, int N, int V, int R, int M, int GP,
                     int iters, const float* __restrict__ topv,
                     const int* __restrict__ topi,
                     const bool* __restrict__ can_plain,
                     const int* __restrict__ n_plain,
                     const int* __restrict__ rank,
                     const float* __restrict__ vreq,
                     const float* __restrict__ vprio,
                     const int* __restrict__ vpdb,
                     const bool* __restrict__ vvalid,
                     const int* __restrict__ vidx,
                     const bool* __restrict__ evicted,
                     const float* __restrict__ p_prio,
                     const float* __restrict__ p_req,
                     const float* __restrict__ used,
                     const float* __restrict__ alloc,
                     const bool* __restrict__ could, float margin,
                     int* __restrict__ target_out, bool* __restrict__ claimed_out,
                     bool* __restrict__ takes_out, int* __restrict__ vidx_t,
                     float* __restrict__ freed, int* __restrict__ usage,
                     bool* __restrict__ could_bid) {
  extern __shared__ unsigned claim_smem[];
  __shared__ uint2 x_slot[tpusched::MAX_CLUSTER];  // each CTA's bidders with a bid
  __shared__ unsigned long long x_bar;             // ... their mbarrier
  __shared__ int s_wcnt[32], s_woff[32];
  const int Q = cluster_ctas(), q = cluster_rank();
  // Cluster b claims for tenant b: every array offset to it, the
  // validation's only after the claim iterations (fewer live registers
  // through them).
  const long long b = cluster_index();
  topv += b * C * K;
  topi += b * C * K;
  can_plain += b * C;
  n_plain += b * C;
  rank += b * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, W = T >> 5;
  const int CPC = (C + Q - 1) / Q;
  const int c_lo = q * CPC, c_hi = min(C, c_lo + CPC);
  const int BPW = (CPC + W - 1) / W;
  const int w_lo = c_lo + warp * BPW;            // the warp's first bidder
  const int nbw = max(0, min(c_hi, w_lo + BPW) - w_lo);
  const int s_lo = w_lo - c_lo;                  // ... its slot in the CTA
  const int NW = (N + 31) >> 5;
  const int NPC = ((N + Q - 1) / Q + 31) / 32 * 32;  // nodes a CTA owns
  const int KPL = (K + 31) >> 5;
  ClaimSmem sm;
  sm.taken = claim_smem;
  sm.best = reinterpret_cast<int*>(sm.taken + NW);
  sm.avail = reinterpret_cast<unsigned*>(sm.best + 2 * NPC);
  sm.target = reinterpret_cast<int*>(sm.avail + CPC * KPL);
  sm.navail = sm.target + CPC;
  sm.want = sm.navail + CPC;
  sm.flag = reinterpret_cast<unsigned char*>(sm.want + CPC);
  for (int i = tid; i < NW; i += T) sm.taken[i] = 0u;
  for (int i = tid; i < 2 * NPC; i += T) sm.best[i] = INT_MAX;
  for (int i = tid; i < CPC; i += T) {
    sm.flag[i] = 0;
    sm.target[i] = -1;
  }
  if (tid == 0) {
    mbar_init(&x_bar);
    mbar_init_fence();
  }
  auto clampn = [&](int n) { return min(max(n, 0), N - 1); };
  // Bidder c's candidates at this lane: a plain bidder's scored node at
  // k = 0 alone, else its top-K row (finite bids only).
  auto load = [&](int c, int (&cn)[CLAIM_KPL], unsigned& fin) {
    fin = 0u;
    const bool cp = can_plain[c];
#pragma unroll
    for (int i = 0; i < CLAIM_KPL; ++i) {
      const int k = i * 32 + lane;
      int n = 0;
      bool ok = false;
      if (i < KPL && k < K) {
        if (cp) {
          n = n_plain[c];
          ok = k == 0;
        } else {
          n = topi[(long long)c * K + k];
          ok = isfinite(topv[(long long)c * K + k]);
        }
      }
      cn[i] = clampn(n);
      fin |= (ok ? 1u : 0u) << i;
    }
  };
  int cr[CLAIM_REG][CLAIM_KPL];
  unsigned fr[CLAIM_REG];
#pragma unroll
  for (int s = 0; s < CLAIM_REG; ++s)
    if (s < nbw) load(w_lo + s, cr[s], fr[s]);
  // Every CTA of the cluster runs, its state and mbarrier set up, before
  // any DSMEM access.
  tpusched::cluster_sync();

  // Slot s of the warp (unclaimed): the ballots of its available
  // candidates, their count, and whether it bids; returns 1 if it does.
  auto avail = [&](int s, const int (&cn)[CLAIM_KPL], unsigned fin) {
    const int sl = s_lo + s;
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < CLAIM_KPL; ++i) {
      if (i >= KPL) break;
      const int n = cn[i];
      const bool a = ((fin >> i) & 1u) &&
                     !((sm.taken[n >> 5] >> (n & 31)) & 1u);
      const unsigned m = __ballot_sync(FULL, a);
      if (lane == i) sm.avail[sl * KPL + i] = m;
      cnt += __popc(m);
    }
    if (lane == 0) {
      sm.navail[sl] = cnt;
      sm.flag[sl] = cnt > 0 ? HAS : 0;
    }
    return cnt > 0 ? 1 : 0;
  };
  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    int* best = sm.best + buf * NPC;
    // 1. Availability, by ballots over the lanes' candidates.
    int whas = 0;
#pragma unroll
    for (int s = 0; s < CLAIM_REG; ++s)
      if (s < nbw && !(sm.flag[s_lo + s] & CLAIMED))
        whas += avail(s, cr[s], fr[s]);
    for (int s = CLAIM_REG; s < nbw; ++s) {
      if (sm.flag[s_lo + s] & CLAIMED) continue;
      int cn[CLAIM_KPL];
      unsigned fin;
      load(w_lo + s, cn, fin);
      whas += avail(s, cn, fin);
    }
    if (lane == 0) s_wcnt[warp] = whas;
    __syncthreads();
    // 2. Each bidder's active rank: the warps' counts scanned in the
    // CTA, the CTAs' totals exchanged over the cluster.
    if (warp == 0) {
      const int own = lane < W ? s_wcnt[lane] : 0;
      int x = own;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, x, d);
        if (lane >= d) x += y;
      }
      if (lane < W) s_woff[lane] = x - own;
      const int total = __shfl_sync(FULL, x, 31);
      __syncwarp();
      if (lane == 0) mbar_expect(&x_bar, 8u * Q);
      // Orders this CTA's last writes (the reset of the other best
      // buffer) before the records that release them to the cluster.
      asm volatile("fence.acq_rel.cluster;" ::: "memory");
      if (lane < Q)
        st_async(&x_slot[q], lane, make_uint2((unsigned)total, 0u), &x_bar);
    }
    mbar_wait(&x_bar, (unsigned)(it & 1));
    int ra = s_woff[warp];
    for (int x = 0; x < q; ++x) ra += (int)x_slot[x].x;
    // 3. The target-th available candidate, by the ballots' counts and a
    // bit find; 4. its node's lowest bidder rank, by atomicMin into the
    // owner CTA's best.
    for (int s = 0; s < nbw; ++s) {
      const int sl = s_lo + s;
      if (!(sm.flag[sl] & HAS)) continue;
      int tgt = ra % sm.navail[sl] + 1;
      ++ra;
      int i = 0;
      unsigned m = sm.avail[sl * KPL];
      while (tgt > __popc(m)) {
        tgt -= __popc(m);
        m = sm.avail[sl * KPL + ++i];
      }
      for (int t = 1; t < tgt; ++t) m &= m - 1u;
      const int j = i * 32 + __ffs(m) - 1;
      if (lane == 0) {
        const int c = w_lo + s;
        const int want = can_plain[c] ? (j == 0 ? n_plain[c] : 0)
                                      : topi[(long long)c * K + j];
        sm.want[sl] = want;
        const int n = clampn(want), owner = n / NPC;
        atomicMin(tpusched::cluster_ptr(best + (n - owner * NPC), owner),
                  rank[c]);
      }
    }
    tpusched::cluster_sync();
    // 5. The winner test against the owner's best; 6. the taken bits of
    // every node some bidder won, from every CTA's best, and this CTA's
    // other best buffer reset for the next iteration.
    for (int s = 0; s < nbw; ++s) {
      const int sl = s_lo + s;
      if (lane != 0 || !(sm.flag[sl] & HAS)) continue;
      const int want = sm.want[sl];
      const int n = clampn(want), owner = n / NPC;
      if (*tpusched::cluster_ptr(best + (n - owner * NPC), owner) ==
          rank[w_lo + s]) {
        sm.target[sl] = want;
        sm.flag[sl] = CLAIMED;
      }
    }
    for (int n = tid; n < NW * 32; n += T) {
      bool hit = false;
      if (n < N) {
        const int owner = n / NPC;
        hit = *tpusched::cluster_ptr(best + (n - owner * NPC), owner) !=
              INT_MAX;
      }
      const unsigned m = __ballot_sync(FULL, hit);
      if (lane == 0 && m) sm.taken[n >> 5] |= m;
    }
    for (int i = tid; i < NPC; i += T) sm.best[(buf ^ 1) * NPC + i] = INT_MAX;
    __syncthreads();
  }
  // No CTA leaves while another may still read its best.
  tpusched::cluster_sync();
  {
    const long long nv = (long long)N * V;
    vreq += b * nv * R;
    vprio += b * nv;
    vpdb += b * nv;
    vvalid += b * nv;
    vidx += b * nv;
    evicted += b * M;
    p_prio += b * C;
    p_req += b * C * R;
    used += b * N * R;
    alloc += b * N * R;
    could += b * C;
    target_out += b * C;
    claimed_out += b * C;
    takes_out += b * C;
    vidx_t += b * C * V;
    freed += b * C * R;
    usage += b * C * GP;
    could_bid += b * C;
  }
  // Exact validation on the claimed node: a warp a bidder, lane v the
  // node's victim v.
  const int v = lane;
  for (int s = 0; s < nbw; ++s) {
    const int c = w_lo + s, sl = s_lo + s;
    const bool claimed = sm.flag[sl] & CLAIMED;
    const int target = claimed ? sm.target[sl] : -1;
    const bool cp = can_plain[c];
    const int t = clampn(target);
    const long long row = (long long)t * V;
    bool el = false;
    if (v < V) {
      const bool vv = vvalid[row + v];
      bool ev = false;
      if (vv && M > 0) ev = evicted[min(max(vidx[row + v], 0), M - 1)];
      el = vv && !ev && vprio[row + v] + margin < p_prio[c];
    }
    const unsigned elig = __ballot_sync(FULL, el);
    // Lane v's prefix of the eligible requests through victim v, left to
    // right from 0.0.
    float acc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.0f;
    for (int w = 0; w <= v && w < V; ++w) {
      const bool e = (elig >> w) & 1u;
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < R) acc[r] = acc[r] + (e ? vreq[(row + w) * R + r] : 0.0f);
    }
    bool fits = el;
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < R)
        fits = fits && (used[(long long)t * R + r] - acc[r]) +
                               p_req[(long long)c * R + r] <=
                           alloc[(long long)t * R + r];
    const unsigned fm = __ballot_sync(FULL, fits);
    const bool feas = fm != 0u;
    const int bpos = feas ? __ffs(fm) - 1 : 0;
    const bool released = claimed && !cp && !feas;
    const bool kept = claimed && (cp || feas);
    const bool takes = kept && !cp;
    if (v < V) {
      const bool sel = takes && el && v <= bpos;
      vidx_t[(long long)c * V + v] = sel ? vidx[row + v] : M;
      const int g = vpdb[row + v];
      if (sel && GP > 0 && g >= 0) atomicAdd(&usage[(long long)c * GP + g], 1);
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const float f = __shfl_sync(FULL, acc[r], bpos);
      if (r < R && lane == 0) freed[(long long)c * R + r] = takes ? f : 0.0f;
    }
    if (lane == 0) {
      target_out[c] = kept ? target : -1;
      claimed_out[c] = kept;
      takes_out[c] = takes;
      could_bid[c] = cp || (could[c] && !released);
    }
  }
}

}  // namespace

extern "C" int tpusched_auction_tables(
    int B, int L, int N, int V, int R, int M, int GP, const float* vreq,
    const float* vcost, const float* vprio, const int* vpdb,
    const bool* vvalid, const int* vidx, const bool* evicted,
    const float* thr, const float* remaining, float margin, float* cum_req,
    float* cum_cost, int* cum_viol, void* stream) {
  if (V > 32 || R > MAXR) return (int)cudaErrorInvalidValue;
  const long long cells = (long long)B * L * N;
  const int blocks = (int)((cells + ROW_THREADS - 1) / ROW_THREADS);
  auction_tables_kernel<<<blocks, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      B, L, N, V, R, M, GP, vreq, vcost, vprio, vpdb, vvalid, vidx, evicted,
      thr, remaining, margin, cum_req, cum_cost, cum_viol);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_auction_ok(int B, int C, int N, int Pm,
                                   const bool* mask, const int* rows,
                                   const bool* pair_ok,
                                   const bool* pre_active,
                                   const bool* node_valid, bool* ok,
                                   bool* any_ok, void* stream) {
  auction_ok_kernel<<<B * C, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      C, N, Pm, mask, rows, pair_ok, pre_active, node_valid, ok, any_ok);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_auction_rank(int B, int Q, int L, int N, int V,
                                     int R, int C, const float* cum_req,
                                     const float* cum_cost,
                                     const int* cum_viol, const int* lane,
                                     const bool* ok, const float* used,
                                     const float* alloc, const float* p_req,
                                     float* bid, bool* could, void* stream) {
  if (V < 1 || V > 32 || R < 1 || R > MAXR)
    return (int)cudaErrorInvalidValue;
  const int tiles = (C + RANK_TILE - 1) / RANK_TILE;
  return (int)tpusched::launch_clusters(
      auction_rank_kernel, B * tiles, Q, RANK_THREADS,
      (size_t)rank_smem_bytes(V, R), (cudaStream_t)stream, C, L, N, V, R,
      cum_req, cum_cost, cum_viol, lane, ok, used, alloc, p_req, bid, could);
}

extern "C" int tpusched_auction_claim(
    int B, int Q, int threads, int C, int K, int N, int V, int R, int M,
    int GP, int iters, const float* topv, const int* topi,
    const bool* can_plain, const int* n_plain, const int* rank,
    const float* vreq, const float* vprio, const int* vpdb,
    const bool* vvalid, const int* vidx, const bool* evicted,
    const float* p_prio, const float* p_req, const float* used,
    const float* alloc, const bool* could, float margin, int* target,
    bool* claimed, bool* takes, int* vidx_t, float* freed, int* usage,
    bool* could_bid, void* stream) {
  if (V > 32 || R > MAXR || K < 1 || K > 32 * CLAIM_KPL || N < 1 ||
      threads < 32 || threads > CLAIM_THREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = claim_smem_bytes(N, C, Q, K);
  if (smem > CLAIM_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  return (int)tpusched::launch_clusters(
      auction_claim_kernel, B, Q, threads, (size_t)smem,
      (cudaStream_t)stream, C, K, N, V, R, M, GP, iters, topv, topi,
      can_plain, n_plain, rank, vreq, vprio, vpdb, vvalid, vidx, evicted,
      p_prio, p_req, used, alloc, could, margin, target, claimed, takes,
      vidx_t, freed, usage, could_bid);
}

extern "C" int tpusched_claim_limits(int N, int C, int Q, int K,
                                     long long* out) {
  out[0] = MAXR;
  out[1] = CLAIM_SMEM_LIMIT;
  out[2] = claim_smem_bytes(N, C, Q, K);
  return 0;
}
