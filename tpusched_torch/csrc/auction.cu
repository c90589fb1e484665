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
// K17 (:486-562), two entry points, one CTA per bidder row:
//  * auction_ok: ok[c, n] = the bidder's static mask row & its pairwise
//    verdict & valid node & active bidder, and whether any is set (the
//    auction's thresholds need the active bidders first);
//  * auction_rank: need = (used[n] + p_req[c]) - alloc[n]; in a lane, pos
//    = max over r of #{v : cum_req[l, n, v, r] < need[r]} (cum_req is a
//    prefix of non-negative values, so non-decreasing in v, and a binary
//    search gives that count), feas = need <= cum_req[l, n, V - 1], and
//    the cost and violations at min(pos, V - 1). The bidder's bucket lane
//    ranks unless no allowed node is feasible there and one is in the
//    optimistic lane; over the allowed feasible nodes with the fewest
//    violations bid = -cost (else -inf), the row K6 ranks. could[c] = any
//    allowed node is feasible in the optimistic lane. Three passes over
//    the row (the two any-flags, the violation minimum, the bids); the
//    lane tables stay in L2. Bound: bytes, ok [C, N] and bid [C, N].
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
// B * C rows, row b * C + c reading tenant b's mask rows (rows index its
// own [Pm, N]), lane tables, usage and capacity; K18 runs one cluster a
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
constexpr int ROW_WARPS = ROW_THREADS / 32;
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

struct Lane {
  bool feas;
  float cost;
  int viol;
};

// One lane's first-feasible prefix of node n for the demand `need`.
__device__ __forceinline__ Lane lane_eval(int l, int n, int N, int V, int R,
                                          const float* need,
                                          const float* __restrict__ cum_req,
                                          const float* __restrict__ cum_cost,
                                          const int* __restrict__ cum_viol) {
  const long long base = ((long long)l * N + n) * V;
  const float* cr = cum_req + base * R;
  int pos = 0;
  bool feas = true;
  for (int r = 0; r < R; ++r) {
    int lo = 0, hi = V;  // #{v : cr[v, r] < need[r]}, cr non-decreasing
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cr[mid * R + r] < need[r])
        lo = mid + 1;
      else
        hi = mid;
    }
    pos = max(pos, lo);
    feas = feas && need[r] <= cr[(V - 1) * R + r];
  }
  const int p = min(pos, V - 1);
  return Lane{feas, cum_cost[base + p], cum_viol[base + p]};
}

__global__ void __launch_bounds__(ROW_THREADS)
auction_rank_kernel(int C, int L, int N, int V, int R,
                    const float* __restrict__ cum_req,
                    const float* __restrict__ cum_cost,
                    const int* __restrict__ cum_viol,
                    const int* __restrict__ lane, const bool* __restrict__ ok,
                    const float* __restrict__ used,
                    const float* __restrict__ alloc,
                    const float* __restrict__ p_req, float* __restrict__ bid,
                    bool* __restrict__ could) {
  __shared__ int s_min[ROW_WARPS];
  // Row c (blockIdx.x = b * C + c) of tenant b: its lane tables, usage
  // and capacity.
  const int c = blockIdx.x;
  const long long b = c / C;
  const long long lnv = (long long)L * N * V;
  cum_req += b * lnv * R;
  cum_cost += b * lnv;
  cum_viol += b * lnv;
  used += b * N * R;
  alloc += b * N * R;
  const long long row = (long long)c * N;
  const int lb = lane[c], lo_lane = L - 1;
  float req[MAXR];
  for (int r = 0; r < R; ++r) req[r] = p_req[(long long)c * R + r];
  float need[MAXR];
  auto demand = [&](int n) {
    for (int r = 0; r < R; ++r)
      need[r] = (used[(long long)n * R + r] + req[r]) - alloc[(long long)n * R + r];
  };
  // Pass 1: any allowed node feasible in the bucket lane, in the
  // optimistic lane.
  bool any_b = false, any_o = false;
  for (int n = threadIdx.x; n < N; n += ROW_THREADS) {
    if (!ok[row + n]) continue;
    demand(n);
    any_b |= lane_eval(lb, n, N, V, R, need, cum_req, cum_cost, cum_viol).feas;
    any_o |= lane_eval(lo_lane, n, N, V, R, need, cum_req, cum_cost, cum_viol)
                 .feas;
  }
  any_b = __syncthreads_or(any_b);
  any_o = __syncthreads_or(any_o);
  const int l = (!any_b && any_o) ? lo_lane : lb;
  // Pass 2: the fewest violations over the allowed feasible nodes.
  int mv = INT_MAX;
  for (int n = threadIdx.x; n < N; n += ROW_THREADS) {
    if (!ok[row + n]) continue;
    demand(n);
    const Lane e = lane_eval(l, n, N, V, R, need, cum_req, cum_cost, cum_viol);
    if (e.feas) mv = min(mv, e.viol);
  }
  for (int off = 16; off > 0; off >>= 1)
    mv = min(mv, __shfl_xor_sync(0xffffffffu, mv, off));
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = mv;
  __syncthreads();
  mv = s_min[0];
  for (int w = 1; w < ROW_WARPS; ++w) mv = min(mv, s_min[w]);
  // Pass 3: the bids.
  for (int n = threadIdx.x; n < N; n += ROW_THREADS) {
    float b = -INFINITY;
    if (ok[row + n]) {
      demand(n);
      const Lane e =
          lane_eval(l, n, N, V, R, need, cum_req, cum_cost, cum_viol);
      if (e.feas && e.viol == mv) b = -e.cost;
    }
    bid[row + n] = b;
  }
  if (threadIdx.x == 0) could[c] = any_o;
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

extern "C" int tpusched_auction_rank(int B, int L, int N, int V, int R,
                                     int C, const float* cum_req,
                                     const float* cum_cost,
                                     const int* cum_viol, const int* lane,
                                     const bool* ok, const float* used,
                                     const float* alloc, const float* p_req,
                                     float* bid, bool* could, void* stream) {
  if (V > 32 || R > MAXR) return (int)cudaErrorInvalidValue;
  auction_rank_kernel<<<B * C, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      C, L, N, V, R, cum_req, cum_cost, cum_viol, lane, ok, used, alloc,
      p_req, bid, could);
  return (int)cudaGetLastError();
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
