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
// K18 auction_claim (:564-679), one CTA of 1024 threads, a thread a
// bidder, its candidates read from [K, C] transposed lists (the wrapper
// transposes K6's [C, K] output, so that a warp's loads coalesce):
// `iters` claim iterations with taken [N] and best [N] in shared
// memory (each unclaimed bidder with an available candidate takes its
// (active-rank mod #available + 1)-th available candidate, active-rank
// from a block scan; per node the lowest rank wins by atomicMin; integer
// work, exact in any order), then each bidder's exact validation on its
// claimed node: true-priority eligibility, the V-long request prefix from
// 0.0, the first prefix after which it fits, that prefix's victims, its
// sum (the freed capacity, the value the fit was tested with) and its
// evictions per budget. Bound: latency (iters block barriers and the
// [C, K] candidate walks).
//
// Tenant axis (tpusched/tenants.py:75 solve_many, JAX's vmap of
// _preempt_rounds): each entry point takes B first and every array gains
// a leading [B] axis. K16 runs B * L * N threads, tenant b's cells
// reading its own victim table, evictions, lanes and budgets; K17 runs
// B * C rows, row b * C + c reading tenant b's mask rows (rows index its
// own [Pm, N]), lane tables, usage and capacity; K18 runs one CTA a
// tenant (grid B, 5 * N bytes of shared memory each, C <= 1024 a
// tenant), offsetting every array to its tenant (b = 0 for one cluster).
#include <limits.h>
#include <math.h>

#include "kernels.h"

namespace {

constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int CLAIM_THREADS = 1024;
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

// Inclusive scan of one int per thread over the CTA.
__device__ __forceinline__ int block_scan(int x, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = s_warp[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    s_warp[lane] = t;
  }
  __syncthreads();
  const int out = x + (warp > 0 ? s_warp[warp - 1] : 0);
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(CLAIM_THREADS)
auction_claim_kernel(int C, int K, int N, int V, int R, int M, int GP,
                     int iters, const float* __restrict__ topv_t,
                     const int* __restrict__ topi_t,
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
  extern __shared__ int s_best[];  // [N] int, then taken [N] bytes
  unsigned char* taken = reinterpret_cast<unsigned char*>(s_best + N);
  __shared__ int s_warp[32];
  {  // CTA b claims for tenant b: every array offset to it.
    const long long b = blockIdx.x;
    const long long nv = (long long)N * V;
    topv_t += b * K * C;
    topi_t += b * K * C;
    can_plain += b * C;
    n_plain += b * C;
    rank += b * C;
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
  const int c = threadIdx.x;
  const bool live = c < C;
  for (int n = threadIdx.x; n < N; n += CLAIM_THREADS) taken[n] = 0;
  const bool cp = live && can_plain[c];
  const int np = live ? n_plain[c] : 0;
  const int my_rank = live ? rank[c] : INT_MAX;
  // Candidate k: a plain bidder's scored node alone, else the top-K,
  // read from the [K, C] transposed lists (a warp's loads coalesce).
  auto cand = [&](int k) {
    return cp ? (k == 0 ? np : 0) : topi_t[(long long)k * C + c];
  };
  auto fin = [&](int k) {
    return cp ? k == 0 : isfinite(topv_t[(long long)k * C + c]);
  };
  auto clampn = [&](int n) { return min(max(n, 0), N - 1); };
  int target = -1;
  bool claimed = false;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    // The walks load every candidate unconditionally and unrolled, so
    // that a thread keeps several loads in flight (one CTA has too few
    // warps to hide a chain of dependent loads).
    int navail = 0;
    if (live && !claimed) {
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const int n = clampn(cand(k));
        const bool f = fin(k);
        navail += (f && !taken[n]) ? 1 : 0;
      }
    }
    const bool has = live && !claimed && navail > 0;
    const int r_active = block_scan(has ? 1 : 0, s_warp) - 1;
    int want = 0;
    if (has) {
      const int tgt = r_active % navail + 1;
      int cnt = 0, j = K - 1;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const int n = clampn(cand(k));
        const bool f = fin(k);
        if (f && !taken[n] && ++cnt == tgt) {
          j = k;
          break;
        }
      }
      want = cand(j);
    }
    for (int n = threadIdx.x; n < N; n += CLAIM_THREADS) s_best[n] = INT_MAX;
    __syncthreads();
    if (has) atomicMin(&s_best[clampn(want)], my_rank);
    __syncthreads();
    const bool winner = has && s_best[clampn(want)] == my_rank;
    __syncthreads();
    if (winner) {
      target = want;
      claimed = true;
      taken[clampn(want)] = 1;
    }
    __syncthreads();
  }
  if (!live) return;
  // Exact validation on the claimed node.
  const int t = clampn(target);
  const long long row = (long long)t * V;
  const float prio = p_prio[c];
  float acc[MAXR], fr[MAXR];
  for (int r = 0; r < R; ++r) acc[r] = fr[r] = 0.0f;
  unsigned elig = 0u;
  int bp = -1;
  for (int v = 0; v < V; ++v) {
    const bool vv = vvalid[row + v];
    bool ev = false;
    if (vv && M > 0) ev = evicted[min(max(vidx[row + v], 0), M - 1)];
    const bool el = vv && !ev && vprio[row + v] + margin < prio;
    elig |= (el ? 1u : 0u) << v;
    for (int r = 0; r < R; ++r)
      acc[r] = acc[r] + (el ? vreq[(row + v) * R + r] : 0.0f);
    if (el && bp < 0) {
      bool fits = true;
      for (int r = 0; r < R; ++r)
        fits = fits && (used[(long long)t * R + r] - acc[r]) +
                               p_req[(long long)c * R + r] <=
                           alloc[(long long)t * R + r];
      if (fits) {
        bp = v;
        for (int r = 0; r < R; ++r) fr[r] = acc[r];
      }
    }
  }
  const bool feas = bp >= 0;
  const bool released = claimed && !cp && !feas;
  const bool kept = claimed && (cp || feas);
  const bool takes = kept && !cp;
  const int bpos = feas ? bp : 0;
  for (int v = 0; v < V; ++v) {
    const bool sel = takes && ((elig >> v) & 1u) && v <= bpos;
    vidx_t[(long long)c * V + v] = sel ? vidx[row + v] : M;
    const int g = vpdb[row + v];
    if (sel && GP > 0 && g >= 0) usage[(long long)c * GP + g] += 1;
  }
  for (int r = 0; r < R; ++r) freed[(long long)c * R + r] = takes ? fr[r] : 0.0f;
  target_out[c] = kept ? target : -1;
  claimed_out[c] = kept;
  takes_out[c] = takes;
  could_bid[c] = cp || (could[c] && !released);
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
    int B, int C, int K, int N, int V, int R, int M, int GP, int iters,
    const float* topv_t, const int* topi_t, const bool* can_plain,
    const int* n_plain, const int* rank, const float* vreq,
    const float* vprio, const int* vpdb, const bool* vvalid, const int* vidx,
    const bool* evicted, const float* p_prio, const float* p_req,
    const float* used, const float* alloc, const bool* could, float margin,
    int* target, bool* claimed, bool* takes, int* vidx_t, float* freed,
    int* usage, bool* could_bid, void* stream) {
  if (C > CLAIM_THREADS || V > 32 || R > MAXR || K < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = (long long)N * (sizeof(int) + 1);
  if (smem > CLAIM_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        auction_claim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  auction_claim_kernel<<<B, CLAIM_THREADS, (size_t)smem,
                         (cudaStream_t)stream>>>(
      C, K, N, V, R, M, GP, iters, topv_t, topi_t, can_plain, n_plain, rank,
      vreq, vprio, vpdb, vvalid, vidx, evicted, p_prio, p_req, used, alloc,
      could, margin, target, claimed, takes, vidx_t, freed, usage,
      could_bid);
  return (int)cudaGetLastError();
}
