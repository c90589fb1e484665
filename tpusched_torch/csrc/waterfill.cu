// K12: the per-pod [P, N] part of the spread water-fill dealer.
//
// Replaces tpusched/kernels/assign.py:563 _spread_waterfill_deal from its
// `fill` table on (:636-698). Its inputs: each pod's signature s_p, its
// 0-based position q among this round's members of s_p (in rank order),
// the per-signature fill-level table `fill` (domains by ascending count,
// `j * csort - presum`, with the 1e9 stand-in for absent domains) and the
// domain order `ord_dom` (the table entry points below), the nodes'
// free-capacity order `cap_order` and the per-domain node lists (torch):
// dsort [S, N] each signature's node domains ascending and dnode [S, N]
// the nodes in that order, each domain's nodes in cap_order order
// (keyless nodes, domain -1, first). One warp a pod row, WARPS rows a
// CTA, no block barrier:
//   1. j_p  = (count of fill[s_p, n] <= q over n) - 1, clipped to [0, N);
//      r_i = (int)(q - fill[s_p, j_p]) (truncation, as astype(int32));
//      the domain ord_dom[s_p, r_i mod (j_p + 1)] and the level offset
//      m_p = r_i div (j_p + 1) (floor division and modulo, as jnp's).
//      The count is a 32-way search (a probe a lane, three steps at N =
//      5 120): `fill <= q` holds on a prefix of every row. Over the real
//      domains fill is nondecreasing (fill[j] - fill[j-1] = j * (csort[j]
//      - csort[j-1]) >= 0 over exact integers); an entry past the first
//      absent domain is near r * 1e9 - presum (r >= 1 real domains), far
//      above any q; and a row with no real domain is 0 throughout.
//      tests/test_torch_waterfill_excess.py holds the search to the count.
//   2. The chosen domain's segment of dsort (two more searches), and
//      n_feas = #{relaxed[p, n]} over its nodes (ballots, 4 x 32 nodes a
//      step, the node loads issued before the relaxed gathers);
//   3. targets t_k = fmod-mod(m_p + k, max(n_feas, 1)) + 1 for k < K1
//      (jnp.mod's sign rule), lane k holding t_k; a second walk of the
//      segment compacts each step's relaxed nodes in shared memory by
//      ballot rank, and lane k takes the t_k-th; it stops past the
//      largest target;
//   4. cand[p, k] = that node (cap_order[N - 1] where n_feas = 0, the
//      count of csum < t being N), val[p, k] = score there (-inf where
//      n_feas = 0); ok[p] = member[p] & n_feas > 0.
// Every count is an integer and every f32 value in 1-3 an integer-valued
// float below 2^24 or a comparison against one, so the plain version,
// which runs the same steps as [P, N] tensor passes over all N nodes,
// gives the same bits.
//
// Bound: bytes. relaxed [P, N] bool read once (52 MB at 10240 x 5120,
// 0.016 ms at 3.35 TB/s); a row reads only its domain's nodes, and the
// tables (S rows) stay in L2.
//
// The tables around it (:606-641), four more entry points, each exact
// (integers, integer-valued floats, one f64 prefix of integers below
// 2^53 rounded once to f32, as the plain version does):
//   waterfill_members (a thread a pod): s_p (the first DoNotSchedule
//     slot's signature, clamped at 0, slot 0 where there is none, as
//     argmax), member = allowed & a DoNotSchedule slot, and the sort key
//     (gid << 32) + rank, gid = s_p for a member, S otherwise;
//   waterfill_q (a thread a row of those keys sorted by the caller): q =
//     the row's position in its gid's run (a binary search for the run's
//     start), -1 for a non-member;
//   waterfill_cnt (a thread a (signature, domain)): cnt = the domain's
//     count where a node has it (a binary search in dsort), 1e9 where
//     none does;
//   waterfill_fill (a CTA a signature, after the caller's stable sort of
//     cnt): fill = j * csort - presum, presum the exclusive prefix of
//     csort in f64 (a block scan), rounded once; ord_dom as int32.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): every array gains a
// leading [B] axis and blockIdx.y is the tenant.
#include <math.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_K1 = 32;
constexpr int U = 4;  // 32-node steps a walk iteration
constexpr int DO_NOT_SCHEDULE = 0;

__device__ __forceinline__ int floor_div(int a, int m) {  // m > 0
  return a >= 0 ? a / m : -((-a + m - 1) / m);
}

// The number of leading i in [0, n) with pred(i), where pred holds on a
// prefix: each step a lane probes one of 32 evenly spaced positions of
// the open range, and the ballot's popcount cuts it 32-fold. Uniform
// across the warp.
template <class Pred>
__device__ __forceinline__ int prefix_count(int n, Pred pred) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the count lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const int k = __popc(__ballot_sync(FULL, i < hi && pred(i)));
    if (k == 0) break;  // pred(lo) fails
    hi = min(hi, lo + k * step);
    lo = lo + (k - 1) * step + 1;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
waterfill_kernel(int P, int S, int N, int K1, const float* __restrict__ fill,
                 const int* __restrict__ ord_dom,
                 const int* __restrict__ dsort, const int* __restrict__ dnode,
                 const int* __restrict__ s_p, const float* __restrict__ q,
                 const bool* __restrict__ relaxed,
                 const int* __restrict__ cap_order,
                 const float* __restrict__ score,
                 const bool* __restrict__ member, int* __restrict__ cand,
                 float* __restrict__ val, bool* __restrict__ ok) {
  __shared__ int s_node[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + warp;
  if (p >= P) return;  // the whole warp
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y, SN = (long long)S * N;
    fill += b * SN;
    ord_dom += b * SN;
    dsort += b * SN;
    dnode += b * SN;
    s_p += b * P;
    q += b * P;
    relaxed += b * P * N;
    cap_order += b * N;
    score += b * P * N;
    member += b * P;
    cand += b * P * K1;
    val += b * P * K1;
    ok += b * P;
  }
  const long long s = s_p[p];
  const float qp = q[p];
  const float* frow = fill + s * N;
  const int c = prefix_count(N, [&](int i) { return frow[i] <= qp; });
  const int j_p = min(max(c - 1, 0), N - 1);
  const int r_i = (int)(qp - frow[j_p]);
  const int m = j_p + 1;
  const int m_p = floor_div(r_i, m);
  const int dchoice = ord_dom[s * N + (r_i - m_p * m)];

  // The chosen domain's nodes: dsort[s, lo:hi].
  const int* drow = dsort + s * N;
  const int* nrow = dnode + s * N;
  const int lo = prefix_count(N, [&](int i) { return drow[i] < dchoice; });
  const int hi = lo + prefix_count(
      N - lo, [&](int i) { return drow[lo + i] == dchoice; });
  const bool* rrow = relaxed + (long long)p * N;

  int f = 0;
  for (int i0 = lo; i0 < hi; i0 += 32 * U) {
    int n[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * 32 + lane;
      n[u] = i < hi ? nrow[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      f += __popc(__ballot_sync(FULL, n[u] >= 0 && rrow[n[u]]));
  }

  int t = 0;
  if (lane < K1) {
    const float x = (float)m_p + (float)lane;
    const float y = fmaxf((float)f, 1.0f);
    float r = fmodf(x, y);
    if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = r + y;
    t = (int)(r + 1.0f);
  }
  const int t_max = __reduce_max_sync(FULL, t);
  const unsigned lt = (1u << lane) - 1u;
  int found = -1, base = 0;
  for (int i0 = lo; i0 < hi && base < t_max; i0 += 32 * U) {
    int n[U];
    bool sel[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * 32 + lane;
      n[u] = i < hi ? nrow[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) sel[u] = n[u] >= 0 && rrow[n[u]];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned bal = __ballot_sync(FULL, sel[u]);
      if (sel[u]) s_node[warp][__popc(bal & lt)] = n[u];
      __syncwarp();
      const int cnt = __popc(bal);
      if (t > base && t <= base + cnt) found = s_node[warp][t - base - 1];
      __syncwarp();
      base += cnt;
    }
  }
  if (lane < K1) {
    const long long o = (long long)p * K1 + lane;
    cand[o] = found >= 0 ? found : cap_order[N - 1];
    val[o] = found >= 0 ? score[(long long)p * N + found] : -INFINITY;
  }
  if (lane == 0) ok[p] = member[p] && f > 0;
}

// The group of a sort key (gid << 32) + rank, for any int32 rank.
__device__ __forceinline__ long long gid_of(long long k) {
  return (k + 0x80000000LL) >> 32;
}

__global__ void __launch_bounds__(THREADS)
waterfill_members_kernel(int P, int C, int S, const int* __restrict__ ts_sig,
                         const bool* __restrict__ ts_valid,
                         const signed char* __restrict__ ts_when,
                         const bool* __restrict__ allowed,
                         const int* __restrict__ rank, int* __restrict__ s_p,
                         bool* __restrict__ member,
                         long long* __restrict__ key) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y;
    ts_sig += b * P * C;
    ts_valid += b * P * C;
    ts_when += b * P * C;
    allowed += b * P;
    rank += b * P;
    s_p += b * P;
    member += b * P;
    key += b * P;
  }
  const long long row = (long long)p * C;
  int first = -1;
  for (int c = 0; c < C && first < 0; ++c)
    if (ts_valid[row + c] && ts_when[row + c] == DO_NOT_SCHEDULE) first = c;
  const int s = max(ts_sig[row + max(first, 0)], 0);
  const bool m = allowed[p] && first >= 0;
  s_p[p] = s;
  member[p] = m;
  key[p] = ((long long)(m ? s : S) << 32) + (long long)rank[p];
}

__global__ void __launch_bounds__(THREADS)
waterfill_q_kernel(int P, int S, const long long* __restrict__ key_s,
                   const long long* __restrict__ perm, float* __restrict__ q) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= P) return;
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y;
    key_s += b * P;
    perm += b * P;
    q += b * P;
  }
  const long long g = gid_of(key_s[i]);
  if (g >= S) {
    q[perm[i]] = -1.0f;
    return;
  }
  int lo = 0, hi = i;  // the run's start: rows before i of a smaller gid
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (gid_of(key_s[mid]) < g) lo = mid + 1; else hi = mid;
  }
  q[perm[i]] = (float)(i - lo);
}

__global__ void __launch_bounds__(THREADS)
waterfill_cnt_kernel(int S, int N, const int* __restrict__ dsort,
                     const float* __restrict__ counts,
                     float* __restrict__ cnt) {
  const long long SN = (long long)S * N, b = blockIdx.y;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= SN) return;
  dsort += b * SN;
  counts += b * SN;
  cnt += b * SN;
  const long long s = i / N;
  const int d = (int)(i - s * N);
  const int* row = dsort + s * N;
  int lo = 0, hi = N;  // the first entry >= d
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < d) lo = mid + 1; else hi = mid;
  }
  cnt[i] = (lo < N && row[lo] == d) ? counts[i] : 1e9f;
}

__global__ void __launch_bounds__(THREADS)
waterfill_fill_kernel(int S, int N, const float* __restrict__ csort,
                      const long long* __restrict__ ord,
                      float* __restrict__ fill, int* __restrict__ ord_dom) {
  __shared__ double s_part[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = ((long long)blockIdx.y * S + blockIdx.x) * N;
  csort += row;
  ord += row;
  fill += row;
  ord_dom += row;
  double run = 0.0;
  for (int j0 = 0; j0 < N; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    const float c = j < N ? csort[j] : 0.0f;
    double v = (double)c;
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) s_part[warp] = v;
    __syncthreads();
    double before = 0.0, all = 0.0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before += s_part[w];
      all += s_part[w];
    }
    __syncthreads();
    if (j < N) {
      const double excl = run + before + v - (double)c;
      fill[j] = (float)j * c - (float)excl;
      ord_dom[j] = (int)ord[j];
    }
    run += all;
  }
}

}  // namespace

extern "C" int tpusched_waterfill_members(int B, int P, int C, int S,
                                          const int* ts_sig,
                                          const bool* ts_valid,
                                          const signed char* ts_when,
                                          const bool* allowed,
                                          const int* rank, int* s_p,
                                          bool* member, long long* key,
                                          void* stream) {
  waterfill_members_kernel<<<dim3((P + THREADS - 1) / THREADS, B), THREADS,
                             0, (cudaStream_t)stream>>>(
      P, C, S, ts_sig, ts_valid, ts_when, allowed, rank, s_p, member, key);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_waterfill_q(int B, int P, int S,
                                    const long long* key_s,
                                    const long long* perm, float* q,
                                    void* stream) {
  waterfill_q_kernel<<<dim3((P + THREADS - 1) / THREADS, B), THREADS, 0,
                       (cudaStream_t)stream>>>(P, S, key_s, perm, q);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_waterfill_cnt(int B, int S, int N, const int* dsort,
                                      const float* counts, float* cnt,
                                      void* stream) {
  const long long SN = (long long)S * N;
  waterfill_cnt_kernel<<<dim3((int)((SN + THREADS - 1) / THREADS), B),
                         THREADS, 0, (cudaStream_t)stream>>>(S, N, dsort,
                                                             counts, cnt);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_waterfill_fill(int B, int S, int N, const float* csort,
                                       const long long* ord, float* fill,
                                       int* ord_dom, void* stream) {
  waterfill_fill_kernel<<<dim3(S, B), THREADS, 0, (cudaStream_t)stream>>>(
      S, N, csort, ord, fill, ord_dom);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_waterfill(int B, int P, int S, int N, int K1,
                                  const float* fill, const int* ord_dom,
                                  const int* dsort, const int* dnode,
                                  const int* s_p, const float* q,
                                  const bool* relaxed, const int* cap_order,
                                  const float* score, const bool* member,
                                  int* cand, float* val, bool* ok,
                                  void* stream) {
  if (K1 < 1 || K1 > MAX_K1) return (int)cudaErrorInvalidValue;
  waterfill_kernel<<<dim3((P + WARPS - 1) / WARPS, B), THREADS, 0,
                     (cudaStream_t)stream>>>(P, S, N, K1, fill, ord_dom,
                                             dsort, dnode, s_p, q, relaxed,
                                             cap_order, score, member, cand,
                                             val, ok);
  return (int)cudaGetLastError();
}
