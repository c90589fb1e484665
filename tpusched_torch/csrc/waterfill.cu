// K12: the per-pod [P, N] part of the spread water-fill dealer.
//
// Replaces tpusched/kernels/assign.py:563 _spread_waterfill_deal from its
// `fill` table on (:636-698). The caller computes, in torch over [S, N]
// and [P], each pod's signature s_p, its 0-based position q among this
// round's members of s_p (in rank order), the per-signature fill-level
// table `fill` (domains by ascending count, `j * csort - presum`, with
// the 1e9 stand-in for absent domains), the domain order `ord_dom` and
// the nodes' free-capacity order `cap_order`. One CTA per pod row then:
//   1. j_p  = (count of fill[s_p, n] <= q over n) - 1, clipped to [0, N);
//      r_i = (int)(q - fill[s_p, j_p]) (truncation, as astype(int32));
//      the domain ord_dom[s_p, r_i mod (j_p + 1)] and the level offset
//      m_p = r_i div (j_p + 1) (floor division and modulo, as jnp's);
//   2. sel[n] = relaxed[p, n] & (node n in that domain); n_feas = #sel;
//   3. targets t_k = fmod-mod(m_p + k, max(n_feas, 1)) + 1 for k <= K
//      (jnp.mod's sign rule), and, walking the nodes in cap_order with a
//      block-wide running count of sel, the position of the t_k-th
//      selected node (N where there is none, as the count of csum < t);
//   4. cand[p, k] = cap_order[min(pos, N - 1)], val[p, k] = score there
//      where sel, else -inf; ok[p] = member[p] & n_feas > 0.
// Every count is an integer and every f32 value in 1-3 an integer-valued
// float below 2^24 or a comparison against one, so the plain version,
// which runs the same steps as [P, N] tensor passes, gives the same bits.
// j_p is the count the JAX code defines, not a binary search: fill mixes
// real counts with the 1e9 sentinel, and only the real entries (exact
// integers, all below any sentinel entry) can be <= q.
//
// Bound: bytes. relaxed [P, N] bool read once (52 MB at 10240 x 5120,
// 0.016 ms at 3.35 TB/s); the pass over cap_order reads it again through
// L1/L2, and fill/dom rows (S of them) and cap_order stay in L2.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): every array gains a
// leading [B] axis and CTA (p, b) = (blockIdx.x, blockIdx.y) deals pod p
// of tenant b from its tenant's tables.
#include <math.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K1 = 32;

// Block-wide sum of an int, in every thread.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < WARPS; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// Block-wide inclusive scan of a 0/1 flag; *total gets the block's sum.
__device__ __forceinline__ int block_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) before += scratch[w];
    all += scratch[w];
  }
  __syncthreads();
  *total = all;
  return before + v;
}

__device__ __forceinline__ int floor_div(int a, int m) {  // m > 0
  return a >= 0 ? a / m : -((-a + m - 1) / m);
}

__global__ void __launch_bounds__(THREADS)
waterfill_kernel(int P, int S, int N, int K1, const float* __restrict__ fill,
                 const int* __restrict__ ord_dom, const int* __restrict__ dom,
                 const int* __restrict__ s_p, const float* __restrict__ q,
                 const bool* __restrict__ relaxed,
                 const int* __restrict__ cap_order,
                 const float* __restrict__ score,
                 const bool* __restrict__ member, int* __restrict__ cand,
                 float* __restrict__ val, bool* __restrict__ ok) {
  __shared__ int scratch[WARPS];
  __shared__ int s_t[MAX_K1], s_pos[MAX_K1];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y, SN = (long long)S * N;
    fill += b * SN;
    ord_dom += b * SN;
    dom += b * SN;
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
  const int* drow = dom + s * N;
  const bool* rrow = relaxed + (long long)p * N;

  int c = 0;
  for (int n = tid; n < N; n += THREADS) c += frow[n] <= qp ? 1 : 0;
  c = block_sum(c, scratch);
  const int j_p = min(max(c - 1, 0), N - 1);
  const float r_p = qp - frow[j_p];
  const int r_i = (int)r_p;
  const int m = j_p + 1;
  const int m_p = floor_div(r_i, m);
  const int slot = r_i - m_p * m;
  const int dchoice = ord_dom[s * N + slot];

  int f = 0;
  for (int n = tid; n < N; n += THREADS)
    f += (rrow[n] && drow[n] == dchoice) ? 1 : 0;
  f = block_sum(f, scratch);

  if (tid < K1) {
    const float x = (float)m_p + (float)tid;
    const float y = fmaxf((float)f, 1.0f);
    float r = fmodf(x, y);
    if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = r + y;
    s_t[tid] = (int)(r + 1.0f);
    s_pos[tid] = N;
  }
  __syncthreads();
  int t_max = 0;
  for (int k = 0; k < K1; ++k) t_max = max(t_max, s_t[k]);

  int base = 0;
  for (int j0 = 0; j0 < N && base < t_max && base < f; j0 += THREADS) {
    const int j = j0 + tid;
    int flag = 0;
    if (j < N) {
      const int n = cap_order[j];
      flag = (rrow[n] && drow[n] == dchoice) ? 1 : 0;
    }
    int total;
    const int incl = block_scan(flag, scratch, &total);
    if (flag)
      for (int k = 0; k < K1; ++k)
        if (s_t[k] == base + incl) s_pos[k] = j;
    base += total;
  }
  __syncthreads();
  if (tid < K1) {
    const int n = cap_order[min(s_pos[tid], N - 1)];
    const long long o = (long long)p * K1 + tid;
    cand[o] = n;
    val[o] = (rrow[n] && drow[n] == dchoice) ? score[(long long)p * N + n]
                                              : -INFINITY;
  }
  if (tid == 0) ok[p] = member[p] && f > 0;
}

}  // namespace

extern "C" int tpusched_waterfill(int B, int P, int S, int N, int K1,
                                  const float* fill,
                                  const int* ord_dom, const int* dom,
                                  const int* s_p, const float* q,
                                  const bool* relaxed, const int* cap_order,
                                  const float* score, const bool* member,
                                  int* cand, float* val, bool* ok,
                                  void* stream) {
  if (K1 > MAX_K1) return (int)cudaErrorInvalidValue;
  waterfill_kernel<<<dim3(P, B), THREADS, 0, (cudaStream_t)stream>>>(
      P, S, N, K1, fill, ord_dom, dom, s_p, q, relaxed, cap_order, score, member,
      cand, val, ok);
  return (int)cudaGetLastError();
}
