// K13: the DoNotSchedule spread validator of the fast rounds, two entry
// points.
//
// Replaces tpusched/kernels/assign.py:1093 _spread_excess_mask, which for
// each spread slot c reverts the kept members of each (signature, domain)
// group beyond the longest rank-ordered prefix whose size respects every
// prefix member's skew allowance against the end-of-round counts.
//
// excess_min: min_end[p] = min over nodes n of counts[s_p, dom[s_p, n]]
// where n is valid, aff_ok[p, n] and n has the key (0 if there is none),
// the [P, N] pass (:1127-1134). One CTA per pod row; min is exact in any
// order. Bound: bytes, aff_ok [P, N] bool read once (52 MB at 10240 x
// 5120, 0.016 ms at 3.35 TB/s).
//
// excess_survive: after the caller's torch.sort of the rows by (group,
// rank) (non-members in one group after every real one), per group the
// running member count q (1-based) and the running minimum of the members'
// allowances T; a member survives iff b_fixed + q <= that minimum, and
// bad = member & !survive (:1147-1172). One thread per group walks its
// rows in rank order: a running min and a count, both exact, so the plain
// version's log-step segmented scan gives the same bits. The non-member
// group is not walked (its rows are never bad). Bound: the walk's length,
// the largest group (O(P) bytes in all).
//
// Tenant axis (tpusched/tenants.py:75 solve_many): both entry points take
// B first and every array gains a leading [B] axis; blockIdx.y is the
// tenant. The caller sorts each tenant's rows on their own, so a group's
// segment never runs into the next tenant's rows.
#include <math.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
excess_min_kernel(int P, int S, int N, const int* __restrict__ dom,
                  const float* __restrict__ counts,
                  const bool* __restrict__ node_valid,
                  const bool* __restrict__ aff_ok,
                  const int* __restrict__ s_c, float* __restrict__ min_end) {
  __shared__ float scratch[WARPS];
  const int p = blockIdx.x;
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y, SN = (long long)S * N;
    dom += b * SN;
    counts += b * SN;
    node_valid += b * N;
    aff_ok += b * P * N;
    s_c += b * P;
    min_end += b * P;
  }
  const long long s = s_c[p];
  const int* drow = dom + s * N;
  const bool* arow = aff_ok + (long long)p * N;
  float lo = INFINITY;
  for (int n = threadIdx.x; n < N; n += THREADS) {
    const int d = drow[n];
    if (d >= 0 && node_valid[n] && arow[n]) lo = fminf(lo, counts[s * N + d]);
  }
  for (int off = 16; off > 0; off >>= 1)
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = lo;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) lo = fminf(lo, scratch[w]);
    min_end[p] = isinf(lo) ? 0.0f : lo;
  }
}

__global__ void excess_survive_kernel(int P, const int* __restrict__ gid_s,
                                      const int* __restrict__ perm,
                                      const bool* __restrict__ member,
                                      const float* __restrict__ T,
                                      const float* __restrict__ b_fixed,
                                      bool* __restrict__ bad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y;
    gid_s += b * P;
    perm += b * P;
    member += b * P;
    T += b * P;
    b_fixed += b * P;
    bad += b * P;
  }
  const int p0 = perm[i];
  if (!member[p0]) {
    bad[p0] = false;
    return;
  }
  const int g = gid_s[i];
  if (i > 0 && gid_s[i - 1] == g) return;
  // Members of a real group only: every row of this segment is a member.
  float q = 0.0f, pm = INFINITY;
  for (int j = i; j < P && gid_s[j] == g; ++j) {
    const int p = perm[j];
    q = q + 1.0f;
    pm = fminf(pm, T[p]);
    bad[p] = !(b_fixed[p] + q <= pm);
  }
}

}  // namespace

extern "C" int tpusched_excess_min(int B, int P, int S, int N, const int* dom,
                                   const float* counts,
                                   const bool* node_valid, const bool* aff_ok,
                                   const int* s_c, float* min_end,
                                   void* stream) {
  excess_min_kernel<<<dim3(P, B), THREADS, 0, (cudaStream_t)stream>>>(
      P, S, N, dom, counts, node_valid, aff_ok, s_c, min_end);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_excess_survive(int B, int P, const int* gid_s,
                                       const int* perm, const bool* member,
                                       const float* T, const float* b_fixed,
                                       bool* bad, void* stream) {
  excess_survive_kernel<<<dim3((P + THREADS - 1) / THREADS, B), THREADS, 0,
                          (cudaStream_t)stream>>>(P, gid_s, perm, member, T,
                                                  b_fixed, bad);
  return (int)cudaGetLastError();
}
