// K24: a fast tranche's pick, the C lowest-rank pending pods.
//
// Replaces tpusched/kernels/assign.py:996 _top_by_rank. Over the pods in
// pop order (`order`, rank-major), with pend_rm[i] = pend[order[i]]:
//   slot[i] = #pending before i              where pend_rm[i]
//             n_pend + #non-pending before i  elsewhere
//   buf[slot[i]] = order[i]  for slot[i] < C,   n_pend = #pending
// so buf holds the C lowest-rank pending pods by rank, then non-pending
// ones by rank (every slot a distinct pod). The counts are int32 sums,
// exact in any order, so a block scan gives the plain version's slots.
//
// Bound: bytes, [P] flags and order read once and [C] written: about a
// microsecond at 3.35 TB/s, so in practice launch latency. One CTA per
// tenant: each thread counts a contiguous chunk of the rank-major flags,
// a block scan of the chunk counts gives each chunk's offsets, and the
// thread walks its chunk again to place its pods.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): CTA b picks tenant
// b's tranche from its own [B, P] flags and order into buf [B, C]. A solo
// call is B = 1.
#include "kernels.h"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

// Exclusive prefix of v over the block's threads in thread order, and
// the block's total.
__device__ __forceinline__ int block_excl_scan(int v, int* s_warp,
                                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = s_warp[lane];
    int wincl = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, wincl, off);
      if (lane >= off) wincl += o;
    }
    s_warp[lane] = wincl - w;
    if (lane == 31) *total = wincl;
  }
  __syncthreads();
  return s_warp[warp] + incl - v;
}

__global__ void __launch_bounds__(THREADS)
top_by_rank_kernel(int P, int C, const bool* __restrict__ pend,
                   const long long* __restrict__ order,
                   long long* __restrict__ buf,
                   long long* __restrict__ n_pend) {
  __shared__ int s_warp[WARPS];
  __shared__ int s_total;
  const long long b = blockIdx.x;
  pend += b * P;
  order += b * P;
  buf += b * C;
  const int chunk = (P + THREADS - 1) / THREADS;
  const int lo = min((int)threadIdx.x * chunk, P);
  const int hi = min(lo + chunk, P);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += pend[order[i]] ? 1 : 0;
  int cp = block_excl_scan(cnt, s_warp, &s_total);
  const int total = s_total;
  int cn = lo - cp;  // non-pending pods before the chunk
  for (int i = lo; i < hi; ++i) {
    const int slot = pend[order[i]] ? cp++ : total + cn++;
    if (slot < C) buf[slot] = order[i];
  }
  if (threadIdx.x == 0) n_pend[b] = total;
}

}  // namespace

extern "C" int tpusched_top_by_rank(int B, int P, int C, const bool* pend,
                                    const long long* order, long long* buf,
                                    long long* n_pend, void* stream) {
  top_by_rank_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      P, C, pend, order, buf, n_pend);
  return (int)cudaGetLastError();
}
