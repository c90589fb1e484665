// K25 ring_hop: one hop of the blockwise pairwise count ring, the
// match of a signature block against a resident member block fused with
// the count of the matches by domain.
//
// Replaces the per-hop body of tpusched/ring.py:76 ring_sig_counts
// (:123-149, match_block and body: gather_term_sat, ns_scope_ok and the
// scatter-add of the [sblk, mblk] contributions into counts [sblk, N]).
// For signature s of the block and member m of the resident block:
//
//   match[s, m] = AND over s's atoms of msat[atom, m] (slot -1: true)
//                 & (ns_all[s] | ns[s, k] == mns[m] for some k)
//                 & svalid[s] & mvalid[m]
//   dom[s, m]   = ndom[mnode[m], skey[s]] if skey[s] >= 0, mnode[m] >= 0
//                 and the snapshot has topology keys, else -1
//   counts[s, dom[s, m]] += 1.0f where match[s, m] and dom[s, m] >= 0
//
// so the [S, M+P] match (K9's output) is never written. One thread per
// (s, m), s from blockIdx.y, so a warp shares its signature: lanes that
// add to the same domain (a zone-like key sends most members to a few)
// are grouped by __match_any_sync and their leader adds the group's
// count with one atomicAdd. Every add is a whole number of members and
// every count stays below 2^24 (a cluster has fewer members), so each
// partial sum is an exact integer in f32 and the result equals the dense
// count (K10) bit for bit whatever order the atomics land in.
//
// An atom id at or past A (the only ids an atom-less snapshot, A = 0,
// could hold) is unsatisfied: the port's K9 gives the same at A = 0 for
// any id >= 0. Namespace ids compare as they are, padding included (the
// JAX function's rule). A domain id at or past N is not added (the
// snapshot keeps ids below its node bucket).
//
// Bound: bytes; msat [A, mblk] bool, the member vectors (9 bytes a
// member) and counts [sblk, N] read and written once. The atomics of a
// hot domain are the latency to watch; the warp aggregation cuts them
// by up to 32x.
#include "kernels.h"

namespace {

constexpr int HOP_THREADS = 256;

__global__ void ring_hop_kernel(int A, int mblk, int AT, int NS, int N,
                                int TK, const bool* __restrict__ msat,
                                const int* __restrict__ mnode,
                                const bool* __restrict__ mvalid,
                                const int* __restrict__ mns,
                                const int* __restrict__ skey,
                                const int* __restrict__ satoms,
                                const int* __restrict__ sns,
                                const bool* __restrict__ snsall,
                                const bool* __restrict__ svalid,
                                const int* __restrict__ ndom,
                                float* counts) {
  const int s = blockIdx.y;
  const int m = blockIdx.x * HOP_THREADS + threadIdx.x;
  bool hit = m < mblk && svalid[s] && mvalid[m];
  for (int k = 0; k < AT && hit; ++k) {
    const int a = satoms[s * AT + k];
    if (a >= 0) hit = a < A && msat[(long long)a * mblk + m];
  }
  if (hit && !snsall[s]) {
    bool in = false;
    const int ns_m = mns[m];
    for (int k = 0; k < NS; ++k) in = in || sns[s * NS + k] == ns_m;
    hit = in;
  }
  int d = -1;
  if (hit) {
    const int key = skey[s], node = mnode[m];
    if (key >= 0 && node >= 0 && TK > 0) d = ndom[(long long)node * TK + key];
    hit = d >= 0 && d < N;
  }
  const unsigned active = __ballot_sync(0xffffffffu, hit);
  if (!hit) return;
  const unsigned peers = __match_any_sync(active, d);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&counts[(long long)s * N + d], (float)__popc(peers));
}

}  // namespace

extern "C" int tpusched_ring_hop(int A, int mblk, int sblk, int AT, int NS,
                                 int N, int TK, const bool* msat,
                                 const int* mnode, const bool* mvalid,
                                 const int* mns, const int* skey,
                                 const int* satoms, const int* sns,
                                 const bool* snsall, const bool* svalid,
                                 const int* ndom, float* counts,
                                 void* stream) {
  const dim3 blocks((mblk + HOP_THREADS - 1) / HOP_THREADS, sblk);
  ring_hop_kernel<<<blocks, HOP_THREADS, 0, (cudaStream_t)stream>>>(
      A, mblk, AT, NS, N, TK, msat, mnode, mvalid, mns, skey, satoms, sns,
      snsall, svalid, ndom, counts);
  return (int)cudaGetLastError();
}
