// K8: one capacity-prefix commit sub-step of a fast round.
//
// Replaces the body of tpusched/kernels/assign.py:894-957 (_deal_commit's
// `sub`, cum_width=None). The caller sorts the active candidates by
// (node, rank) with a library sort and passes the permutation `perm` and
// the sorted nodes `cand_s` (N marks an inactive row; those sort last).
// Then, per sorted row i with segment start s (the first row of its
// node):
//   cum     = inclusive prefix of the active rows' requests, over all rows
//   within  = cum[i] - (s > 0 ? cum[s - 1] : 0)       (JAX's association)
//   fits    = active & forall r: used[n] + within <= alloc[n]
//   commit  = fits & no non-fitting row in [s, i]
// and scatters back through perm: choice = node and ptr = KC on a
// commit, ptr + 1 on a row that did not fit.
//
// Fixed orders, so the plain version agrees bit for bit:
//  * the prefix is a Hillis-Steele scan (step d adds the row d back, for
//    d = 1, 2, 4, ...), which the plain version runs as whole-tensor
//    adds;
//  * `used` gains each node's commits one at a time in ascending rank,
//    by the thread of the node's segment. JAX adds them with a
//    duplicate-index f32 scatter-add whose order is unspecified (an
//    atomic add on CUDA, whose rounding changes run to run).
//
// The node_add entry point replaces assign.py:701 _node_add (the
// validator's reverts, sign = -1, in the rounds with signatures): the
// caller sorts the masked rows by (node, rank), masked-out rows last with
// node N; one thread per node segment adds its rows' sign * requests into
// used, one row at a time in ascending rank, as the sub-step commits them.
// JAX adds each segment's total (a prefix sum) at once, a different
// association (so `used` agrees with JAX's to rounding, not bitwise); the
// order here depends only on the rows' ranks, so a compacted view adds
// exactly what the full width adds. Bound: bytes, [P, R] read once. A
// tenant batch (tpusched/tenants.py:75 solve_many) sorts each tenant's
// rows on their own ([B, P] perm and node_s, [B, P, R] requests, [B, N, R]
// used); blockIdx.y is the tenant, so each node's adds stay in its
// tenant's rows, in the same rank order as a solo call.
//
// Bound: latency. The work is O(P log P) adds over [P] x R (P = 10240 at
// the headline), far below a microsecond of bandwidth; what costs is the
// dependent chain of log2(P) scan steps per resource, each a block
// barrier. One CTA does it all, with its scratch in global memory (L1
// serves it), so P is not bounded by shared memory.
//
// Tenant axis (tpusched/tenants.py:75 solve_many, prefix_commit only):
// gridDim.x = B, and CTA b runs tenant b's sub-step on its own rows
// ([B, P] perm with the tenant's own pod indices, sorted nodes, choice
// and ptr, [B, P, R] requests, [B, N, R] allocatable and usage, its own
// scratch). node_add keeps its solo form.
#include <limits.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
prefix_commit_kernel(int P, int N, int R, int KC, const int* __restrict__ perm,
                     const int* __restrict__ cand_s,
                     const float* __restrict__ req,
                     const float* __restrict__ alloc, float* used,
                     int* choice, int* ptr, float* buf_a, float* buf_b,
                     int* seg, int* first_bad, unsigned char* fit) {
  const int tid = threadIdx.x;
  {  // CTA b runs tenant b's sub-step.
    const long long b = blockIdx.x;
    perm += b * P;
    cand_s += b * P;
    req += b * P * R;
    alloc += b * N * R;
    used += b * N * R;
    choice += b * P;
    ptr += b * P;
    buf_a += b * 2 * P;
    buf_b += b * 2 * P;
    seg += b * 2 * P;
    first_bad += b * 2 * P;
    fit += b * P;
  }
  for (int i = tid; i < P; i += THREADS) {
    const int c = cand_s[i];
    int lo = 0, hi = i;  // first row of node c (cand_s is sorted)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cand_s[mid] < c) lo = mid + 1; else hi = mid;
    }
    seg[i] = lo;
    first_bad[i] = INT_MAX;
    fit[i] = c < N ? 1 : 0;
  }
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    for (int i = tid; i < P; i += THREADS)
      buf_a[i] = cand_s[i] < N ? req[(long long)perm[i] * R + r] : 0.0f;
    __syncthreads();
    float* src = buf_a;
    float* dst = buf_b;
    for (int d = 1; d < P; d <<= 1) {
      for (int i = tid; i < P; i += THREADS)
        dst[i] = i >= d ? src[i] + src[i - d] : src[i];
      __syncthreads();
      float* t = src;
      src = dst;
      dst = t;
    }
    for (int i = tid; i < P; i += THREADS) {
      const int n = cand_s[i];
      if (n >= N) continue;
      const int s = seg[i];
      const float within = src[i] - (s > 0 ? src[s - 1] : 0.0f);
      const long long o = (long long)n * R + r;
      if (!(used[o] + within <= alloc[o])) fit[i] = 0;
    }
    __syncthreads();
  }
  for (int i = tid; i < P; i += THREADS)
    if (cand_s[i] < N && !fit[i]) atomicMin(&first_bad[seg[i]], i);
  __syncthreads();
  for (int i = tid; i < P; i += THREADS) {
    const int n = cand_s[i];
    if (n >= N) continue;
    const int s = seg[i];
    const int stop = first_bad[s];
    const int q = perm[i];
    if (fit[i] && i < stop) {
      choice[q] = n;
      ptr[q] = KC;
    } else if (!fit[i]) {
      ptr[q] = ptr[q] + 1;
    }
    if (s == i && fit[i] && i < stop) {
      // The node's committed rows are the prefix [i, stop) of its segment.
      for (int r = 0; r < R; ++r) {
        const long long o = (long long)n * R + r;
        float u = used[o];
        for (int j = i; j < P && j < stop && cand_s[j] == n; ++j)
          u = u + req[(long long)perm[j] * R + r];
        used[o] = u;
      }
    }
  }
}

__global__ void node_add_kernel(int P, int N, int R,
                                const int* __restrict__ perm,
                                const int* __restrict__ node_s,
                                const float* __restrict__ req, float sign,
                                float* __restrict__ used) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y;
    perm += b * P;
    node_s += b * P;
    req += b * P * R;
    used += b * N * R;
  }
  const int n = node_s[i];
  if (n >= N || (i > 0 && node_s[i - 1] == n)) return;
  for (int r = 0; r < R; ++r) {
    const long long o = (long long)n * R + r;
    float u = used[o];
    for (int j = i; j < P && node_s[j] == n; ++j)
      u = u + sign * req[(long long)perm[j] * R + r];
    used[o] = u;
  }
}

}  // namespace

extern "C" int tpusched_node_add(int B, int P, int N, int R, const int* perm,
                                 const int* node_s, const float* req,
                                 int sign, float* used, void* stream) {
  const int threads = 256;
  node_add_kernel<<<dim3((P + threads - 1) / threads, B), threads, 0,
                    (cudaStream_t)stream>>>(P, N, R, perm, node_s, req,
                                            (float)sign, used);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_prefix_commit(int B, int P, int N, int R, int KC,
                                      const int* perm, const int* cand_s,
                                      const float* req, const float* alloc,
                                      float* used, int* choice, int* ptr,
                                      float* buf_f, int* buf_i,
                                      unsigned char* fit, void* stream) {
  prefix_commit_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      P, N, R, KC, perm, cand_s, req, alloc, used, choice, ptr, buf_f,
      buf_f + P, buf_i, buf_i + P, fit);
  return (int)cudaGetLastError();
}
