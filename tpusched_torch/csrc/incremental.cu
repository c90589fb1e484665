// The incremental warm solve's two passes over the carried placements.
//
// K19 capacity_prefix_keep replaces tpusched/kernels/assign.py:2227
// _capacity_prefix_keep: per node, the longest rank-ordered prefix of the
// carried pods whose summed requests fit allocatable - used, for every
// resource. The caller sorts the rows by (node, rank) with the library
// sort (inactive rows last, node N); one thread walks each node's run of
// rows, its running sums per resource starting at 0.0 and adding one row
// at a time, and stops at the first misfit (JAX's cummax of the last
// misfit). The sums stay within the node: JAX's global cumsum less the
// segment's offset cancels ~1e7 bytes a term at config-5 magnitudes
// (ROADMAP C5). The plain version adds in the same order. Bound: bytes,
// the sorted index arrays, the requests and the two [N, R] tables read
// once, the [P] output written once.
//
// K20 frontier_closure replaces the frontier closure and the first
// revalidation pass of solve_incremental (assign.py:2328-2340): hot[s] =
// any over pods of invol[p, s] & fr0[p] & valid[p] (first launch, a
// thread a pod, plain stores of 1); then a thread a pod: fr = fr0 & valid
// | any_s(invol[p, s] & hot[s]) | (carry >= 0 & dirty_node[carry]),
// carried = valid & carry >= 0 & !fr & mask[p, carry], and the frontier
// count (pods without a carry, or in the frontier) by an integer atomic
// add, exact in any order. carry is -1 where a pod carries nothing.
// Bound: bytes, invol [P, S] read twice, the [P] vectors once, one mask
// byte a carried pod.
#include "kernels.h"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_R = 16;

__global__ void capacity_prefix_keep_kernel(int P, int N, int R,
                                            const int* __restrict__ perm,
                                            const int* __restrict__ node_s,
                                            const float* __restrict__ req,
                                            const float* __restrict__ alloc,
                                            const float* __restrict__ used,
                                            bool* __restrict__ keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const int n = node_s[i];
  if (n >= N) return;                        // inactive rows sort last
  if (i > 0 && node_s[i - 1] == n) return;   // not the node's first row
  float run[MAX_R];
  for (int r = 0; r < R; ++r) run[r] = 0.0f;
  const float* a = alloc + (long long)n * R;
  const float* u = used + (long long)n * R;
  for (int j = i; j < P && node_s[j] == n; ++j) {
    const int p = perm[j];
    const float* q = req + (long long)p * R;
    bool fits = true;
    for (int r = 0; r < R; ++r) {
      run[r] = run[r] + q[r];
      fits = fits && (u[r] + run[r] <= a[r]);
    }
    if (!fits) return;
    keep[p] = true;
  }
}

__global__ void frontier_hot_kernel(int P, int S,
                                    const bool* __restrict__ invol,
                                    const bool* __restrict__ fr0,
                                    const bool* __restrict__ valid,
                                    int* __restrict__ hot) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P || !(fr0[p] && valid[p])) return;
  const bool* row = invol + (long long)p * S;
  for (int s = 0; s < S; ++s)
    if (row[s]) hot[s] = 1;
}

__global__ void frontier_pods_kernel(int P, int N, int S,
                                     const bool* __restrict__ invol,
                                     const bool* __restrict__ fr0,
                                     const bool* __restrict__ valid,
                                     const int* __restrict__ carry,
                                     const bool* __restrict__ dirty_node,
                                     const bool* __restrict__ mask,
                                     const int* __restrict__ hot,
                                     bool* __restrict__ fr,
                                     bool* __restrict__ carried,
                                     int* __restrict__ count) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const bool v = valid[p];
  bool f = fr0[p] && v;
  if (S > 0) {
    const bool* row = invol + (long long)p * S;
    for (int s = 0; s < S && !f; ++s) f = row[s] && hot[s] != 0;
  }
  const int c = carry[p];
  const bool has = c >= 0;
  if (dirty_node != nullptr && has && dirty_node[c]) f = true;
  fr[p] = f;
  carried[p] = v && has && !f && mask[(long long)p * N + c];
  if ((v && !has) || f) atomicAdd(count, 1);
}

}  // namespace

extern "C" int tpusched_capacity_prefix_keep(int P, int N, int R,
                                             const int* perm,
                                             const int* node_s,
                                             const float* requests,
                                             const float* alloc,
                                             const float* used, bool* keep,
                                             void* stream) {
  capacity_prefix_keep_kernel<<<(P + THREADS - 1) / THREADS, THREADS, 0,
                                (cudaStream_t)stream>>>(
      P, N, R, perm, node_s, requests, alloc, used, keep);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_frontier_closure(int P, int N, int S,
                                         const bool* invol, const bool* fr0,
                                         const bool* valid, const int* carry,
                                         const bool* dirty_node,
                                         const bool* mask, int* hot,
                                         bool* fr, bool* carried, int* count,
                                         void* stream) {
  const int blocks = (P + THREADS - 1) / THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (S > 0) {
    frontier_hot_kernel<<<blocks, THREADS, 0, st>>>(P, S, invol, fr0, valid,
                                                    hot);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  frontier_pods_kernel<<<blocks, THREADS, 0, st>>>(
      P, N, S, invol, fr0, valid, carry, dirty_node, mask, hot, fr, carried,
      count);
  return (int)cudaGetLastError();
}
