// K15's standalone entry point: one preemptor's victim search in one CTA
// (preempt.cuh), for the tests and the kernel phase of chip_smoke.py; the
// parity scan runs the same device function inside K4 (scan.cu). The
// victim table comes as kernels/preempt.precompute builds it: the node
// offsets, the [V, N] planes and the sorted order; the evictions so far
// come in the sorted order (ev_s, a scratch copy the kernel marks).
//
// Replaces tpusched/kernels/preempt.py:317 preempt_step for one pod.
// Outputs: best[0] = the chosen node (0 when nothing fits, as JAX's
// argmin of an all-inf row), best[1] = can, evict_m [M] (zeros on entry)
// marks the chosen victims, freed [R] (zeros on entry) their requests
// summed in sorted order.
#include "kernels.h"
#include "preempt.cuh"

namespace {

using tpusched::MAX_R;
using tpusched::PRE_THREADS;

__global__ void __launch_bounds__(PRE_THREADS)
preempt_step_kernel(tpusched::Victims v, const float* __restrict__ p_prio,
                    const float* __restrict__ p_req,
                    const unsigned char* __restrict__ allowed,
                    const bool* __restrict__ node_valid,
                    const float* __restrict__ used,
                    const float* __restrict__ alloc, unsigned char* ev_s,
                    const float* __restrict__ remaining, int* best,
                    unsigned char* evict_m, float* freed_out) {
  __shared__ tpusched::PreemptSmem sh;
  float rq[MAX_R];
  for (int r = 0; r < MAX_R; ++r) rq[r] = r < v.R ? p_req[r] : 0.0f;
  int n;
  const float prio = *p_prio;
  const int bp = tpusched::preempt_search(v, sh, prio, rq, allowed,
                                          node_valid, used, alloc, ev_s,
                                          remaining, &n);
  if (threadIdx.x != 0) return;
  if (bp < 0) {
    best[0] = 0;
    best[1] = 0;
    return;
  }
  float freed[MAX_R];
  tpusched::preempt_take(v, n, bp, prio, ev_s, freed,
                         [&](int m, int) { evict_m[m] = 1; });
  best[0] = n;
  best[1] = 1;
  for (int r = 0; r < v.R; ++r) freed_out[r] = freed[r];
}

}  // namespace

extern "C" int tpusched_preempt_step(
    int N, int R, int M, int GP, int V, const int* off, const int* pl_vic,
    const float* pl_req, const int* perm, const float* cost_s,
    const float* vprio_s, const float* req_s, const int* pdb_s, float margin,
    const float* p_prio, const float* p_req, const bool* allowed,
    const bool* node_valid, const float* used, const float* alloc,
    unsigned char* ev_s, const float* remaining, int* best, bool* evict_m,
    float* freed, void* stream) {
  if (R > MAX_R) return (int)cudaErrorInvalidValue;
  tpusched::Victims v{M,      N,      R,       GP,     V,
                      margin, off,    (const int4*)pl_vic, pl_req, perm,
                      cost_s, vprio_s, req_s,  pdb_s};
  preempt_step_kernel<<<1, PRE_THREADS, 0, (cudaStream_t)stream>>>(
      v, p_prio, p_req, (const unsigned char*)allowed, node_valid, used,
      alloc, ev_s, remaining, best, (unsigned char*)evict_m, freed);
  return (int)cudaGetLastError();
}
