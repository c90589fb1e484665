// K26 tableau_nv: every bidder's exact victim-prefix tableau on the
// node-major victim table.
//
// Replaces tpusched/kernels/preempt.py:169 _tableau_nv: for C bidders
// (priority p_prio[c], requests p_req[c]) and the table of each node's
// first V victims by cost (precompute_nv), per (c, n, v)
//
//   elig  = real victim, not evicted, vprio + margin < p_prio[c]
//   wreq  = the eligible victims' requests summed over v' <= v
//   fits  = elig & all over r of (used[n, r] - wreq[r]) + p_req[c, r]
//           <= alloc[n, r]
//   wcost = the eligible victims' cost summed over v' <= v
//   wviol = the number of violating victims at or before v (int32), a
//           victim violating when the eligible victims of its budget at
//           or before it on its node outnumber the budget's remaining
//           disruptions
//
// and per (c, n) the lexicographic (violations, cost) minimum over the
// fitting prefixes: node_viol = min wviol over fits (+inf if none),
// node_cost = min wcost over the fitting prefixes at node_viol.
//
// One thread per (b, c, n) walks the node's V <= 32 victims with the R <= 8
// request sums, the cost sum and the violation count in registers (the
// eligible victims as a bit mask for the budget counts), so JAX's
// [C, N, V, R] request prefix (1 GB at fast (h)'s first auction round) is
// never written. Every f32 prefix is summed from 0.0 left to right, the
// port's `vprefix` order (preempt.py's plain version), and the running
// minimum compares as `amin` does, so each output equals the plain
// version bit for bit (--fmad=false keeps used - wreq + p_req two
// roundings). A CTA of 128 threads owns 128 consecutive (c, n) rows,
// whose V-long outputs are one contiguous run of each output: the thread
// stages its row in shared memory and the CTA writes the runs with
// consecutive threads on consecutive elements.
//
// Bound: bytes, the [C, N, V] outputs (10 bytes a cell) and [C, N] minima
// written once: 0.26 ms at [1 024, 5 120, 16] on 3.35 TB/s; the victim
// table and the bidders' rows are read from L2.
//
// Tenant axis: B tenants of C bidders each, row (b * C + c) * N + n
// reading tenant b's victim table, evictions, usage, capacity and
// budgets.
#include <math.h>

#include "kernels.h"

namespace {

constexpr int NV_THREADS = 128;
constexpr int NV_MAXV = 32;
constexpr int NV_MAXR = 8;

__global__ void __launch_bounds__(NV_THREADS)
tableau_nv_kernel(int B, int C, int N, int V, int R, int M, int GP,
                  const float* __restrict__ vreq,
                  const float* __restrict__ vcost,
                  const float* __restrict__ vprio,
                  const int* __restrict__ vpdb,
                  const bool* __restrict__ vvalid,
                  const int* __restrict__ vidx,
                  const bool* __restrict__ evicted,
                  const float* __restrict__ p_prio,
                  const float* __restrict__ p_req,
                  const float* __restrict__ used,
                  const float* __restrict__ alloc,
                  const float* __restrict__ remaining, float margin,
                  bool* __restrict__ elig_out, float* __restrict__ wcost_out,
                  int* __restrict__ wviol_out, bool* __restrict__ fits_out,
                  float* __restrict__ node_viol,
                  float* __restrict__ node_cost) {
  __shared__ bool s_elig[NV_THREADS * NV_MAXV];
  __shared__ bool s_fits[NV_THREADS * NV_MAXV];
  __shared__ float s_cost[NV_THREADS * NV_MAXV];
  __shared__ int s_viol[NV_THREADS * NV_MAXV];
  const long long rows = (long long)B * C * N;
  const long long first = (long long)blockIdx.x * NV_THREADS;
  const long long i = first + threadIdx.x;
  if (i < rows) {
    const long long b = i / ((long long)C * N);
    const long long bc = i / N;  // b * C + c
    const int n = (int)(i % N);
    evicted += b * M;
    remaining += b * GP;
    const long long node = b * N + n;
    const long long row = node * V;
    const float prio = p_prio[bc];
    unsigned elig = 0u;
    for (int v = 0; v < V; ++v) {
      const bool vv = vvalid[row + v];
      bool ev = false;
      if (vv && M > 0) ev = evicted[min(max(vidx[row + v], 0), M - 1)];
      if (vv && !ev && vprio[row + v] + margin < prio) elig |= 1u << v;
    }
    float acc[NV_MAXR];
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    float cost = 0.0f, best_v = INFINITY, best_c = INFINITY;
    int viol = 0;
    const int at = threadIdx.x * V;
    for (int v = 0; v < V; ++v) {
      const bool el = (elig >> v) & 1u;
      bool fit = el;
      for (int r = 0; r < R; ++r) {
        acc[r] = acc[r] + (el ? vreq[(row + v) * R + r] : 0.0f);
        fit = fit && (used[node * R + r] - acc[r]) + p_req[bc * R + r]
                         <= alloc[node * R + r];
      }
      cost = cost + (el ? vcost[row + v] : 0.0f);
      const int g = vpdb[row + v];
      if (GP > 0 && el && g >= 0) {
        int cnt = 0;
        for (int w = 0; w <= v; ++w)
          cnt += ((elig >> w) & 1u) && vpdb[row + w] == g;
        viol += (float)cnt > remaining[g];
      }
      if (fit) {
        const float fv = (float)viol;
        if (fv < best_v) {
          best_v = fv;
          best_c = cost;
        } else if (fv == best_v) {
          best_c = fminf(best_c, cost);
        }
      }
      s_elig[at + v] = el;
      s_fits[at + v] = fit;
      s_cost[at + v] = cost;
      s_viol[at + v] = viol;
    }
    node_viol[i] = best_v;
    node_cost[i] = best_c;
  }
  __syncthreads();
  // The CTA's rows are one contiguous run of V-long rows in each output.
  const long long base = first * V;
  const long long count =
      (rows - first < NV_THREADS ? rows - first : NV_THREADS) * V;
  for (int k = threadIdx.x; k < count; k += NV_THREADS) {
    elig_out[base + k] = s_elig[k];
    fits_out[base + k] = s_fits[k];
    wcost_out[base + k] = s_cost[k];
    wviol_out[base + k] = s_viol[k];
  }
}

}  // namespace

extern "C" int tpusched_tableau_nv(int B, int C, int N, int V, int R, int M,
                                   int GP, const float* vreq,
                                   const float* vcost, const float* vprio,
                                   const int* vpdb, const bool* vvalid,
                                   const int* vidx, const bool* evicted,
                                   const float* p_prio, const float* p_req,
                                   const float* used, const float* alloc,
                                   const float* remaining, float margin,
                                   bool* elig, float* wcost, int* wviol,
                                   bool* fits, float* node_viol,
                                   float* node_cost, void* stream) {
  if (V > NV_MAXV || R > NV_MAXR) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * C * N;
  const unsigned blocks = (unsigned)((rows + NV_THREADS - 1) / NV_THREADS);
  tableau_nv_kernel<<<blocks, NV_THREADS, 0, (cudaStream_t)stream>>>(
      B, C, N, V, R, M, GP, vreq, vcost, vprio, vpdb, vvalid, vidx, evicted,
      p_prio, p_req, used, alloc, remaining, margin, elig, wcost, wviol, fits,
      node_viol, node_cost);
  return (int)cudaGetLastError();
}
