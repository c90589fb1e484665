// K7: the node desirability column mean of a fast round's dealing pass.
//
// Replaces tpusched/kernels/assign.py:793-814 (_deal_commit with
// cum_width=None):
//   desir[n] = sum_p where(feasible[p, n] & allowed[p], masked[p, n], 0)
//              / max(sum_p allowed[p], 1)
//   desir[n] = -inf where no allowed row is feasible at n.
// JAX leaves the order of the f32 column sum to XLA. Here it is fixed:
// one thread per column adds the rows in ascending order, which the
// plain version repeats, so the two agree bit for bit and run to run
// (no atomics).
//
// Bound: bytes, one read of feasible (1 byte) and masked (4) per cell:
// 0.26 GB at 10240 x 5120, 0.078 ms at 3.35 TB/s. A warp's 32 adjacent
// columns read 128 consecutive bytes of each row. The price of the fixed
// order is parallelism: only N threads, each walking all rows, so the
// loop is unrolled to keep several rows' loads in flight.
#include <math.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
desirability_kernel(int rows, int N, const bool* __restrict__ feasible,
                    const float* __restrict__ masked,
                    const bool* __restrict__ allowed,
                    float* __restrict__ desir) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  float acc = 0.0f;
  bool any = false;
  int n_allowed = 0;
#pragma unroll 8
  for (int p = 0; p < rows; ++p) {
    const long long o = (long long)p * N + n;
    const bool al = allowed[p];
    const bool f = feasible[o] && al;
    const float c = f ? masked[o] : 0.0f;
    acc = acc + c;
    any = any || f;
    n_allowed += al ? 1 : 0;
  }
  const float den = (float)max(n_allowed, 1);
  desir[n] = any ? acc / den : -INFINITY;
}

}  // namespace

extern "C" int tpusched_desirability(int rows, int N, const bool* feasible,
                                     const float* masked, const bool* allowed,
                                     float* desir, void* stream) {
  desirability_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0,
                        (cudaStream_t)stream>>>(rows, N, feasible, masked,
                                                allowed, desir);
  return (int)cudaGetLastError();
}
