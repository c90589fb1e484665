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
// With `fixed` (the signature path, assign.py:799-812, which the
// frontier-compaction contract needs) each cell adds
// round(contrib * 16) clipped to +-32767 as an int32 (rintf: half to even,
// as jnp.round and torch.round), and desir = (float)sum / (16 * #allowed).
// Integer sums are exact in any order, so the column mean is the same for
// a compacted [F, N] view as for the full [P, N] block: the f32 sum is
// not (it adds the rows in row order, and a view's rows are other rows).
// The same freedom lets the fixed-point sum split the rows into chunks:
// each (column tile, row chunk) block adds its chunk and atomically adds
// the partial sum into an int32 workspace, and a second launch divides.
//
// Bound: bytes, one read of feasible (1 byte) and masked (4) per cell:
// 0.26 GB at 10240 x 5120, 0.078 ms at 3.35 TB/s. A warp's 32 adjacent
// columns read 128 consecutive bytes of each row. The price of the f32
// sum's fixed order is parallelism: only N threads, each walking all rows,
// so the loop is unrolled to keep several rows' loads in flight. The
// fixed-point sum has CHUNKS times the threads.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): the last grid
// dimension is the tenant; tenant b's columns sum its own rows of
// [B, rows, N] into desir [B, N] (its own [2N + 1] workspace in fixed
// point). A solo call is B = 1.
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
  const long long b = blockIdx.y;
  feasible += b * rows * N;
  masked += b * rows * N;
  allowed += b * rows;
  desir += b * N;
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

// Row chunks of the fixed-point sum: enough blocks to fill the card at
// N = 5120 (80 column tiles x 32 chunks).
constexpr int CHUNKS = 32;

// work: [N] int32 column sums, [N] int32 any-feasible flags, [1] int32
// allowed-row count, all zero on entry.
__global__ void __launch_bounds__(THREADS)
desirability_fixed_partial(int rows, int N, const bool* __restrict__ feasible,
                           const float* __restrict__ masked,
                           const bool* __restrict__ allowed,
                           int* __restrict__ work) {
  const long long b = blockIdx.z;
  feasible += b * rows * N;
  masked += b * rows * N;
  allowed += b * rows;
  work += b * (2LL * N + 1);
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int per = (rows + gridDim.y - 1) / gridDim.y;
  const int p0 = blockIdx.y * per;
  const int p1 = min(rows, p0 + per);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int n_allowed = 0;
    for (int p = p0; p < p1; ++p) n_allowed += allowed[p] ? 1 : 0;
    if (n_allowed) atomicAdd(work + 2 * N, n_allowed);
  }
  if (n >= N) return;
  int acc = 0;
  bool any = false;
#pragma unroll 8
  for (int p = p0; p < p1; ++p) {
    const long long o = (long long)p * N + n;
    const bool f = feasible[o] && allowed[p];
    const float c = f ? masked[o] : 0.0f;
    acc += (int)fminf(fmaxf(rintf(c * 16.0f), -32767.0f), 32767.0f);
    any = any || f;
  }
  if (acc) atomicAdd(work + n, acc);
  if (any) atomicOr(work + N + n, 1);
}

__global__ void __launch_bounds__(THREADS)
desirability_fixed_final(int N, const int* __restrict__ work,
                         float* __restrict__ desir) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  work += blockIdx.y * (2LL * N + 1);
  desir += blockIdx.y * (long long)N;
  const float den = 16.0f * (float)max(work[2 * N], 1);
  desir[n] = work[N + n] ? (float)work[n] / den : -INFINITY;
}

}  // namespace

extern "C" int tpusched_desirability(int B, int rows, int N,
                                     const bool* feasible,
                                     const float* masked, const bool* allowed,
                                     int fixed, int* work, float* desir,
                                     void* stream) {
  const int blocks = (N + THREADS - 1) / THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (!fixed) {
    desirability_kernel<<<dim3(blocks, B), THREADS, 0, st>>>(
        rows, N, feasible, masked, allowed, desir);
    return (int)cudaGetLastError();
  }
  if (rows > 0) {
    const dim3 grid(blocks, min(CHUNKS, rows), B);
    desirability_fixed_partial<<<grid, THREADS, 0, st>>>(
        rows, N, feasible, masked, allowed, work);
  }
  desirability_fixed_final<<<dim3(blocks, B), THREADS, 0, st>>>(N, work,
                                                               desir);
  return (int)cudaGetLastError();
}
