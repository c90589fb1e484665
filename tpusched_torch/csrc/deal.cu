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
// Bound: bytes, one read of feasible (1 byte) and masked (4) per cell of
// an allowed row: 0.26 GB at 10240 x 5120, 0.078 ms at 3.35 TB/s. The
// card needs megabytes in flight to reach that rate, and the f32 sum's
// fixed order allows one adder a column. So the f32 path runs a CTA per
// tile of 32 columns (one 128-byte line of masked a row) and tenant, of
// LOADERS loader warps and one adding warp, over stages of STAGE rows:
//  * the loader warps read a stage's rows of the tile, a lane a column
//    (each row a coalesced 128-byte line of masked and 32 bytes of
//    feasible; the rows' allowed flags one coalesced byte a lane, then a
//    ballot), all of a warp's 32 rows issued before any is used (~40 KB
//    in flight a CTA), fold `allowed` and `feasible` into the value
//    (contrib = feasible & allowed ? masked : 0) and store it into one
//    half of a double-buffered shared tile;
//  * meanwhile the adding warp, a lane a column, adds the other half's
//    rows in ascending order into its sum, started from 0.0: the same
//    association as the plain version's, so the output is bit for bit
//    the same at every row count, view and tenant count;
//  * one __syncthreads a stage hands the halves over. The `any` flags
//    and the allowed-row count are merged across the loader warps at the
//    end (OR and an integer sum, exact in any order), and the adding warp
//    makes the same final division.
// The loaders use plain loads, not cp.async: a feasible row starts at an
// arbitrary byte (N need not be a multiple of 4), and folding the mask in
// registers leaves the adding warp one shared load and one add a row.
// The fixed-point sum has CHUNKS times the threads of a thread per
// column.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): the last grid
// dimension is the tenant; tenant b's columns sum its own rows of
// [B, rows, N] into desir [B, N] (its own [2N + 1] workspace in fixed
// point). A solo call is B = 1.
#include <math.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 64;         // the fixed-point kernels
constexpr int TILE = 32;            // f32 path: columns a CTA
constexpr int LOADERS = 8;          // loader warps a CTA
constexpr int ROWS_PER = 32;        // rows a loader warp a stage
constexpr int STAGE = LOADERS * ROWS_PER;
constexpr int F32_THREADS = 32 * (1 + LOADERS);
constexpr size_t F32_SMEM = 2 * STAGE * TILE * sizeof(float);
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(F32_THREADS)
desirability_kernel(int rows, int N, const bool* __restrict__ feasible,
                    const float* __restrict__ masked,
                    const bool* __restrict__ allowed,
                    float* __restrict__ desir) {
  extern __shared__ float s_c[];   // [2][STAGE][TILE] contributions
  __shared__ unsigned s_any[LOADERS];
  __shared__ int s_nal[LOADERS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = blockIdx.y;
  feasible += b * rows * N;
  masked += b * rows * N;
  allowed += b * rows;
  desir += b * N;
  const int col = blockIdx.x * TILE + lane;
  const bool in = col < N;
  const int stages = (rows + STAGE - 1) / STAGE;
  float acc = 0.0f;       // the adding warp's column sum
  bool any = false;       // a loader lane's column: some allowed row feasible
  int n_allowed = 0;      // a loader warp's allowed rows
  for (int j = 0; j <= stages; ++j) {
    if (warp > 0 && j < stages) {
      const int r0 = j * STAGE + (warp - 1) * ROWS_PER;
      const bool al_l = r0 + lane < rows && allowed[r0 + lane];
      const unsigned alb = __ballot_sync(FULL, al_l);
      n_allowed += __popc(alb);
      float v[ROWS_PER];
      bool f[ROWS_PER];
#pragma unroll
      for (int t = 0; t < ROWS_PER; ++t) {
        v[t] = 0.0f;
        f[t] = false;
        if (in && ((alb >> t) & 1u)) {
          const long long o = (long long)(r0 + t) * N + col;
          f[t] = feasible[o];
          v[t] = masked[o];
        }
      }
      float* dst = s_c + ((j & 1) * STAGE + (warp - 1) * ROWS_PER) * TILE;
#pragma unroll
      for (int t = 0; t < ROWS_PER; ++t) {
        dst[t * TILE + lane] = f[t] ? v[t] : 0.0f;
        any = any || f[t];
      }
    }
    if (warp == 0 && j > 0) {
      const int len = min(STAGE, rows - (j - 1) * STAGE);
      const float* src = s_c + ((j - 1) & 1) * STAGE * TILE + lane;
#pragma unroll 8
      for (int r = 0; r < len; ++r) acc = acc + src[r * TILE];
    }
    __syncthreads();
  }
  if (warp > 0) {
    const unsigned a = __ballot_sync(FULL, any);
    if (lane == 0) {
      s_any[warp - 1] = a;
      s_nal[warp - 1] = n_allowed;
    }
  }
  __syncthreads();
  if (warp == 0 && in) {
    unsigned a = 0;
    int nal = 0;
    for (int w = 0; w < LOADERS; ++w) {
      a |= s_any[w];
      nal += s_nal[w];
    }
    const float den = (float)max(nal, 1);
    desir[col] = ((a >> lane) & 1u) ? acc / den : -INFINITY;
  }
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
    // The stage buffers (64 KB) pass the 48 KB default: opt in once.
    static const cudaError_t opt = cudaFuncSetAttribute(
        desirability_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)F32_SMEM);
    if (opt != cudaSuccess) return (int)opt;
    desirability_kernel<<<dim3((N + TILE - 1) / TILE, B), F32_THREADS,
                          F32_SMEM, st>>>(rows, N, feasible, masked,
                                          allowed, desir);
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
