// K3: per-pod score normalisation and QoS weighting of the tableau.
//
// Replaces tpusched/kernels/assign.py:233 finalize_static's [P, N] part:
// score.default_normalize(na_raw) and
// score.taint_toleration_from_count(tt_count), each a row max over valid
// nodes followed by a rescale, then w_na[p] * na + w_tt[p] * tt in f32.
//
// Bound: bytes. It reads na_raw and tt_count (8 bytes a cell) and writes
// score (4 bytes a cell): 0.63 GB at 10240 x 5120, 0.19 ms at 3.35 TB/s.
// One block per pod row: the block reads the row once for the two maxima
// (max is exact in any order, so a tree reduction matches jnp.max), then
// again for the epilogue, which the 50 MB L2 mostly serves.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): B tenants' [B, P, N]
// rows flatten to B * P rows; row i normalises over its own tenant's
// node validity, node_valid[i / P]. A solo call is B = 1.
#include <math.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float block_max(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (THREADS >> 5) ? scratch[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  float out = scratch[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(THREADS)
finalize_kernel(int P, int N, const float* __restrict__ na_raw,
                const float* __restrict__ tt_count,
                const bool* __restrict__ node_valid,
                const float* __restrict__ w_na,
                const float* __restrict__ w_tt, float* __restrict__ score) {
  __shared__ float scratch[THREADS >> 5];
  int p = blockIdx.x;
  node_valid += (long long)(p / P) * N;
  const float* raw = na_raw + (long long)p * N;
  const float* cnt = tt_count + (long long)p * N;
  float mx_na = -INFINITY, mx_tt = -INFINITY;
  for (int n = threadIdx.x; n < N; n += THREADS) {
    bool v = node_valid[n];
    mx_na = fmaxf(mx_na, v ? raw[n] : 0.0f);
    mx_tt = fmaxf(mx_tt, v ? cnt[n] : 0.0f);
  }
  mx_na = block_max(mx_na, scratch);
  mx_tt = block_max(mx_tt, scratch);
  float den_na = fmaxf(mx_na, 1e-9f);
  float den_tt = fmaxf(mx_tt, 1e-9f);
  float wn = w_na[p], wt = w_tt[p];
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float na = mx_na > 0.0f ? raw[n] * 100.0f / den_na : 0.0f;
    float tt = mx_tt > 0.0f ? (mx_tt - cnt[n]) * 100.0f / den_tt : 100.0f;
    score[(long long)p * N + n] = wn * na + wt * tt;
  }
}

}  // namespace

extern "C" int tpusched_finalize_static(int B, int P, int N,
                                        const float* na_raw,
                                        const float* tt_count,
                                        const bool* node_valid,
                                        const float* w_na, const float* w_tt,
                                        float* score, void* stream) {
  finalize_kernel<<<B * P, THREADS, 0, (cudaStream_t)stream>>>(
      P, N, na_raw, tt_count, node_valid, w_na, w_tt, score);
  return (int)cudaGetLastError();
}
