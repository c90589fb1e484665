// K6: per-row top-K of a [rows, N] score block, with the seeded tie pick.
//
// Replaces, per row of `masked`, the lax.top_k of
// tpusched/kernels/assign.py:854 (_deal_commit's fallback candidates) and
// of tpusched/engine.py:1007 (score_topk), the argmax / max of
// engine.py:367 (_score_top1), and assign.py:379 pick_node_batch (the
// h-th maximum in node order, h = tie_hash(seed, pod) % #maxima, hashed
// by the row's ORIGINAL pod index).
//
// Order: larger value first, ties to the lower node index (lax.top_k's
// and a stable descending sort's). -inf entries rank last, by index.
//
// Bound: bytes, one read of the block (4 bytes a cell, 0.21 GB at
// 10240 x 5120: 0.063 ms at 3.35 TB/s); the K outputs are tiny. One CTA
// per row copies the row into shared memory once (coalesced), then makes
// K passes over it: pass j keeps each thread's best entry that ranks
// after pass j-1's winner and reduces those to the block's best. That is
// exact for any K, costs O(K * N) shared-memory reads per row, and is
// meant for the small K of the callers (8, 16, a serving k). The seeded
// pick counts the maxima, then walks the row in tiles of THREADS with a
// ballot per warp until the h-th one.
#include <limits.h>
#include <math.h>

#include "cell.cuh"
#include "kernels.h"

namespace {

using tpusched::beats;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 200 * 1024;

__device__ __forceinline__ void block_best(float& v, int& i, float* s_v,
                                           int* s_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
  }
  __syncthreads();
  v = s_v[0];
  i = s_i[0];
  for (int w = 1; w < WARPS; ++w) {
    if (beats(s_v[w], s_i[w], v, i)) {
      v = s_v[w];
      i = s_i[w];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
row_topk_kernel(int N, int K, const float* __restrict__ masked, int seeded,
                unsigned seed, const int* __restrict__ row_ids,
                int use_smem, float* __restrict__ topv,
                int* __restrict__ topi, int* __restrict__ pick) {
  extern __shared__ float srow[];
  __shared__ float s_v[WARPS];
  __shared__ int s_i[WARPS];
  __shared__ int s_c[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const float* row = masked + b * N;
  if (use_smem) {
    for (int n = tid; n < N; n += THREADS) srow[n] = row[n];
    __syncthreads();
    row = srow;
  }
  // Pass j: the best entry ranked after (pv, pi), the previous winner.
  float pv = INFINITY;
  int pi = -1;
  for (int j = 0; j < K; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int n = tid; n < N; n += THREADS) {
      float v = row[n];
      if (beats(pv, pi, v, n) && beats(v, n, bv, bi)) {
        bv = v;
        bi = n;
      }
    }
    block_best(bv, bi, s_v, s_i);
    if (tid == 0) {
      topv[b * K + j] = bv;
      topi[b * K + j] = bi;
    }
    pv = bv;
    pi = bi;
    if (j == 0 && seeded) {
      // Seeded pick among the maxima (the pass-0 value).
      const float mx = bv;
      int cnt = 0;
      for (int n = tid; n < N; n += THREADS) cnt += row[n] == mx;
      for (int off = 16; off > 0; off >>= 1)
        cnt += __shfl_down_sync(0xffffffffu, cnt, off);
      if (lane == 0) s_c[warp] = cnt;
      __syncthreads();
      int total = 0;
      for (int w = 0; w < WARPS; ++w) total += s_c[w];
      __syncthreads();
      const unsigned pid = row_ids ? (unsigned)row_ids[b] : (unsigned)b;
      const int h =
          (int)(tpusched::tie_hash(seed, pid) % (unsigned)max(total, 1));
      int running = 0;
      for (int base = 0; base < N; base += THREADS) {
        const int n = base + tid;
        const bool f = n < N && row[n] == mx;
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        if (lane == 0) s_c[warp] = __popc(bal);
        __syncthreads();
        int before = running, tile = 0;
        for (int w = 0; w < WARPS; ++w) {
          before += w < warp ? s_c[w] : 0;
          tile += s_c[w];
        }
        if (f && before + __popc(bal & ((1u << lane) - 1u)) == h)
          pick[b] = n;
        __syncthreads();
        running += tile;
        if (running > h) break;
      }
    }
  }
}

}  // namespace

extern "C" int tpusched_row_topk(int rows, int N, int K, const float* masked,
                                 int seeded, unsigned int seed,
                                 const int* row_ids, float* topv, int* topi,
                                 int* pick, void* stream) {
  if (K < 1 || K > N) return (int)cudaErrorInvalidValue;
  long long bytes = (long long)N * (long long)sizeof(float);
  int use_smem = bytes <= SMEM_LIMIT ? 1 : 0;
  size_t dyn = use_smem ? (size_t)bytes : 0;
  if (dyn > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        row_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  row_topk_kernel<<<rows, THREADS, dyn, (cudaStream_t)stream>>>(
      N, K, masked, seeded, seed, row_ids, use_smem, topv, topi, pick);
  return (int)cudaGetLastError();
}
