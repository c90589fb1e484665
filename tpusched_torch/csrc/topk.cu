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
//
// The radix path (entry point tpusched_row_topk_radix) takes the calls
// without the seeded pick from K = 8 up (kernels/assign.RADIX_MIN_K, a
// measured cut): the preemption auction's K = 256 (tpusched/kernels/
// preempt.py:563), where K passes would cost 2K barriers and K reads of
// the row, and the fast rounds' K = 8. One CTA a row loads the row into
// shared memory as order-preserving uint32 keys (-0.0 folded into +0.0,
// so that it ties with +0.0 by index, as beats does); four 8-bit digit
// passes, each a 256-bin shared histogram (warp-aggregated adds) and a
// block scan from the top digit down, find the K-th largest key T and
// how many of the K lie at T; each thread then counts its contiguous
// chunk's keys above T and at T, a block scan places them, and the keys
// above T and the first ties at T (in index order) are written as packed
// (key, ~index) pairs, which a bitonic sort in shared memory orders
// (larger key first, then lower index). It is exact, in O(N + K log^2 K)
// shared-memory work and ~log^2 K / 2 + 26 barriers a row.
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
      topv[b * K + j] = bv + 0.0f;  // -0.0 as +0.0, as row_topk_plain
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

constexpr int RTHREADS = 256;  // radix path: one bin a thread
constexpr int RWARPS = RTHREADS / 32;

// Order-preserving key of a finite or infinite float: larger value,
// larger key; -0.0 and +0.0 the same key.
__device__ __forceinline__ unsigned fkey(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Inclusive sum of x over threads 0 .. tid (RTHREADS threads); *total
// gets the block's sum. Two barriers; s_w holds RWARPS ints.
__device__ __forceinline__ int block_incl(int x, int* s_w, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += o;
  }
  if (lane == 31) s_w[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < RWARPS; ++w) {
    before += w < warp ? s_w[w] : 0;
    all += s_w[w];
  }
  __syncthreads();
  *total = all;
  return x + before;
}

__global__ void __launch_bounds__(RTHREADS)
row_topk_radix_kernel(int N, int K, int Kp, const float* __restrict__ masked,
                      int use_smem, float* __restrict__ topv,
                      int* __restrict__ topi) {
  extern __shared__ unsigned long long rsm[];
  unsigned long long* sel = rsm;             // [Kp] packed (key, ~index)
  unsigned* keys = (unsigned*)(rsm + Kp);    // [N] when use_smem
  __shared__ int hist[256];
  __shared__ int s_w[RWARPS];
  __shared__ int s_digit, s_above;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const float* row = masked + b * N;
  if (use_smem) {
    for (int n = tid; n < N; n += RTHREADS) keys[n] = fkey(row[n]);
    __syncthreads();
  }
  auto key_at = [&](int n) { return use_smem ? keys[n] : fkey(row[n]); };

  // The K-th largest key T, digit by digit from the top; k = how many of
  // the K lie at T once all four digits are fixed.
  unsigned prefix = 0, pmask = 0;
  int k = K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;
    __syncthreads();
    for (int base = 0; base < N; base += RTHREADS) {
      const int n = base + tid;
      const unsigned key = n < N ? key_at(n) : 0u;
      const bool in = n < N && (key & pmask) == prefix;
      const unsigned digit = (key >> shift) & 255u;
      const unsigned act = __ballot_sync(0xffffffffu, in);
      if (in) {
        const unsigned peers = __match_any_sync(act, digit);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
      }
    }
    __syncthreads();
    // Thread t holds digit 255 - t: the inclusive sum counts the keys at
    // or above that digit.
    const int h = hist[255 - tid];
    int total;
    const int incl = block_incl(h, s_w, &total);
    if (incl >= k && incl - h < k) {
      s_digit = 255 - tid;
      s_above = incl - h;
    }
    __syncthreads();
    prefix |= (unsigned)s_digit << shift;
    pmask |= 255u << shift;
    k -= s_above;
  }
  const unsigned T = prefix;
  const int above = K - k;

  // Thread t's chunk [lo, hi): its keys above T and at T, placed by a
  // block scan, in index order.
  const int chunk = (N + RTHREADS - 1) / RTHREADS;
  const int lo = min(tid * chunk, N), hi = min(lo + chunk, N);
  int gt = 0, eq = 0;
  for (int n = lo; n < hi; ++n) {
    const unsigned key = key_at(n);
    gt += key > T;
    eq += key == T;
  }
  int tot;
  int at_gt = block_incl(gt, s_w, &tot) - gt;
  int at_eq = block_incl(eq, s_w, &tot) - eq;
  for (int i = K + tid; i < Kp; i += RTHREADS) sel[i] = 0ull;
  for (int n = lo; n < hi && (at_eq < k || at_gt < above); ++n) {
    const unsigned key = key_at(n);
    const unsigned long long packed =
        ((unsigned long long)key << 32) | (unsigned)(~n);
    if (key > T) {
      sel[at_gt++] = packed;
    } else if (key == T) {
      if (at_eq < k) sel[above + at_eq] = packed;
      ++at_eq;
    }
  }
  __syncthreads();

  // Bitonic sort of the Kp pairs, larger packed value first (pads are 0).
  for (int size = 2; size <= Kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < Kp / 2; i += RTHREADS) {
        const int p = 2 * i - (i & (stride - 1));
        const int q = p + stride;
        const unsigned long long x = sel[p], y = sel[q];
        const bool desc = (p & size) == 0;
        if (desc ? x < y : x > y) {
          sel[p] = y;
          sel[q] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < K; j += RTHREADS) {
    const unsigned long long x = sel[j];
    topv[b * K + j] = unkey((unsigned)(x >> 32));
    topi[b * K + j] = (int)~(unsigned)x;
  }
}

}  // namespace

extern "C" int tpusched_row_topk_radix(int rows, int N, int K,
                                       const float* masked, float* topv,
                                       int* topi, void* stream) {
  if (K < 1 || K > N) return (int)cudaErrorInvalidValue;
  int Kp = 1;
  while (Kp < K) Kp <<= 1;
  long long sel_bytes = (long long)Kp * 8;
  long long row_bytes = (long long)N * 4;
  if (sel_bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int use_smem = sel_bytes + row_bytes <= SMEM_LIMIT ? 1 : 0;
  size_t dyn = (size_t)(sel_bytes + (use_smem ? row_bytes : 0));
  if (dyn > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        row_topk_radix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  row_topk_radix_kernel<<<rows, RTHREADS, dyn, (cudaStream_t)stream>>>(
      N, K, Kp, masked, use_smem, topv, topi);
  return (int)cudaGetLastError();
}

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
