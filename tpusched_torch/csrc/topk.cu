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
// and a stable descending sort's). -inf entries rank last, by index;
// -0.0 ranks as +0.0 and is written as +0.0.
//
// Bound: bytes, one read of the block (4 bytes a cell, 0.21 GB at
// 10240 x 5120: 0.063 ms at 3.35 TB/s); the K outputs are tiny.
//
// The warp kernel (entry point tpusched_row_topk; K <= 32, seeded or
// not) reads each row once, with no barrier on the common path. A warp
// takes a row (or a 1/S share of it: `split`, below) in chunks of 32 x V
// consecutive entries, lane l holding entries l*V .. l*V + V-1 of a chunk
// (V = 4: one float4 a lane, a 512-byte warp load; four chunks in flight
// a lane). The warp keeps the K best entries seen so far as a sorted list
// spread over its lanes (lane j < K holds the j-th), and every lane a
// copy of the K-th. An entry that does not beat the K-th is dropped with
// one compare; a ballot collects the lanes whose entry beats it, and each
// such entry is inserted in turn (its position a ballot of the lanes
// that beat it, the tail shifted by one shuffle). The list is the K best
// of everything offered, whatever the order of the offers, so every
// order of evaluation gives the same bits. With the seeded pick each
// lane also keeps its own maximum, how many of its entries equal it and
// the chunk where it first saw it: the row's #maxima is the sum of the
// counts of the lanes whose maximum is the row's, and the walk for the
// h-th maximum starts at the first chunk holding one (a second read,
// from L1 or L2, a ballot a component and a popc, stopping at the chunk
// that holds it; one chunk when the maximum is unique).
//
// Few rows (the fast rounds' 1 024-row views): S warps of a CTA share a
// row, warp s taking chunks s, s + S, ...; each writes its list and its
// seeded counts to shared memory, one barrier, and the row's first warp
// offers the others' lists to its own (assign.topk_split chooses S).
//
// The radix path (entry point tpusched_row_topk_radix) takes the calls
// without the seeded pick from assign.RADIX_MIN_K up, and the top-K of a
// seeded call above 32 (the warp kernel at K = 1 then makes the pick):
// the preemption auction's K = 256 (tpusched/kernels/preempt.py:563). One
// CTA a row loads the row into shared memory as order-preserving uint32
// keys (-0.0 folded into +0.0, so that it ties with +0.0 by index, as
// beats does); four 8-bit digit
// passes, each a 256-bin shared histogram (warp-aggregated adds) and a
// block scan from the top digit down, find the K-th largest key T and
// how many of the K lie at T; each thread then counts its contiguous
// chunk's keys above T and at T, a block scan places them, and the keys
// above T and the first ties at T (in index order) are written as packed
// (key, ~index) pairs, which a bitonic sort in shared memory orders
// (larger key first, then lower index). It is exact, in O(N + K log^2 K)
// shared-memory work and ~log^2 K / 2 + 26 barriers a row. Above 16 384
// the pairs do not fit in shared memory: they are sorted in a scratch
// buffer in device memory that the wrapper allocates.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "cell.cuh"
#include "kernels.h"

namespace {

using tpusched::beats;

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 200 * 1024;
constexpr int WTHREADS = 256;  // warp kernel: 8 warps a CTA
constexpr int WWARPS = WTHREADS / 32;
constexpr int WARP_MAX_K = 32;  // one list entry a lane
constexpr int UNROLL = 4;       // chunks in flight a lane

// One lane's share of chunk c (V consecutive entries); NaN past N, which
// beats nothing, equals nothing and is never offered.
template <int V>
__device__ __forceinline__ void load_chunk(const float* row, int N, int c,
                                           int lane, float (&x)[V]) {
  const int n0 = (c * 32 + lane) * V;
  const float pad = __int_as_float(0x7fffffff);
  if constexpr (V == 4) {
    if (n0 < N) {  // N % 4 == 0: the float4 is whole
      const float4 f = __ldg(reinterpret_cast<const float4*>(row + n0));
      x[0] = f.x;
      x[1] = f.y;
      x[2] = f.z;
      x[3] = f.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = pad;
    }
  } else {
    x[0] = n0 < N ? __ldg(row + n0) : pad;
  }
}

// The warp's K best so far: lane j < K holds the j-th (ev, ei), every
// lane the K-th (tv, ti). Inserts each lane's (x, n) that beats the K-th,
// lowest lane first (a later one is compared again with the K-th it
// moved to).
__device__ __forceinline__ void offer(float x, int n, float& ev, int& ei,
                                      float& tv, int& ti, int K, int lane) {
  unsigned bal = __ballot_sync(FULL, beats(x, n, tv, ti));
  while (bal) {
    const int src = __ffs(bal) - 1;
    bal &= bal - 1;
    const float cv = __shfl_sync(FULL, x, src);
    const int ci = __shfl_sync(FULL, n, src);
    if (!beats(cv, ci, tv, ti)) continue;
    // The entries that beat it are a prefix of the list: it goes at pos.
    const int pos =
        __popc(__ballot_sync(FULL, lane < K && beats(ev, ei, cv, ci)));
    const float uv = __shfl_up_sync(FULL, ev, 1);
    const int ui = __shfl_up_sync(FULL, ei, 1);
    if (lane == pos) {
      ev = cv;
      ei = ci;
    } else if (lane > pos) {
      ev = uv;
      ei = ui;
    }
    tv = __shfl_sync(FULL, ev, K - 1);
    ti = __shfl_sync(FULL, ei, K - 1);
  }
}

// One entry (x, n) of chunk c: offered to the warp's list and, SEEDED,
// counted against this lane's maximum.
template <bool SEEDED>
__device__ __forceinline__ void take(float x, int n, int c, float& ev,
                                     int& ei, float& tv, int& ti, float& mv,
                                     int& cnt, int& ft, int K, int lane) {
  offer(x, n, ev, ei, tv, ti, K, lane);
  if (SEEDED) {
    const bool gt = x > mv;
    cnt = gt ? 1 : cnt + (x == mv);
    ft = gt ? c : ft;
    mv = gt ? x : mv;
  }
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

template <int V, bool SEEDED>
__global__ void __launch_bounds__(WTHREADS)
row_topk_warp_kernel(int rows, int N, int K, int S,
                     const float* __restrict__ masked, unsigned seed,
                     const int* __restrict__ row_ids,
                     float* __restrict__ topv, int* __restrict__ topi,
                     int* __restrict__ pick) {
  __shared__ float s_v[WWARPS][WARP_MAX_K];
  __shared__ int s_i[WWARPS][WARP_MAX_K];
  __shared__ float s_m[WWARPS];
  __shared__ int s_cnt[WWARPS], s_ft[WWARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = warp % S;
  const long long r = (long long)blockIdx.x * (WWARPS / S) + warp / S;
  const bool live = r < rows;
  if (S == 1 && !live) return;
  const float* row = masked + r * N;
  const int nch = live ? (N + 32 * V - 1) / (32 * V) : 0;

  float ev = -INFINITY, tv = -INFINITY;
  int ei = INT_MAX, ti = INT_MAX;
  float mv = -INFINITY;  // SEEDED: this lane's maximum,
  int cnt = 0, ft = 0;   // its count, and a chunk at or before its first
  int c = s;
  for (; c + (UNROLL - 1) * S < nch; c += UNROLL * S) {
    float x[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load_chunk<V>(row, N, c + u * S, lane, x[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j)
        take<SEEDED>(x[u][j], ((c + u * S) * 32 + lane) * V + j, c + u * S,
                     ev, ei, tv, ti, mv, cnt, ft, K, lane);
  }
  for (; c < nch; c += S) {
    float x[V];
    load_chunk<V>(row, N, c, lane, x);
#pragma unroll
    for (int j = 0; j < V; ++j)
      take<SEEDED>(x[j], (c * 32 + lane) * V + j, c, ev, ei, tv, ti, mv, cnt,
                   ft, K, lane);
  }

  // This warp's maximum, its count and first chunk.
  float M = __shfl_sync(FULL, ev, 0);
  int total = 0, start = 0;
  if (SEEDED) {
    total = warp_sum(mv == M ? cnt : 0);
    start = warp_min(mv == M ? ft : INT_MAX);
  }
  if (S > 1) {
    if (lane < K) {
      s_v[warp][lane] = ev;
      s_i[warp][lane] = ei;
    }
    if (lane == 0) {
      s_m[warp] = M;
      s_cnt[warp] = total;
      s_ft[warp] = start;
    }
    __syncthreads();
    if (s != 0 || !live) return;
    for (int w = 1; w < S; ++w)
      offer(lane < K ? s_v[warp + w][lane] : __int_as_float(0x7fffffff),
            lane < K ? s_i[warp + w][lane] : INT_MAX, ev, ei, tv, ti, K,
            lane);
    M = __shfl_sync(FULL, ev, 0);
    if (SEEDED) {
      total = 0;
      start = INT_MAX;
      for (int w = 0; w < S; ++w)
        if (s_m[warp + w] == M) {
          total += s_cnt[warp + w];
          start = min(start, s_ft[warp + w]);
        }
    }
  }
  if (lane < K) {
    topv[r * K + lane] = ev + 0.0f;  // -0.0 as +0.0, as row_topk_plain
    topi[r * K + lane] = ei;
  }
  if (!SEEDED) return;

  // The h-th maximum in node order, from the first chunk that holds one.
  const unsigned pid = row_ids ? (unsigned)row_ids[r] : (unsigned)r;
  const int h = (int)(tpusched::tie_hash(seed, pid) % (unsigned)max(total, 1));
  const unsigned below = (1u << lane) - 1u;
  const int nall = (N + 32 * V - 1) / (32 * V);
  int running = 0;
  for (int cc = start; cc < nall; ++cc) {
    float x[V];
    load_chunk<V>(row, N, cc, lane, x);
    unsigned bal[V];
    int before = running, tile = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      bal[j] = __ballot_sync(FULL, x[j] == M);
      before += __popc(bal[j] & below);
      tile += __popc(bal[j]);
    }
    if (running + tile > h) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if ((bal[j] >> lane) & 1u) {
          if (before == h) pick[r] = (cc * 32 + lane) * V + j;
          ++before;
        }
      }
      break;
    }
    running += tile;
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
                      int use_smem, unsigned long long* __restrict__ scratch,
                      float* __restrict__ topv, int* __restrict__ topi) {
  extern __shared__ unsigned long long rsm[];
  const long long b = blockIdx.x;
  // [Kp] packed (key, ~index): in shared memory, or this row's slice of
  // the scratch buffer when they do not fit.
  unsigned long long* sel = scratch ? scratch + b * Kp : rsm;
  unsigned* keys = (unsigned*)(scratch ? rsm : rsm + Kp);  // [N] if use_smem
  __shared__ int hist[256];
  __shared__ int s_w[RWARPS];
  __shared__ int s_digit, s_above;
  const int tid = threadIdx.x, lane = tid & 31;
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
                                       int* topi, void* scratch,
                                       void* stream) {
  if (K < 1 || K > N) return (int)cudaErrorInvalidValue;
  int Kp = 1;
  while (Kp < K) Kp <<= 1;
  const long long sel_bytes = (long long)Kp * 8;
  const long long row_bytes = (long long)N * 4;
  const bool global_sel = sel_bytes > SMEM_LIMIT;
  if (global_sel && !scratch) return (int)cudaErrorInvalidValue;
  const long long sel_smem = global_sel ? 0 : sel_bytes;
  const int use_smem = sel_smem + row_bytes <= SMEM_LIMIT ? 1 : 0;
  const size_t dyn = (size_t)(sel_smem + (use_smem ? row_bytes : 0));
  if (dyn > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        row_topk_radix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  row_topk_radix_kernel<<<rows, RTHREADS, dyn, (cudaStream_t)stream>>>(
      N, K, Kp, masked, use_smem,
      global_sel ? (unsigned long long*)scratch : nullptr, topv, topi);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_row_topk(int rows, int N, int K, int split,
                                 const float* masked, int seeded,
                                 unsigned int seed, const int* row_ids,
                                 float* topv, int* topi, int* pick,
                                 void* stream) {
  if (K < 1 || K > N || K > WARP_MAX_K || split < 1 || split > WWARPS ||
      (split & (split - 1)))
    return (int)cudaErrorInvalidValue;
  const int per = WWARPS / split;  // rows a CTA
  const dim3 grid((unsigned)((rows + per - 1) / per));
  const bool vec = N % 4 == 0 && ((uintptr_t)masked & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
#define TOPK_LAUNCH(V, SEEDED)                                           \
  row_topk_warp_kernel<V, SEEDED><<<grid, WTHREADS, 0, st>>>(            \
      rows, N, K, split, masked, seed, row_ids, topv, topi, pick)
  if (vec) {
    if (seeded) TOPK_LAUNCH(4, true); else TOPK_LAUNCH(4, false);
  } else {
    if (seeded) TOPK_LAUNCH(1, true); else TOPK_LAUNCH(1, false);
  }
#undef TOPK_LAUNCH
  return (int)cudaGetLastError();
}
