// K21 queue_rank: the device queue's ranking.
//
// Replaces tpusched/kernels/queue.py:106 _rank (the availability-decay
// priority and the sort keys, with :91 sortable_u32), :134 rank_full and
// :147 window_select / :177 _window_body (one lexicographic sort of the
// [Q] pending table, sliced to the window).
//
// Per slot (first launch, a thread a slot), in reference_priorities' op
// order: age = now - submitted; never = age < 1e-9; avail = never ? 1 :
// clip(run / (never ? 1 : age), 0, 1) (IEEE division: no fast math);
// pressure = clip(slo - avail, 0, 1); prio = (double)base + (double)gain
// * (double)pressure rounded once to f32 (__double2float_rn). The f32
// product is exact in f64, so this is the single rounding of XLA CPU's
// fused multiply-add and of the numpy oracle, bit for bit; the build's
// --fmad=false leaves the expression as written. The key is the unique
// 97-bit (ineligible:1, ~sortable_u32(prio):32, seq:32, slot:32), held as
// two u64 words: a = ineligible << 32 | ~sortable, b = seq << 32 | slot.
// The slot makes every key distinct, so any correct sort gives
// jax.lax.sort's stable order. The eligible and valid counts are warp
// ballots added with integer atomics (exact in any order).
//
// Sort: 16 bytes a key do not fit one CTA's shared memory at Q = 16 384
// (256 KB against 227 KB). The table is padded to Qp = next pow2(Q) with
// keys that sort last (a = ~0, b = slot); each CTA sorts a tile of up to
// 2 048 keys (32 KB of shared memory) with a bitonic network; then
// log2(Qp / tile) merge passes, each a thread a key: its rank in the
// partner run by binary search (keys are distinct, so strict less), its
// place = its offset + that rank. The last launch writes the first n_out
// slots of the order (and, for a window, their priorities).
//
// Bound: bytes. The table's seven input fields (25 bytes a slot) are read
// once and the priorities and the order written once: ~0.6 MB at
// Q = 16 384, 0.2 us at 3.35 TB/s. The sort's passes are latency of a
// few small launches; this first version keeps them simple.
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;           // keys a CTA sorts (32 KB of smem)
constexpr int SORT_THREADS = 1024;
constexpr float MIN_OBSERVED_AGE_S = 1e-9f;
constexpr float DEFAULT_OBSERVED_AVAIL = 1.0f;

typedef unsigned long long u64;

__device__ __forceinline__ bool key_less(ulonglong2 x, ulonglong2 y) {
  return x.x < y.x || (x.x == y.x && x.y < y.y);
}

// queue.py:91 sortable_u32: monotone f32 -> u32.
__device__ __forceinline__ unsigned sortable_u32(float f) {
  const unsigned u = __float_as_uint(f);
  return u >= 0x80000000u ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(THREADS)
queue_keys_kernel(int Q, int Qp, const bool* __restrict__ valid,
                  const float* __restrict__ base,
                  const float* __restrict__ slo,
                  const float* __restrict__ submitted,
                  const float* __restrict__ run,
                  const float* __restrict__ parked,
                  const unsigned* __restrict__ seq, float now, double gain,
                  float* __restrict__ prio, ulonglong2* __restrict__ keys,
                  int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool elig = false, v = false;
  if (i < Q) {
    const float age = now - submitted[i];
    const bool never = age < MIN_OBSERVED_AGE_S;
    const float q = run[i] / (never ? 1.0f : age);
    const float avail =
        never ? DEFAULT_OBSERVED_AVAIL : fminf(fmaxf(q, 0.0f), 1.0f);
    const float pressure = fminf(fmaxf(slo[i] - avail, 0.0f), 1.0f);
    const double fused = (double)base[i] + gain * (double)pressure;
    const float p = __double2float_rn(fused);
    prio[i] = p;
    v = valid[i];
    elig = v && parked[i] <= now;
    const u64 a = ((u64)(elig ? 0u : 1u) << 32) | (u64)(~sortable_u32(p));
    const u64 b = ((u64)seq[i] << 32) | (u64)(unsigned)i;
    keys[i] = make_ulonglong2(a, b);
  } else if (i < Qp) {
    keys[i] = make_ulonglong2(~0ull, (u64)(unsigned)i);
  }
  const unsigned e = __ballot_sync(0xffffffffu, elig);
  const unsigned d = __ballot_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) {
    if (e) atomicAdd(counts, __popc(e));
    if (d) atomicAdd(counts + 1, __popc(d));
  }
}

// Each CTA sorts keys[blockIdx.x * T .. + T) ascending (T a power of two
// <= TILE) with a bitonic network in shared memory.
__global__ void __launch_bounds__(SORT_THREADS)
queue_tile_sort_kernel(int T, const ulonglong2* __restrict__ in,
                       ulonglong2* __restrict__ out) {
  __shared__ ulonglong2 s[TILE];
  const long long base = (long long)blockIdx.x * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) s[i] = in[base + i];
  __syncthreads();
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < T; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const ulonglong2 x = s[i], y = s[ixj];
          const bool up = (i & k) == 0;
          if (up ? key_less(y, x) : key_less(x, y)) {
            s[i] = y;
            s[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x) out[base + i] = s[i];
}

// One merge pass: sorted runs of width w, merged pairwise into runs of
// 2w. A key's place is its offset in its run plus the number of keys of
// the partner run below it.
__global__ void __launch_bounds__(THREADS)
queue_merge_kernel(int Qp, int w, const ulonglong2* __restrict__ in,
                   ulonglong2* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Qp) return;
  const ulonglong2 key = in[i];
  const int run = i / w;
  const int off = i - run * w;
  const ulonglong2* partner = in + (long long)(run ^ 1) * w;
  int lo = 0, hi = w;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_less(partner[mid], key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[(long long)(run & ~1) * w + off + lo] = key;
}

__global__ void __launch_bounds__(THREADS)
queue_emit_kernel(int n, const ulonglong2* __restrict__ sorted,
                  const float* __restrict__ prio, int* __restrict__ idx,
                  float* __restrict__ prio_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = (int)(unsigned)(sorted[i].y & 0xffffffffull);
  idx[i] = s;
  if (prio_out) prio_out[i] = prio[s];
}

}  // namespace

extern "C" int tpusched_queue_rank(int Q, int Qp, int n_out,
                                   const bool* valid, const float* base,
                                   const float* slo, const float* submitted,
                                   const float* run, const float* parked,
                                   const int* seq, float now, double gain,
                                   float* prio, void* keys_a, void* keys_b,
                                   int* counts, int* idx, float* prio_out,
                                   void* stream) {
  if (Q <= 0 || Qp < Q || (Qp & (Qp - 1)) != 0 || n_out > Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ulonglong2* a = (ulonglong2*)keys_a;
  ulonglong2* b = (ulonglong2*)keys_b;
  queue_keys_kernel<<<(Qp + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      Q, Qp, valid, base, slo, submitted, run, parked,
      (const unsigned*)seq, now, gain, prio, a, counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int T = Qp < TILE ? Qp : TILE;
  queue_tile_sort_kernel<<<Qp / T, SORT_THREADS, 0, st>>>(T, a, b);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ulonglong2* src = b;
  ulonglong2* dst = a;
  for (int w = T; w < Qp; w <<= 1) {
    queue_merge_kernel<<<(Qp + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        Qp, w, src, dst);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ulonglong2* t = src;
    src = dst;
    dst = t;
  }
  if (n_out > 0) {
    queue_emit_kernel<<<(n_out + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        n_out, src, prio, idx, prio_out);
  }
  return (int)cudaGetLastError();
}
