// K23: the dealing of a fast round: demand and capacity prefixes, then
// each pod's dealt position.
//
// Replaces tpusched/kernels/assign.py:815-853 (_deal_commit's dealing):
//   cum_dem = inclusive prefix over rows of the demand [L, R] (the pods'
//             requests in rank order, or scattered to their global ranks)
//   cum_rem = inclusive prefix over rows of the remaining capacity [N, R]
//             with the nodes in descending desirability
//   pos[p]  = max over r of searchsorted(cum_rem[:, r], cum_dem[g(p), r])
// (left side), g(p) the pod's rank where the rows were scattered by rank,
// else p.
//
// Fixed order. The prefixes are the plain version's Hillis-Steele scan
// (_scan_plain: at step d every row i >= d adds row i - d, from the
// previous step's values) in a double buffer of shared memory, so the
// f32 bits are the plain version's on every device. A column of length
// len needs only the steps d < len: the plain version scans the demand
// and capacity as columns of one [max(L, N), 2R] array, and its rows
// past a column's own length are zeros that no row above them reads. A
// warp-shuffle or decoupled-lookback scan would sum in another order.
// The search is torch.searchsorted's lower_bound step for step
// (`!(mid >= v)` moves right), so ties, +inf and NaN land where it puts
// them even where a Hillis-Steele prefix is not monotone.
//
// Bound: latency. The bytes are [L, R] + [N, R] read once, the [P] output
// and P * R searches of log2(N) steps: microseconds at 3.35 TB/s. What
// costs is the chain of log2(L) barriers per column. One CTA per (tenant,
// column) scans, all columns at once; then one thread per pod searches.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): blockIdx.y is the
// tenant of the scan; the search's flat thread index carries it. A solo
// call is B = 1.
//
// deal_lists: the round's whole hand-off from K7's desirability to K8's
// candidate lists, in two launches for every tenant (replaces the ~25
// torch ops of `_deal_commit` between the two kernels; JAX
// tpusched/kernels/assign.py:815-853 and the lists after it).
//   1. deal_prep, 2R CTAs a tenant. CTA r < R scans demand column r: the
//      allowed pods' requests at their ranks (or rows) in shared memory,
//      then the prefix. CTA R + r sorts the tenant's nodes by descending
//      desirability itself (every capacity CTA does, so no CTA waits for
//      another), writes the order, and scans capacity column r over it,
//      the remaining capacity of a node with a non-finite desirability
//      taken as 0.
//   2. deal_lists_search, a thread a pod: the dealt position (deal_search's
//      lower bound), the dealt node, its feasibility and score, the seeded
//      pick's score, and the [K + 1] list that K8 reads, or K12's override.
// The sort: one 64-bit key a node, the desirability's order key (of
// -x + 0.0, as `_desc_order` sorts: -0.0 ranks with +0.0, NaN after every
// number as torch.sort puts it) above the node index, so an ascending
// sort of unique keys is the stable descending sort: a bitonic network in
// shared memory (indices by shifts; passes inside 64 keys sync one warp).
// The scan keeps _scan_plain's values step for step in fewer barriers: a
// warp owns W = 32 KR rows (KR = 4, 8 or 16 a lane, the least that covers
// the column with 1 024 threads) and holds, KR * 2 a lane in registers,
// its own rows and the W rows before them. The steps d < W (W a power of
// two) then need no other warp: a row's value after them depends only on
// the W - 1 rows before it (the window's first rows go wrong, and nothing
// reads them), so their adds come from the lane's own registers and
// shuffles. The steps d >= W exchange rows through a double buffer in
// shared memory, one CTA barrier a step: 4 at L = 10 240 (KR = 16),
// against 14 before. A column past 16 384 rows takes the
// one-barrier-a-step loop of deal_scan.
// Bound: latency (the sort's and the scan's barrier chains, one launch
// each); bytes [N] + [N, R] x 2 + [V, R] in, [V, K + 1] x 2 out and a few
// gathers a pod, ~0.7 MB at (b): 0.2 us at 3.35 TB/s.
#include <math.h>

#include "kernels.h"

namespace {

constexpr int SCAN_THREADS = 1024;
constexpr int SEARCH_THREADS = 256;

// Column c < R of tenant b's demand, or column c - R of its capacity,
// scanned into cum (transposed: [B, R, len]).
__global__ void __launch_bounds__(SCAN_THREADS)
deal_scan_kernel(int L, int N, int R, const float* __restrict__ dem,
                 const float* __restrict__ rem, float* __restrict__ cum_dem,
                 float* __restrict__ cum_rem) {
  extern __shared__ float smem[];
  const long long b = blockIdx.y;
  const int c = blockIdx.x;
  const bool is_dem = c < R;
  const int r = is_dem ? c : c - R;
  const int len = is_dem ? L : N;
  const float* src = is_dem ? dem + b * L * R : rem + b * N * R;
  float* dst = (is_dem ? cum_dem + b * R * L : cum_rem + b * R * N) +
               (long long)r * len;
  float* a = smem;
  float* t = smem + len;
  for (int i = threadIdx.x; i < len; i += SCAN_THREADS)
    a[i] = src[(long long)i * R + r];
  __syncthreads();
  for (int d = 1; d < len; d <<= 1) {
    for (int i = threadIdx.x; i < len; i += SCAN_THREADS)
      t[i] = i >= d ? a[i] + a[i - d] : a[i];
    __syncthreads();
    float* s = a;
    a = t;
    t = s;
  }
  for (int i = threadIdx.x; i < len; i += SCAN_THREADS) dst[i] = a[i];
}

// torch.searchsorted(sorted, v, right=False) on one row: the first index
// whose value is >= v, by the library's own bisection.
__device__ __forceinline__ int lower_bound(const float* __restrict__ row,
                                           int n, float v) {
  int start = 0, end = n;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(row[mid] >= v)) start = mid + 1;
    else end = mid;
  }
  return start;
}

__global__ void __launch_bounds__(SEARCH_THREADS)
deal_search_kernel(int B, int P, int L, int N, int R,
                   const long long* __restrict__ gather,
                   const float* __restrict__ cum_dem,
                   const float* __restrict__ cum_rem,
                   long long* __restrict__ pos) {
  const long long i = (long long)blockIdx.x * SEARCH_THREADS + threadIdx.x;
  if (i >= (long long)B * P) return;
  const long long b = i / P;
  const long long g = gather ? gather[i] : i % P;
  int best = 0;
  for (int r = 0; r < R; ++r) {
    const float v = cum_dem[(b * R + r) * L + g];
    best = max(best, lower_bound(cum_rem + (b * R + r) * N, N, v));
  }
  pos[i] = best;
}

constexpr unsigned FULL = 0xffffffffu;

// The ascending key of x in `_desc_order`'s sort of -x + 0.0.
__device__ __forceinline__ unsigned desc_key(float x) {
  const float y = __fadd_rn(-x, 0.0f);
  if (y != y) return 0xffffffffu;
  const unsigned u = __float_as_uint(y);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void cswap(unsigned long long* key, int x, int y) {
  const unsigned long long kx = key[x], ky = key[y];
  if (ky < kx) {
    key[x] = ky;
    key[y] = kx;
  }
}

// Ascending sort of key[0, L) by the whole CTA: the bitonic network in its
// one-direction form (a flip stage, then half-cleaners), padded to a power
// of two with keys taken as +inf (a comparator whose upper index is >= L
// is left out). Comparator i of a pass that spans at most 64 keys stays
// inside keys [64 (i / 32), 64 (i / 32 + 1)), which the one warp holding
// comparators 32 (i / 32) .. + 31 owns at every such pass, so between two
// of them the warp syncs alone.
__device__ void sort_keys(unsigned long long* key, int L) {
  const int T = blockDim.x, tid = threadIdx.x;
  int n2 = 1;
  while (n2 < L) n2 <<= 1;
  int prev = 1 << 30;  // the span of the last pass (the keys' write: wide)
  auto sync = [&](int span) {
    if (span > 64 || prev > 64) __syncthreads();
    else __syncwarp();
    prev = span;
  };
  // Every span is a power of two: comparator indices by shifts and masks
  // (an integer division would cost the pass several times over).
  for (int lk = 1; (1 << lk) <= n2; ++lk) {
    const int k = 1 << lk;
    sync(k);
    for (int i = tid; i < n2 / 2; i += T) {
      const int lo = ((i >> (lk - 1)) << lk) | (i & ((k >> 1) - 1));
      const int hi = (lo | (k - 1)) - (i & ((k >> 1) - 1));
      if (hi < L) cswap(key, lo, hi);
    }
    for (int lj = lk - 2; lj >= 0; --lj) {
      const int j = 1 << lj;
      sync(2 * j);
      for (int i = tid; i < n2 / 2; i += T) {
        const int x = ((i >> lj) << (lj + 1)) | (i & (j - 1));
        if (x + j < L) cswap(key, x, x + j);
      }
    }
  }
  __syncthreads();
}

// One step d < W of the register path on a lane's RL window rows x
// (window row u: lane u / RL, register u % RL; global row g0 + j): row u
// adds row u - d of the step before, rows g < d add nothing. RL and D are
// powers of two, so the source is the lane before's register j - D + RL
// (D < RL) or this register D / RL lanes back; D a template argument, so
// every register index is a constant. Then the next step.
template <int RL, int W, int D>
__device__ __forceinline__ void warp_steps(float (&x)[RL], int g0, int len) {
  if constexpr (D < W) {
    if (D >= len) return;
    if constexpr (D < RL) {
      float t[D];
#pragma unroll
      for (int j = 0; j < D; ++j)
        t[j] = __shfl_up_sync(FULL, x[j - D + RL], 1);
#pragma unroll
      for (int j = RL - 1; j >= D; --j)
        if (g0 + j >= D) x[j] = x[j] + x[j - D];
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (g0 + j >= D) x[j] = x[j] + t[j];
    } else {
#pragma unroll
      for (int j = 0; j < RL; ++j) {
        const float y = __shfl_up_sync(FULL, x[j], D / RL);
        if (g0 + j >= D) x[j] = x[j] + y;
      }
    }
    warp_steps<RL, W, 2 * D>(x, g0, len);
  }
}

// Inclusive prefix of rows [0, len) of a column, src(i) its value at row
// i, into dst, with _scan_plain's values: at step d every row i >= d adds
// row i - d of the step before. sm: 2 len floats of shared memory, free
// once the scan's first barrier is passed (src may read it before). KR > 0
// (a power of two): the register path of the file's comment (KR * 1 024
// >= len); KR = 0: a block-wide step at a time in shared memory.
template <int KR, class Src>
__device__ void scan_column(float* sm, int len, Src src, float* dst) {
  const int tid = threadIdx.x, T = blockDim.x;
  if constexpr (KR == 0) {
    float* a = sm;
    float* t = sm + len;
    for (int i = tid; i < len; i += T) a[i] = src(i);
    __syncthreads();
    for (int d = 1; d < len; d <<= 1) {
      for (int i = tid; i < len; i += T) t[i] = i >= d ? a[i] + a[i - d] : a[i];
      __syncthreads();
      float* s = a;
      a = t;
      t = s;
    }
    for (int i = tid; i < len; i += T) dst[i] = a[i];
  } else {
    constexpr int RL = 2 * KR;  // rows a lane: the window's
    constexpr int W = 32 * KR;  // rows a warp owns
    const int lane = tid & 31;
    const int g0 = (tid >> 5) * W - W + RL * lane;  // the lane's first row
    float x[RL];
#pragma unroll
    for (int j = 0; j < RL; ++j) {
      const int g = g0 + j;
      x[j] = g >= 0 && g < len ? src(g) : 0.0f;
    }
    // Steps d < W inside the warp's window [base - W, base + W).
    warp_steps<RL, W, 1>(x, g0, len);
    // Steps d >= W: the warps' own rows (lanes 16-31) through a double
    // buffer, one CTA barrier a step.
    const bool own = lane >= 16;
    float* buf = sm;
    __syncthreads();
    for (int d = W; d < len; d <<= 1) {
      if (own) {
#pragma unroll
        for (int j = 0; j < RL; ++j)
          if (g0 + j < len) buf[g0 + j] = x[j];
      }
      __syncthreads();
      if (own) {
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          const int g = g0 + j;
          if (g >= d && g < len) x[j] = x[j] + buf[g - d];
        }
      }
      buf = buf == sm ? sm + len : sm;
    }
    if (own) {
#pragma unroll
      for (int j = 0; j < RL; ++j)
        if (g0 + j < len) dst[g0 + j] = x[j];
    }
  }
}

// Launch 1 of deal_lists: grid (2R, B). cum_dem [B, R, L], cum_rem and
// order [B, R, N] (capacity CTA R + r writes order row r).
template <int KR>
__global__ void __launch_bounds__(1024)
deal_lists_prep_kernel(int V, int L, int N, int R, int scatter,
                                 const float* __restrict__ desir,
                                 const float* __restrict__ alloc,
                                 const float* __restrict__ used,
                                 const float* __restrict__ req,
                                 const bool* __restrict__ allowed,
                                 const int* __restrict__ rank,
                                 float* __restrict__ cum_dem,
                                 float* __restrict__ cum_rem,
                                 int* order) {
  extern __shared__ unsigned long long prep_smem[];
  float* sm = reinterpret_cast<float*>(prep_smem);
  const long long b = blockIdx.y;
  const int c = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  if (c < R) {  // demand column c: allowed requests at their rows
    for (int i = tid; i < L; i += T) sm[i] = 0.0f;
    __syncthreads();
    for (int p = tid; p < V; p += T) {
      const long long bp = b * V + p;
      sm[scatter ? rank[bp] : p] = allowed[bp] ? req[bp * R + c] : 0.0f;
    }
    __syncthreads();
    scan_column<KR>(sm, L, [&](int i) { return sm[i]; },
                    cum_dem + (b * R + c) * L);
    return;
  }
  const int r = c - R;
  const float* des = desir + b * N;
  for (int n = tid; n < N; n += T)
    prep_smem[n] = ((unsigned long long)desc_key(des[n]) << 32) | (unsigned)n;
  sort_keys(prep_smem, N);
  int* ord = order + (b * R + r) * N;
  for (int j = tid; j < N; j += T) ord[j] = (int)(prep_smem[j] & 0xffffffffu);
  __syncthreads();
  const float* al = alloc + b * N * R;
  const float* us = used + b * N * R;
  scan_column<KR>(
      sm, N,
      [&](int i) {
        const int n = ord[i];
        if (!isfinite(des[n])) return 0.0f;
        const float x = al[(long long)n * R + r] - us[(long long)n * R + r];
        return x < 0.0f ? 0.0f : x;
      },
      cum_rem + (b * R + r) * N);
}

// Launch 2 of deal_lists: a thread a (tenant, pod).
__global__ void __launch_bounds__(SEARCH_THREADS)
deal_lists_search_kernel(int B, int V, int L, int N, int R, int K,
                         int scatter, const float* __restrict__ cum_dem,
                         const float* __restrict__ cum_rem,
                         const int* __restrict__ order,
                         const int* __restrict__ rank,
                         const bool* __restrict__ feasible,
                         const float* __restrict__ masked,
                         const float* __restrict__ topv,
                         const int* __restrict__ topi,
                         const int* __restrict__ tie_pick,
                         const int* __restrict__ cand,
                         const float* __restrict__ val,
                         const bool* __restrict__ ok, int* __restrict__ topi_o,
                         float* __restrict__ topv_o, int* __restrict__ first) {
  const long long i = (long long)blockIdx.x * SEARCH_THREADS + threadIdx.x;
  if (i >= (long long)B * V) return;
  const long long b = i / V, p = i % V;
  const int K1 = K + 1;
  int* oi = topi_o + i * K1;
  float* ov = topv_o + i * K1;
  const int* ti = topi + i * K;
  const float* tv = topv + i * K;
  first[i] = ti[0];
  if (ok && ok[i]) {  // K12's override: the whole list
    for (int k = 0; k < K1; ++k) {
      oi[k] = cand[i * K1 + k];
      ov[k] = val[i * K1 + k];
    }
    return;
  }
  const long long g = scatter ? rank[i] : p;
  int pos = 0;
  for (int r = 0; r < R; ++r) {
    const float v = cum_dem[(b * R + r) * L + g];
    pos = max(pos, lower_bound(cum_rem + (b * R + r) * N, N, v));
  }
  const int dealt = order[b * R * N + min(pos, N - 1)];
  const float* mrow = masked + i * N;
  const bool dealt_ok = feasible[i * N + dealt];
  const float dealt_score = mrow[dealt];
  int head_i = ti[0];
  float head_v = tv[0];
  bool use = dealt_ok;
  if (tie_pick) {
    head_i = tie_pick[i];
    head_v = mrow[head_i];
    use = dealt_ok && dealt_score < head_v;
  }
  oi[0] = use ? dealt : head_i;
  ov[0] = use ? dealt_score : head_v;
  oi[1] = head_i;
  ov[1] = head_v;
  for (int k = 1; k < K; ++k) {
    oi[k + 1] = ti[k];
    ov[k + 1] = tv[k];
  }
}

template <int KR>
cudaError_t deal_prep(size_t smem, cudaStream_t st, int B,
                      int V, int L, int N, int R, int scatter,
                      const float* desir, const float* alloc,
                      const float* used, const float* req,
                      const bool* allowed, const int* rank, float* cum_dem,
                      float* cum_rem, int* order) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        deal_lists_prep_kernel<KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  deal_lists_prep_kernel<KR><<<dim3(2 * R, B), 1024, smem, st>>>(
      V, L, N, R, scatter, desir, alloc, used, req, allowed, rank, cum_dem,
      cum_rem, order);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpusched_deal_lists(
    int B, int V, int L, int N, int R, int K, int scatter, const float* desir,
    const float* alloc, const float* used, const float* req,
    const bool* allowed, const int* rank, const bool* feasible,
    const float* masked, const float* topv, const int* topi,
    const int* tie_pick, const int* cand, const float* val, const bool* ok,
    float* scratch, int* topi_o, float* topv_o, int* first, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = L > N ? L : N;
  // The scans' 2 rows floats, or the node sort's N 8-byte keys.
  const size_t smem = 8 * (size_t)rows;
  float* cum_dem = scratch;
  float* cum_rem = cum_dem + (size_t)B * R * L;
  int* order = reinterpret_cast<int*>(cum_rem + (size_t)B * R * N);
  cudaError_t e;
  if (rows <= 4 * 1024)
    e = deal_prep<4>(smem, st, B, V, L, N, R, scatter, desir, alloc,
                     used, req, allowed, rank, cum_dem, cum_rem, order);
  else if (rows <= 8 * 1024)
    e = deal_prep<8>(smem, st, B, V, L, N, R, scatter, desir, alloc,
                     used, req, allowed, rank, cum_dem, cum_rem, order);
  else if (rows <= 16 * 1024)
    e = deal_prep<16>(smem, st, B, V, L, N, R, scatter, desir, alloc,
                      used, req, allowed, rank, cum_dem, cum_rem, order);
  else
    e = deal_prep<0>(smem, st, B, V, L, N, R, scatter, desir, alloc, used,
                     req, allowed, rank, cum_dem, cum_rem, order);
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)B * V;
  deal_lists_search_kernel<<<(unsigned)((n + SEARCH_THREADS - 1) /
                                        SEARCH_THREADS),
                             SEARCH_THREADS, 0, st>>>(
      B, V, L, N, R, K, scatter, cum_dem, cum_rem, order, rank, feasible,
      masked, topv, topi, tie_pick, cand, val, ok, topi_o, topv_o, first);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_deal(int B, int P, int L, int N, int R,
                             const float* dem, const float* rem,
                             const long long* gather, float* cum_dem,
                             float* cum_rem, long long* pos, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = 2 * (size_t)(L > N ? L : N) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        deal_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  deal_scan_kernel<<<dim3(2 * R, B), SCAN_THREADS, smem, st>>>(
      L, N, R, dem, rem, cum_dem, cum_rem);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)B * P;
  deal_search_kernel<<<(unsigned)((n + SEARCH_THREADS - 1) / SEARCH_THREADS),
                       SEARCH_THREADS, 0, st>>>(B, P, L, N, R, gather,
                                                cum_dem, cum_rem, pos);
  return (int)cudaGetLastError();
}
