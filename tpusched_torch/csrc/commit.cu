// K8: one capacity-prefix commit sub-step of a fast round.
//
// Replaces the body of tpusched/kernels/assign.py:894-957 (_deal_commit's
// `sub`, cum_width=None). The caller sorts the active candidates by
// (node, rank) with a library sort and passes the permutation `perm` and
// the sorted nodes `cand_s` (N marks an inactive row; those sort last).
// Then, per sorted row i with segment start s (the first row of its
// node):
//   cum     = inclusive prefix of the active rows' requests, over all rows
//   within  = cum[i] - (s > 0 ? cum[s - 1] : 0)       (JAX's association)
//   fits    = active & forall r: used[n] + within <= alloc[n]
//   commit  = fits & no non-fitting row in [s, i]
// and scatters back through perm: choice = node and ptr = KC on a
// commit, ptr + 1 on a row that did not fit.
//
// Fixed orders, so the plain version agrees bit for bit:
//  * the prefix is a Hillis-Steele scan (step d adds the row d back, for
//    d = 1, 2, 4, ...), which the plain version runs as whole-tensor
//    adds;
//  * `used` gains each node's commits one at a time in ascending rank,
//    by the thread of the node's segment. JAX adds them with a
//    duplicate-index f32 scatter-add whose order is unspecified (an
//    atomic add on CUDA, whose rounding changes run to run).
//
// The node_add entry point replaces assign.py:701 _node_add (the
// validator's reverts, sign = -1, in the rounds with signatures; the gang
// gate's unwind; the preemption rounds' plain commits; the incremental
// carry): used_out[n] = used_in[n] + sign * req of each masked row of node
// n, one row at a time in ascending (rank, row index) order, nodes no row
// touches copied through. JAX adds each segment's total (a prefix sum) at
// once, a different association (so `used` agrees with JAX's to rounding,
// not bitwise); the order here depends only on the rows' ranks, so a
// compacted view adds exactly what the full width adds.
//
// node_add takes the rows unsorted, in one launch: one CTA of 1 024
// threads a tenant counts each node's masked rows (shared-memory
// atomics), scans the counts, and scatters a 64-bit (rank, row) key per
// row into its node's bucket, in whatever order the atomics land. Each
// bucket is then put in key order, which is the stable sort's order
// whatever the scatter's was: a bucket of up to 32 rows by its node's
// thread (insertion sort), up to 1 024 by a warp and past that by the
// whole CTA (a bitonic sort in its one-direction form, padded with +inf
// keys), so a skewed bucket (a gang rolled back on one node, a small
// cluster) never goes quadratic in one thread. A node's adds then run in
// that order: the thread's own, or, for a long bucket, a warp reading 32
// rows' requests at once and adding them in order through shuffles. The
// buckets (P * 8 + (N + P / 32 + 2) * 4 bytes) live in shared memory where
// they fit in a CTA's 227 KB, else in global scratch. Ranks are compared
// as they are (a compacted view's ranks are global and may pass its P).
// Bound: bytes ([P] node, mask, rank, [P, R] requests read once, [N, R]
// used read and written once), 0.1 us of them at P = 10 240, N = 5 120;
// what costs is latency: one launch and a handful of CTA barriers.
//
// prefix_commit's bound: latency. The work is O(P log P) adds over [P] x R
// (P = 10240 at the headline), far below a microsecond of bandwidth; what costs is the
// dependent chain of log2(P) scan steps per resource, each a block
// barrier. One CTA does it all, with its scratch in global memory (L1
// serves it), so P is not bounded by shared memory.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): gridDim.x = B, and CTA
// b runs tenant b's sub-step on its own rows ([B, P] perm with the
// tenant's own pod indices, sorted nodes, choice and ptr, [B, P, R]
// requests, [B, N, R] allocatable and usage, its own scratch), or tenant
// b's node_add (its own rows, buckets and usage).
#include <limits.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
prefix_commit_kernel(int P, int N, int R, int KC, const int* __restrict__ perm,
                     const int* __restrict__ cand_s,
                     const float* __restrict__ req,
                     const float* __restrict__ alloc, float* used,
                     int* choice, int* ptr, float* buf_a, float* buf_b,
                     int* seg, int* first_bad, unsigned char* fit) {
  const int tid = threadIdx.x;
  {  // CTA b runs tenant b's sub-step.
    const long long b = blockIdx.x;
    perm += b * P;
    cand_s += b * P;
    req += b * P * R;
    alloc += b * N * R;
    used += b * N * R;
    choice += b * P;
    ptr += b * P;
    buf_a += b * 2 * P;
    buf_b += b * 2 * P;
    seg += b * 2 * P;
    first_bad += b * 2 * P;
    fit += b * P;
  }
  for (int i = tid; i < P; i += THREADS) {
    const int c = cand_s[i];
    int lo = 0, hi = i;  // first row of node c (cand_s is sorted)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cand_s[mid] < c) lo = mid + 1; else hi = mid;
    }
    seg[i] = lo;
    first_bad[i] = INT_MAX;
    fit[i] = c < N ? 1 : 0;
  }
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    for (int i = tid; i < P; i += THREADS)
      buf_a[i] = cand_s[i] < N ? req[(long long)perm[i] * R + r] : 0.0f;
    __syncthreads();
    float* src = buf_a;
    float* dst = buf_b;
    for (int d = 1; d < P; d <<= 1) {
      for (int i = tid; i < P; i += THREADS)
        dst[i] = i >= d ? src[i] + src[i - d] : src[i];
      __syncthreads();
      float* t = src;
      src = dst;
      dst = t;
    }
    for (int i = tid; i < P; i += THREADS) {
      const int n = cand_s[i];
      if (n >= N) continue;
      const int s = seg[i];
      const float within = src[i] - (s > 0 ? src[s - 1] : 0.0f);
      const long long o = (long long)n * R + r;
      if (!(used[o] + within <= alloc[o])) fit[i] = 0;
    }
    __syncthreads();
  }
  for (int i = tid; i < P; i += THREADS)
    if (cand_s[i] < N && !fit[i]) atomicMin(&first_bad[seg[i]], i);
  __syncthreads();
  for (int i = tid; i < P; i += THREADS) {
    const int n = cand_s[i];
    if (n >= N) continue;
    const int s = seg[i];
    const int stop = first_bad[s];
    const int q = perm[i];
    if (fit[i] && i < stop) {
      choice[q] = n;
      ptr[q] = KC;
    } else if (!fit[i]) {
      ptr[q] = ptr[q] + 1;
    }
    if (s == i && fit[i] && i < stop) {
      // The node's committed rows are the prefix [i, stop) of its segment.
      for (int r = 0; r < R; ++r) {
        const long long o = (long long)n * R + r;
        float u = used[o];
        for (int j = i; j < P && j < stop && cand_s[j] == n; ++j)
          u = u + req[(long long)perm[j] * R + r];
        used[o] = u;
      }
    }
  }
}

// -- node_add ---------------------------------------------------------------

constexpr int NA_THREADS = 1024;
constexpr int NA_SMALL = 32;    // longest bucket one thread orders and walks
constexpr int NA_WARP = 1024;   // longest bucket one warp orders; past it the CTA
constexpr int NA_DEVICES = 64;  // devices whose attribute launch_node_add tracks
constexpr unsigned FULL = 0xffffffffu;

// A row's place in its node's order: the rank (signed, so flipped to sort
// as unsigned), then the row index, as the stable sort of the plain
// version orders the (node, rank) keys.
__device__ __forceinline__ unsigned long long row_key(int rank, int row) {
  return ((unsigned long long)((unsigned)rank ^ 0x80000000u) << 32) |
         (unsigned)row;
}

__device__ __forceinline__ void cswap(unsigned long long* key, int x, int y) {
  const unsigned long long kx = key[x], ky = key[y];
  if (ky < kx) {
    key[x] = ky;
    key[y] = kx;
  }
}

struct WarpSync {
  __device__ void operator()() const { __syncwarp(); }
};
struct CtaSync {
  __device__ void operator()() const { __syncthreads(); }
};

// Ascending sort of key[0, L) by the bitonic network in its one-direction
// form (a flip stage, then half-cleaners; every comparator puts the
// smaller key at the lower index), padded to a power of two with keys
// taken as +inf: a comparator whose upper index is >= L is left out. The
// `lanes` threads that share the sort take its comparators in turn;
// sync() is their barrier.
template <class Sync>
__device__ void sort_keys(unsigned long long* key, int L, int lane, int lanes,
                          Sync sync) {
  int n2 = 1;
  while (n2 < L) n2 <<= 1;
  for (int k = 2; k <= n2; k <<= 1) {
    const int h = k >> 1;
    for (int i = lane; i < n2 / 2; i += lanes) {
      const int base = (i / h) * k, off = i % h;
      if (base + k - 1 - off < L) cswap(key, base + off, base + k - 1 - off);
    }
    sync();
    for (int j = k >> 2; j >= 1; j >>= 1) {
      for (int i = lane; i < n2 / 2; i += lanes) {
        const int x = (i / j) * 2 * j + i % j;
        if (x + j < L) cswap(key, x, x + j);
      }
      sync();
    }
  }
}

// Node n's walk by one warp over its ordered bucket key[s, e): every lane
// keeps the R running sums, 32 rows' requests are read at once (a row a
// lane) and added in order through shuffles; lane 0 writes the node.
template <int R>
__device__ void warp_walk(const unsigned long long* key, int s, int e,
                          const float* req, float sign, const float* in,
                          float* out, int n, int lane) {
  float u[R];
#pragma unroll
  for (int r = 0; r < R; ++r) u[r] = in[(long long)n * R + r];
  for (int c = s; c < e; c += 32) {
    float v[R];
    const int j = c + lane;
    const long long row = j < e ? (long long)(unsigned)key[j] : 0;
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = j < e ? sign * req[row * R + r] : 0.0f;
    const int m = min(32, e - c);
    for (int t = 0; t < m; ++t)
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] = u[r] + __shfl_sync(FULL, v[r], t);
  }
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) out[(long long)n * R + r] = u[r];
}

// Exclusive prefix sum of a[0, n) in place, by the whole CTA: each thread
// sums a contiguous chunk, the chunk sums are scanned across warps.
__device__ void cta_exclusive_scan(int* a, int n, int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * chunk, n), hi = min(lo + chunk, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int x = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? warp_tot[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  int base = (warp ? warp_tot[warp - 1] : 0) + x - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = base;
    base += c;
  }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(NA_THREADS, 1)
node_add_kernel(int P, int N, const int* __restrict__ node, int node_bs,
                const bool* __restrict__ mask, int mask_bs,
                const int* __restrict__ rank, int rank_bs,
                const float* __restrict__ req, float sign,
                const float* __restrict__ used_in,
                float* __restrict__ used_out, int smem,
                unsigned long long* key_scratch, int* int_scratch) {
  extern __shared__ unsigned long long na_smem[];
  __shared__ int warp_tot[32];
  __shared__ int n_big;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x;
  const long long b = blockIdx.x;  // the tenant
  node += b * node_bs;
  mask += b * mask_bs;
  rank += b * rank_bs;
  req += b * P * R;
  used_in += b * N * R;
  used_out += b * N * R;
  // key[P]: the masked rows' keys, bucketed by node; end[N]: the buckets'
  // ends; big[P / 32 + 2]: the nodes whose bucket passes NA_SMALL.
  unsigned long long* key;
  int* end;
  if (smem) {
    key = na_smem;
    end = reinterpret_cast<int*>(na_smem + P);
  } else {
    key = key_scratch + b * P;
    end = int_scratch + b * (N + P / NA_SMALL + 2);
  }
  int* big = end + N;
  for (int n = tid; n < N; n += T) end[n] = 0;
  if (tid == 0) n_big = 0;
  __syncthreads();
  for (int i = tid; i < P; i += T)
    if (mask[i]) atomicAdd(&end[min(max(node[i], 0), N - 1)], 1);
  __syncthreads();
  cta_exclusive_scan(end, N, warp_tot);
  // Scatter: a bucket's keys land in any order; its start moves to its end.
  for (int i = tid; i < P; i += T)
    if (mask[i])
      key[atomicAdd(&end[min(max(node[i], 0), N - 1)], 1)] =
          row_key(rank[i], i);
  __syncthreads();
  // Bucket n is key[start, end[n]) with start = end[n - 1] (0 for n = 0).
  // A short bucket: its node's thread orders it (insertion sort) and adds
  // its rows in order; an empty one copies the node through.
  for (int n = tid; n < N; n += T) {
    const int s = n ? end[n - 1] : 0, e = end[n];
    if (e - s > NA_SMALL) {
      big[atomicAdd(&n_big, 1)] = n;
      continue;
    }
    for (int x = s + 1; x < e; ++x) {
      const unsigned long long kx = key[x];
      int y = x - 1;
      while (y >= s && key[y] > kx) {
        key[y + 1] = key[y];
        --y;
      }
      key[y + 1] = kx;
    }
    float u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = used_in[(long long)n * R + r];
    for (int x = s; x < e; ++x) {
      const long long row = (unsigned)key[x];
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] = u[r] + sign * req[row * R + r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) used_out[(long long)n * R + r] = u[r];
  }
  __syncthreads();
  const int nb = n_big;
  // Longer buckets up to NA_WARP: a warp each, in turns over the warps.
  for (int x = warp; x < nb; x += T >> 5) {
    const int n = big[x];
    const int s = n ? end[n - 1] : 0, e = end[n];
    if (e - s > NA_WARP) continue;
    sort_keys(key + s, e - s, lane, 32, WarpSync());
    warp_walk<R>(key, s, e, req, sign, used_in, used_out, n, lane);
  }
  // The longest: the whole CTA orders one bucket at a time, warp 0 walks
  // it.
  for (int x = 0; x < nb; ++x) {
    const int n = big[x];
    const int s = n ? end[n - 1] : 0, e = end[n];
    if (e - s <= NA_WARP) continue;
    sort_keys(key + s, e - s, tid, T, CtaSync());
    if (warp == 0) warp_walk<R>(key, s, e, req, sign, used_in, used_out, n,
                                lane);
    __syncthreads();
  }
}

template <int R>
int launch_node_add(int B, int P, int N, const int* node, int node_bs,
                    const bool* mask, int mask_bs, const int* rank,
                    int rank_bs, const float* req, float sign,
                    const float* used_in, float* used_out, int smem,
                    unsigned long long* key_scratch, int* int_scratch,
                    cudaStream_t stream) {
  const size_t bytes =
      smem ? (size_t)P * 8 + (size_t)(N + P / NA_SMALL + 2) * 4 : 0;
  // The dynamic shared memory this instantiation may take past 48 KB, set
  // on a device only where a launch needs more than it was last given
  // there (a race sets it twice, to the same effect).
  static int granted[NA_DEVICES];
  if (bytes > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= NA_DEVICES || (int)bytes > granted[dev]) {
      err = cudaFuncSetAttribute(node_add_kernel<R>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
      if (dev < NA_DEVICES) granted[dev] = (int)bytes;
    }
  }
  node_add_kernel<R><<<B, NA_THREADS, bytes, stream>>>(
      P, N, node, node_bs, mask, mask_bs, rank, rank_bs, req, sign, used_in,
      used_out, smem, key_scratch, int_scratch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tpusched_node_add(int B, int P, int N, int R,
                                 const int* node, int node_bs,
                                 const bool* mask, int mask_bs,
                                 const int* rank, int rank_bs,
                                 const float* req, int sign,
                                 const float* used_in, float* used_out,
                                 int smem, unsigned long long* key_scratch,
                                 int* int_scratch, void* stream) {
  const float sg = (float)sign;
  const cudaStream_t st = (cudaStream_t)stream;
#define NODE_ADD_CASE(RR)                                                   \
  case RR:                                                                  \
    return launch_node_add<RR>(B, P, N, node, node_bs, mask, mask_bs, rank, \
                               rank_bs, req, sg, used_in, used_out, smem,   \
                               key_scratch, int_scratch, st);
  switch (R) {
    NODE_ADD_CASE(1)
    NODE_ADD_CASE(2)
    NODE_ADD_CASE(3)
    NODE_ADD_CASE(4)
    NODE_ADD_CASE(5)
    NODE_ADD_CASE(6)
    NODE_ADD_CASE(7)
    NODE_ADD_CASE(8)
  }
#undef NODE_ADD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int tpusched_prefix_commit(int B, int P, int N, int R, int KC,
                                      const int* perm, const int* cand_s,
                                      const float* req, const float* alloc,
                                      float* used, int* choice, int* ptr,
                                      float* buf_f, int* buf_i,
                                      unsigned char* fit, void* stream) {
  prefix_commit_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      P, N, R, KC, perm, cand_s, req, alloc, used, choice, ptr, buf_f,
      buf_f + P, buf_i, buf_i + P, fit);
  return (int)cudaGetLastError();
}
