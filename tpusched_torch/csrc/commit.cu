// K8: the capacity-prefix commits of a fast round, and node_add.
//
// prefix_commit_loop replaces tpusched/kernels/assign.py:888-957, the
// while_loop of _deal_commit's commit sub-steps (cum_width=None), with one
// launch a round: one CTA of 1 024 threads a tenant runs its tenant's
// sub-steps until no row is active. Each row keeps its pointer into its
// candidate list (topi / topv [P, KC]: the dealt node, then the top-K) on
// chip; a row is active while it is allowed, uncommitted (ptr < KC) and
// its candidate topv[ptr] is finite. Per sub-step:
//  * the active rows are counted by node (shared-memory atomics); a
//    CTA-wide OR of `any active` ends the loop (JAX's sub_cond);
//  * the active rows are ordered by (node, rank), node_add's bucketing
//    below: a 64-bit (rank, row) key per row scattered into its node's
//    bucket, each bucket put in key order. The buckets packed in node
//    order are exactly the layout the stable sort of (node, rank) keys
//    gave (active rows first, each node in rank order), and a segment's
//    start is its bucket's offset;
//  * the request prefix is a Hillis-Steele scan over the A active rows
//    only (step d adds row i - d to row i for d = 1, 2, 4, ...). Row i's
//    sum reads rows <= i alone, and the full-width scan's rows >= A held
//    zeros, so rows < A get the same bits as before;
//  * per row: within = cum[i] - (s > 0 ? cum[s - 1] : 0) (JAX's
//    association; s the segment start), fits = forall r: used[n] + within
//    <= alloc[n]; the first row of each node that does not fit stops its
//    commits (an atomicMin a node); a row before it commits (choice = n,
//    ptr = KC), a row that does not fit advances (ptr + 1);
//  * `used` gains each node's commits one at a time in ascending rank,
//    by the node's thread, or by a warp for a bucket past 32 rows (as
//    node_add walks). JAX adds them with a duplicate-index f32
//    scatter-add of unspecified order (an atomic add on CUDA, whose
//    rounding changes run to run).
// steps[b] gets the number of sub-steps tenant b ran. Bound: latency. The
// bytes (candidate lists, requests, usage once) take well under a
// microsecond at P = 10 240; what costs is the chain of CTA barriers, about
// R * log2(A) + 12 a sub-step, and the sub-steps of a round run back to
// back with no host read or launch between them. The buckets, pointers,
// fit flags, each node's first non-fitting row and the scan's two
// buffers (18 P + 8 N + 4 (P / 32 + 2) bytes) live in shared memory where
// they fit in a CTA's 227 KB (P = 10 240 with N = 5 120 does), else in
// global scratch.
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
// Both take the rows unsorted. One CTA of 1 024 threads a tenant counts
// each node's rows (shared-memory atomics), scans the counts, and
// scatters a 64-bit (rank, row) key per row into its node's bucket, in
// whatever order the atomics land. Each bucket is then put in key order,
// which is the stable sort's order whatever the scatter's was: a bucket
// of up to 32 rows by its node's thread (insertion sort), up to 1 024 by a
// warp and past that by the whole CTA (a bitonic sort in its
// one-direction form, padded with +inf keys), so a skewed bucket (a gang
// rolled back on one node, a small cluster, a round whose candidates all
// name one node) never goes quadratic in one thread. A node's adds then
// run in that order: the thread's own, or, for a long bucket, a warp
// reading 32 rows' requests at once and adding them in order through
// shuffles. node_add's buckets (P * 8 + (N + P / 32 + 2) * 4 bytes) live in
// shared memory where they fit, else in global scratch. Ranks are
// compared as they are (a compacted view's ranks are global and may pass
// its P). node_add's bound: bytes ([P] node, mask, rank, [P, R] requests
// read once, [N, R] used read and written once), 0.1 us of them at P =
// 10 240, N = 5 120; what costs is latency: one launch and a handful of
// CTA barriers.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): gridDim.x = B, and CTA
// b runs tenant b's sub-steps or node_add on its own rows, buckets and
// usage.
#include <limits.h>
#include <math.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 1024;
constexpr int SMALL = 32;      // longest bucket one thread orders and walks
constexpr int WARP_MAX = 1024; // longest bucket one warp orders; past it the CTA
constexpr int DEVICES = 64;    // devices whose shared-memory opt-in is tracked
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

// -- the buckets (node_add and prefix_commit_loop) ---------------------------
// key[P]: the rows' keys, bucketed by node; end[N]: each bucket's count
// before bucket_scatter, its end after it (bucket n is key[start, end[n])
// with start = end[n - 1], 0 for n = 0); big[P / SMALL + 2]: the nodes
// whose bucket passes SMALL.
struct Buckets {
  unsigned long long* key;
  int* end;
  int* big;
};

__device__ __forceinline__ int bucket_start(const Buckets& bk, int n) {
  return n ? bk.end[n - 1] : 0;
}

// After the counts are in end[] (and a barrier): scan them and scatter
// key_of(i) of every row with node_of(i) >= 0 into its node's bucket.
template <class NodeOf, class KeyOf>
__device__ void bucket_scatter(const Buckets& bk, int P, int N,
                               NodeOf node_of, KeyOf key_of, int* warp_tot) {
  cta_exclusive_scan(bk.end, N, warp_tot);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int n = node_of(i);
    if (n >= 0) bk.key[atomicAdd(&bk.end[n], 1)] = key_of(i);
  }
  __syncthreads();
}

// Every bucket in key order: up to SMALL rows by its node's thread, up to
// WARP_MAX by a warp (in turns over the warps), past that by the CTA one
// bucket at a time. Lists the buckets past SMALL in big[] and returns
// their count; *n_big must be 0 on entry.
__device__ int order_buckets(const Buckets& bk, int N, int* n_big) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x;
  for (int n = tid; n < N; n += T) {
    const int s = bucket_start(bk, n), e = bk.end[n];
    if (e - s > SMALL) {
      bk.big[atomicAdd(n_big, 1)] = n;
      continue;
    }
    for (int x = s + 1; x < e; ++x) {
      const unsigned long long kx = bk.key[x];
      int y = x - 1;
      while (y >= s && bk.key[y] > kx) {
        bk.key[y + 1] = bk.key[y];
        --y;
      }
      bk.key[y + 1] = kx;
    }
  }
  __syncthreads();
  const int nb = *n_big;
  for (int x = warp; x < nb; x += T >> 5) {
    const int n = bk.big[x];
    const int s = bucket_start(bk, n), e = bk.end[n];
    if (e - s <= WARP_MAX) sort_keys(bk.key + s, e - s, lane, 32, WarpSync());
  }
  for (int x = 0; x < nb; ++x) {
    const int n = bk.big[x];
    const int s = bucket_start(bk, n), e = bk.end[n];
    if (e - s > WARP_MAX) sort_keys(bk.key + s, e - s, tid, T, CtaSync());
  }
  __syncthreads();
  return nb;
}

// Node n's walk by one warp over its ordered rows key[s, e): every lane
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

// Each node's adds over the ordered rows key[s, stop(n, s, e)) of its
// bucket, out[n] = in[n] + sign * req row by row: a short bucket by its
// node's thread, a listed long one by a warp. A node with nothing to add
// is copied through unless out is in (in place: nothing to write).
template <int R, class Stop>
__device__ void walk_buckets(const Buckets& bk, int N, int nb,
                             const float* req, float sign, const float* in,
                             float* out, Stop stop) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x;
  for (int n = tid; n < N; n += T) {
    const int s = bucket_start(bk, n), e = bk.end[n];
    if (e - s > SMALL) continue;
    const int x_end = stop(n, s, e);
    if (x_end <= s && in == out) continue;
    float u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = in[(long long)n * R + r];
    for (int x = s; x < x_end; ++x) {
      const long long row = (unsigned)bk.key[x];
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] = u[r] + sign * req[row * R + r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) out[(long long)n * R + r] = u[r];
  }
  for (int x = warp; x < nb; x += T >> 5) {
    const int n = bk.big[x];
    const int s = bucket_start(bk, n);
    warp_walk<R>(bk.key, s, stop(n, s, bk.end[n]), req, sign, in, out, n,
                 lane);
  }
}

// The dynamic shared memory `bytes` a launch of `kernel` takes, opted in
// past 48 KB on the current device only where a launch needs more than
// it was last given there (*granted per device; a race sets it twice, to
// the same effect).
template <class Kernel>
cudaError_t grant_smem(Kernel kernel, size_t bytes, int* granted) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < DEVICES && (int)bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < DEVICES) granted[dev] = (int)bytes;
  return err;
}

// -- prefix_commit_loop ------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(THREADS, 1)
prefix_commit_loop_kernel(int P, int N, int KC, const int* __restrict__ topi,
                          const float* __restrict__ topv,
                          const bool* __restrict__ allowed,
                          const int* __restrict__ rank,
                          const float* __restrict__ req,
                          const float* __restrict__ alloc,
                          const float* __restrict__ used_in, float* used,
                          int* __restrict__ choice, int* __restrict__ steps,
                          int smem, unsigned long long* key_scratch,
                          int* int_scratch, float* float_scratch,
                          unsigned char* byte_scratch) {
  extern __shared__ unsigned long long pc_smem[];
  __shared__ int warp_tot[32];
  __shared__ int n_big;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const long long b = blockIdx.x;  // the tenant
  topi += b * P * KC;
  topv += b * P * KC;
  allowed += b * P;
  rank += b * P;
  req += b * P * R;
  alloc += b * N * R;
  used_in += b * N * R;
  used += b * N * R;
  choice += b * P;
  // key[P], the scan's buffers cum_a[P] and cum_b[P], end[N], each node's
  // first non-fitting row bad[N], big[P / SMALL + 2], ptr[P], fit[P].
  const int n_ints = 2 * N + P / SMALL + 2;
  unsigned long long* key;
  float* cum_a;
  int* ints;
  unsigned char* bytes;
  if (smem) {
    key = pc_smem;
    cum_a = reinterpret_cast<float*>(pc_smem + P);
    ints = reinterpret_cast<int*>(cum_a + 2 * P);
    bytes = reinterpret_cast<unsigned char*>(ints + n_ints);
  } else {
    key = key_scratch + b * P;
    cum_a = float_scratch + b * 2 * P;
    ints = int_scratch + b * n_ints;
    bytes = byte_scratch + b * 2 * P;
  }
  float* cum_b = cum_a + P;
  int* bad = ints + N;
  unsigned char* ptr = bytes;
  unsigned char* fit = bytes + P;
  const Buckets bk{key, ints, ints + 2 * N};

  for (int i = tid; i < P; i += T) {
    choice[i] = -1;
    ptr[i] = allowed[i] ? 0 : (unsigned char)KC;
  }
  for (int o = tid; o < N * R; o += T) used[o] = used_in[o];
  // Row i's candidate node while it is active, else -1.
  auto cand_of = [&](int i) {
    const int p = ptr[i];
    if (p >= KC) return -1;
    const long long o = (long long)i * KC + p;
    const int n = topi[o];
    return topv[o] > -INFINITY && n >= 0 && n < N ? n : -1;
  };
  int step = 0;
  for (;;) {
    for (int n = tid; n < N; n += T) {
      bk.end[n] = 0;
      bad[n] = INT_MAX;
    }
    if (tid == 0) n_big = 0;
    __syncthreads();
    bool any = false;
    for (int i = tid; i < P; i += T) {
      const int n = cand_of(i);
      if (n >= 0) {
        atomicAdd(&bk.end[n], 1);
        any = true;
      }
    }
    if (!__syncthreads_or(any)) break;
    ++step;
    bucket_scatter(bk, P, N, cand_of,
                   [&](int i) { return row_key(rank[i], i); }, warp_tot);
    const int nb = order_buckets(bk, N, &n_big);
    const int A = bk.end[N - 1];  // the active rows, packed in node order
    for (int r = 0; r < R; ++r) {
      for (int j = tid; j < A; j += T) {
        const int row = (int)(unsigned)key[j];
        if (r == 0) {
          // The rank has done its work: the key now holds (node, row).
          const int n = topi[(long long)row * KC + ptr[row]];
          key[j] = ((unsigned long long)(unsigned)n << 32) | (unsigned)row;
          fit[j] = 1;
        }
        cum_a[j] = req[(long long)row * R + r];
      }
      __syncthreads();
      float* src = cum_a;
      float* dst = cum_b;
      for (int d = 1; d < A; d <<= 1) {
        for (int j = tid; j < A; j += T)
          dst[j] = j >= d ? src[j] + src[j - d] : src[j];
        __syncthreads();
        float* t = src;
        src = dst;
        dst = t;
      }
      for (int j = tid; j < A; j += T) {
        const int n = (int)(key[j] >> 32);
        const int s = bucket_start(bk, n);
        const float within = src[j] - (s > 0 ? src[s - 1] : 0.0f);
        const long long o = (long long)n * R + r;
        if (!(used[o] + within <= alloc[o])) {
          fit[j] = 0;
          atomicMin(&bad[n], j);
        }
      }
      __syncthreads();
    }
    // Rows before their node's first non-fitting row commit; a row that
    // does not fit moves to its next candidate; the others (blocked by an
    // earlier row of their node) try the same node again.
    for (int j = tid; j < A; j += T) {
      const int n = (int)(key[j] >> 32);
      const int row = (int)(unsigned)key[j];
      if (j < bad[n]) {
        choice[row] = n;
        ptr[row] = (unsigned char)KC;
      } else if (!fit[j]) {
        ptr[row] = ptr[row] + 1;
      }
    }
    walk_buckets<R>(bk, N, nb, req, 1.0f, used, used,
                    [&](int n, int s, int e) { return min(bad[n], e); });
    __syncthreads();
  }
  if (tid == 0) steps[b] = step;
}

int pc_granted[DEVICES];

template <int R>
int launch_prefix_commit_loop(int B, int P, int N, int KC, const int* topi,
                              const float* topv, const bool* allowed,
                              const int* rank, const float* req,
                              const float* alloc, const float* used_in,
                              float* used, int* choice, int* steps, int smem,
                              unsigned long long* key_scratch,
                              int* int_scratch, float* float_scratch,
                              unsigned char* byte_scratch,
                              cudaStream_t stream) {
  const size_t bytes =
      smem ? (size_t)P * 18 + (size_t)(2 * N + P / SMALL + 2) * 4 : 0;
  const cudaError_t err =
      grant_smem(prefix_commit_loop_kernel<R>, bytes, pc_granted);
  if (err != cudaSuccess) return (int)err;
  prefix_commit_loop_kernel<R><<<B, THREADS, bytes, stream>>>(
      P, N, KC, topi, topv, allowed, rank, req, alloc, used_in, used, choice,
      steps, smem, key_scratch, int_scratch, float_scratch, byte_scratch);
  return (int)cudaGetLastError();
}

// -- node_add ---------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(THREADS, 1)
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
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const long long b = blockIdx.x;  // the tenant
  node += b * node_bs;
  mask += b * mask_bs;
  rank += b * rank_bs;
  req += b * P * R;
  used_in += b * N * R;
  used_out += b * N * R;
  Buckets bk;
  if (smem) {
    bk.key = na_smem;
    bk.end = reinterpret_cast<int*>(na_smem + P);
  } else {
    bk.key = key_scratch + b * P;
    bk.end = int_scratch + b * (N + P / SMALL + 2);
  }
  bk.big = bk.end + N;
  for (int n = tid; n < N; n += T) bk.end[n] = 0;
  if (tid == 0) n_big = 0;
  __syncthreads();
  auto node_of = [&](int i) {
    return mask[i] ? min(max(node[i], 0), N - 1) : -1;
  };
  for (int i = tid; i < P; i += T) {
    const int n = node_of(i);
    if (n >= 0) atomicAdd(&bk.end[n], 1);
  }
  __syncthreads();
  bucket_scatter(bk, P, N, node_of,
                 [&](int i) { return row_key(rank[i], i); }, warp_tot);
  const int nb = order_buckets(bk, N, &n_big);
  walk_buckets<R>(bk, N, nb, req, sign, used_in, used_out,
                  [](int n, int s, int e) { return e; });
}

int na_granted[DEVICES];

template <int R>
int launch_node_add(int B, int P, int N, const int* node, int node_bs,
                    const bool* mask, int mask_bs, const int* rank,
                    int rank_bs, const float* req, float sign,
                    const float* used_in, float* used_out, int smem,
                    unsigned long long* key_scratch, int* int_scratch,
                    cudaStream_t stream) {
  const size_t bytes =
      smem ? (size_t)P * 8 + (size_t)(N + P / SMALL + 2) * 4 : 0;
  const cudaError_t err = grant_smem(node_add_kernel<R>, bytes, na_granted);
  if (err != cudaSuccess) return (int)err;
  node_add_kernel<R><<<B, THREADS, bytes, stream>>>(
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

extern "C" int tpusched_prefix_commit_loop(
    int B, int P, int N, int R, int KC, const int* topi, const float* topv,
    const bool* allowed, const int* rank, const float* req,
    const float* alloc, const float* used_in, float* used, int* choice,
    int* steps, int smem, unsigned long long* key_scratch, int* int_scratch,
    float* float_scratch, unsigned char* byte_scratch, void* stream) {
  if (KC < 1 || KC > 255) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define LOOP_CASE(RR)                                                       \
  case RR:                                                                  \
    return launch_prefix_commit_loop<RR>(                                   \
        B, P, N, KC, topi, topv, allowed, rank, req, alloc, used_in, used,  \
        choice, steps, smem, key_scratch, int_scratch, float_scratch,       \
        byte_scratch, st);
  switch (R) {
    LOOP_CASE(1)
    LOOP_CASE(2)
    LOOP_CASE(3)
    LOOP_CASE(4)
    LOOP_CASE(5)
    LOOP_CASE(6)
    LOOP_CASE(7)
    LOOP_CASE(8)
  }
#undef LOOP_CASE
  return (int)cudaErrorInvalidValue;
}
