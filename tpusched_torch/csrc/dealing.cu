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

}  // namespace

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
