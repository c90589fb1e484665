// Thread-block clusters: the CTA's place in its cluster, the cluster
// barrier, DSMEM records into mbarrier slots, and the launch of B
// clusters of Q CTAs. Shared by K4 (csrc/scan.cu: the pick, tie counts
// and extents between the CTAs of a tenant) and K18 (csrc/auction.cu: the
// claim iterations' bidder counts).
#pragma once

#include <cuda_runtime.h>

namespace tpusched {

constexpr int MAX_CLUSTER = 16;  // the card's non-portable cluster size

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_ctas() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return (int)r;
}

// barrier.cluster: arrive has release and wait acquire semantics at
// cluster scope, so what a thread wrote before arriving (shared memory of
// any CTA of the cluster, device memory) is visible to every thread of
// the cluster after its wait. Every thread of every CTA takes part.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// -- exchanges without a cluster barrier ------------------------------------
// A record (8 bytes) of each CTA into slot [rank] of every CTA: st.async
// writes it into the receiver's shared memory and completes the
// transaction count of the receiver's mbarrier for that exchange, and a
// CTA waits on its own mbarrier's phase for all Q records, not for the
// whole cluster (no barrier.cluster, whose release would also wait for
// the loads each thread has in flight).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// The generic address of *p in the shared memory of CTA `rank`: loads,
// stores and atomics through it reach that CTA (DSMEM).
template <typename T>
__device__ __forceinline__ T* cluster_ptr(T* p, int rank) {
  unsigned long long r;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(r) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(r);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

// Makes the mbarriers a CTA initialised visible to the cluster's
// st.async (before the cluster barrier that precedes any of them).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The local arrival of an exchange, expecting `bytes` from the cluster.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned phase) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  } while (!done);
}

// rec into *slot of CTA `rank`, completing 8 bytes of its *bar.
__device__ __forceinline__ void st_async(uint2* slot, int rank, uint2 rec,
                                         unsigned long long* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];"
      :: "r"(cluster_addr(slot, rank)), "r"(rec.x), "r"(rec.y),
         "r"(cluster_addr(bar, rank)) : "memory");
}

// B clusters of Q CTAs (Q in 1, 2, 4, 8, 16) of `threads` threads with
// `dyn` bytes of dynamic shared memory each: the shared-memory opt-in
// when static and dynamic pass 48 KB, the non-portable size attribute
// for Q = 16, and a check that the card can place one cluster (a Q it
// cannot place raises: no smaller Q instead).
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int B, int Q, int threads,
                            size_t dyn, cudaStream_t stream, Args... args) {
  if (Q != 1 && Q != 2 && Q != 4 && Q != 8 && Q != MAX_CLUSTER)
    return cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  if (dyn > 0 && dyn + fa.sharedSizeBytes > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return e;
  }
  if (Q > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * Q));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (Q > 1) {
    int fit = 0;
    e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (fit < 1) return cudaErrorLaunchOutOfResources;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace tpusched
