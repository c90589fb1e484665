// K4: the parity scan, one persistent thread-block cluster a tenant.
//
// Replaces tpusched/kernels/assign.py:426 solve_sequential (its lax.scan
// over pods with pod_cycle :311 and pick_node :365, filter.resource_fit,
// score.least_requested and score.balanced_allocation inside) for
// snapshots without signatures, gangs or preemption. With no signature
// the spread and inter-pod normalisers are the constants 100 and 0, so
// the score of pod p on node n is, in assign.py:324-330's association,
//   ((((w_lr*LR + w_ba*BA) + static[p,n]) + w_ts*100) + w_ia*0).
//
// Bound: latency, not bytes. Pod i+1 scores against the `used` that pod
// i's commit left, so the P pods form a chain of P dependent argmaxes over
// the nodes; the bytes (mask + static rows, 5 bytes a cell, 0.26 GB at
// 10240 x 5120) would take 0.08 ms at 3.35 TB/s. The chain stays inside
// one launch (no launch or grid-wide barrier per pod), and each pod's
// work is spread over a thread-block cluster of Q CTAs a tenant (Q in
// {1, 2, 4, 8, 16}, chosen by the wrapper; 16 needs the non-portable
// cluster size). CTA q owns the contiguous node range [q*span, (q+1)*span)
// and keeps only its slice of `used` and `alloc` in shared memory (123
// KB / Q at N = 5120, R = 3); inside the range, thread t owns nodes
// base + t + k*THREADS, so a warp's loads of a mask or score row are
// coalesced. Per pod:
//  * every thread scores its nodes; the pod's mask and static-score
//    entries of its first KR nodes were loaded into registers while the
//    previous pod ran (order is known at launch: order[i+2], then pod
//    i+1's rows and its requests and weights are read during pod i);
//  * one exchange: the CTA reduces its warps' (best, index) pairs (one
//    __syncthreads), warp 0 writes the CTA's pair by st.async into a
//    slot of every CTA (DSMEM; slots double-buffered), each write
//    completing 8 bytes of the receiver's mbarrier, and once its
//    mbarrier holds all Q pairs every warp of a CTA reduces them, all
//    with `beats` (larger value, then lower index: associative, so any
//    tree gives the same pick). No barrier.cluster a pod: its release
//    would also wait for every thread's loads in flight, the rows read
//    ahead among them;
//  * the thread that owns the picked node adds the pod's request to its
//    own `used` row and writes assigned/chosen: it is the only thread
//    that ever reads that row, so the commit needs no barrier.
// The seeded tie-break (the h-th tie in node order) adds one exchange of
// the CTAs' tie counts. With one node a thread (the wrapper picks the
// threads so where it can), warps and lanes are in node order and the
// warp that holds h finds it by a ballot; otherwise the CTA whose range
// holds h finds the tile of THREADS nodes and the warp that hold it from
// each warp's tie count a tile (the count pass keeps each thread's ties
// as a bitmask; one barrier for every 32 tiles). The owner of the h-th
// tie commits.
//
// The pairwise variant (PAIR = true, entry point
// tpusched_parity_scan_pair) is the same scan for snapshots with
// signatures (topology spread, inter-pod affinity): pod_cycle with
// tpusched/kernels/pairwise.py:504 pairwise_row and the two normalisers,
// in assign.py:324-330's association
//   ((((w_lr*LR + w_ba*BA) + static) + w_ts*inv_norm(pen)) + w_ia*minmax(raw)),
// then :201 pair_state_add_pod after each commit. Per pod: the spread
// slots' extents (min count over eligible nodes, max count over nodes
// with the key) and then the normalisers' extents, each a min/max over
// the cluster (exact in any order: each CTA reduces its range and
// exchanges its values as the pick is); in between, a
// pass that evaluates pairwise.cuh's cell at each of the thread's nodes
// into pen/raw/allowed scratch; then K4's pick and commit, where the
// thread that commits also adds the pod to the pair state. `used` and
// `alloc` may take 123 KB of shared memory, which leaves no room for the
// [S, N] counts: counts/anti/match_tot and the [N] scratch live in
// device memory (L1/L2); each thread reads only the scratch cells it
// wrote. The pair-state adds of pod i reach every CTA of the cluster
// through a split barrier.cluster: every thread arrives (release) after
// pod i's commit and waits (acquire) before pod i+1 reads the counts for
// its spread extents (the one cluster barrier a pod; the loads read
// ahead for pod i+1 were issued at pod i's start and have landed). These
// pointers are not __restrict__/read-only, since the kernel writes them.
//
// The preemption variants (PREEMPT = true, entry points
// tpusched_parity_scan_preempt and tpusched_parity_scan_pair_preempt)
// add assign.py:408 _preempt_branch, the PostFilter of :448-487: a valid
// pod outside a gang that fits nowhere runs K15's victim search
// (preempt.cuh) against its allowed row before any eviction (the static
// mask, with PAIR and the pairwise verdicts), with `used` as it stands.
// If a prefix fits, thread 0 evicts its victims (evicted[m] = 1, the
// budget's remaining disruptions - 1, with PAIR pairwise.py:240
// pair_state_evict), subtracts their requests' segment sum (the value
// the fit was tested with) from used[n] in one step and adds the pod's
// (JAX's `used - freed`, then `.at[n].add`), adds
// the pod to the pair state, and places it with chosen = -inf (no
// rescore). The victim table, the budget counts and the evictions in
// the victims' sorted order (ev_s, which K15 reads and thread 0 marks)
// live in device memory; K15 keeps its per-node state in registers and
// needs 0.5 KB of static shared memory for its block reduction. K15's
// node-major walk needs every node in one CTA, so the preemption
// variants launch one CTA of 1 024 threads a tenant (a cluster of one):
// the exchanges go through shared memory and __syncthreads, the rows are
// read as the pod needs them, and a barrier ends every pod (thread 0's
// evictions and K15's reads of any node's `used`). With the optional
// outputs evictor / evict_pos (the explained solve's provenance,
// tpusched/kernels/assign.py:484-487), thread 0 also writes, for each
// victim it evicts, the pod's index and its step in pop order; the CTA
// is the only writer, so no atomics. NULL leaves the kernel as it was.
//
// Tenant axis (tpusched/tenants.py:75 solve_many, entry points
// tpusched_parity_scan and tpusched_parity_scan_pair): B clusters, and
// cluster b scans tenant b alone ([B, P] order, weights and outputs,
// [B, P, N] mask and static score, [B, N, R] allocatable and usage,
// [B, P, R] requests; rw is shared), each CTA with its own slice of the
// tenant's `used`/`alloc`. The seeded tie hash takes the tenant's own pod
// index. With PAIR every array of the pairwise block gains the leading
// [B] axis too, the pair state [B, S, N] / [B, S] and the [B, N] scratch
// included, so cluster b reads and updates only its tenant's state (the
// TENANTS instantiation). The B scans are independent, so B tenants take
// about one tenant's time while B x Q <= 132 SMs. The preemption
// variants (entry points tpusched_parity_scan_preempt and
// tpusched_parity_scan_pair_preempt) take the axis the same way:
// with PREEMPT the TENANTS instantiation also offsets the preemption
// block to tenant b (tenant_pre): its victim table (node offsets [B, N +
// 1], planes [B, V, N] and [B, R, V, N], sorted order [B, M] and [B, M,
// R]), its pods' priority, validity and gang, its nodes' validity, its
// running pods' nodes and anti terms, its budgets and its evictions (by
// pod and in the sorted order), so that K15's search and every segment
// sum stay inside the tenant's own victims. The explain outputs stay
// solo (NULL for B > 1). At 1 024 threads, B = 1 launches the
// instantiations without TENANTS (the copied blocks cost registers).
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "cell.cuh"
#include "kernels.h"
#include "pairwise.cuh"
#include "preempt.cuh"

namespace {

using tpusched::MAX_R;
using tpusched::ResW;
using tpusched::beats;
using tpusched::tie_hash;

constexpr int MAX_Q = 16;        // CTAs a tenant's cluster
constexpr int KR = 2;            // nodes a thread keeps in registers
constexpr int POD_F = MAX_R + 4; // a pod's requests, then its 4 weights
constexpr int SMEM_LIMIT = 220 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// The pairwise variant's state and per-node scratch (unused at S = 0).
struct PairScan {
  tpusched::PairTerms t;
  float* counts;             // [S, N] in/out
  float* anti;               // [S, N] in/out
  float* match_tot;          // [S] in/out
  float* pen;                // [N] scratch: spread penalty
  float* raw;                // [N] scratch: inter-pod raw score
  unsigned char* allowed;    // [N] scratch: static mask & pairwise ok
};

// The preemption variants' victim table and per-pod arrays (unused
// without PREEMPT).
struct PreemptScan {
  tpusched::Victims v;
  const float* prio;         // [P] pending pods' effective priority
  const bool* pod_valid;     // [P]
  const int* group;          // [P] gang (-1: none)
  const bool* node_valid;    // [N]
  const int* run_node;       // [M] running pod's node
  const int* run_anti_sig;   // [M, J] its required anti terms (-1 pad)
  int J;
  float* remaining;          // [GP] in/out: budgets' disruptions left
  unsigned char* evicted;    // [M] out (zeros on entry)
  unsigned char* ev_s;       // [M] scratch (zeros): evicted, sorted order
  int* evictor;              // [M] out or NULL: the evicting pod
  int* evict_pos;            // [M] out or NULL: its pop-order step
};

struct NoSmem {};

// Tenant b's preemption block (PREEMPT with TENANTS).
__device__ __forceinline__ PreemptScan tenant_pre(PreemptScan pre,
                                                  long long b, int P,
                                                  int N) {
  tpusched::Victims& v = pre.v;
  const long long M = v.M;
  const long long VN = (long long)v.V * N;
  v.off += b * (N + 1);
  v.pl_vic += b * VN;
  v.pl_req += b * v.R * VN;
  v.perm += b * M;
  v.cost_s += b * M;
  v.vprio_s += b * M;
  v.req_s += b * M * v.R;
  v.pdb_s += b * M;
  pre.prio += b * P;
  pre.pod_valid += b * P;
  pre.group += b * P;
  pre.node_valid += b * N;
  pre.run_node += b * M;
  pre.run_anti_sig += b * M * pre.J;
  pre.remaining += b * v.GP;
  pre.evicted += b * M;
  pre.ev_s += b * M;
  return pre;
}

// Pod p's requests (in shared memory) and weights.
struct PodCtx {
  const float* rq;
  float w_lr, w_ba, w_ts, w_ia;
};

// PAIR only: the pod's normaliser extents over valid nodes (spread
// penalty lo/hi, inter-pod raw lo/hi).
struct Norm {
  float plo, phi, rlo, rhi;
};

// Feasibility and score of one (pod, node) cell (cell.cuh's arithmetic,
// plus pod_cycle's `+ w_ia * 0`, or with PAIR the pairwise scores read
// from the scratch the pod's pairwise pass wrote); mk and st are the
// node's static mask and score entries, u and a its `used` and `alloc`
// rows. Returns false when the node is infeasible (static mask, pairwise
// or resource fit).
template <bool PAIR>
__device__ __forceinline__ bool cell(const PodCtx& c, int n, bool mk, float st,
                                     const float* u, const float* a, int R,
                                     const ResW& w, const PairScan& ps,
                                     const Norm& nm, float* out) {
  if constexpr (PAIR) {
    if (!ps.allowed[n]) return false;
  } else {
    if (!mk) return false;
  }
  if (!tpusched::cell_fits<MAX_R>(u, a, c.rq, R)) return false;
  float s;
  if constexpr (PAIR) {
    s = tpusched::cell_dynamic<MAX_R>(u, a, c.rq, R, w, c.w_lr, c.w_ba);
    s = s + st;
    s = s + c.w_ts * tpusched::inverse_norm(ps.pen[n], nm.plo, nm.phi);
    s = s + c.w_ia * tpusched::minmax_norm(ps.raw[n], nm.rlo, nm.rhi);
  } else {
    s = tpusched::cell_score<MAX_R>(u, a, c.rq, R, w, c.w_lr, c.w_ba, st,
                                    c.w_ts);
    s = s + c.w_ia * 0.0f;
  }
  *out = s;
  return true;
}

// -- the cluster ------------------------------------------------------------

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

// A barrier of the whole cluster (CL), or of the CTA: the scan's start
// and end.
template <bool CL>
__device__ __forceinline__ void xsync() {
  if constexpr (CL) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ void warp_min_max(float& lo, float& hi) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, off));
  }
}

// pair_state_add_pod(p, n): selector matches into counts and match_tot,
// required anti terms into anti (integer adds). Thread 0.
__device__ __forceinline__ void pair_add_pod(const PairScan& ps, int p,
                                             int n) {
  const tpusched::PairTerms& t = ps.t;
  const long long N = t.N;
  for (int s = 0; s < t.S; ++s) {
    if (!t.match[(long long)s * t.X + t.M + p]) continue;
    ps.match_tot[s] = ps.match_tot[s] + 1.0f;
    const int d = t.dom[s * N + n];
    if (d >= 0) {
      const long long i = s * N + d;
      ps.counts[i] = ps.counts[i] + 1.0f;
    }
  }
  for (int it = 0; it < t.IT; ++it) {
    const long long pt = (long long)p * t.IT + it;
    if (!(t.ia_valid[pt] && t.ia_anti[pt] && t.ia_required[pt])) continue;
    const int s = max(t.ia_sig[pt], 0);
    const int d = t.dom[s * N + n];
    if (d >= 0) {
      const long long i = s * N + d;
      ps.anti[i] = ps.anti[i] + 1.0f;
    }
  }
}

// pair_state_evict for running member m: its selector matches leave
// match_tot and (on a keyed node) counts, its required anti terms leave
// anti (integer adds). Thread 0.
__device__ __forceinline__ void pair_evict(const PairScan& ps,
                                           const PreemptScan& pre, int m) {
  const tpusched::PairTerms& t = ps.t;
  const long long N = t.N;
  const int node = pre.run_node[m];
  for (int s = 0; s < t.S; ++s) {
    if (!t.match[(long long)s * t.X + m]) continue;
    ps.match_tot[s] = ps.match_tot[s] - 1.0f;
    const int d = node >= 0 ? t.dom[s * N + node] : -1;
    if (d >= 0) {
      const long long i = s * N + d;
      ps.counts[i] = ps.counts[i] - 1.0f;
    }
  }
  for (int j = 0; j < pre.J; ++j) {
    const int s = pre.run_anti_sig[(long long)m * pre.J + j];
    if (s < 0 || node < 0) continue;
    const int d = t.dom[s * N + node];
    if (d >= 0) {
      const long long i = s * N + d;
      ps.anti[i] = ps.anti[i] - 1.0f;
    }
  }
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

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
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

// The next pod's mask and static-score entries at the thread's first KR
// nodes (n0, n0 + THREADS, ...), read ahead into registers.
template <int K, int THREADS>
__device__ __forceinline__ void load_rows(const bool* mask, const float* st,
                                          int n0, int end, float (&sv)[K],
                                          bool (&mv)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = n0 + k * THREADS;
    if (n < end) {
      sv[k] = st[n];
      mv[k] = mask[n];
    }
  }
}

template <bool PAIR, bool PREEMPT, bool TENANTS, int THREADS>
__global__ void __launch_bounds__(THREADS)
parity_scan_kernel(int P, int N, int R, const int* __restrict__ order,
                   const bool* __restrict__ mask,
                   const float* __restrict__ static_score,
                   const float* __restrict__ alloc_g,
                   const float* __restrict__ requests,
                   const float* __restrict__ w_lr,
                   const float* __restrict__ w_ba,
                   const float* __restrict__ w_ts,
                   const float* __restrict__ w_ia,
                   const float* __restrict__ rw_g, int seeded,
                   unsigned seed, float* used_g, int* __restrict__ assigned,
                   float* __restrict__ chosen, int use_smem, PairScan ps,
                   PreemptScan pre) {
  static_assert(!PREEMPT || THREADS == tpusched::PRE_THREADS,
                "K15 runs in K4's CTA");
  constexpr int WARPS = THREADS / 32;
  constexpr bool CL = !PREEMPT;               // nodes over a cluster
  constexpr int KRN = PREEMPT ? 0 : KR;       // nodes read ahead
  constexpr int KA = KRN > 0 ? KRN : 1;       // (array sizes)
  constexpr int SLOTS = CL ? MAX_Q : 1;
  constexpr int PC = PAIR ? tpusched::MAX_C : 1;
  constexpr int PW = PAIR ? WARPS : 1;
  constexpr int EXT = PAIR ? (CL ? MAX_Q : 1) * tpusched::MAX_C : 1;
  extern __shared__ float smem[];
  __shared__ std::conditional_t<PREEMPT, tpusched::PreemptSmem, NoSmem> s_pre;
  __shared__ uint2 x_rec[2][SLOTS];   // pick and tie-count records
  __shared__ unsigned long long x_bar[2];   // ... their mbarriers
  __shared__ float s_wv[WARPS];       // the CTA's candidates, a warp each
  __shared__ int s_wi[WARPS];
  __shared__ uint2 x_ext[2][EXT];     // PAIR: the extents' records
  __shared__ unsigned long long x_ebar[2];  // ... their mbarriers
  __shared__ float s_pod[3][POD_F];   // pods i, i + 1, i + 2's fields
  __shared__ int s_cnt[WARPS];
  __shared__ int s_tile[WARPS][32];   // seeded walk: ties a warp a tile
  __shared__ float s_lo[PC][PW], s_hi[PC][PW];
  __shared__ float s_cmin[PC], s_cmax[PC];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = CL ? cluster_ctas() : 1;
  const int rank = CL ? cluster_rank() : 0;
  {  // Cluster b scans tenant b.
    const long long b = CL ? cluster_index() : blockIdx.x;
    order += b * P;
    mask += b * P * N;
    static_score += b * P * N;
    alloc_g += b * N * R;
    requests += b * P * R;
    w_lr += b * P;
    w_ba += b * P;
    w_ts += b * P;
    w_ia += b * P;
    used_g += b * N * R;
    assigned += b * P;
    chosen += b * P;
    if constexpr (PAIR && TENANTS) {
      ps.t = tpusched::tenant_terms(ps.t, b);
      const long long SN = (long long)ps.t.S * N;
      ps.counts += b * SN;
      ps.anti += b * SN;
      ps.match_tot += b * ps.t.S;
      ps.pen += b * N;
      ps.raw += b * N;
      ps.allowed += b * N;
    }
    if constexpr (PREEMPT && TENANTS) pre = tenant_pre(pre, b, P, N);
  }
  // This CTA's node range and `used`/`alloc` rows (row n at n - ub).
  const int span = (N + Q - 1) / Q;
  const int base = min(rank * span, N), end = min(base + span, N);
  const int n0 = base + tid;
  const int ub = use_smem ? base : 0;
  float* used = used_g;
  const float* alloc = alloc_g;
  if (use_smem) {
    float* su = smem;
    float* sa = smem + (long long)span * R;
    const long long off = (long long)base * R;
    for (int i = tid; i < (end - base) * R; i += THREADS) {
      su[i] = used_g[off + i];
      sa[i] = alloc_g[off + i];
    }
    used = su;
    alloc = sa;
  }
  // The solve's resource weights, read by every cell: in shared memory,
  // not in 18 registers of each thread, but in the S = 0 preemption
  // variant over a tenant axis (on an H100 the 8-tenant batch's parity
  // wall ran 5 % slower with the shared copy, and the solo variant's 6 %
  // slower with registers).
  constexpr bool RW_SHARED = PAIR || !PREEMPT || !TENANTS;
  __shared__ ResW s_rw;
  ResW r_rw;
  if constexpr (RW_SHARED) {
    if (tid == 0) tpusched::load_resw<MAX_R>(s_rw, rw_g, R);
  } else {
    tpusched::load_resw<MAX_R>(r_rw, rw_g, R);
  }
  const ResW& rwc = RW_SHARED ? s_rw : r_rw;
  // Field t of pod p: its requests, then w_lr, w_ba, w_ts, w_ia.
  auto field = [&](int t, int p) -> float {
    if (t < R) return requests[(long long)p * R + t];
    if (t < MAX_R) return 0.0f;
    const float* w = t == MAX_R       ? w_lr
                     : t == MAX_R + 1 ? w_ba
                     : t == MAX_R + 2 ? w_ts
                                      : w_ia;
    return w[p];
  };

  int p = P > 0 ? order[0] : 0;
  float st_c[KA], st_n[KA];
  bool mk_c[KA], mk_n[KA];
  if (tid < POD_F && P > 0) s_pod[0][tid] = field(tid, p);
  if constexpr (KRN > 0)
    load_rows<KRN, THREADS>(mask + (long long)p * N,
                            static_score + (long long)p * N, n0, end, st_c,
                            mk_c);
  int p_next = P > 1 ? order[1] : 0;
  if constexpr (CL) {
    if (tid == 0) {
      for (int j = 0; j < 2; ++j) {
        mbar_init(&x_bar[j]);
        if constexpr (PAIR) mbar_init(&x_ebar[j]);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // Every CTA of the cluster runs (and has its shared memory and
  // mbarriers set up) before any DSMEM store.
  xsync<CL>();

  // Exchange number m of an mbarrier pair `bar`: send(e) posts this
  // CTA's nrec records into buffer e of every CTA; returns e once this
  // CTA holds all Q x nrec. Buffers alternate, and so the phases of each
  // buffer's mbarrier: a CTA sends m + 2 only after it holds every record
  // of m + 1, which each CTA sends after it has read its slots of m.
  auto exchange = [&](unsigned long long* bar, int& m, unsigned nrec,
                      auto&& send) {
    const int e = m & 1;
    const unsigned phase = (m >> 1) & 1;
    ++m;
    if constexpr (CL) {
      if (tid == 0) mbar_expect(&bar[e], 8u * Q * nrec);
    }
    send(e);
    if constexpr (CL)
      mbar_wait(&bar[e], phase);
    else
      __syncthreads();
    return e;
  };
  // Record v into *slot of CTA q (CL), or of this CTA.
  auto post = [&](uint2* slot, int q, uint2 v, unsigned long long* bar) {
    if constexpr (CL)
      st_async(slot, q, v, bar);
    else
      *slot = v;
  };
  auto f2 = [](float a, float b) {
    return make_uint2(__float_as_uint(a), __float_as_uint(b));
  };
  int xm = 0;   // record exchanges so far (x_rec, x_bar)
  int ex = 0;   // extent exchanges so far (x_ext, x_ebar)
  int pb = 0;   // s_pod buffer of pod i
  for (int i = 0; i < P; ++i) {
    const int nb = pb == 2 ? 0 : pb + 1;
    // Pod i+1's reads, issued now and used in pod i+1: its rows into
    // registers, its fields (stored into s_pod[nb] before this pod's
    // argmax exchange, which orders them before pod i+1), and order[i+2].
    float fv = 0.0f;
    if (i + 1 < P) {
      if constexpr (KRN > 0)
        load_rows<KRN, THREADS>(mask + (long long)p_next * N,
                                static_score + (long long)p_next * N, n0,
                                end, st_n, mk_n);
      if (tid < POD_F) fv = field(tid, p_next);
    }
    const int p_nn = i + 2 < P ? order[i + 2] : 0;
    const float* pf = s_pod[pb];
    const PodCtx c{pf, pf[MAX_R], pf[MAX_R + 1], pf[MAX_R + 2],
                   pf[MAX_R + 3]};
    const bool* mrow = mask + (long long)p * N;
    const float* srow = static_score + (long long)p * N;
    auto urow = [&](int n) { return used + (long long)(n - ub) * R; };
    auto arow = [&](int n) { return alloc + (long long)(n - ub) * R; };

    Norm nm{};
    if constexpr (PAIR) {
      // pairwise_row for pod p against the current pair state: pod i-1's
      // adds are visible after this wait (its arrive ends pod i-1).
      if constexpr (CL) {
        if (i > 0) cluster_wait();
      }
      const tpusched::PairTerms& t = ps.t;
      // The spread slots' extents over the cluster.
      unsigned nvalid = 0;
      for (int cc = 0; cc < t.C; ++cc) {
        const long long pc = (long long)p * t.C + cc;
        if (!t.ts_valid[pc]) continue;  // uniform across the cluster
        ++nvalid;
        const int s = max(t.ts_sig[pc], 0);
        float lo = INFINITY, hi = 0.0f;
        for (int n = n0; n < end; n += THREADS)
          tpusched::spread_extent(t, ps.counts, p, s, n, lo, hi);
        warp_min_max(lo, hi);
        if (lane == 0) {
          s_lo[cc][warp] = lo;
          s_hi[cc][warp] = hi;
        }
      }
      __syncthreads();
      const bool slot = tid < t.C && t.ts_valid[(long long)p * t.C + tid];
      int e = exchange(x_ebar, ex, nvalid, [&](int e) {
        if (!slot) return;
        float lo = s_lo[tid][0], hi = s_hi[tid][0];
        for (int w = 1; w < WARPS; ++w) {
          lo = fminf(lo, s_lo[tid][w]);
          hi = fmaxf(hi, s_hi[tid][w]);
        }
        for (int q = 0; q < Q; ++q)
          post(&x_ext[e][rank * tpusched::MAX_C + tid], q, f2(lo, hi),
               &x_ebar[e]);
      });
      if (slot) {
        float lo = INFINITY, hi = 0.0f;
        for (int q = 0; q < Q; ++q) {
          const uint2 x = x_ext[e][q * tpusched::MAX_C + tid];
          lo = fminf(lo, __uint_as_float(x.x));
          hi = fmaxf(hi, __uint_as_float(x.y));
        }
        s_cmin[tid] = lo;
        s_cmax[tid] = hi;
      }
      __syncthreads();
      // Each node's pairwise verdict, penalty and raw score into the
      // scratch (read back only by this thread), and the normalisers'
      // extents over valid nodes.
      float plo = INFINITY, phi = -INFINITY, rlo = INFINITY, rhi = -INFINITY;
      auto pair_at = [&](int n, bool mk) {
        float pen, raw;
        const bool ok = tpusched::pair_node(t, ps.counts, ps.anti,
                                            ps.match_tot, p, n, s_cmin,
                                            s_cmax, &pen, &raw);
        ps.pen[n] = pen;
        ps.raw[n] = raw;
        ps.allowed[n] = ok && mk;
        if (t.node_valid[n]) {
          plo = fminf(plo, pen);
          phi = fmaxf(phi, pen);
          rlo = fminf(rlo, raw);
          rhi = fmaxf(rhi, raw);
        }
      };
#pragma unroll
      for (int k = 0; k < KRN; ++k) {
        const int n = n0 + k * THREADS;
        if (n < end) pair_at(n, mk_c[k]);
      }
      for (int n = n0 + KRN * THREADS; n < end; n += THREADS)
        pair_at(n, mrow[n]);
      warp_min_max(plo, phi);
      warp_min_max(rlo, rhi);
      if (lane == 0) {
        s_lo[0][warp] = plo;
        s_hi[0][warp] = phi;
        s_lo[1][warp] = rlo;
        s_hi[1][warp] = rhi;
      }
      __syncthreads();
      e = exchange(x_ebar, ex, 2, [&](int e) {
        if (tid >= Q) return;
        for (int w = 0; w < WARPS; ++w) {
          plo = fminf(plo, s_lo[0][w]);
          phi = fmaxf(phi, s_hi[0][w]);
          rlo = fminf(rlo, s_lo[1][w]);
          rhi = fmaxf(rhi, s_hi[1][w]);
        }
        post(&x_ext[e][rank * 2], tid, f2(plo, phi), &x_ebar[e]);
        post(&x_ext[e][rank * 2 + 1], tid, f2(rlo, rhi), &x_ebar[e]);
      });
      for (int q = 0; q < Q; ++q) {
        const uint2 x = x_ext[e][q * 2], y = x_ext[e][q * 2 + 1];
        plo = fminf(plo, __uint_as_float(x.x));
        phi = fmaxf(phi, __uint_as_float(x.y));
        rlo = fminf(rlo, __uint_as_float(y.x));
        rhi = fmaxf(rhi, __uint_as_float(y.y));
      }
      nm = Norm{plo, phi, rlo, rhi};
    }

    // The thread's best: the first feasible node, then strictly greater
    // (its nodes ascend). The first KRN nodes' scores and feasibility are
    // kept for the seeded tie count.
    float best = -INFINITY;
    int bidx = INT_MAX;
    float sc[KA];
    unsigned fb = 0;
#pragma unroll
    for (int k = 0; k < KRN; ++k) {
      const int n = n0 + k * THREADS;
      float s;
      if (n < end && cell<PAIR>(c, n, mk_c[k], st_c[k], urow(n), arow(n), R,
                                rwc, ps, nm, &s)) {
        fb |= 1u << k;
        sc[k] = s;
        if (bidx == INT_MAX || s > best) {
          best = s;
          bidx = n;
        }
      }
    }
    for (int n = n0 + KRN * THREADS; n < end; n += THREADS) {
      float s;
      if (cell<PAIR>(c, n, mrow[n], srow[n], urow(n), arow(n), R, rwc, ps,
                     nm, &s) &&
          (bidx == INT_MAX || s > best)) {
        best = s;
        bidx = n;
      }
    }
    warp_argmax(best, bidx);
    if (i + 1 < P && tid < POD_F) s_pod[nb][tid] = fv;
    {  // The cluster's pick: the CTA's candidate into every CTA's slot.
      if (lane == 0) {
        s_wv[warp] = best;
        s_wi[warp] = bidx;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < WARPS ? s_wv[lane] : -INFINITY;
        bidx = lane < WARPS ? s_wi[lane] : INT_MAX;
        warp_argmax(best, bidx);
      }
      const uint2 rec = make_uint2(__float_as_uint(best), (unsigned)bidx);
      const int e = exchange(x_bar, xm, 1, [&](int e) {
        if (warp == 0 && lane < Q) post(&x_rec[e][rank], lane, rec, &x_bar[e]);
      });
      best = lane < Q ? __uint_as_float(x_rec[e][lane].x) : -INFINITY;
      bidx = lane < Q ? (int)x_rec[e][lane].y : INT_MAX;
      warp_argmax(best, bidx);
    }
    const float mx = best;
    const bool found = bidx != INT_MAX;
    // The node this thread commits pod p to (-1: none).
    int mine = -1;
    if (found && !seeded && bidx >= base && bidx < end &&
        (bidx - base) % THREADS == tid)
      mine = bidx;

    if (seeded && found) {
      // The h-th tie in node order, h = tie_hash(seed, p) % #ties: count
      // the CTA's ties (a warp's in s_cnt), exchange the counts (CTA
      // ranges ascend with the rank), and find the h-th in the CTA whose
      // range holds it.
      auto tie = [&](int n) {
        float s;
        return cell<PAIR>(c, n, mrow[n], srow[n], urow(n), arow(n), R, rwc,
                          ps, nm, &s) &&
               s == mx;
      };
      // tb: the thread's ties among its first 32 nodes (bit k: node
      // n0 + k * THREADS), for the walk below.
      int cnt = 0;
      unsigned tb = 0;
#pragma unroll
      for (int k = 0; k < KRN; ++k)
        tb |= (unsigned)(n0 + k * THREADS < end && ((fb >> k) & 1) &&
                         sc[k] == mx) << k;
      for (int n = n0 + KRN * THREADS, k = KRN; n < end;
           n += THREADS, ++k) {
        const bool t = tie(n);
        if (k < 32)
          tb |= (unsigned)t << k;
        else
          cnt += t;
      }
      cnt = warp_sum(cnt + __popc(tb));
      if (lane == 0) s_cnt[warp] = cnt;
      __syncthreads();
      const int all = warp_sum(lane < WARPS ? s_cnt[lane] : 0);
      const int e = exchange(x_bar, xm, 1, [&](int e) {
        if (warp == 0 && lane < Q)
          post(&x_rec[e][rank], lane, make_uint2((unsigned)all, 0u),
               &x_bar[e]);
      });
      // All ties, those of the CTAs before this one, and this CTA's.
      const int v = lane < Q ? (int)x_rec[e][lane].x : 0;
      const int total = warp_sum(v);
      const int before = warp_sum(lane < rank ? v : 0);
      const int own = __shfl_sync(FULL, v, rank);
      const int h = (int)(tie_hash(seed, (unsigned)p) %
                          (unsigned)max(total, 1));
      const int npt = (end - base + THREADS - 1) / THREADS;
      if (npt == 1) {
        // One tile: warps and lanes are in node order, so the warp that
        // holds h (s_cnt: the CTA's ties a warp) finds it by a ballot.
        int wbefore = before;
        for (int w = 0; w < warp; ++w) wbefore += s_cnt[w];
        if (h >= wbefore && h < wbefore + s_cnt[warp]) {
          const bool t = tb & 1u;
          const unsigned bal = __ballot_sync(FULL, t);
          if (t && wbefore + __popc(bal & ((1u << lane) - 1u)) == h)
            mine = n0;
        }
      } else if (h >= before && h < before + own) {  // uniform in the CTA
        // Tile k holds each thread's k-th node, so node order is (tile,
        // warp, lane). A group of 32 tiles at a time (one in all but
        // CTAs of over 32 x THREADS nodes): each warp's ties a tile into
        // s_tile (lane k: tile g + k), one barrier, then every warp sums
        // the tiles over the warps and finds the tile, and the warp in it,
        // that hold the want-th tie.
        int want = h - before;
        for (int g = 0; g < npt; g += 32) {   // uniform: g and want
          if (g > 0) {
            __syncthreads();   // every warp read the last group's s_tile
            tb = 0;
            for (int k = 0; k < 32 && g + k < npt; ++k) {
              const int n = n0 + (g + k) * THREADS;
              tb |= (unsigned)(n < end && tie(n)) << k;
            }
          }
          int ck = 0;
          for (int k = 0; k < 32 && g + k < npt; ++k) {
            const int c = __popc(__ballot_sync(FULL, (tb >> k) & 1u));
            if (lane == k) ck = c;
          }
          s_tile[warp][lane] = ck;
          __syncthreads();
          int tt = 0, wb = 0;   // tile g + lane: ties, those of warps before
          for (int w = 0; w < WARPS; ++w) {
            const int v = s_tile[w][lane];
            tt += v;
            wb += w < warp ? v : 0;
          }
          int incl = tt;
          for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(FULL, incl, off);
            if (lane >= off) incl += o;
          }
          const unsigned hit = __ballot_sync(FULL, want < incl);
          if (hit) {
            const int k = __ffs(hit) - 1;
            const int r = want - __shfl_sync(FULL, incl - tt + wb, k);
            const bool t = (tb >> k) & 1u;
            const unsigned bal = __ballot_sync(FULL, t);
            if (t && __popc(bal & ((1u << lane) - 1u)) == r)
              mine = n0 + (g + k) * THREADS;
            break;
          }
          want -= __shfl_sync(FULL, incl, 31);
        }
      }
    }

    bool preempt = false;
    if constexpr (PREEMPT) {
      // Uniform across the block: found and the pod's fields.
      preempt = !found && pre.pod_valid[p] && pre.group[p] < 0;
      if (preempt) {
        const unsigned char* allowed_row =
            PAIR ? ps.allowed : (const unsigned char*)mrow;
        const float prio = pre.prio[p];
        int n;
        const int bp = tpusched::preempt_search(
            pre.v, s_pre, prio, c.rq, allowed_row, pre.node_valid, used,
            alloc, pre.ev_s, pre.remaining, &n);
        if (tid == 0) {
          if (bp >= 0) {
            float freed[MAX_R];
            tpusched::preempt_take(
                pre.v, n, bp, prio, pre.ev_s, freed, [&](int m, int g) {
                  pre.evicted[m] = 1;
                  if (pre.evictor) {
                    pre.evictor[m] = p;
                    pre.evict_pos[m] = i;
                  }
                  if (g >= 0) pre.remaining[g] = pre.remaining[g] - 1.0f;
                  if constexpr (PAIR) pair_evict(ps, pre, m);
                });
            float* u = used + (long long)n * R;
            for (int r = 0; r < R; ++r) u[r] = u[r] - freed[r];
            for (int r = 0; r < R; ++r) u[r] = u[r] + c.rq[r];
            if constexpr (PAIR) pair_add_pod(ps, p, n);
            assigned[p] = n;
          } else {
            assigned[p] = -1;
          }
          chosen[p] = -INFINITY;
        }
      }
    }
    if (!preempt) {
      if (mine >= 0) {
        float* u = urow(mine);
        for (int r = 0; r < R; ++r) u[r] = u[r] + c.rq[r];
        assigned[p] = mine;
        chosen[p] = mx;
        if constexpr (PAIR) pair_add_pod(ps, p, mine);
      } else if (!found && rank == 0 && tid == 0) {
        assigned[p] = -1;
        chosen[p] = -INFINITY;
      }
    }
    if constexpr (PREEMPT) {
      __syncthreads();
    } else if constexpr (PAIR) {
      cluster_arrive();   // orders pair_add_pod before pod i+1's wait
    }
#pragma unroll
    for (int k = 0; k < KRN; ++k) {
      st_c[k] = st_n[k];
      mk_c[k] = mk_n[k];
    }
    p = p_next;
    p_next = p_nn;
    pb = nb;
  }
  if constexpr (PAIR && CL) {
    if (P > 0) cluster_wait();
  }
  // The owners' commits before the write-back (and no CTA leaves while
  // another could still address its shared memory).
  xsync<CL>();
  if (use_smem) {
    const long long off = (long long)base * R;
    for (int i = tid; i < (end - base) * R; i += THREADS)
      used_g[off + i] = used[i];
  }
}

// Shared memory, then the launch of one instantiation as B clusters of
// Q CTAs. Each CTA's `used`/`alloc` rows go to dynamic shared memory when
// they fit beside the kernel's static shared memory. A cluster size the
// card cannot place raises (no smaller Q instead).
template <typename Kernel>
int launch_kernel(Kernel kernel, int Q, int threads, int B, int P, int N,
                  int R, const int* order, const bool* mask,
                  const float* static_score, const float* alloc,
                  const float* requests, const float* w_lr, const float* w_ba,
                  const float* w_ts, const float* w_ia, const float* rw,
                  int seeded, unsigned int seed, float* used, int* assigned,
                  float* chosen, const PairScan& ps, const PreemptScan& pre,
                  void* stream) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const long long span = (N + Q - 1) / Q;
  long long bytes = 2LL * span * R * (long long)sizeof(float);
  int use_smem = bytes + (long long)fa.sharedSizeBytes <= SMEM_LIMIT ? 1 : 0;
  size_t dyn = use_smem ? (size_t)bytes : 0;
  // Static and dynamic shared memory together above 48 KB need the
  // opt-in.
  if (dyn > 0 && dyn + fa.sharedSizeBytes > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  if (Q > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * Q));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = (cudaStream_t)stream;
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
    if (e != cudaSuccess) return (int)e;
    if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, P, N, R, order, mask, static_score,
                         alloc, requests, w_lr, w_ba, w_ts, w_ia, rw, seeded,
                         seed, used, assigned, chosen, use_smem, ps, pre);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instantiation for (Q, threads). Without preemption: 256, 512 or
// 1 024 threads a CTA (the wrapper's policy, kernels/assign.scan_threads),
// the pairwise block offset per tenant in the kernel (TENANTS) below
// 1 024 threads, and at 1 024 only for B > 1 (a copy of the block that
// costs registers). The preemption variants: one CTA of 1 024 threads a
// tenant, TENANTS only for B > 1.
template <bool PAIR, bool PREEMPT>
int launch_scan(int B, int Q, int threads, int P, int N, int R,
                const int* order, const bool* mask, const float* static_score,
                const float* alloc, const float* requests, const float* w_lr,
                const float* w_ba, const float* w_ts, const float* w_ia,
                const float* rw, int seeded, unsigned int seed, float* used,
                int* assigned, float* chosen, const PairScan& ps,
                const PreemptScan& pre, void* stream) {
  if (R > MAX_R || (Q != 1 && Q != 2 && Q != 4 && Q != 8 && Q != MAX_Q))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto kernel, int t) {
    return launch_kernel(kernel, Q, t, B, P, N, R, order, mask, static_score,
                         alloc, requests, w_lr, w_ba, w_ts, w_ia, rw, seeded,
                         seed, used, assigned, chosen, ps, pre, stream);
  };
  if constexpr (PREEMPT) {
    if (Q != 1 || threads != tpusched::PRE_THREADS)
      return (int)cudaErrorInvalidValue;
    if (B > 1) return go(parity_scan_kernel<PAIR, true, true, 1024>, 1024);
    return go(parity_scan_kernel<PAIR, true, false, 1024>, 1024);
  } else {
    if (threads == 256)
      return go(parity_scan_kernel<PAIR, false, PAIR, 256>, 256);
    if (threads == 512)
      return go(parity_scan_kernel<PAIR, false, PAIR, 512>, 512);
    if (threads != 1024) return (int)cudaErrorInvalidValue;
    if (PAIR && B > 1)
      return go(parity_scan_kernel<PAIR, false, PAIR, 1024>, 1024);
    return go(parity_scan_kernel<PAIR, false, false, 1024>, 1024);
  }
}

// The preemption block of both preemption entry points.
PreemptScan make_preempt(int N, int R, int M, int GP, int V, int J,
                         const int* off, const int* pl_vic,
                         const float* pl_req, const int* perm,
                         const float* cost_s, const float* vprio_s,
                         const float* req_s, const int* pdb_s, float margin,
                         const float* prio, const bool* pod_valid,
                         const int* group, const bool* node_valid,
                         const int* run_node, const int* run_anti_sig,
                         float* remaining, unsigned char* evicted,
                         unsigned char* ev_s, int* evictor, int* evict_pos) {
  return PreemptScan{{M, N, R, GP, V, margin, off, (const int4*)pl_vic,
                      pl_req, perm, cost_s, vprio_s, req_s, pdb_s},
                     prio, pod_valid, group, node_valid, run_node,
                     run_anti_sig, J, remaining, evicted, ev_s, evictor,
                     evict_pos};
}

}  // namespace

extern "C" int tpusched_parity_scan(int B, int Q, int threads, int P,
                                    int N, int R,
                                    const int* order,
                                    const bool* mask,
                                    const float* static_score,
                                    const float* alloc,
                                    const float* requests,
                                    const float* w_lr, const float* w_ba,
                                    const float* w_ts, const float* w_ia,
                                    const float* rw, int seeded,
                                    unsigned int seed, float* used,
                                    int* assigned, float* chosen,
                                    void* stream) {
  PairScan none{};
  PreemptScan no_pre{};
  return launch_scan<false, false>(B, Q, threads, P, N, R, order, mask,
                                   static_score, alloc, requests, w_lr, w_ba,
                                   w_ts, w_ia, rw, seeded, seed, used,
                                   assigned, chosen, none, no_pre, stream);
}

extern "C" int tpusched_parity_scan_pair(
    int B, int Q, int threads, int P, int N, int R, const int* order,
    const bool* mask, const float* static_score, const float* alloc,
    const float* requests, const float* w_lr, const float* w_ba,
    const float* w_ts, const float* w_ia, const float* rw, int seeded,
    unsigned int seed,
    int S, int C, int IT, int M, const int* dom, const bool* match,
    const bool* node_valid, const bool* aff_ok, const int* ts_sig,
    const bool* ts_valid, const signed char* ts_when,
    const float* ts_max_skew, const int* ia_sig, const bool* ia_valid,
    const bool* ia_anti, const bool* ia_required, const float* ia_weight,
    float* counts, float* anti, float* match_tot, float* pen, float* raw,
    unsigned char* allowed, float* used, int* assigned, float* chosen,
    void* stream) {
  if (C > tpusched::MAX_C) return (int)cudaErrorInvalidValue;
  PairScan ps{{N, S, C, IT, M + P, M, dom, match, node_valid, aff_ok, ts_sig,
               ts_valid, ts_when, ts_max_skew, ia_sig, ia_valid, ia_anti,
               ia_required, ia_weight},
              counts, anti, match_tot, pen, raw, allowed};
  PreemptScan no_pre{};
  return launch_scan<true, false>(B, Q, threads, P, N, R, order, mask,
                                  static_score, alloc, requests, w_lr, w_ba,
                                  w_ts, w_ia, rw, seeded, seed, used,
                                  assigned, chosen, ps, no_pre, stream);
}

extern "C" int tpusched_parity_scan_preempt(
    int B, int P, int N, int R, const int* order, const bool* mask,
    const float* static_score, const float* alloc, const float* requests,
    const float* w_lr, const float* w_ba, const float* w_ts,
    const float* w_ia, const float* rw, int seeded, unsigned int seed, int M,
    int GP, int V, int J, const int* off, const int* pl_vic,
    const float* pl_req, const int* perm, const float* cost_s,
    const float* vprio_s, const float* req_s, const int* pdb_s, float margin,
    const float* prio, const bool* pod_valid, const int* group,
    const bool* node_valid, const int* run_node, const int* run_anti_sig,
    float* remaining, unsigned char* evicted, unsigned char* ev_s,
    float* used, int* assigned, float* chosen, int* evictor, int* evict_pos,
    void* stream) {
  if (B > 1 && evictor) return (int)cudaErrorInvalidValue;
  PairScan none{};
  PreemptScan pre = make_preempt(
      N, R, M, GP, V, J, off, pl_vic, pl_req, perm, cost_s, vprio_s, req_s,
      pdb_s, margin, prio, pod_valid, group, node_valid, run_node,
      run_anti_sig, remaining, evicted, ev_s, evictor, evict_pos);
  return launch_scan<false, true>(B, 1, tpusched::PRE_THREADS, P, N, R,
                                  order, mask, static_score, alloc, requests,
                                  w_lr, w_ba, w_ts, w_ia, rw, seeded, seed,
                                  used, assigned, chosen, none, pre, stream);
}

extern "C" int tpusched_parity_scan_pair_preempt(
    int B, int P, int N, int R, const int* order, const bool* mask,
    const float* static_score, const float* alloc, const float* requests,
    const float* w_lr, const float* w_ba, const float* w_ts,
    const float* w_ia, const float* rw, int seeded, unsigned int seed,
    int S, int C, int IT, int M, const int* dom, const bool* match,
    const bool* node_valid, const bool* aff_ok, const int* ts_sig,
    const bool* ts_valid, const signed char* ts_when,
    const float* ts_max_skew, const int* ia_sig, const bool* ia_valid,
    const bool* ia_anti, const bool* ia_required, const float* ia_weight,
    float* counts, float* anti, float* match_tot, float* pen, float* raw,
    unsigned char* allowed, int M2, int GP, int V, int J, const int* off,
    const int* pl_vic, const float* pl_req, const int* perm,
    const float* cost_s, const float* vprio_s, const float* req_s,
    const int* pdb_s, float margin, const float* prio, const bool* pod_valid,
    const int* group, const bool* node_valid2, const int* run_node,
    const int* run_anti_sig, float* remaining, unsigned char* evicted,
    unsigned char* ev_s, float* used, int* assigned, float* chosen,
    int* evictor, int* evict_pos, void* stream) {
  if (C > tpusched::MAX_C || M2 != M || (B > 1 && evictor))
    return (int)cudaErrorInvalidValue;
  PairScan ps{{N, S, C, IT, M + P, M, dom, match, node_valid, aff_ok, ts_sig,
               ts_valid, ts_when, ts_max_skew, ia_sig, ia_valid, ia_anti,
               ia_required, ia_weight},
              counts, anti, match_tot, pen, raw, allowed};
  PreemptScan pre = make_preempt(
      N, R, M, GP, V, J, off, pl_vic, pl_req, perm, cost_s, vprio_s, req_s,
      pdb_s, margin, prio, pod_valid, group, node_valid2, run_node,
      run_anti_sig, remaining, evicted, ev_s, evictor, evict_pos);
  return launch_scan<true, true>(B, 1, tpusched::PRE_THREADS, P, N, R,
                                 order, mask, static_score, alloc, requests,
                                 w_lr, w_ba, w_ts, w_ia, rw, seeded, seed,
                                 used, assigned, chosen, ps, pre, stream);
}
