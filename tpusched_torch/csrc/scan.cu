// K4: the parity scan, one persistent CTA a tenant.
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
// i's commit left, so the P pods form a chain of P dependent block-wide
// argmaxes; the bytes (mask + static rows, 5 bytes a cell, 0.26 GB at
// 10240 x 5120) would take 0.08 ms at 3.35 TB/s. The design keeps the
// whole chain inside one CTA of 1024 threads: no launch or grid-wide
// barrier per pod, `used` and `alloc` in shared memory when 2*N*R floats
// fit (123 KB at N = 5120, R = 3), each thread owning a contiguous chunk
// of nodes so that "lowest index among the maxima" and the seeded
// tie rank are chunk-local scans plus one block combine. Spreading one
// pod's nodes over a thread-block cluster (DSMEM) is a later step.
//
// The pairwise variant (PAIR = true, entry point
// tpusched_parity_scan_pair) is the same scan for snapshots with
// signatures (topology spread, inter-pod affinity): pod_cycle with
// tpusched/kernels/pairwise.py:504 pairwise_row and the two normalisers,
// in assign.py:324-330's association
//   ((((w_lr*LR + w_ba*BA) + static) + w_ts*inv_norm(pen)) + w_ia*minmax(raw)),
// then :201 pair_state_add_pod after each commit. Per pod: one block
// reduction per spread slot (its min count over eligible nodes and max
// count over nodes with the key), a pass that evaluates pairwise.cuh's
// cell at every node of the thread's chunk into pen/raw/allowed scratch,
// two block reductions of the normalisers' extents, then K4's pick
// and commit, and thread 0 adds the pod to the pair state. `used` and
// `alloc` already take 123 KB of shared memory at N = 5120, which leaves
// no room for the [S, N] counts: counts/anti/match_tot and the [N]
// scratch live in device memory (L1/L2); each thread reads only the
// scratch cells it wrote, and the barrier that ends every pod makes
// thread 0's pair-state adds visible to the next pod. These pointers are
// not __restrict__/read-only, since the kernel writes them. The S = 0
// instantiation (PAIR = false) does exactly the work it did before.
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
// needs 0.5 KB of static shared memory for its block reduction. Without
// preemption the instantiations are unchanged. With the optional
// outputs evictor / evict_pos (the explained
// solve's provenance, tpusched/kernels/assign.py:484-487), thread 0 also
// writes, for each victim it evicts, the pod's index and its step in pop
// order; the CTA is the only writer, so no atomics. NULL leaves the
// kernel as it was.
//
// Tenant axis (tpusched/tenants.py:75 solve_many, entry points
// tpusched_parity_scan and tpusched_parity_scan_pair): gridDim.x = B, and
// CTA b scans tenant b alone ([B, P] order, weights and outputs, [B, P, N]
// mask and static score, [B, N, R] allocatable and usage, [B, P, R]
// requests; rw is shared), with its own `used`/`alloc` in its own shared
// memory. The seeded tie hash takes the tenant's own pod index. With PAIR
// every array of the pairwise block gains the leading [B] axis too, the
// pair state [B, S, N] / [B, S] and the [B, N] scratch included, so CTA b
// reads and updates only its tenant's state (the TENANTS instantiation,
// launched for B > 1). The B scans are independent, so B tenants take
// about one tenant's time while B <= 132 SMs. The preemption variants
// (entry points tpusched_parity_scan_preempt and
// tpusched_parity_scan_pair_preempt) take the axis the same way:
// with PREEMPT the TENANTS instantiation also offsets the preemption
// block to tenant b (tenant_pre): its victim table (node offsets [B, N +
// 1], planes [B, V, N] and [B, R, V, N], sorted order [B, M] and [B, M,
// R]), its pods' priority, validity and gang, its nodes' validity, its
// running pods' nodes and anti terms, its budgets and its evictions (by
// pod and in the sorted order), so that K15's search and every segment
// sum stay inside the tenant's own victims. The explain outputs stay
// solo (NULL for B > 1).
// B = 1 launches the instantiations without TENANTS.
#include <math.h>
#include <limits.h>

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

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 220 * 1024;
static_assert(THREADS == tpusched::PRE_THREADS, "K15 runs in K4's CTA");

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

struct PodCtx {
  float rq[MAX_R];
  float w_lr, w_ba, w_ts, w_ia;
  const bool* mask;
  const float* st;
};

// PAIR only: the pod's normaliser extents over valid nodes (spread
// penalty lo/hi, inter-pod raw lo/hi). Kept out of PodCtx so that the
// S = 0 instantiation's frame stays as it was.
struct Norm {
  float plo, phi, rlo, rhi;
};

// Feasibility and score of one (pod, node) cell (cell.cuh's arithmetic,
// plus pod_cycle's `+ w_ia * 0`, or with PAIR the pairwise scores read
// from the scratch the pod's pairwise pass wrote); returns false when
// the node is infeasible (static mask, pairwise or resource fit).
template <bool PAIR>
__device__ __forceinline__ bool cell(const PodCtx& c, int n, int R,
                                     const float* used, const float* alloc,
                                     const ResW& w, const PairScan& ps,
                                     const Norm& nm, float* out) {
  if constexpr (PAIR) {
    if (!ps.allowed[n]) return false;
  } else {
    if (!c.mask[n]) return false;
  }
  const float* u = used + (long long)n * R;
  const float* a = alloc + (long long)n * R;
  if (!tpusched::cell_fits(u, a, c.rq, R)) return false;
  float s;
  if constexpr (PAIR) {
    s = tpusched::cell_dynamic(u, a, c.rq, R, w, c.w_lr, c.w_ba);
    s = s + c.st[n];
    s = s + c.w_ts * tpusched::inverse_norm(ps.pen[n], nm.plo, nm.phi);
    s = s + c.w_ia * tpusched::minmax_norm(ps.raw[n], nm.rlo, nm.rhi);
  } else {
    s = tpusched::cell_score(u, a, c.rq, R, w, c.w_lr, c.w_ba, c.st[n],
                             c.w_ts);
    s = s + c.w_ia * 0.0f;
  }
  *out = s;
  return true;
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

template <bool PAIR, bool PREEMPT, bool TENANTS = false>
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
  extern __shared__ float smem[];
  __shared__ std::conditional_t<PREEMPT, tpusched::PreemptSmem, NoSmem> s_pre;
  __shared__ float s_val[WARPS];
  __shared__ int s_idx[WARPS];
  __shared__ int s_cnt[WARPS];
  __shared__ float s_best;
  __shared__ int s_pick;
  __shared__ int s_total;
  __shared__ float s_lo[PAIR ? WARPS : 1], s_hi[PAIR ? WARPS : 1];
  __shared__ float s_cmin[PAIR ? tpusched::MAX_C : 1];
  __shared__ float s_cmax[PAIR ? tpusched::MAX_C : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {  // CTA b scans tenant b.
    const long long b = blockIdx.x;
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
  float* used = used_g;
  const float* alloc = alloc_g;
  if (use_smem) {
    float* su = smem;
    float* sa = smem + (long long)N * R;
    for (int i = tid; i < N * R; i += THREADS) {
      su[i] = used_g[i];
      sa[i] = alloc_g[i];
    }
    used = su;
    alloc = sa;
  }
  ResW rwc;
  tpusched::load_resw(rwc, rw_g, R);
  const int chunk = (N + THREADS - 1) / THREADS;
  const int lo = min(tid * chunk, N), hi = min(lo + chunk, N);
  __syncthreads();

  for (int i = 0; i < P; ++i) {
    const int p = order[i];
    PodCtx c;
    for (int r = 0; r < R; ++r) c.rq[r] = requests[(long long)p * R + r];
    c.w_lr = w_lr[p];
    c.w_ba = w_ba[p];
    c.w_ts = w_ts[p];
    c.w_ia = w_ia[p];
    c.mask = mask + (long long)p * N;
    c.st = static_score + (long long)p * N;
    Norm nm{};
    if constexpr (PAIR) {
      // pairwise_row for pod p against the current pair state.
      const tpusched::PairTerms& t = ps.t;
      tpusched::spread_extents<WARPS>(t, ps.counts, p, lo, hi, 1, s_lo, s_hi,
                                      s_cmin, s_cmax);
      float plo = INFINITY, phi = -INFINITY, rlo = INFINITY, rhi = -INFINITY;
      for (int n = lo; n < hi; ++n) {
        float pen, raw;
        const bool ok = tpusched::pair_node(t, ps.counts, ps.anti,
                                            ps.match_tot, p, n, s_cmin,
                                            s_cmax, &pen, &raw);
        ps.pen[n] = pen;
        ps.raw[n] = raw;
        ps.allowed[n] = ok && c.mask[n];
        if (t.node_valid[n]) {
          plo = fminf(plo, pen);
          phi = fmaxf(phi, pen);
          rlo = fminf(rlo, raw);
          rhi = fmaxf(rhi, raw);
        }
      }
      tpusched::block_min_max<WARPS>(plo, phi, s_lo, s_hi);
      tpusched::block_min_max<WARPS>(rlo, rhi, s_lo, s_hi);
      nm = Norm{plo, phi, rlo, rhi};
    }

    // Chunk-local best: the first feasible node, then strictly greater.
    float best = -INFINITY;
    int bidx = INT_MAX;
    for (int n = lo; n < hi; ++n) {
      float s;
      if (cell<PAIR>(c, n, R, used, alloc, rwc, ps, nm, &s) &&
          (bidx == INT_MAX || s > best)) {
        best = s;
        bidx = n;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, best, off);
      int oi = __shfl_down_sync(0xffffffffu, bidx, off);
      if (beats(ov, oi, best, bidx)) {
        best = ov;
        bidx = oi;
      }
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = bidx;
    }
    __syncthreads();
    if (warp == 0) {
      best = s_val[lane];
      bidx = s_idx[lane];
      for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_down_sync(0xffffffffu, best, off);
        int oi = __shfl_down_sync(0xffffffffu, bidx, off);
        if (beats(ov, oi, best, bidx)) {
          best = ov;
          bidx = oi;
        }
      }
      if (lane == 0) {
        s_best = best;
        s_pick = bidx;
      }
    }
    __syncthreads();
    const float mx = s_best;
    const bool found = s_pick != INT_MAX;

    if (seeded && found) {
      // The h-th tie in node order, h = tie_hash(seed, p) % #ties: count
      // the chunk's ties, exclusive-scan the counts, and let the thread
      // whose range holds h walk its chunk to it.
      int cnt = 0;
      for (int n = lo; n < hi; ++n) {
        float s;
        if (cell<PAIR>(c, n, R, used, alloc, rwc, ps, nm, &s) && s == mx)
          ++cnt;
      }
      int incl = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      if (lane == 31) s_cnt[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        int w = s_cnt[lane];
        int wincl = w;
        for (int off = 1; off < 32; off <<= 1) {
          int o = __shfl_up_sync(0xffffffffu, wincl, off);
          if (lane >= off) wincl += o;
        }
        s_cnt[lane] = wincl - w;  // exclusive prefix over warps
        if (lane == 31) s_total = wincl;
      }
      __syncthreads();
      const int excl = s_cnt[warp] + incl - cnt;
      const unsigned total = (unsigned)max(s_total, 1);
      const int h = (int)(tie_hash(seed, (unsigned)p) % total);
      if (h >= excl && h < excl + cnt) {
        int want = h - excl;
        for (int n = lo; n < hi; ++n) {
          float s;
          if (cell<PAIR>(c, n, R, used, alloc, rwc, ps, nm, &s) && s == mx) {
            if (want == 0) {
              s_pick = n;
              break;
            }
            --want;
          }
        }
      }
      __syncthreads();
    }

    bool preempt = false;
    if constexpr (PREEMPT) {
      // Uniform across the block: found and the pod's fields.
      preempt = !found && pre.pod_valid[p] && pre.group[p] < 0;
    }
    if constexpr (PREEMPT) {
      if (preempt) {
        const unsigned char* allowed_row =
            PAIR ? ps.allowed : (const unsigned char*)c.mask;
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
    if (tid == 0 && !preempt) {
      if (found) {
        const int n = s_pick;
        for (int r = 0; r < R; ++r)
          used[(long long)n * R + r] = used[(long long)n * R + r] + c.rq[r];
        assigned[p] = n;
        chosen[p] = mx;
        if constexpr (PAIR) pair_add_pod(ps, p, n);
      } else {
        assigned[p] = -1;
        chosen[p] = -INFINITY;
      }
    }
    __syncthreads();
  }

  if (use_smem) {
    for (int i = tid; i < N * R; i += THREADS) used_g[i] = used[i];
  }
}

// Shared memory, then the launch of one instantiation. `used`/`alloc` go
// to dynamic shared memory when they fit beside the kernel's static
// shared memory.
template <typename Kernel>
int launch_kernel(Kernel kernel, int B, int P, int N, int R,
                  const int* order, const bool* mask,
                  const float* static_score, const float* alloc,
                  const float* requests, const float* w_lr, const float* w_ba,
                  const float* w_ts, const float* w_ia, const float* rw,
                  int seeded, unsigned int seed, float* used, int* assigned,
                  float* chosen, const PairScan& ps, const PreemptScan& pre,
                  void* stream) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  long long bytes = 2LL * N * R * (long long)sizeof(float);
  int use_smem = bytes + (long long)fa.sharedSizeBytes <= SMEM_LIMIT ? 1 : 0;
  size_t dyn = use_smem ? (size_t)bytes : 0;
  // Static and dynamic shared memory together above 48 KB need the
  // opt-in.
  if (dyn > 0 && dyn + fa.sharedSizeBytes > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, THREADS, dyn, (cudaStream_t)stream>>>(
      P, N, R, order, mask, static_score, alloc, requests, w_lr, w_ba, w_ts,
      w_ia, rw, seeded, seed, used, assigned, chosen, use_smem, ps, pre);
  return (int)cudaGetLastError();
}

// The pairwise and preemption variants over B > 1 tenants offset their
// pairwise and preemption blocks in the kernel (TENANTS): a copy of the
// blocks that costs registers (the CTA's 1 024 threads hold 64 each), so
// B = 1 keeps the instantiations without it.
template <bool PAIR, bool PREEMPT>
int launch_scan(int B, int P, int N, int R, const int* order,
                const bool* mask, const float* static_score, const float* alloc,
                const float* requests, const float* w_lr, const float* w_ba,
                const float* w_ts, const float* w_ia, const float* rw,
                int seeded, unsigned int seed, float* used, int* assigned,
                float* chosen, const PairScan& ps, const PreemptScan& pre,
                void* stream) {
  if (R > MAX_R) return (int)cudaErrorInvalidValue;
  if constexpr (PAIR || PREEMPT) {
    if (B > 1)
      return launch_kernel(parity_scan_kernel<PAIR, PREEMPT, true>, B, P, N,
                           R, order, mask, static_score, alloc, requests,
                           w_lr, w_ba, w_ts, w_ia, rw, seeded, seed, used,
                           assigned, chosen, ps, pre, stream);
  }
  return launch_kernel(parity_scan_kernel<PAIR, PREEMPT>, B, P, N, R, order,
                       mask, static_score, alloc, requests, w_lr, w_ba, w_ts,
                       w_ia, rw, seeded, seed, used, assigned, chosen, ps, pre,
                       stream);
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

extern "C" int tpusched_parity_scan(int B, int P, int N, int R,
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
  return launch_scan<false, false>(B, P, N, R, order, mask, static_score,
                                   alloc, requests, w_lr, w_ba, w_ts, w_ia,
                                   rw, seeded, seed, used, assigned, chosen,
                                   none, no_pre, stream);
}

extern "C" int tpusched_parity_scan_pair(
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
    unsigned char* allowed, float* used, int* assigned, float* chosen,
    void* stream) {
  if (C > tpusched::MAX_C) return (int)cudaErrorInvalidValue;
  PairScan ps{{N, S, C, IT, M + P, M, dom, match, node_valid, aff_ok, ts_sig,
               ts_valid, ts_when, ts_max_skew, ia_sig, ia_valid, ia_anti,
               ia_required, ia_weight},
              counts, anti, match_tot, pen, raw, allowed};
  PreemptScan no_pre{};
  return launch_scan<true, false>(B, P, N, R, order, mask, static_score,
                                  alloc, requests, w_lr, w_ba, w_ts, w_ia, rw,
                                  seeded, seed, used, assigned, chosen, ps,
                                  no_pre, stream);
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
  return launch_scan<false, true>(B, P, N, R, order, mask, static_score,
                                  alloc, requests, w_lr, w_ba, w_ts, w_ia, rw,
                                  seeded, seed, used, assigned, chosen, none,
                                  pre, stream);
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
  return launch_scan<true, true>(B, P, N, R, order, mask, static_score,
                                 alloc, requests, w_lr, w_ba, w_ts, w_ia, rw,
                                 seeded, seed, used, assigned, chosen, ps, pre,
                                 stream);
}
