// K2: the cell-local static tableau over all (pod, node) cells.
//
// Replaces tpusched/kernels/assign.py:110 _tableau_cells, i.e.
// filter.node_affinity_mask + filter.taint_mask + the cordon and validity
// masks, score.node_affinity_raw and score.taint_intolerable_count
// (with atoms.gather_term_sat inside). XLA builds these from [P, T, AT, N]
// and [P, N, TN] gathers; here one thread owns one (p, n) cell and loops
// over the few terms, atoms and taints (sizes read from the shapes).
//
// Bound: bytes written. Each cell writes mask + aff_ok (1 byte each) and
// na_raw + tt_count (4 bytes each): 10 bytes a cell, 0.52 GB at
// 10240 x 5120, which the H100's 3.35 TB/s writes in 0.16 ms. The grid is
// 2-D: blockIdx.y is the pod, x tiles the nodes, so a warp writes 32
// consecutive cells of one row (coalesced) and reads one pod's term,
// toleration and weight rows as broadcasts. node_sat_t is [A, N], so its
// reads are coalesced along n too.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): blockIdx.z is the
// tenant. A cell reads only its own tenant's pod, node, label and taint
// rows ([B, P, ...], [B, N, ...], [B, A, N], [B, VT]) and writes
// [B, P, N]. A solo call is B = 1.
#include "kernels.h"

namespace {

constexpr int EFFECT_NO_SCHEDULE = 0;
constexpr int EFFECT_PREFER_NO_SCHEDULE = 1;
constexpr int EFFECT_NO_EXECUTE = 2;

// gather_term_sat for one cell: every listed atom of the term holds at n.
__device__ __forceinline__ bool term_sat(const bool* __restrict__ sat_t,
                                         const int* __restrict__ atoms,
                                         int AT, int N, int n) {
  bool ok = true;
  for (int j = 0; j < AT; ++j) {
    int a = atoms[j];
    if (a >= 0) ok = ok && sat_t[(long long)a * N + n];
  }
  return ok;
}

__global__ void tableau_kernel(int P, int N, int A, int T, int AT, int PT,
                               int TN, int VT,
                               const bool* __restrict__ node_sat_t,
                               const int* __restrict__ req_term_atoms,
                               const bool* __restrict__ req_term_valid,
                               const int* __restrict__ pref_term_atoms,
                               const bool* __restrict__ pref_term_valid,
                               const float* __restrict__ pref_weight,
                               const int* __restrict__ taint_ids,
                               const signed char* __restrict__ taint_effect,
                               const bool* __restrict__ tolerated,
                               const bool* __restrict__ node_schedulable,
                               const bool* __restrict__ node_valid,
                               const bool* __restrict__ tolerates_unsched,
                               const bool* __restrict__ pod_valid,
                               bool* __restrict__ mask,
                               bool* __restrict__ aff_ok_out,
                               float* __restrict__ na_raw,
                               float* __restrict__ tt_count) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long b = blockIdx.z;
  node_sat_t += b * A * N;
  req_term_atoms += b * P * T * AT;
  req_term_valid += b * P * T;
  pref_term_atoms += b * P * PT * AT;
  pref_term_valid += b * P * PT;
  pref_weight += b * P * PT;
  taint_ids += b * N * TN;
  taint_effect += b * VT;
  tolerated += b * P * VT;
  node_schedulable += b * N;
  node_valid += b * N;
  tolerates_unsched += b * P;
  pod_valid += b * P;
  mask += b * P * N;
  aff_ok_out += b * P * N;
  na_raw += b * P * N;
  tt_count += b * P * N;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    long long cell = (long long)p * N + n;

    // Required node affinity: OR over valid terms, AND within a term; no
    // valid term at all matches every node.
    bool has_req = false, any_term = false;
    for (int t = 0; t < T; ++t) {
      if (!req_term_valid[(long long)p * T + t]) continue;
      has_req = true;
      any_term = any_term ||
          term_sat(node_sat_t, req_term_atoms + ((long long)p * T + t) * AT,
                   AT, N, n);
    }
    bool aff_ok = has_req ? any_term : true;

    // Taints: every NoSchedule/NoExecute taint tolerated; count the
    // intolerable PreferNoSchedule ones.
    bool taint_ok = true;
    float count = 0.0f;
    for (int j = 0; j < TN; ++j) {
      int tid = taint_ids[(long long)n * TN + j];
      if (tid < 0) continue;
      int eff = taint_effect[tid];
      bool tol = tolerated[(long long)p * VT + tid];
      if ((eff == EFFECT_NO_SCHEDULE || eff == EFFECT_NO_EXECUTE) && !tol)
        taint_ok = false;
      if (eff == EFFECT_PREFER_NO_SCHEDULE && !tol) count = count + 1.0f;
    }

    // Preferred affinity: weights of satisfied valid terms, summed over
    // the terms in index order.
    float raw = 0.0f;
    for (int t = 0; t < PT; ++t) {
      bool ok = pref_term_valid[(long long)p * PT + t] &&
          term_sat(node_sat_t, pref_term_atoms + ((long long)p * PT + t) * AT,
                   AT, N, n);
      raw = raw + pref_weight[(long long)p * PT + t] * (ok ? 1.0f : 0.0f);
    }

    bool cordon_ok = node_schedulable[n] || tolerates_unsched[p];
    mask[cell] = aff_ok && taint_ok && node_valid[n] && cordon_ok &&
                 pod_valid[p];
    aff_ok_out[cell] = aff_ok;
    na_raw[cell] = raw;
    tt_count[cell] = count;
  }
}

}  // namespace

extern "C" int tpusched_tableau_cells(
    int B, int P, int N, int A, int T, int AT, int PT, int TN, int VT,
    const bool* node_sat_t, const int* req_term_atoms,
    const bool* req_term_valid, const int* pref_term_atoms,
    const bool* pref_term_valid, const float* pref_weight,
    const int* taint_ids, const signed char* taint_effect,
    const bool* tolerated, const bool* node_schedulable,
    const bool* node_valid, const bool* tolerates_unsched,
    const bool* pod_valid, bool* mask, bool* aff_ok, float* na_raw,
    float* tt_count, void* stream) {
  int threads = 256;
  // Pods beyond the 65535 grid.y limit loop inside the kernel.
  dim3 grid((N + threads - 1) / threads, P < 65535 ? P : 65535, B);
  tableau_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      P, N, A, T, AT, PT, TN, VT, node_sat_t, req_term_atoms, req_term_valid,
      pref_term_atoms, pref_term_valid, pref_weight, taint_ids, taint_effect,
      tolerated, node_schedulable, node_valid, tolerates_unsched, pod_valid,
      mask, aff_ok, na_raw, tt_count);
  return (int)cudaGetLastError();
}
