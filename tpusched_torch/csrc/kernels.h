// C interface of the port's Hopper kernels (tpusched_torch/_build.py
// declares the same signatures for ctypes). Every entry point launches
// on the given stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() after its launch. Arrays are row-major and
// contiguous; bool is one byte (torch.bool).
#pragma once

#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

const char* tpusched_error_string(int err);

// K1. out[x, a] = does label set x satisfy atom a (tpusched/kernels/atoms.py
// atom_sat). label_nums may be NULL (no Gt/Lt evaluation).
int tpusched_atom_sat(const int* label_pairs, const int* label_keys,
                      const float* label_nums, int X, int L,
                      const int* atom_key, const signed char* atom_op,
                      const int* atom_pairs, const float* atom_num,
                      const bool* atom_valid, int A, int V,
                      bool* out, void* stream);

// K2. The cell-local [P, N] tableau (tpusched/kernels/assign.py
// _tableau_cells): static mask, node-affinity mask, raw preferred-affinity
// weight sums and intolerable PreferNoSchedule taint counts.
int tpusched_tableau_cells(int P, int N, int A, int T, int AT, int PT,
                           int TN, int VT,
                           const bool* node_sat_t,
                           const int* req_term_atoms,
                           const bool* req_term_valid,
                           const int* pref_term_atoms,
                           const bool* pref_term_valid,
                           const float* pref_weight,
                           const int* taint_ids,
                           const signed char* taint_effect,
                           const bool* tolerated,
                           const bool* node_schedulable,
                           const bool* node_valid,
                           const bool* tolerates_unsched,
                           const bool* pod_valid,
                           bool* mask, bool* aff_ok, float* na_raw,
                           float* tt_count, void* stream);

// K3. static score[p, n] = w_na[p] * default_normalize(na_raw)[p, n]
//                        + w_tt[p] * taint_toleration_from_count(tt)[p, n]
// (tpusched/kernels/assign.py finalize_static).
int tpusched_finalize_static(int P, int N, const float* na_raw,
                             const float* tt_count, const bool* node_valid,
                             const float* w_na, const float* w_tt,
                             float* score, void* stream);

// K4. The parity scan (tpusched/kernels/assign.py solve_sequential with
// no signatures, gangs or preemption). used holds the initial [N, R]
// usage on entry and the final one on return.
int tpusched_parity_scan(int P, int N, int R, const int* order,
                         const bool* mask, const float* static_score,
                         const float* alloc, const float* requests,
                         const float* w_lr, const float* w_ba,
                         const float* w_ts, const float* w_ia,
                         const float* rw, int seeded, unsigned int seed,
                         float* used, int* assigned, float* chosen,
                         void* stream);

#ifdef __cplusplus
}
#endif
