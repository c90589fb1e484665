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

// K5. The batched Filter + Score over a [rows_n, N] block
// (tpusched/kernels/assign.py batched_cycle / _cycle_nosig). rows (may be
// NULL) maps output row i to pod row rows[i] of mask, sscore, req, the
// weights and the pairwise rows; pending (may be NULL) is per output row.
// pair_ok, ts, ia ([P, N], K11's outputs) and w_ia are NULL at S = 0,
// where the spread score is the constant 100 and the inter-pod term is
// absent. masked_out = 1 writes where(feasible, score, -inf), 0 the raw
// score. ia_ok ([P, N], K11's) and relaxed ([rows_n, N]) are NULL unless
// the spread-relaxed feasibility mask & fit & ia_ok (& pending) is wanted.
int tpusched_cycle(int rows_n, int N, int R, const int* rows,
                   const bool* pending, const bool* mask,
                   const float* sscore, const float* alloc,
                   const float* used, const float* req, const float* w_lr,
                   const float* w_ba, const float* w_ts, const float* rw,
                   const bool* pair_ok, const float* ts, const float* ia,
                   const float* w_ia, int masked_out, bool* feasible,
                   float* score, const bool* ia_ok, bool* relaxed,
                   void* stream);

// K6. Per row of masked [rows, N]: the K best (value, index), larger value
// first and ties to the lower index (topv/topi [rows, K]); with seeded,
// pick[row] = the (tie_hash(seed, id) % #maxima)-th maximum in node
// order, id = row_ids[row] (row_ids may be NULL: id = row).
int tpusched_row_topk(int rows, int N, int K, const float* masked,
                      int seeded, unsigned int seed, const int* row_ids,
                      float* topv, int* topi, int* pick, void* stream);

// K7. desir[n] = sum over rows (ascending) of masked where feasible and
// allowed, over max(#allowed, 1); -inf where no allowed row is feasible.
// fixed = 1: the sum is of int32 round(masked * 16) clipped to +-32767,
// over 16 * max(#allowed, 1) (assign.py:799-812, width-invariant), in
// row chunks that add into work ([2N + 1] int32, zero on entry).
int tpusched_desirability(int rows, int N, const bool* feasible,
                          const float* masked, const bool* allowed,
                          int fixed, int* work, float* desir, void* stream);

// K8. One capacity-prefix commit sub-step over the (node, rank)-sorted
// candidates: perm [P] (sorted row -> pod row), cand_s [P] (sorted nodes,
// N = inactive). Updates used [N, R], choice [P] and ptr [P] in place.
// Scratch: buf_f [2P] floats, buf_i [2P] ints, fit [P] bytes.
int tpusched_prefix_commit(int P, int N, int R, int KC, const int* perm,
                           const int* cand_s, const float* req,
                           const float* alloc, float* used, int* choice,
                           int* ptr, float* buf_f, int* buf_i,
                           unsigned char* fit, void* stream);

// K8's node_add (tpusched/kernels/assign.py _node_add): rows sorted by
// (node, rank), perm [P] (sorted row -> pod row), node_s [P] (sorted
// nodes, N = masked out); used[n] += sign * req[perm[j]] for each row of
// node n, one at a time in sorted order. sign is +1 or -1.
int tpusched_node_add(int P, int N, int R, const int* perm,
                      const int* node_s, const float* req, int sign,
                      float* used, void* stream);

// K4, pairwise variant (tpusched/kernels/assign.py solve_sequential with
// signatures): the parity scan with pairwise_row and pair_state_add_pod.
// The pairwise block (S .. ia_weight, then counts, anti, match_tot) is
// K11's; counts/anti/match_tot hold the initial pair state on entry and
// the final one on return; pen, raw ([N] floats) and allowed ([N] bytes)
// are scratch.
int tpusched_parity_scan_pair(
    int P, int N, int R, const int* order, const bool* mask,
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
    void* stream);

// K9. out[s, x] = member x matches signature s (tpusched/kernels/
// pairwise.py sig_member_match): its selector atoms ([S, AT], -1 pad)
// all satisfied in member_sat_t [A, X], its namespace in ns [S, NS] or
// ns_all, and valid[s].
int tpusched_sig_match(int S, int X, int AT, int NS, const bool* member_sat_t,
                       const int* atoms, const int* ns, const bool* ns_all,
                       const bool* valid, const int* member_ns, bool* out,
                       void* stream);

// K10. The pair state from scratch (pairwise.py pair_state_init, and
// pair_state_seed when assigned is not NULL): adds into counts [S, N],
// anti [S, N] and match_tot [S], which must hold zeros on entry.
int tpusched_pair_counts(int S, int N, int M, int P, int J, int IT,
                         const bool* match, const int* dom,
                         const int* run_node, const bool* run_valid,
                         const int* run_anti_sig, const int* ia_sig,
                         const bool* ia_valid, const bool* ia_anti,
                         const bool* ia_required, const int* assigned,
                         float* counts, float* anti, float* match_tot,
                         void* stream);

// K11. Every pod's pairwise row against one pair state (pairwise.py
// pairwise_from_counts, exclude_self_node = NULL, with the two
// normalisers of score.py): pair_ok [P, N], ts_score and ia_score [P, N].
int tpusched_pairwise_batch(
    int P, int N, int S, int C, int IT, int M, const int* dom,
    const bool* match, const bool* node_valid, const bool* aff_ok,
    const int* ts_sig, const bool* ts_valid, const signed char* ts_when,
    const float* ts_max_skew, const int* ia_sig, const bool* ia_valid,
    const bool* ia_anti, const bool* ia_required, const float* ia_weight,
    const float* counts, const float* anti, const float* match_tot,
    bool* pair_ok, float* ts_score, float* ia_score, bool* ia_ok,
    void* stream);

// K10's commit entry point (pairwise.py pair_state_commit): pods p < P
// with commit[p] add sign (+1 or -1) at choice[p] into counts, anti and
// match_tot, in place. match [S, M + P] is the view's member table.
int tpusched_pair_commit(int S, int N, int M, int P, int IT,
                         const bool* match, const int* dom,
                         const int* ia_sig, const bool* ia_valid,
                         const bool* ia_anti, const bool* ia_required,
                         const int* choice, const bool* commit, int sign,
                         float* counts, float* anti, float* match_tot,
                         void* stream);

// K14. ok[p] = the required inter-pod and symmetric anti-affinity verdict
// of pod p at node choice[p] (clipped to 0), its own contribution left
// out where esn[p] >= 0 (pairwise.py ia_ok_at_choice).
int tpusched_ia_at_choice(int P, int N, int S, int IT, int M, const int* dom,
                          const bool* match, const int* ia_sig,
                          const bool* ia_valid, const bool* ia_anti,
                          const bool* ia_required, const float* counts,
                          const float* anti, const float* match_tot,
                          const int* choice, const int* esn, bool* ok,
                          void* stream);

// K12. The water-fill dealer's per-pod part (assign.py
// _spread_waterfill_deal from its fill table on): fill [S, N] f32,
// ord_dom and dom [S, N], s_p [P], q [P] f32, relaxed [P, N], cap_order
// [N], score [P, N], member [P]; writes cand and val [P, K1] (K1 <= 32)
// and ok [P].
int tpusched_waterfill(int P, int N, int K1, const float* fill,
                       const int* ord_dom, const int* dom, const int* s_p,
                       const float* q, const bool* relaxed,
                       const int* cap_order, const float* score,
                       const bool* member, int* cand, float* val, bool* ok,
                       void* stream);

// K13 (assign.py _spread_excess_mask), first entry point: min_end[p] =
// min of counts[s_c[p], dom[s_c[p], n]] over valid nodes n with
// aff_ok[p, n] and the key, 0 if none.
int tpusched_excess_min(int P, int N, const int* dom, const float* counts,
                        const bool* node_valid, const bool* aff_ok,
                        const int* s_c, float* min_end, void* stream);

// K13, second entry point: rows sorted by (group gid_s, rank), perm [P]
// sorted row -> pod row; per group of members the running count q and
// running min of T; bad[p] = member & !(b_fixed + q <= min), false for
// non-members (whose group is the last).
int tpusched_excess_survive(int P, const int* gid_s, const int* perm,
                            const bool* member, const float* T,
                            const float* b_fixed, bool* bad, void* stream);

// K15 (tpusched/kernels/preempt.py preempt_step): one preemptor's victim
// search over the (node, cost)-sorted victim table (perm .. pdb_s, in
// preempt.cuh's thread-interleaved layout padded to Mp = 1024 *
// ceil(M / 1024): [Mp] each, req_s [R, Mp]); p_prio and p_req point to
// the pod's priority and [R] requests, allowed and node_valid are [N],
// used and alloc [N, R], evicted [M], remaining [GP] each budget's
// disruptions left. Scratch (the same layout): elig [Mp] bytes, cum
// [(R + 1) * Mp] floats, cum_viol [Mp] ints. Writes
// best[0] (node, 0 if none) and best[1] (can); evict_m [M] and freed [R]
// must hold zeros on entry.
int tpusched_preempt_step(
    int N, int R, int M, int GP, const int* perm, const int* node_s,
    const int* seg_start, const float* cost_s, const float* vprio_s,
    const float* req_s, const int* pdb_s, float margin, const float* p_prio,
    const float* p_req, const bool* allowed, const bool* node_valid,
    const float* used, const float* alloc, const bool* evicted,
    const float* remaining, unsigned char* elig, float* cum, int* cum_viol,
    int* best, bool* evict_m, float* freed, void* stream);

// K4's preemption variants (solve_sequential with cfg.preemption): the
// parity scan (and its pairwise variant) with K15's search for each valid
// pod outside a gang (group < 0) that fits nowhere. The block M .. cum_viol
// is K15's table and scratch, each pod's effective priority, validity and
// gang, node validity, the running pods' nodes and [M, J] required anti
// signatures; remaining [GP] holds the budgets' disruptions allowed on
// entry and what is left on return; evicted [M] (zeros on entry) the
// evictions.
int tpusched_parity_scan_preempt(
    int P, int N, int R, const int* order, const bool* mask,
    const float* static_score, const float* alloc, const float* requests,
    const float* w_lr, const float* w_ba, const float* w_ts,
    const float* w_ia, const float* rw, int seeded, unsigned int seed, int M,
    int GP, int J, const int* perm, const int* node_s, const int* seg_start,
    const float* cost_s, const float* vprio_s, const float* req_s,
    const int* pdb_s, float margin, const float* prio, const bool* pod_valid,
    const int* group, const bool* node_valid, const int* run_node,
    const int* run_anti_sig, float* remaining, unsigned char* evicted,
    unsigned char* elig, float* cum, int* cum_viol, float* used,
    int* assigned, float* chosen, void* stream);

int tpusched_parity_scan_pair_preempt(
    int P, int N, int R, const int* order, const bool* mask,
    const float* static_score, const float* alloc, const float* requests,
    const float* w_lr, const float* w_ba, const float* w_ts,
    const float* w_ia, const float* rw, int seeded, unsigned int seed,
    int S, int C, int IT, int M, const int* dom, const bool* match,
    const bool* node_valid, const bool* aff_ok, const int* ts_sig,
    const bool* ts_valid, const signed char* ts_when,
    const float* ts_max_skew, const int* ia_sig, const bool* ia_valid,
    const bool* ia_anti, const bool* ia_required, const float* ia_weight,
    float* counts, float* anti, float* match_tot, float* pen, float* raw,
    unsigned char* allowed, int M2, int GP, int J, const int* perm,
    const int* node_s, const int* seg_start, const float* cost_s,
    const float* vprio_s, const float* req_s, const int* pdb_s,
    float margin, const float* prio, const bool* pod_valid, const int* group,
    const bool* node_valid2, const int* run_node, const int* run_anti_sig,
    float* remaining, unsigned char* evicted, unsigned char* elig,
    float* cum, int* cum_viol, float* used, int* assigned, float* chosen,
    void* stream);

// K16. The fast preemption auction's lane tables (tpusched/kernels/
// preempt.py:488-545): per lane l and node n, the V-long inclusive
// prefixes (from 0.0, left to right) of the requests and cost of the
// victims eligible at thr[l], and of their PDB violations.
int tpusched_auction_tables(int L, int N, int V, int R, int M, int GP,
                            const float* vreq, const float* vcost,
                            const float* vprio, const int* vpdb,
                            const bool* vvalid, const int* vidx,
                            const bool* evicted, const float* thr,
                            const float* remaining, float margin,
                            float* cum_req, float* cum_cost, int* cum_viol,
                            void* stream);

// K17's auction_ok entry point: ok[c, n] = mask[rows ? rows[c] : c, n] &
// node_valid[n] & pre_active[c] & (pair_ok ? pair_ok[c, n] : true), and
// any_ok[c] = any over n. rows and pair_ok may be NULL.
int tpusched_auction_ok(int C, int N, const bool* mask, const int* rows,
                        const bool* pair_ok, const bool* pre_active,
                        const bool* node_valid, bool* ok, bool* any_ok,
                        void* stream);

// K17. The auction's [C, N] ranking (preempt.py:486-562): bid = -cost of
// the first prefix freeing each bidder's demand on each allowed node, over
// the nodes with the fewest violations, in the bidder's lane (or the
// optimistic lane L - 1 as its fallback); -inf elsewhere. could[c]: some
// allowed node is feasible in the optimistic lane.
int tpusched_auction_rank(int L, int N, int V, int R, int C,
                          const float* cum_req, const float* cum_cost,
                          const int* cum_viol, const int* lane,
                          const bool* ok, const float* used,
                          const float* alloc, const float* p_req, float* bid,
                          bool* could, void* stream);

// K18. The auction's claim iterations and exact [C, V] validation
// (preempt.py:564-679), one CTA; C <= 1024, 5 * N bytes of shared
// memory. topv_t, topi_t: the candidate lists transposed, [K, C]. usage
// must arrive zeroed.
int tpusched_auction_claim(int C, int K, int N, int V, int R, int M, int GP,
                           int iters, const float* topv_t, const int* topi_t,
                           const bool* can_plain, const int* n_plain,
                           const int* rank, const float* vreq,
                           const float* vprio, const int* vpdb,
                           const bool* vvalid, const int* vidx,
                           const bool* evicted, const float* p_prio,
                           const float* p_req, const float* used,
                           const float* alloc, const bool* could,
                           float margin, int* target, bool* claimed,
                           bool* takes, int* vidx_t, float* freed,
                           int* usage, bool* could_bid, void* stream);

#ifdef __cplusplus
}
#endif
