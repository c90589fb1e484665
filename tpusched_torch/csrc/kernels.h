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

// Tenant axis: the entry points that take B first run B independent
// tenants in one launch (tpusched/tenants.py solve_many); every array of
// their comment gains a leading [B] axis (rw, the shared resource weights,
// excepted), and a solo call passes B = 1.

// K1. out[x, a] = does label set x satisfy atom a (tpusched/kernels/atoms.py
// atom_sat). label_nums may be NULL (no Gt/Lt evaluation).
int tpusched_atom_sat(const int* label_pairs, const int* label_keys,
                      const float* label_nums, int B, int X, int L,
                      const int* atom_key, const signed char* atom_op,
                      const int* atom_pairs, const float* atom_num,
                      const bool* atom_valid, int A, int V,
                      bool* out, void* stream);

// K2. The cell-local [P, N] tableau (tpusched/kernels/assign.py
// _tableau_cells): static mask, node-affinity mask, raw preferred-affinity
// weight sums and intolerable PreferNoSchedule taint counts.
int tpusched_tableau_cells(int B, int P, int N, int A, int T, int AT, int PT,
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
int tpusched_finalize_static(int B, int P, int N, const float* na_raw,
                             const float* tt_count, const bool* node_valid,
                             const float* w_na, const float* w_tt,
                             float* score, void* stream);

// K4. The parity scan (tpusched/kernels/assign.py solve_sequential with
// no signatures, gangs or preemption), B tenants as B clusters of Q CTAs
// (Q in {1, 2, 4, 8, 16}) of `threads` (256, 512 or 1024) threads. used holds
// the initial [N, R] usage on entry and the final one on return.
int tpusched_parity_scan(int B, int Q, int threads, int P, int N, int R,
                         const int* order,
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
// P is the source pod rows per tenant; rows holds [B, rows_n] pod indices.
// A CTA covers tr (1..32) rows x threads * 4 nodes (threads: 32..256, a
// multiple of 32); R is 1..8.
int tpusched_cycle(int B, int rows_n, int P, int N, int R, const int* rows,
                   const bool* pending, const bool* mask,
                   const float* sscore, const float* alloc,
                   const float* used, const float* req, const float* w_lr,
                   const float* w_ba, const float* w_ts, const float* rw,
                   const bool* pair_ok, const float* ts, const float* ia,
                   const float* w_ia, int masked_out, bool* feasible,
                   float* score, const bool* ia_ok, bool* relaxed,
                   int tr, int threads, void* stream);

// K6. Per row of masked [rows, N]: the K best (value, index), larger value
// first and ties to the lower index (topv/topi [rows, K]); with seeded,
// pick[row] = the (tie_hash(seed, id) % #maxima)-th maximum in node
// order, id = row_ids[row] (row_ids may be NULL: id = row). One warp a
// row, or `split` (1, 2, 4 or 8) warps of a CTA a row; K <= 32.
int tpusched_row_topk(int rows, int N, int K, int split, const float* masked,
                      int seeded, unsigned int seed, const int* row_ids,
                      float* topv, int* topi, int* pick, void* stream);

// K6's radix path, the same top-K (not seeded) by a radix select and a
// bitonic sort of the K selected. Above K = 16 384 the pairs do not fit
// in shared memory: scratch then holds rows x (K rounded up to a power
// of two) uint64 (NULL otherwise).
int tpusched_row_topk_radix(int rows, int N, int K, const float* masked,
                            float* topv, int* topi, void* scratch,
                            void* stream);

// K7. desir[n] = sum over rows (ascending) of masked where feasible and
// allowed, over max(#allowed, 1); -inf where no allowed row is feasible.
// fixed = 1: the sum is of int32 round(masked * 16) clipped to +-32767,
// over 16 * max(#allowed, 1) (assign.py:799-812, width-invariant), in
// row chunks that add into work ([2N + 1] int32, zero on entry).
int tpusched_desirability(int B, int rows, int N, const bool* feasible,
                          const float* masked, const bool* allowed,
                          int fixed, int* work, float* desir, void* stream);

// K8. A fast round's capacity-prefix commit sub-steps, all of them in one
// launch (tpusched/kernels/assign.py:888-957): each row walks its
// candidate list topi / topv [P, KC] from the start while it is allowed
// and its candidate is finite; per sub-step the active rows are ordered
// by (node, rank), each node commits the longest rank-ordered prefix of
// its rows that fits alloc - used (rows that do not fit move to their
// next candidate), until no row is active. used_out [N, R] gets used_in
// plus the commits, added per node in ascending rank; choice [P] the
// committed node or -1; steps [1] the sub-steps run. B tenants, one CTA
// each. With smem = 1 the CTA keeps its state in dynamic shared memory
// (P * 18 + (2N + P / 32 + 2) * 4 bytes); with smem = 0 in key_scratch
// [B, P], int_scratch [B, 2N + P / 32 + 2], float_scratch [B, 2P] and
// byte_scratch [B, 2P]. R is 1..8, KC 1..255.
int tpusched_prefix_commit_loop(int B, int P, int N, int R, int KC,
                                const int* topi, const float* topv,
                                const bool* allowed, const int* rank,
                                const float* req, const float* alloc,
                                const float* used_in, float* used_out,
                                int* choice, int* steps, int smem,
                                unsigned long long* key_scratch,
                                int* int_scratch, float* float_scratch,
                                unsigned char* byte_scratch, void* stream);

// K23 (tpusched/kernels/assign.py _deal_commit's dealing). Inclusive
// prefixes of the demand dem [L, R] and the capacity rem [N, R] (nodes
// by descending desirability) into cum_dem [R, L] and cum_rem [R, N]
// (scratch, transposed), in _scan_plain's Hillis-Steele order; then
// pos[p] = max over r of the left searchsorted of cum_dem[r, g] in
// cum_rem[r, :], g = gather[p] (gather [P] may be NULL: g = p, L = P).
int tpusched_deal(int B, int P, int L, int N, int R, const float* dem,
                  const float* rem, const long long* gather, float* cum_dem,
                  float* cum_rem, long long* pos, void* stream);

// K23's hand-off (tpusched/kernels/assign.py _deal_commit from K7's
// desirability to K8's lists; kernels/assign.py deal_lists_plain): desir
// [N], alloc and used [N, R], req [V, R], allowed and rank [V], feasible
// and masked [V, N] (only gathered), topv and topi [V, K], tie_pick [V]
// (NULL: unseeded), K12's override cand and val [V, K + 1] and ok [V]
// (all three NULL: none). scatter = 1: pod p's demand sits at row
// rank[p] of the L-row demand column; 0: at row p (L = V). scratch:
// [B, R, L] + [B, R, N] floats and [B, R, N] ints. Out: topi_o and topv_o
// [V, K + 1], first [V] (topi's first column). Rows L and N <= 29 056.
int tpusched_deal_lists(int B, int V, int L, int N, int R, int K,
                        int scatter, const float* desir, const float* alloc,
                        const float* used, const float* req,
                        const bool* allowed, const int* rank,
                        const bool* feasible, const float* masked,
                        const float* topv, const int* topi,
                        const int* tie_pick, const int* cand,
                        const float* val, const bool* ok, float* scratch,
                        int* topi_o, float* topv_o, int* first,
                        void* stream);

// K24 (tpusched/kernels/assign.py _top_by_rank). Over the pods in pop
// order (order [P] int64), buf [C] gets the C lowest-rank pods with
// pend set, by rank, then the others by rank; n_pend [1] the count of
// pend. C <= P.
int tpusched_top_by_rank(int B, int P, int C, const bool* pend,
                         const long long* order, long long* buf,
                         long long* n_pend, void* stream);

// K8's node_add (tpusched/kernels/assign.py _node_add): for the rows with
// mask set, used_out[node[i]] = used_in[node[i]] + sign * req[i] (node
// clamped to [0, N - 1]), each node's rows one at a time in ascending
// (rank, row index) order; nodes no row touches are copied through. B
// tenants, one CTA each; node, mask and rank [B, P] with batch strides
// node_bs, mask_bs, rank_bs (0: one row shared by every tenant), req
// [B, P, R] and used [B, N, R] contiguous. sign is +1 or -1. With smem = 1
// the CTA keeps its buckets in dynamic shared memory (P * 8 + (N + P / 32
// + 2) * 4 bytes); with smem = 0 in key_scratch [B, P] and int_scratch
// [B, N + P / 32 + 2]. R is 1..8.
int tpusched_node_add(int B, int P, int N, int R, const int* node,
                      int node_bs, const bool* mask, int mask_bs,
                      const int* rank, int rank_bs, const float* req,
                      int sign, const float* used_in, float* used_out,
                      int smem, unsigned long long* key_scratch,
                      int* int_scratch, void* stream);

// K4, pairwise variant (tpusched/kernels/assign.py solve_sequential with
// signatures): the parity scan with pairwise_row and pair_state_add_pod.
// The pairwise block (S .. ia_weight, then counts, anti, match_tot) is
// K11's; counts/anti/match_tot hold the initial pair state on entry and
// the final one on return; pen, raw ([N] floats) and allowed ([N] bytes)
// are scratch. B, Q and threads as for K4.
int tpusched_parity_scan_pair(
    int B, int Q, int threads, int P, int N, int R, const int* order, const bool* mask,
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
int tpusched_sig_match(int B, int A, int S, int X, int AT, int NS,
                       const bool* member_sat_t, const int* atoms, const int* ns, const bool* ns_all,
                       const bool* valid, const int* member_ns, bool* out,
                       void* stream);

// K10. The pair state from scratch (pairwise.py pair_state_init, and
// pair_state_seed when assigned is not NULL): adds into counts [S, N],
// anti [S, N] and match_tot [S], which must hold zeros on entry; counts
// NULL skips the count scatter (the ring's counts stand in for it).
int tpusched_pair_counts(int B, int S, int N, int M, int P, int J, int IT,
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
    int B, int P, int N, int S, int C, int IT, int M, const int* dom,
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
int tpusched_pair_commit(int B, int S, int N, int M, int P, int IT,
                         const bool* match, const int* dom,
                         const int* ia_sig, const bool* ia_valid,
                         const bool* ia_anti, const bool* ia_required,
                         const int* choice, const bool* commit, int sign,
                         float* counts, float* anti, float* match_tot,
                         void* stream);

// K14. ok[p] = the required inter-pod and symmetric anti-affinity verdict
// of pod p at node choice[p] (clipped to 0), its own contribution left
// out where esn[p] >= 0 (pairwise.py ia_ok_at_choice).
int tpusched_ia_at_choice(int B, int P, int N, int S, int IT, int M,
                          const int* dom,
                          const bool* match, const int* ia_sig,
                          const bool* ia_valid, const bool* ia_anti,
                          const bool* ia_required, const float* counts,
                          const float* anti, const float* match_tot,
                          const int* choice, const int* esn, bool* ok,
                          void* stream);

// K12. The water-fill dealer's per-pod part (assign.py
// _spread_waterfill_deal from its fill table on): fill [S, N] f32,
// ord_dom [S, N], the per-domain node lists dsort and dnode [S, N] (the
// nodes' domains ascending, the nodes in that order, each domain's in
// cap_order order), s_p [P], q [P] f32, relaxed [P, N], cap_order [N],
// score [P, N], member [P]; writes cand and val [P, K1] (K1 <= 32) and
// ok [P].
int tpusched_waterfill(int B, int P, int S, int N, int K1, const float* fill,
                       const int* ord_dom, const int* dsort, const int* dnode,
                       const int* s_p, const float* q, const bool* relaxed,
                       const int* cap_order, const float* score,
                       const bool* member, int* cand, float* val, bool* ok,
                       void* stream);

// K12's tables (assign.py:606-641): s_p, member and the sort key
// (gid << 32) + rank of each pod [P] from its C spread slots, allowed and
// rank; q [P] from those keys sorted (key_s, perm); cnt [S, N] from the
// node lists dsort and the domain counts; fill [S, N] and ord_dom from
// cnt sorted (csort, ord int64).
int tpusched_waterfill_members(int B, int P, int C, int S, const int* ts_sig,
                               const bool* ts_valid,
                               const signed char* ts_when,
                               const bool* allowed, const int* rank,
                               int* s_p, bool* member, long long* key,
                               void* stream);
int tpusched_waterfill_q(int B, int P, int S, const long long* key_s,
                         const long long* perm, float* q, void* stream);
int tpusched_waterfill_cnt(int B, int S, int N, const int* dsort,
                           const float* counts, float* cnt, void* stream);
int tpusched_waterfill_fill(int B, int S, int N, const float* csort,
                            const long long* ord, float* fill, int* ord_dom,
                            void* stream);

// K13 (assign.py _spread_excess_mask), the key table: key[s, n] =
// counts[s, dom[s, n]] where node n is valid and has the key, +inf
// elsewhere.
int tpusched_excess_keys(int B, int S, int N, const int* dom,
                         const float* counts, const bool* node_valid,
                         float* key, void* stream);

// K13, the [P, N] pass over every spread slot c < C (C <= 16): the min of
// key[s_c(p), n] over n with aff_ok[p, n] (0 if none) and slot c's per-pod
// steps, written [C, P]: T (that min + maxSkew), cnt_total, the sort key
// (gid << 32) + rank; g_cnt [C, S * N + 1] (zeroed by the caller) gains
// each group's members.
int tpusched_excess_min(int B, int P, int S, int N, int C, const float* key,
                        const bool* aff_ok, const int* ts_sig,
                        const bool* ts_valid, const signed char* ts_when,
                        const float* ts_skew, const int* choice,
                        const bool* kept, const int* rank, const int* dom,
                        const float* counts, float* T, float* cnt_total,
                        long long* gkey, int* g_cnt, void* stream);

// K13, the group walk over every slot: key_s and perm [C, P] each slot's
// keys sorted and their pod rows; bad [P] (zeroed by the caller) set
// where a member of any slot's group fails b_fixed + q <= the running
// min of T, b_fixed = cnt_total - the group's count.
int tpusched_excess_walk(int B, int C, int P, int S, int N,
                         const long long* key_s, const long long* perm,
                         const float* T, const float* cnt_total,
                         const int* g_cnt, bool* bad, void* stream);

// K13, the walk's older form, one slot: rows sorted by (group gid_s,
// rank), perm [P] sorted row -> pod row; per group of members the running
// count q and running min of T; bad[p] (zeroed by the caller) set where
// member & !(b_fixed + q <= min).
int tpusched_excess_survive(int B, int P, const int* gid_s, const int* perm,
                            const bool* member, const float* T,
                            const float* b_fixed, bool* bad, void* stream);

// K15 (tpusched/kernels/preempt.py preempt_step): one preemptor's victim
// search over the (node, cost)-sorted victim table (preempt.cuh): off
// [N + 1] each node's first sorted position, the planes holding each
// node's first V victims, pl_vic [V, N, 4] (vprio, cost as f32 bits,
// pdb, perm) and pl_req [R, V, N], and the sorted order perm .. pdb_s
// [M] (req_s [M, R]) for the rest; p_prio and p_req point to the pod's
// priority and [R] requests, allowed and node_valid are [N], used and
// alloc [N, R], ev_s [M] the evictions so far in the sorted order (the
// kernel marks the chosen victims there), remaining [GP] each budget's
// disruptions left. Writes best[0] (node, 0 if none) and best[1] (can);
// evict_m [M] and freed [R] must hold zeros on entry.
int tpusched_preempt_step(
    int N, int R, int M, int GP, int V, const int* off, const int* pl_vic,
    const float* pl_req, const int* perm, const float* cost_s,
    const float* vprio_s, const float* req_s, const int* pdb_s, float margin,
    const float* p_prio, const float* p_req, const bool* allowed,
    const bool* node_valid, const float* used, const float* alloc,
    unsigned char* ev_s, const float* remaining, int* best, bool* evict_m,
    float* freed, void* stream);

// K4's preemption variants (solve_sequential with cfg.preemption): the
// parity scan (and its pairwise variant) with K15's search for each valid
// pod outside a gang (group < 0) that fits nowhere. The block M .. pdb_s
// is K15's table; then each pod's effective priority, validity and gang,
// node validity, the running pods' nodes and [M, J] required anti
// signatures; remaining [GP] holds the budgets' disruptions allowed on
// entry and what is left on return; evicted [M] (zeros on entry) the
// evictions, ev_s [M] (zeros on entry) the same in the victims' sorted
// order. evictor and evict_pos [M] (may be NULL; else -1 on entry)
// receive, for each evicted victim, the evicting pod and its pop-order
// step. With the tenant axis every part of the table gains a leading [B]
// axis (each tenant its own order, offsets and planes, V shared), and
// evictor / evict_pos must be NULL when B > 1.
int tpusched_parity_scan_preempt(
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
    void* stream);

int tpusched_parity_scan_pair_preempt(
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
    int* evictor, int* evict_pos, void* stream);

// K16. The fast preemption auction's lane tables (tpusched/kernels/
// preempt.py:488-545): per lane l and node n, the V-long inclusive
// prefixes (from 0.0, left to right) of the requests and cost of the
// victims eligible at thr[l], and of their PDB violations.
int tpusched_auction_tables(int B, int L, int N, int V, int R, int M, int GP,
                            const float* vreq, const float* vcost,
                            const float* vprio, const int* vpdb,
                            const bool* vvalid, const int* vidx,
                            const bool* evicted, const float* thr,
                            const float* remaining, float margin,
                            float* cum_req, float* cum_cost, int* cum_viol,
                            void* stream);

// K17's auction_ok entry point: ok[c, n] = mask[rows ? rows[c] : c, n] &
// node_valid[n] & pre_active[c] & (pair_ok ? pair_ok[c, n] : true), and
// any_ok[c] = any over n. rows and pair_ok may be NULL; mask is [Pm, N]
// (Pm = C without rows).
int tpusched_auction_ok(int B, int C, int N, int Pm, const bool* mask,
                        const int* rows,
                        const bool* pair_ok, const bool* pre_active,
                        const bool* node_valid, bool* ok, bool* any_ok,
                        void* stream);

// K17. The auction's [C, N] ranking (preempt.py:486-562): bid = -cost of
// the first prefix freeing each bidder's demand on each allowed node, over
// the nodes with the fewest violations, in the bidder's lane (or the
// optimistic lane L - 1 as its fallback); -inf elsewhere. could[c]: some
// allowed node is feasible in the optimistic lane. B * ceil(C / 32)
// clusters of Q CTAs (1, 2, 4, 8 or 16), a cluster a tile of 32 bidders.
int tpusched_auction_rank(int B, int Q, int L, int N, int V, int R, int C,
                          const float* cum_req, const float* cum_cost,
                          const int* cum_viol, const int* lane,
                          const bool* ok, const float* used,
                          const float* alloc, const float* p_req, float* bid,
                          bool* could, void* stream);

// K18. The auction's claim iterations and exact [C, V] validation
// (preempt.py:564-679): B clusters of Q CTAs (1, 2, 4, 8 or 16) of
// `threads` threads, cluster b tenant b, a warp a bidder; topv, topi
// [C, K] (K <= 256) as K6 gives them. usage must arrive zeroed; ranks
// below INT_MAX.
int tpusched_auction_claim(int B, int Q, int threads, int C, int K, int N,
                           int V, int R, int M, int GP, int iters,
                           const float* topv, const int* topi,
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

// K18's limits (tpusched_torch/limits.py holds copies): out [3] gets
// MAXR, CLAIM_SMEM_LIMIT and claim_smem_bytes(N, C, Q, K). Host only.
int tpusched_claim_limits(int N, int C, int Q, int K, long long* out);

// K19 (assign.py _capacity_prefix_keep). After the caller's sort of the
// rows by (node, rank) (perm: sorted row -> pod row, node_s: sorted nodes,
// N for inactive rows): keep[p] = p lies in its node's longest rank-ordered
// prefix whose summed requests fit alloc - used. keep must arrive false.
// R <= 16.
int tpusched_capacity_prefix_keep(int P, int N, int R, const int* perm,
                                  const int* node_s, const float* requests,
                                  const float* alloc, const float* used,
                                  bool* keep, void* stream);

// K20 (assign.py solve_incremental's frontier closure and static
// revalidation). invol [P, S] (NULL when S = 0), dirty_node [N] or NULL;
// carry -1 where a pod carries nothing. hot [max(S, 1)] and count must
// arrive zeroed. Two launches: the hot signatures, then the pods.
int tpusched_frontier_closure(int P, int N, int S, const bool* invol,
                              const bool* fr0, const bool* valid,
                              const int* carry, const bool* dirty_node,
                              const bool* mask, int* hot, bool* fr,
                              bool* carried, int* count, void* stream);

// K22 (kernels/explain.py explain_probe's [P, N] pass). The pairwise
// block is tpusched_pairwise_batch's (S = 0 and NULL pointers without
// signatures), then the probe's arrays: alloc, used [N, R], requests
// [P, R], rw [R], pod and node validity, schedulable [N],
// tolerates_unsched [P], taint_ids [N, TN], taint_effect [VT], tolerated
// [P, VT], the tableau's aff_ok, na_raw and tt_count [P, N], and the six
// effective weights [P] in SCORE_TERMS order. explain_cells writes
// tallies [P, 6] and feasible [P] (int counts), masked [P, N] (the term
// sum, -inf where infeasible) and norms [P, 6 + 2C] (the row
// normalisers); explain_terms the six terms at topi [P, kb] into terms
// [P, kb, 6], zero where topv is -inf. R <= 8.
int tpusched_explain_cells(
    int P, int N, int S, int C, int IT, int M, const int* dom,
    const bool* match, const bool* node_valid, const bool* aff_ok,
    const int* ts_sig, const bool* ts_valid, const signed char* ts_when,
    const float* ts_max_skew, const int* ia_sig, const bool* ia_valid,
    const bool* ia_anti, const bool* ia_required, const float* ia_weight,
    const float* counts, const float* anti, const float* match_tot, int R,
    int TN, int VT, const float* alloc, const float* used, const float* req,
    const float* rw, const bool* pod_valid, const bool* node_valid2,
    const bool* schedulable, const bool* tolerates_unsched,
    const int* taint_ids, const signed char* taint_effect,
    const bool* tolerated, const bool* aff_ok2, const float* na_raw,
    const float* tt_count, const float* w_lr, const float* w_ba,
    const float* w_na, const float* w_tt, const float* w_ts,
    const float* w_ia, int* tallies, int* feasible, float* masked,
    float* norms, void* stream);

int tpusched_explain_terms(
    int P, int N, int S, int C, int IT, int M, const int* dom,
    const bool* match, const bool* node_valid, const bool* aff_ok,
    const int* ts_sig, const bool* ts_valid, const signed char* ts_when,
    const float* ts_max_skew, const int* ia_sig, const bool* ia_valid,
    const bool* ia_anti, const bool* ia_required, const float* ia_weight,
    const float* counts, const float* anti, const float* match_tot, int R,
    int TN, int VT, const float* alloc, const float* used, const float* req,
    const float* rw, const bool* pod_valid, const bool* node_valid2,
    const bool* schedulable, const bool* tolerates_unsched,
    const int* taint_ids, const signed char* taint_effect,
    const bool* tolerated, const bool* aff_ok2, const float* na_raw,
    const float* tt_count, const float* w_lr, const float* w_ba,
    const float* w_na, const float* w_tt, const float* w_ts,
    const float* w_ia, const float* norms, int kb, const int* topi,
    const float* topv, float* terms, void* stream);

// The per-pod tables' limits (tpusched_torch/limits.py holds copies):
// out [2] gets cell.cuh's MAX_R and pairwise.cuh's MAX_C. Host only.
int tpusched_shape_limits(int* out);

// K21 (kernels/queue.py _rank, rank_full, window_select). Ranks the [Q]
// pending table under (eligible first, priority desc, seq asc): prio [Q]
// gets every slot's effective priority, idx [n_out] the first n_out slots
// of the order, prio_out [n_out] (may be NULL) their priorities, counts
// [2] (zeroed by the caller) the eligible and valid slots. seq holds u32
// bits. keys_a and keys_b are [Qp] 16-byte scratch, Qp = next pow2(Q).
int tpusched_queue_rank(int Q, int Qp, int n_out, const bool* valid,
                        const float* base, const float* slo,
                        const float* submitted, const float* run,
                        const float* parked, const int* seq, float now,
                        double gain, float* prio, void* keys_a, void* keys_b,
                        int* counts, int* idx, float* prio_out, void* stream);

// K25 (ring.py ring_sig_counts, one hop). Adds into counts [sblk, N] the
// members of the resident block [mblk] (msat [A, mblk], mnode, mvalid,
// mns) matching each signature of the block (skey, satoms [sblk, AT], sns
// [sblk, NS], snsall, svalid), at their node's domain under the
// signature's key (ndom [N, TK]).
int tpusched_ring_hop(int A, int mblk, int sblk, int AT, int NS, int N,
                      int TK, const bool* msat, const int* mnode,
                      const bool* mvalid, const int* mns, const int* skey,
                      const int* satoms, const int* sns, const bool* snsall,
                      const bool* svalid, const int* ndom, float* counts,
                      void* stream);

// K26 (preempt.py _tableau_nv). The [C, N, V] victim-prefix tableaus of C
// bidders on the node-major victim table (vreq [N, V, R], vcost, vprio,
// vpdb, vvalid, vidx [N, V]): elig, wcost, wviol, fits [C, N, V] and the
// (violations, cost) minimum over each node's fitting prefixes,
// node_viol and node_cost [C, N]. Tenant axis on every array.
int tpusched_tableau_nv(int B, int C, int N, int V, int R, int M, int GP,
                        const float* vreq, const float* vcost,
                        const float* vprio, const int* vpdb,
                        const bool* vvalid, const int* vidx,
                        const bool* evicted, const float* p_prio,
                        const float* p_req, const float* used,
                        const float* alloc, const float* remaining,
                        float margin, bool* elig, float* wcost, int* wviol,
                        bool* fits, float* node_viol, float* node_cost,
                        void* stream);

#ifdef __cplusplus
}
#endif
