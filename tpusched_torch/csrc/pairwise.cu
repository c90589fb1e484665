// K9 sig_match, K10 pair_counts and K11 pairwise_batch: the pairwise
// (topology spread + inter-pod affinity) kernels of ScoreBatch and of the
// parity solve's set-up.
//
// K9 replaces tpusched/kernels/pairwise.py:85 sig_member_match (with :71
// ns_scope_ok and the atoms.gather_term_sat it calls): one thread per
// (signature s, member x), AND over the selector's atoms (an atom-less
// selector matches everyone), OR over the namespace list or ns_all, AND
// sigs.valid. Bound: bytes, [A, M+P] bool in and [S, M+P] bool out.
//
// K10 replaces :145 pair_state_init (:110 sig_counts, :127
// _anti_counts_running) and, given an assignment, :269 pair_state_seed:
// one thread per member scatters its 0/1 contributions with atomicAdd
// into counts [S, N], anti [S, N] and match_tot [S], which the wrapper
// zeroes. Every contribution is 1.0f and every count stays far below 2^24
// (a cluster has fewer members than that), so each partial sum is an
// exact integer and the result does not depend on the order of the
// atomics. Bound: latency of the atomics to a few hot addresses (S is
// small); the bytes are tiny.
//
// K11 replaces :342 pairwise_from_counts (exclude_self_node=None, the
// ScoreBatch call at tpusched/kernels/assign.py:265 batched_cycle) with
// :303 symmetric_anti_block and the two normalisers of
// tpusched/kernels/score.py:118,131: one CTA per pod row. The row's
// spread minima and maxima come from pairwise.cuh's row_spread_extents
// (one walk over the row for every four of the pod's C <= 16 slots, one
// barrier for all the slots). The cells are pairwise.cuh's pair_cells,
// four a thread at a time (the pod's terms read once for the four, their
// domain and count loads in flight together); their raw spread penalty and
// inter-pod score are held in shared memory until the row's extents are
// known, so each output cell is written once, coalesced. Outputs:
// pair_ok [P, N] bool, the normalised spread and inter-pod scores [P, N]
// f32, which K5 (cycle.cu) then takes in place of its constants 100 and
// 0. Bound: bytes, 9 written per cell plus aff_ok read (0.52 GB at
// 10240 x 5120: 0.16 ms at 3.35 TB/s); the counts, domains and the
// match column stay in L1/L2. The fast rounds also ask for ia_ok alone
// ([P, N] bool, the inter-pod and symmetric verdict without the spread
// filter; tpusched/kernels/assign.py:306-307), which K5 turns into the
// spread-relaxed feasibility: 1 byte more written per cell.
//
// K10's commit entry point (pair_commit) replaces :174 pair_state_commit:
// one thread per pod row of the (possibly compacted) view; a committed pod
// adds sign = +1 or -1 at each signature it matches (match_tot, and counts
// at its node's domain) and at each required anti term it holds (anti),
// into the state it is given (the wrapper makes no copy: the caller hands
// the state over). The lanes of a warp that add at one address are grouped
// first (__match_any_sync) and one lane adds their count, so a round's
// thousands of commits onto S match_tot cells and a few zone domains cost
// one atomic a warp and address, not one a pod. Exact like K10: every add
// is an integer (+-1.0f times at most 32) on an integer below 2^24, so the
// sums are the plain version's in any order. Bound: bytes, [S, P] bool and
// the pods' terms read once (~0.15 us at 10 240 pods, S = 4); what costs is
// the launch and the atomics' latency.
//
// K14 ia_at_choice replaces :434 ia_ok_at_choice: one thread per pod row,
// the required inter-pod terms at the chosen node with the pod's own
// contribution left out where it sits on esn[p], then the symmetric
// anti-affinity column at that node as an int32 sum over signatures of
// match * (int)anti, less the pod's own held terms. It equals
// pairwise_from_counts(exclude_self_node = esn)'s ia_ok at the chosen
// column (the plain versions are held to that on the CPU). Bound: bytes,
// O(S * P) gathers (~0.2 MB at 10240 pods, S = 4).
//
// Tenant axis (tpusched/tenants.py:75 solve_many, whose jax.vmap gives
// each of these functions a leading [B] axis): every entry point takes B
// first and every array gains a leading [B] axis. K9 runs one thread per
// (tenant, signature, member); K10, K10's commit and K14 take the tenant
// from blockIdx.y, K11 runs one CTA per (pod row, tenant). Each tenant's
// atomics land in its own [S, N] and [S] slices, so nothing is added
// across tenants and every count stays the exact integer it was. A solo
// call passes B = 1.
#include <math.h>

#include "kernels.h"
#include "pairwise.cuh"

namespace {

using tpusched::PairTerms;

__global__ void sig_match_kernel(int B, int A, int S, int X, int AT, int NS,
                                 const bool* __restrict__ sat_t,
                                 const int* __restrict__ atoms,
                                 const int* __restrict__ ns,
                                 const bool* __restrict__ ns_all,
                                 const bool* __restrict__ valid,
                                 const int* __restrict__ member_ns,
                                 bool* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long SX = (long long)S * X;
  if (i >= B * SX) return;
  const long long b = i / SX;
  const int s = (int)((i % SX) / X), x = (int)(i % X);
  sat_t += b * A * X;
  atoms += b * S * AT;
  ns += b * S * NS;
  ns_all += b * S;
  valid += b * S;
  member_ns += b * X;
  bool m = valid[s];
  for (int k = 0; k < AT && m; ++k) {
    const int a = atoms[s * AT + k];
    if (a >= 0) m = sat_t[(long long)a * X + x];
  }
  if (m && !ns_all[s]) {
    bool in = false;
    const int mns = member_ns[x];
    for (int k = 0; k < NS; ++k) in = in || ns[s * NS + k] == mns;
    m = in;
  }
  out[i] = m;
}

__global__ void pair_counts_kernel(int S, int N, int M, int P, int J, int IT,
                                   const bool* __restrict__ match,
                                   const int* __restrict__ dom,
                                   const int* __restrict__ run_node,
                                   const bool* __restrict__ run_valid,
                                   const int* __restrict__ run_anti_sig,
                                   const int* __restrict__ ia_sig,
                                   const bool* __restrict__ ia_valid,
                                   const bool* __restrict__ ia_anti,
                                   const bool* __restrict__ ia_required,
                                   const int* __restrict__ assigned,
                                   float* counts, float* anti,
                                   float* match_tot) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int X = M + P;
  if (x >= X) return;
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y;
    match += b * S * X;
    dom += b * S * N;
    run_node += b * M;
    run_valid += b * M;
    run_anti_sig += b * M * J;
    ia_sig += b * P * IT;
    ia_valid += b * P * IT;
    ia_anti += b * P * IT;
    ia_required += b * P * IT;
    if (assigned) assigned += b * P;
    if (counts) counts += b * S * N;
    anti += b * S * N;
    match_tot += b * S;
  }
  const bool running = x < M;
  const int node = running ? run_node[x] : (assigned ? assigned[x - M] : -1);
  const bool live = running ? run_valid[x] : node >= 0;
  if (!live) return;
  const long long nc = max(node, 0);
  for (int s = 0; s < S; ++s) {
    if (!match[(long long)s * X + x]) continue;
    atomicAdd(&match_tot[s], 1.0f);
    if (!counts) continue;  // the ring's counts stand in for these
    const int d = dom[(long long)s * N + nc];
    if (d >= 0) atomicAdd(&counts[(long long)s * N + d], 1.0f);
  }
  if (running) {
    if (node < 0) return;
    for (int j = 0; j < J; ++j) {
      const int s = run_anti_sig[(long long)x * J + j];
      if (s < 0) continue;
      const int d = dom[(long long)s * N + nc];
      if (d >= 0) atomicAdd(&anti[(long long)s * N + d], 1.0f);
    }
  } else {
    const long long p = x - M;
    for (int t = 0; t < IT; ++t) {
      const long long pt = p * IT + t;
      if (!(ia_valid[pt] && ia_anti[pt] && ia_required[pt])) continue;
      const int s = max(ia_sig[pt], 0);
      const int d = dom[(long long)s * N + nc];
      if (d >= 0) atomicAdd(&anti[(long long)s * N + d], 1.0f);
    }
  }
}

constexpr int BATCH_THREADS = 256;  // a row a CTA
constexpr int BATCH_WARPS = BATCH_THREADS / 32;
constexpr unsigned BATCH_FULL = 0xffffffffu;
// The row's raw spread penalties and inter-pod scores stay in shared
// memory (8 bytes a node) up to this many bytes; a wider row keeps them in
// its output rows, which it then rereads.
constexpr int BATCH_SMEM_LIMIT = 192 * 1024;

// The four extents of the normalisers (min and max of the raw penalties
// and scores over valid nodes) over the CTA: a shuffle pass, each warp's
// into s_part, a barrier, warp 0's reduction of the partials into s_norm,
// and a barrier.
__device__ __forceinline__ void row_norm_extents(float4& e, float* s_part,
                                                 float4* s_norm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto fold = [&](int off) {
    e.x = fminf(e.x, __shfl_xor_sync(BATCH_FULL, e.x, off));
    e.y = fmaxf(e.y, __shfl_xor_sync(BATCH_FULL, e.y, off));
    e.z = fminf(e.z, __shfl_xor_sync(BATCH_FULL, e.z, off));
    e.w = fmaxf(e.w, __shfl_xor_sync(BATCH_FULL, e.w, off));
  };
  for (int off = 16; off > 0; off >>= 1) fold(off);
  if (lane == 0) reinterpret_cast<float4*>(s_part)[warp] = e;
  __syncthreads();
  if (warp == 0) {
    e = lane < BATCH_WARPS ? reinterpret_cast<const float4*>(s_part)[lane]
                      : make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
    for (int off = 16; off > 0; off >>= 1) fold(off);
    if (lane == 0) *s_norm = e;
  }
  __syncthreads();
  e = *s_norm;
}

constexpr int BATCH_KB = 4;  // cells a thread evaluates together

// One row: the spread extents, then the cells, BATCH_KB a thread at a
// time (pair_cells), each cell's flags written and its raw spread penalty
// and inter-pod score held until the row's normaliser extents are known,
// then the normalised scores written: the raw cells are held in shared
// memory (`staged`, [2, N]) or, for a row wider than that, in the output
// rows themselves, which are then reread. (Held in registers, the row
// cost more than it saved: 110 registers a thread at N = 5 120.)
__global__ void __launch_bounds__(BATCH_THREADS)
pairwise_batch_kernel(PairTerms t, int P, bool staged,
                      const float* __restrict__ counts,
                      const float* __restrict__ anti,
                      const float* __restrict__ match_tot,
                      bool* __restrict__ pair_ok, float* __restrict__ ts_out,
                      float* __restrict__ ia_out, bool* __restrict__ ia_ok) {
  constexpr int T = BATCH_THREADS;
  extern __shared__ float batch_row[];  // [2, N] when staged
  __shared__ __align__(16) float s_part[BATCH_WARPS * 2 * tpusched::MAX_C];
  __shared__ float s_ext[2 * tpusched::MAX_C];
  __shared__ float4 s_norm;
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;  // the tenant
  t = tpusched::tenant_terms(t, b);
  counts += b * t.S * t.N;
  anti += b * t.S * t.N;
  match_tot += b * t.S;
  const long long row = (b * P + p) * t.N;
  tpusched::row_spread_extents<T>(t, counts, p, s_part, s_ext);
  float* pen_buf = staged ? batch_row : ts_out + row;
  float* raw_buf = staged ? batch_row + t.N : ia_out + row;
  float4 e = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  // This thread's cells n = tid + k * T, BATCH_KB at a time: flags
  // written, (pen, raw) held, the extents grown.
  const int mine = (t.N - tid + T - 1) / T;
  for (int k0 = 0; k0 < mine; k0 += BATCH_KB) {
    int n[BATCH_KB];
    unsigned live = 0u;
#pragma unroll
    for (int k = 0; k < BATCH_KB; ++k) {
      n[k] = tid + (k0 + k) * T;
      if (n[k] < t.N) live |= 1u << k;
    }
    float pen[BATCH_KB], raw[BATCH_KB];
    unsigned spm, iam;
    tpusched::pair_cells<BATCH_KB>(t, counts, anti, match_tot, p, n, live,
                                   s_ext, s_ext + tpusched::MAX_C, pen, raw,
                                   spm, iam);
#pragma unroll
    for (int k = 0; k < BATCH_KB; ++k) {
      if (!((live >> k) & 1u)) continue;
      pair_ok[row + n[k]] = (spm & iam) >> k & 1u;
      if (ia_ok) ia_ok[row + n[k]] = (iam >> k) & 1u;
      pen_buf[n[k]] = pen[k];
      raw_buf[n[k]] = raw[k];
      if (t.node_valid[n[k]]) {
        e.x = fminf(e.x, pen[k]);
        e.y = fmaxf(e.y, pen[k]);
        e.z = fminf(e.z, raw[k]);
        e.w = fmaxf(e.w, raw[k]);
      }
    }
  }
  row_norm_extents(e, s_part, &s_norm);
  // Each thread rereads only the cells it held above.
  for (int n = tid; n < t.N; n += T) {
    ts_out[row + n] = tpusched::inverse_norm(pen_buf[n], e.x, e.y);
    ia_out[row + n] = tpusched::minmax_norm(raw_buf[n], e.z, e.w);
  }
}

// One atomic add of sign x (the warp's lanes that add at this address) for
// each distinct address among the lanes with `on`: lanes are grouped by
// address (__match_any_sync) and each group's lowest lane adds the group's
// count. Every lane of the warp calls it.
__device__ __forceinline__ void warp_grouped_add(float* base, long long addr,
                                                 bool on, float sign) {
  const unsigned live = __ballot_sync(0xffffffffu, on);
  if (!on) return;
  const unsigned group = __match_any_sync(live, (unsigned long long)addr);
  if ((int)(threadIdx.x & 31) == __ffs(group) - 1)
    atomicAdd(base + addr, sign * (float)__popc(group));
}

__global__ void pair_commit_kernel(int S, int N, int M, int P, int IT,
                                   const bool* __restrict__ match,
                                   const int* __restrict__ dom,
                                   const int* __restrict__ ia_sig,
                                   const bool* __restrict__ ia_valid,
                                   const bool* __restrict__ ia_anti,
                                   const bool* __restrict__ ia_required,
                                   const int* __restrict__ choice,
                                   const bool* __restrict__ commit,
                                   float sign, float* counts, float* anti,
                                   float* match_tot) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const long long X = M + P;
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y;
    match += b * S * X;
    dom += b * S * N;
    ia_sig += b * P * IT;
    ia_valid += b * P * IT;
    ia_anti += b * P * IT;
    ia_required += b * P * IT;
    choice += b * P;
    commit += b * P;
    counts += b * S * N;
    anti += b * S * N;
    match_tot += b * S;
  }
  // Every lane stays to the end: the adds are grouped across the warp.
  const bool live = p < P && commit[p];
  const long long nc = live ? max(choice[p], 0) : 0;
  for (int s = 0; s < S; ++s) {
    const bool m = live && match[s * X + M + p];
    const int d = m ? dom[s * (long long)N + nc] : -1;
    warp_grouped_add(match_tot, s, m, sign);
    warp_grouped_add(counts, s * (long long)N + d, d >= 0, sign);
  }
  for (int t = 0; t < IT; ++t) {
    const long long pt = (long long)p * IT + t;
    const bool hold =
        live && ia_valid[pt] && ia_anti[pt] && ia_required[pt];
    const int s = hold ? max(ia_sig[pt], 0) : 0;
    const int d = hold ? dom[s * (long long)N + nc] : -1;
    warp_grouped_add(anti, s * (long long)N + d, d >= 0, sign);
  }
}

__global__ void ia_at_choice_kernel(int P, int N, int S, int IT, int M,
                                    const int* __restrict__ dom,
                                    const bool* __restrict__ match,
                                    const int* __restrict__ ia_sig,
                                    const bool* __restrict__ ia_valid,
                                    const bool* __restrict__ ia_anti,
                                    const bool* __restrict__ ia_required,
                                    const float* __restrict__ counts,
                                    const float* __restrict__ anti,
                                    const float* __restrict__ match_tot,
                                    const int* __restrict__ choice,
                                    const int* __restrict__ esn,
                                    bool* __restrict__ ok_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const long long X = M + P;
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y;
    dom += b * S * N;
    match += b * S * X;
    ia_sig += b * P * IT;
    ia_valid += b * P * IT;
    ia_anti += b * P * IT;
    ia_required += b * P * IT;
    if (counts) counts += b * S * N;
    anti += b * S * N;
    match_tot += b * S;
    choice += b * P;
    esn += b * P;
    ok_out += b * P;
  }
  const long long ch = max(choice[p], 0);
  const int e = esn[p];
  const long long ec = max(e, 0);
  bool ok = true;
  int own = 0;  // the pod's own held anti terms in its chosen domain
  for (int t = 0; t < IT; ++t) {
    const long long pt = (long long)p * IT + t;
    const int s = max(ia_sig[pt], 0);
    const int d = dom[s * (long long)N + ch];
    const bool self = match[s * X + M + p];
    const bool committed = self && e >= 0;
    const int own_dom = dom[s * (long long)N + ec];
    const bool active = committed && own_dom >= 0 && d == own_dom;
    const float nc = counts[s * (long long)N + max(d, 0)]
                     - (active ? 1.0f : 0.0f);
    const bool hk = d >= 0;
    const bool node_has = hk && nc > 0.0f;
    const bool all_zero = match_tot[s] - (committed ? 1.0f : 0.0f) <= 0.0f;
    const bool pos_ok = node_has || (all_zero && self && hk);
    const bool ok_t = ia_anti[pt] ? !node_has : pos_ok;
    if (ia_valid[pt] && ia_required[pt]) ok = ok && ok_t;
    if (ia_valid[pt] && ia_anti[pt] && ia_required[pt] && active) own += 1;
  }
  int blocked = 0;
  for (int s = 0; s < S; ++s) {
    if (!match[s * X + M + p]) continue;
    const int d = dom[s * (long long)N + ch];
    if (d >= 0) blocked += (int)anti[s * (long long)N + d];
  }
  ok_out[p] = ok && !(blocked - own > 0);
}

}  // namespace

extern "C" int tpusched_sig_match(int B, int A, int S, int X, int AT, int NS,
                                  const bool* member_sat_t, const int* atoms,
                                  const int* ns, const bool* ns_all,
                                  const bool* valid, const int* member_ns,
                                  bool* out, void* stream) {
  const long long total = (long long)B * S * X;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  sig_match_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      B, A, S, X, AT, NS, member_sat_t, atoms, ns, ns_all, valid, member_ns,
      out);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_pair_counts(int B, int S, int N, int M, int P, int J,
                                    int IT,
                                    const bool* match, const int* dom,
                                    const int* run_node,
                                    const bool* run_valid,
                                    const int* run_anti_sig,
                                    const int* ia_sig, const bool* ia_valid,
                                    const bool* ia_anti,
                                    const bool* ia_required,
                                    const int* assigned, float* counts,
                                    float* anti, float* match_tot,
                                    void* stream) {
  const int threads = 256;
  const dim3 blocks((M + P + threads - 1) / threads, B);
  pair_counts_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      S, N, M, P, J, IT, match, dom, run_node, run_valid, run_anti_sig,
      ia_sig, ia_valid, ia_anti, ia_required, assigned, counts, anti,
      match_tot);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_pairwise_batch(
    int B, int P, int N, int S, int C, int IT, int M, const int* dom,
    const bool* match, const bool* node_valid, const bool* aff_ok,
    const int* ts_sig, const bool* ts_valid, const signed char* ts_when,
    const float* ts_max_skew, const int* ia_sig, const bool* ia_valid,
    const bool* ia_anti, const bool* ia_required, const float* ia_weight,
    const float* counts, const float* anti, const float* match_tot,
    bool* pair_ok, float* ts_score, float* ia_score, bool* ia_ok,
    void* stream) {
  if (C > tpusched::MAX_C) return (int)cudaErrorInvalidValue;
  PairTerms t{N,      S,          C,        IT,          M + P,   M,
              dom,    match,      node_valid, aff_ok,    ts_sig,  ts_valid,
              ts_when, ts_max_skew, ia_sig, ia_valid,    ia_anti, ia_required,
              ia_weight};
  const long long row_bytes = 8LL * N;
  const bool staged = row_bytes <= BATCH_SMEM_LIMIT;
  const size_t dyn = staged ? (size_t)row_bytes : 0;
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairwise_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  pairwise_batch_kernel<<<dim3(P, B), BATCH_THREADS, dyn,
                          (cudaStream_t)stream>>>(
      t, P, staged, counts, anti, match_tot, pair_ok, ts_score, ia_score,
      ia_ok);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_pair_commit(int B, int S, int N, int M, int P, int IT,
                                    const bool* match, const int* dom,
                                    const int* ia_sig, const bool* ia_valid,
                                    const bool* ia_anti,
                                    const bool* ia_required,
                                    const int* choice, const bool* commit,
                                    int sign, float* counts, float* anti,
                                    float* match_tot, void* stream) {
  const int threads = 256;
  pair_commit_kernel<<<dim3((P + threads - 1) / threads, B), threads, 0,
                       (cudaStream_t)stream>>>(
      S, N, M, P, IT, match, dom, ia_sig, ia_valid, ia_anti, ia_required,
      choice, commit, (float)sign, counts, anti, match_tot);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_ia_at_choice(int B, int P, int N, int S, int IT,
                                     int M,
                                     const int* dom, const bool* match,
                                     const int* ia_sig, const bool* ia_valid,
                                     const bool* ia_anti,
                                     const bool* ia_required,
                                     const float* counts, const float* anti,
                                     const float* match_tot,
                                     const int* choice, const int* esn,
                                     bool* ok, void* stream) {
  const int threads = 256;
  ia_at_choice_kernel<<<dim3((P + threads - 1) / threads, B), threads, 0,
                        (cudaStream_t)stream>>>(
      P, N, S, IT, M, dom, match, ia_sig, ia_valid, ia_anti, ia_required,
      counts, anti, match_tot, choice, esn, ok);
  return (int)cudaGetLastError();
}
