// K2: the cell-local static tableau over all (pod, node) cells.
//
// Replaces tpusched/kernels/assign.py:110 _tableau_cells, i.e.
// filter.node_affinity_mask + filter.taint_mask + the cordon and validity
// masks, score.node_affinity_raw and score.taint_intolerable_count
// (with atoms.gather_term_sat inside). XLA builds these from [P, T, AT, N]
// and [P, N, TN] gathers; here each thread owns 4 consecutive nodes of a
// few pods and loops over the few terms, atoms and taints (sizes read
// from the shapes).
//
// Bound: bytes written. Each cell writes mask + aff_ok (1 byte each) and
// na_raw + tt_count (4 bytes each): 10 bytes a cell, 0.52 GB at
// 10240 x 5120, which the H100's 3.35 TB/s writes in 0.16 ms.
//
// Design. A CTA of 128 threads takes a tile of QPB node quads (4
// consecutive nodes a quad; QPB a power of two up to 128, fewer when N is
// small) by PB = (128 / QPB) x PODS_A_THREAD pods; a thread walks its
// quad through PODS_A_THREAD pods of the tile.
// - Node side, read once a tile: the tile's taint ids are staged in
//   shared memory transposed, [TN][4 x QPB], by one coalesced read of the
//   [N, TN] rows (read in place when they would not fit); node_valid and
//   node_schedulable are one 32-bit word of 4 nodes each, in registers;
//   node_sat_t is read as one word of 4 nodes an atom.
// - Pod side, read once a pod: each pod's taint verdicts, one byte a
//   taint id (0 nothing, 1 an untolerated NoSchedule / NoExecute taint,
//   2 an untolerated PreferNoSchedule one), are staged in shared memory
//   (computed in place when PB x VT would not fit); the term atoms, valid
//   flags and weights are warp-uniform loads of one pod.
// - Bools 4 at a time: a term's verdict for the quad is the bytewise AND
//   of its atoms' words (bool bytes are 0 or 1), the required verdict the
//   OR over valid terms, the mask the AND of the verdict, taint, validity
//   and cordon words.
// - Vector stores: mask and aff_ok as one 32-bit word of 4 cells, na_raw
//   and tt_count as one float4 each (128 and 512 contiguous bytes a warp).
//   With N not a multiple of 4, or an array not aligned for them, the
//   same kernel reads and writes byte and float at a time (VEC false).
// na_raw keeps the sum over the preferred terms in index order,
// raw + w * (ok ? 1 : 0), and the build keeps --fmad=false.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): blockIdx.z is the
// tenant. A cell reads only its own tenant's pod, node, label and taint
// rows ([B, P, ...], [B, N, ...], [B, A, N], [B, VT]) and writes
// [B, P, N]. A solo call is B = 1.
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int EFFECT_NO_SCHEDULE = 0;
constexpr int EFFECT_PREFER_NO_SCHEDULE = 1;
constexpr int EFFECT_NO_EXECUTE = 2;

constexpr int THREADS = 128;
constexpr int PODS_A_THREAD = 8;
constexpr int STAGE_BYTES = 16 * 1024;  // each staged table at most
constexpr unsigned ONES = 0x01010101u;  // 4 bools, all true

// The verdict byte of taint `tid` for a pod: 1 blocks, 2 counts.
__device__ __forceinline__ unsigned char taint_code(int eff, bool tol) {
  if (tol) return 0;
  if (eff == EFFECT_NO_SCHEDULE || eff == EFFECT_NO_EXECUTE) return 1;
  return eff == EFFECT_PREFER_NO_SCHEDULE ? 2 : 0;
}

// Bools p[n .. n+3] as one word (byte k = p[n + k]), 0 past N.
template <bool VEC>
__device__ __forceinline__ unsigned ld4(const bool* p, int n, int N) {
  if (VEC) return __ldg(reinterpret_cast<const unsigned*>(p + n));
  unsigned w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (n + k < N) w |= (unsigned)p[n + k] << (8 * k);
  return w;
}

// gather_term_sat for the quad at n: every listed atom of the term holds.
template <bool VEC>
__device__ __forceinline__ unsigned term_word(const bool* __restrict__ sat_t,
                                              const int* __restrict__ atoms,
                                              int AT, int N, int n) {
  unsigned w = ONES;
  for (int j = 0; j < AT; ++j) {
    const int a = atoms[j];
    if (a >= 0) w &= ld4<VEC>(sat_t + (long long)a * N, n, N);
  }
  return w;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
tableau_kernel(int P, int N, int A, int T, int AT, int PT, int TN, int VT,
               int QPB, int stage_taints, int stage_codes,
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
               bool* __restrict__ mask, bool* __restrict__ aff_ok_out,
               float* __restrict__ na_raw, float* __restrict__ tt_count) {
  extern __shared__ int smem[];
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

  const int tile_n = 4 * QPB;
  const int PL = THREADS / QPB;  // pod lanes
  const int PB = PL * PODS_A_THREAD;
  const int q = threadIdx.x % QPB, pl = threadIdx.x / QPB;
  const int n0 = blockIdx.x * tile_n;  // the tile's first node
  const int n = n0 + 4 * q;            // this thread's quad
  const bool live = n < N;
  int* s_taint = smem;                                   // [TN][tile_n]
  unsigned char* s_code = reinterpret_cast<unsigned char*>(
      smem + (stage_taints ? TN * tile_n : 0));          // [PB][VT]

  if (stage_taints) {
    const int cells = min(tile_n, N - n0) * TN;
    const int* src = taint_ids + (long long)n0 * TN;
    for (int e = threadIdx.x; e < cells; e += THREADS)
      s_taint[(e % TN) * tile_n + e / TN] = src[e];
  }
  const unsigned nvalid = live ? ld4<VEC>(node_valid, n, N) : 0;
  const unsigned nsched = live ? ld4<VEC>(node_schedulable, n, N) : 0;

  for (int p0 = blockIdx.y * PB; p0 < P; p0 += gridDim.y * PB) {
    if (stage_codes) {
      __syncthreads();  // the previous block's codes are read
      const int cells = min(PB, P - p0) * VT;
      for (int e = threadIdx.x; e < cells; e += THREADS) {
        const int v = e % VT;
        s_code[e] = taint_code(taint_effect[v],
                               tolerated[(long long)p0 * VT + e]);
      }
    }
    __syncthreads();  // staged taint ids (first block) and codes
    if (!live) continue;
    for (int i = 0; i < PODS_A_THREAD; ++i) {
      const int pb = pl + i * PL;
      const int p = p0 + pb;
      if (p >= P) break;

      // Required node affinity: OR over valid terms, AND within a term;
      // no valid term at all matches every node.
      bool has_req = false;
      unsigned any_term = 0;
      for (int t = 0; t < T; ++t) {
        if (!req_term_valid[(long long)p * T + t]) continue;
        has_req = true;
        any_term |= term_word<VEC>(
            node_sat_t, req_term_atoms + ((long long)p * T + t) * AT, AT, N,
            n);
      }
      const unsigned aff = has_req ? any_term : ONES;

      // Taints: every NoSchedule/NoExecute taint tolerated; count the
      // intolerable PreferNoSchedule ones.
      unsigned taint_ok = ONES;
      float count[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < TN; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!VEC && n + k >= N) continue;
          // Taint id of slot j at node k of the quad.
          const int tid = stage_taints
                              ? s_taint[j * tile_n + 4 * q + k]
                              : taint_ids[(long long)(n + k) * TN + j];
          if (tid < 0) continue;
          const unsigned char c =
              stage_codes ? s_code[pb * VT + tid]
                          : taint_code(taint_effect[tid],
                                       tolerated[(long long)p * VT + tid]);
          if (c == 1) taint_ok &= ~(0xffu << (8 * k));
          if (c == 2) count[k] = count[k] + 1.0f;
        }
      }

      // Preferred affinity: weights of satisfied valid terms, summed over
      // the terms in index order.
      float raw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int t = 0; t < PT; ++t) {
        const long long pt = (long long)p * PT + t;
        const unsigned ok =
            pref_term_valid[pt]
                ? term_word<VEC>(node_sat_t, pref_term_atoms + pt * AT, AT,
                                 N, n)
                : 0u;
        const float w = pref_weight[pt];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          raw[k] = raw[k] + w * (((ok >> (8 * k)) & 1u) ? 1.0f : 0.0f);
      }

      const unsigned cordon = nsched | (tolerates_unsched[p] ? ONES : 0u);
      const unsigned m =
          aff & taint_ok & nvalid & cordon & (pod_valid[p] ? ONES : 0u);
      const long long cell = (long long)p * N + n;
      if (VEC) {
        *reinterpret_cast<unsigned*>(mask + cell) = m;
        *reinterpret_cast<unsigned*>(aff_ok_out + cell) = aff;
        *reinterpret_cast<float4*>(na_raw + cell) =
            make_float4(raw[0], raw[1], raw[2], raw[3]);
        *reinterpret_cast<float4*>(tt_count + cell) =
            make_float4(count[0], count[1], count[2], count[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (n + k >= N) break;
          mask[cell + k] = (m >> (8 * k)) & 1u;
          aff_ok_out[cell + k] = (aff >> (8 * k)) & 1u;
          na_raw[cell + k] = raw[k];
          tt_count[cell + k] = count[k];
        }
      }
    }
  }
}

bool aligned(const void* p, uintptr_t to) {
  return ((uintptr_t)p & (to - 1)) == 0;
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
  // Node quads a CTA: 128, or the power of two at or above N's quads.
  const int quads = (N + 3) / 4;
  int QPB = 1;
  while (QPB < THREADS && QPB < quads) QPB <<= 1;
  const int tile_n = 4 * QPB;
  const int PB = THREADS / QPB * PODS_A_THREAD;
  const int stage_taints = (long long)TN * tile_n * 4 <= STAGE_BYTES;
  const int stage_codes = (long long)PB * VT <= STAGE_BYTES;
  const size_t dyn = (stage_taints ? (size_t)TN * tile_n * 4 : 0) +
                     (stage_codes ? (size_t)PB * VT : 0);
  const bool vec = N % 4 == 0 && aligned(node_sat_t, 4) &&
                   aligned(node_valid, 4) && aligned(node_schedulable, 4) &&
                   aligned(mask, 4) && aligned(aff_ok, 4) &&
                   aligned(na_raw, 16) && aligned(tt_count, 16);
  // Pod blocks beyond the 65535 grid.y limit loop inside the kernel.
  const int pblocks = (P + PB - 1) / PB;
  dim3 grid((quads + QPB - 1) / QPB, pblocks < 65535 ? pblocks : 65535, B);
  cudaStream_t st = (cudaStream_t)stream;
#define TABLEAU_ARGS                                                       \
  P, N, A, T, AT, PT, TN, VT, QPB, stage_taints, stage_codes, node_sat_t,  \
      req_term_atoms, req_term_valid, pref_term_atoms, pref_term_valid,    \
      pref_weight, taint_ids, taint_effect, tolerated, node_schedulable,   \
      node_valid, tolerates_unsched, pod_valid, mask, aff_ok, na_raw,      \
      tt_count
  if (vec)
    tableau_kernel<true><<<grid, THREADS, dyn, st>>>(TABLEAU_ARGS);
  else
    tableau_kernel<false><<<grid, THREADS, dyn, st>>>(TABLEAU_ARGS);
#undef TABLEAU_ARGS
  return (int)cudaGetLastError();
}
