// K5: the batched Filter + Score pass over a [rows, N] block of cells.
//
// Replaces tpusched/kernels/assign.py:265 batched_cycle (its
// no-signature branch), :1648 _cycle_nosig and :523 score_batch at S = 0:
//   feasible = mask & resource_fit(alloc, used, req)
//   score    = ((w_lr*LR + w_ba*BA) + static) + w_ts*100
// in cell.cuh's arithmetic (the same as K4's, without K4's `+ w_ia*0`).
// With `pending` the row is cut to pending pods (a fast round's
// `feasible &= pending[:, None]`); with masked_out = 1 the score output
// is `where(feasible, score, -inf)` (a fast round's `masked`), else the
// raw score of every cell (ScoreBatch).
//
// `rows` (optional) maps output row i to source pod rows[i]: the
// tranche views of the fast rounds read static.mask / static.score and
// the pod's requests and weights in place, not from gathered [C, N]
// copies. The result is the same either way.
//
// With pairwise signatures (S > 0, ScoreBatch) the wrapper passes K11's
// pair_ok, ts (normalised spread) and ia (normalised inter-pod) [P, N]
// rows, indexed like mask and static, and the cell is batched_cycle's
// (assign.py:300-305):
//   feasible = mask & fit & pair_ok
//   score    = (((w_lr*LR + w_ba*BA) + static) + w_ts*ts) + w_ia*ia
// (9 more bytes read per cell).
//
// The fast rounds with signatures also ask for the spread-relaxed
// feasibility (assign.py:306-307, `base_feasible & ia_ok`, cut to pending
// rows like `feasible`): with K11's ia_ok [P, N] given, the kernel writes
// relaxed = mask & fit & ia_ok (& pending) beside feasible (2 more bytes
// a cell).
//
// Tenant axis (tpusched/tenants.py:75 solve_many): B tenants' output rows
// stack to B * rows_n rows; output row i belongs to tenant i / rows_n,
// and `rows` holds that tenant's own pod indices. Its cells read the
// tenant's [B, P, N] mask and static rows, [B, P] weights, [B, P, R]
// requests and [B, N, R] allocatable and usage (rw is shared). A solo
// call is B = 1.
//
// Bound: bytes and operations alike. A cell reads mask (1 byte) and the
// static score (4) and writes feasible (1) and the score (4): at 10240 x
// 5120, 0.52 GB, 0.16 ms at 3.35 TB/s. Its arithmetic at R = 3 is nine
// IEEE divides and a square root (--fmad=false, no reciprocal in place
// of a divide) among ~150 f32 instructions: ~0.26 ms over 132 SMs.
//
// Design: a CTA covers a tile of `tr` rows x (threads * 4) nodes of one
// tenant, grid (node tiles, row tiles, B). Each thread owns 4 consecutive
// nodes. The tile's node state is read once, in coalesced loads staged
// through shared memory from the AoS [N, R] tables, and kept in registers
// for all its rows (used[r], alloc[r]). The tile rows' constants (pod
// index, requests, weights, pending) are staged in shared memory once,
// and ResW is built once a thread. R is a template parameter (1..8,
// dispatched at launch) and cell.cuh's functions run with RB = R, so
// their loops unroll to the exact R, the `r < R` guard folds away, every
// per-resource value is a register and nothing goes to local memory. A thread reads its 4 cells'
// mask and pair_ok as one 4-byte word, the static score, ts and ia as
// float4, and writes feasible and relaxed as one word and the score as a
// float4; a row whose base is not 4-cell aligned (N % 4 != 0) and the
// ragged edge take scalar accesses. Where the score output is masked, a
// row that is not pending and a thread whose 4 cells are all infeasible
// write -inf without the arithmetic (that is what the arithmetic would
// give them).
#include <stdint.h>
#include <math.h>

#include "cell.cuh"
#include "kernels.h"

namespace {

constexpr int VEC = 4;            // consecutive nodes a thread
constexpr int MAX_THREADS = 256;  // threads a CTA (the wrapper picks)
constexpr int MAX_TR = 32;        // rows a tile (the wrapper picks)
using tpusched::MAX_R;

// The tile rows' constants, staged once a CTA.
struct Rows {
  long long q[MAX_TR];            // source pod row, tenant offset included
  float rq[MAX_TR * MAX_R];
  float w_lr[MAX_TR], w_ba[MAX_TR], w_ts[MAX_TR], w_ia[MAX_TR];
  int live[MAX_TR];               // pending (or no pending given)
};

// 4 bytes of a bool row: one word where `vec`, else one byte a cell in
// [0, left).
__device__ __forceinline__ void load_flags(const unsigned char* p, bool vec,
                                           int left, bool (&f)[VEC]) {
  if (vec) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int c = 0; c < VEC; ++c) f[c] = (w >> (8 * c)) & 0xffu;
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) f[c] = c < left && p[c];
  }
}

__device__ __forceinline__ void load_vals(const float* p, bool vec, int left,
                                          float (&v)[VEC]) {
  if (vec) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) v[c] = c < left ? p[c] : 0.0f;
  }
}

__device__ __forceinline__ void store_flags(unsigned char* p, bool vec,
                                            int left, const bool (&f)[VEC]) {
  if (vec) {
    uint32_t w = 0;
#pragma unroll
    for (int c = 0; c < VEC; ++c) w |= (uint32_t)f[c] << (8 * c);
    *reinterpret_cast<uint32_t*>(p) = w;
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      if (c < left) p[c] = f[c];
  }
}

__device__ __forceinline__ void store_vals(float* p, bool vec, int left,
                                           const float (&v)[VEC]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      if (c < left) p[c] = v[c];
  }
}

// This thread's VEC nodes' values of one [N, R] table (tenant offset
// applied), staged through shared memory: the CTA reads its tile's
// tile_n * R floats in order, then each thread takes its own.
template <int R>
__device__ __forceinline__ void load_nodes(const float* src, int tile_n,
                                           float* stage, float (&v)[VEC][R]) {
  const int tid = threadIdx.x;
  for (int x = tid; x < tile_n * R; x += blockDim.x) stage[x] = src[x];
  __syncthreads();
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    const int j = tid * VEC + c;
#pragma unroll
    for (int r = 0; r < R; ++r) v[c][r] = j < tile_n ? stage[j * R + r] : 0.0f;
  }
  __syncthreads();
}

// At most 64 registers a thread for R <= 3 (8 CTAs of 128 threads an SM;
// nothing goes to local memory there), 128 past it.
template <int R, bool PAIR>
__global__ void __launch_bounds__(MAX_THREADS, R <= 3 ? 4 : 2)
cycle_kernel(int rows_n, int P, int N, int tr, const int* __restrict__ rows,
             const bool* __restrict__ pending,
             const unsigned char* __restrict__ mask,
             const float* __restrict__ sscore,
             const float* __restrict__ alloc, const float* __restrict__ used,
             const float* __restrict__ req, const float* __restrict__ w_lr,
             const float* __restrict__ w_ba, const float* __restrict__ w_ts,
             const float* __restrict__ rw_g,
             const unsigned char* __restrict__ pair_ok,
             const float* __restrict__ ts, const float* __restrict__ ia,
             const float* __restrict__ w_ia, int masked_out,
             unsigned char* __restrict__ feasible, float* __restrict__ score,
             const unsigned char* __restrict__ ia_ok,
             unsigned char* __restrict__ relaxed, int vec_ok) {
  extern __shared__ float stage[];
  __shared__ Rows s;
  const int tid = threadIdx.x;
  const long long b = blockIdx.z;
  const int n_base = blockIdx.x * blockDim.x * VEC;
  const int tile_n = min((int)blockDim.x * VEC, N - n_base);
  const int li0 = blockIdx.y * tr;
  const int nt = min(tr, rows_n - li0);
  if (tid < nt) {
    const long long gi = b * rows_n + li0 + tid;
    const long long q = b * P + (rows ? rows[gi] : li0 + tid);
    s.q[tid] = q;
#pragma unroll
    for (int r = 0; r < R; ++r) s.rq[tid * R + r] = req[q * R + r];
    s.w_lr[tid] = w_lr[q];
    s.w_ba[tid] = w_ba[q];
    s.w_ts[tid] = w_ts[q];
    s.w_ia[tid] = PAIR ? w_ia[q] : 0.0f;
    s.live[tid] = !pending || pending[gi];
  }
  float u[VEC][R], a[VEC][R];
  const long long node0 = (b * N + n_base) * R;
  load_nodes<R>(used + node0, tile_n, stage, u);
  load_nodes<R>(alloc + node0, tile_n, stage, a);
  tpusched::ResW w;
  tpusched::load_resw<R>(w, rw_g, R);
  const int j0 = tid * VEC;
  if (j0 >= tile_n) return;
  const int left = tile_n - j0;   // this thread's nodes, VEC or fewer
  const int n0 = n_base + j0;
  for (int t = 0; t < nt; ++t) {
    const long long q = s.q[t];
    const long long in = q * N + n0;
    const long long out = (b * rows_n + li0 + t) * N + n0;
    const bool vec = vec_ok && left >= VEC && ((in | out) & (VEC - 1)) == 0;
    const bool live = s.live[t];
    bool ok[VEC], ia_f[VEC];
    float sc[VEC];
    if (masked_out && !live) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        ok[c] = false;
        sc[c] = -INFINITY;
      }
      store_flags(feasible + out, vec, left, ok);
      store_vals(score + out, vec, left, sc);
      if (relaxed) store_flags(relaxed + out, vec, left, ok);
      continue;
    }
    float rq[R];
#pragma unroll
    for (int r = 0; r < R; ++r) rq[r] = s.rq[t * R + r];
    load_flags(mask + in, vec, left, ok);
    bool any = false;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      ok[c] = ok[c] && tpusched::cell_fits<R>(u[c], a[c], rq, R) && live;
      any = any || ok[c];
    }
    if (relaxed) {
      load_flags(ia_ok + in, vec, left, ia_f);
      bool rx[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) rx[c] = ok[c] && ia_f[c];
      store_flags(relaxed + out, vec, left, rx);
    }
    if (PAIR) {
      bool pk[VEC];
      load_flags(pair_ok + in, vec, left, pk);
      any = false;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        ok[c] = ok[c] && pk[c];
        any = any || ok[c];
      }
    }
    if (masked_out && !any) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) sc[c] = -INFINITY;
    } else {
      const float wl = s.w_lr[t], wb = s.w_ba[t], wt = s.w_ts[t];
      load_vals(sscore + in, vec, left, sc);
      float tsv[VEC], iav[VEC];
      if (PAIR) {
        load_vals(ts + in, vec, left, tsv);
        load_vals(ia + in, vec, left, iav);
      }
      const float wi = s.w_ia[t];
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        float v;
        if (PAIR) {
          v = tpusched::cell_dynamic<R>(u[c], a[c], rq, R, w, wl, wb);
          v = v + sc[c];
          v = v + wt * tsv[c];
          v = v + wi * iav[c];
        } else {
          v = tpusched::cell_score<R>(u[c], a[c], rq, R, w, wl, wb, sc[c],
                                      wt);
        }
        sc[c] = masked_out && !ok[c] ? -INFINITY : v;
      }
    }
    store_flags(feasible + out, vec, left, ok);
    store_vals(score + out, vec, left, sc);
  }
}

using CycleFn = void (*)(int, int, int, int, const int*, const bool*,
                         const unsigned char*, const float*, const float*,
                         const float*, const float*, const float*,
                         const float*, const float*, const float*,
                         const unsigned char*, const float*, const float*,
                         const float*, int, unsigned char*, float*,
                         const unsigned char*, unsigned char*, int);

template <bool PAIR>
CycleFn pick(int R) {
  switch (R) {
    case 1: return cycle_kernel<1, PAIR>;
    case 2: return cycle_kernel<2, PAIR>;
    case 3: return cycle_kernel<3, PAIR>;
    case 4: return cycle_kernel<4, PAIR>;
    case 5: return cycle_kernel<5, PAIR>;
    case 6: return cycle_kernel<6, PAIR>;
    case 7: return cycle_kernel<7, PAIR>;
    case 8: return cycle_kernel<8, PAIR>;
  }
  return nullptr;
}

bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

}  // namespace

extern "C" int tpusched_cycle(int B, int rows_n, int P, int N, int R,
                              const int* rows,
                              const bool* pending, const bool* mask,
                              const float* sscore, const float* alloc,
                              const float* used, const float* req,
                              const float* w_lr, const float* w_ba,
                              const float* w_ts, const float* rw,
                              const bool* pair_ok, const float* ts,
                              const float* ia, const float* w_ia,
                              int masked_out, bool* feasible, float* score,
                              const bool* ia_ok, bool* relaxed, int tr,
                              int threads, void* stream) {
  if (R < 1 || R > MAX_R || tr < 1 || tr > MAX_TR || threads < 32 ||
      threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const CycleFn fn = pair_ok ? pick<true>(R) : pick<false>(R);
  // The word and float4 accesses need every [.., N] table 16-byte aligned
  // at its base; each row's own alignment is checked in the kernel.
  const int vec_ok = aligned16(mask) && aligned16(sscore) &&
                     aligned16(feasible) && aligned16(score) &&
                     aligned16(pair_ok) && aligned16(ts) && aligned16(ia) &&
                     aligned16(ia_ok) && aligned16(relaxed);
  const int tile_nodes = threads * VEC;
  dim3 grid((N + tile_nodes - 1) / tile_nodes, (rows_n + tr - 1) / tr, B);
  const size_t smem = (size_t)tile_nodes * R * sizeof(float);
  fn<<<grid, threads, smem, (cudaStream_t)stream>>>(
      rows_n, P, N, tr, rows, pending,
      reinterpret_cast<const unsigned char*>(mask), sscore, alloc, used, req,
      w_lr, w_ba, w_ts, rw, reinterpret_cast<const unsigned char*>(pair_ok),
      ts, ia, w_ia, masked_out, reinterpret_cast<unsigned char*>(feasible),
      score, reinterpret_cast<const unsigned char*>(ia_ok),
      reinterpret_cast<unsigned char*>(relaxed), vec_ok);
  return (int)cudaGetLastError();
}
