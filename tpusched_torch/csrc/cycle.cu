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
// Bound: bytes. A cell reads mask (1 byte) and the static score (4) and
// writes feasible (1) and the score (4); used/alloc ([N, R]) and the
// pod's row constants stay in L1/L2. At 10240 x 5120: 0.52 GB, 0.16 ms
// at 3.35 TB/s. One thread per cell; blockIdx.x is the row and y tiles
// the nodes, so a warp reads and writes 32 consecutive cells.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): B tenants' output rows
// stack to B * rows_n rows; output row i belongs to tenant i / rows_n,
// and `rows` holds that tenant's own pod indices. Its cells read the
// tenant's [B, P, N] mask and static rows, [B, P] weights, [B, P, R]
// requests and [B, N, R] allocatable and usage (rw is shared). A solo
// call is B = 1.
#include <math.h>

#include "cell.cuh"
#include "kernels.h"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
cycle_kernel(int rows_n, int P, int N, int R, const int* __restrict__ rows,
             const bool* __restrict__ pending, const bool* __restrict__ mask,
             const float* __restrict__ sscore,
             const float* __restrict__ alloc, const float* __restrict__ used,
             const float* __restrict__ req, const float* __restrict__ w_lr,
             const float* __restrict__ w_ba, const float* __restrict__ w_ts,
             const float* __restrict__ rw_g, const bool* __restrict__ pair_ok,
             const float* __restrict__ ts, const float* __restrict__ ia,
             const float* __restrict__ w_ia, int masked_out,
             bool* __restrict__ feasible, float* __restrict__ score,
             const bool* __restrict__ ia_ok, bool* __restrict__ relaxed) {
  const int i = blockIdx.x;
  const int n = blockIdx.y * THREADS + threadIdx.x;
  if (n >= N) return;
  // Tenant b's pod row q: every [B, P, ...] input is indexed at b * P + q.
  const long long b = i / rows_n;
  const long long q = b * P + (rows ? rows[i] : i % rows_n);
  used += b * N * R;
  alloc += b * N * R;
  tpusched::ResW w;
  tpusched::load_resw(w, rw_g, R);
  float rq[tpusched::MAX_R];
  for (int r = 0; r < R; ++r) rq[r] = req[q * R + r];
  const float* u = used + (long long)n * R;
  const float* a = alloc + (long long)n * R;
  bool ok = mask[q * N + n] && tpusched::cell_fits(u, a, rq, R);
  if (pending && !pending[i]) ok = false;
  const long long o = (long long)i * N + n;
  if (relaxed) relaxed[o] = ok && ia_ok[q * N + n];
  float s;
  if (pair_ok) {
    if (!pair_ok[q * N + n]) ok = false;
    s = tpusched::cell_dynamic(u, a, rq, R, w, w_lr[q], w_ba[q]);
    s = s + sscore[q * N + n];
    s = s + w_ts[q] * ts[q * N + n];
    s = s + w_ia[q] * ia[q * N + n];
  } else {
    s = tpusched::cell_score(u, a, rq, R, w, w_lr[q], w_ba[q],
                             sscore[q * N + n], w_ts[q]);
  }
  feasible[o] = ok;
  score[o] = masked_out && !ok ? -INFINITY : s;
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
                              const bool* ia_ok, bool* relaxed,
                              void* stream) {
  if (R > tpusched::MAX_R) return (int)cudaErrorInvalidValue;
  dim3 grid(B * rows_n, (N + THREADS - 1) / THREADS);
  cycle_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      rows_n, P, N, R, rows, pending, mask, sscore, alloc, used, req, w_lr, w_ba, w_ts,
      rw, pair_ok, ts, ia, w_ia, masked_out, feasible, score, ia_ok,
      relaxed);
  return (int)cudaGetLastError();
}
