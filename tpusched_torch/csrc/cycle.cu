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
// Bound: bytes. A cell reads mask (1 byte) and the static score (4) and
// writes feasible (1) and the score (4); used/alloc ([N, R]) and the
// pod's row constants stay in L1/L2. At 10240 x 5120: 0.52 GB, 0.16 ms
// at 3.35 TB/s. One thread per cell; blockIdx.x is the row and y tiles
// the nodes, so a warp reads and writes 32 consecutive cells.
#include <math.h>

#include "cell.cuh"
#include "kernels.h"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
cycle_kernel(int N, int R, const int* __restrict__ rows,
             const bool* __restrict__ pending, const bool* __restrict__ mask,
             const float* __restrict__ sscore,
             const float* __restrict__ alloc, const float* __restrict__ used,
             const float* __restrict__ req, const float* __restrict__ w_lr,
             const float* __restrict__ w_ba, const float* __restrict__ w_ts,
             const float* __restrict__ rw_g, int masked_out,
             bool* __restrict__ feasible, float* __restrict__ score) {
  const int i = blockIdx.x;
  const int n = blockIdx.y * THREADS + threadIdx.x;
  if (n >= N) return;
  const long long q = rows ? rows[i] : i;
  tpusched::ResW w;
  tpusched::load_resw(w, rw_g, R);
  float rq[tpusched::MAX_R];
  for (int r = 0; r < R; ++r) rq[r] = req[q * R + r];
  const float* u = used + (long long)n * R;
  const float* a = alloc + (long long)n * R;
  bool ok = mask[q * N + n] && tpusched::cell_fits(u, a, rq, R);
  if (pending && !pending[i]) ok = false;
  float s = tpusched::cell_score(u, a, rq, R, w, w_lr[q], w_ba[q],
                                 sscore[q * N + n], w_ts[q]);
  const long long o = (long long)i * N + n;
  feasible[o] = ok;
  score[o] = masked_out && !ok ? -INFINITY : s;
}

}  // namespace

extern "C" int tpusched_cycle(int rows_n, int N, int R, const int* rows,
                              const bool* pending, const bool* mask,
                              const float* sscore, const float* alloc,
                              const float* used, const float* req,
                              const float* w_lr, const float* w_ba,
                              const float* w_ts, const float* rw,
                              int masked_out, bool* feasible, float* score,
                              void* stream) {
  if (R > tpusched::MAX_R) return (int)cudaErrorInvalidValue;
  dim3 grid(rows_n, (N + THREADS - 1) / THREADS);
  cycle_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      N, R, rows, pending, mask, sscore, alloc, used, req, w_lr, w_ba, w_ts,
      rw, masked_out, feasible, score);
  return (int)cudaGetLastError();
}
