// K1: match-expression atom satisfaction over label sets.
//
// Replaces tpusched/kernels/atoms.py:29 atom_sat, which XLA evaluates as
// a broadcast [X, L, A, V] compare-reduce. Here one thread owns one
// (label set x, atom a) cell and loops over the L label slots and the V
// value ids, so the [X, L, A, V] tensor never exists.
//
// Bound: bytes. The inputs are the [X, L] pair/key/number rows and the
// small atom table; the output is X*A bools. Consecutive threads take
// consecutive atoms of one label set, so a warp reads one label row
// (broadcast) and writes a contiguous run of the output. At the headline
// (X = 5120 nodes, L = 4, A <= 8) the kernel is launch-latency bound.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): B independent label
// and atom tables, [B, X, L] and [B, A(, V)], give out [B, X, A] in one
// launch; the flattened cell index carries the tenant. A solo call is
// B = 1.
#include <math.h>

#include "kernels.h"

namespace {

constexpr int OP_IN = 0;
constexpr int OP_NOT_IN = 1;
constexpr int OP_EXISTS = 2;
constexpr int OP_DOES_NOT_EXIST = 3;
constexpr int OP_GT = 4;
constexpr int OP_LT = 5;

__global__ void atom_sat_kernel(const int* __restrict__ label_pairs,
                                const int* __restrict__ label_keys,
                                const float* __restrict__ label_nums,
                                int X, int L,
                                const int* __restrict__ atom_key,
                                const signed char* __restrict__ atom_op,
                                const int* __restrict__ atom_pairs,
                                const float* __restrict__ atom_num,
                                const bool* __restrict__ atom_valid,
                                int B, int A, int V, bool* __restrict__ out) {
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= (long long)B * X * A) return;
  // Tenant b's label rows and atom table; x indexes its label sets.
  const long long b = cell / ((long long)X * A);
  int x = (int)(cell / A % X);
  int a = (int)(cell % A);
  label_pairs += b * X * L;
  label_keys += b * X * L;
  if (label_nums != nullptr) label_nums += b * X * L;
  atom_key += b * A;
  atom_op += b * A;
  atom_pairs += b * A * V;
  atom_num += b * A;
  atom_valid += b * A;
  int key = atom_key[a];
  bool any_pair = false, exists = false, has_num = false;
  float val = 0.0f;
  for (int l = 0; l < L; ++l) {
    int lp = label_pairs[(long long)x * L + l];
    int lk = label_keys[(long long)x * L + l];
    for (int v = 0; v < V; ++v) {
      int pv = atom_pairs[(long long)a * V + v];
      any_pair |= (pv >= 0) && (lp == pv);
    }
    exists |= (lk == key) && (lk >= 0);
    if (label_nums != nullptr) {
      float num = label_nums[(long long)x * L + l];
      // jnp.sum(where(matched, nums, 0)) over L: at most one slot of a
      // label set carries the atom's key, so the order is immaterial.
      if (lk == key && isfinite(num)) {
        has_num = true;
        val = val + num;
      }
    }
  }
  bool gt = has_num && (val > atom_num[a]);
  bool lt = has_num && (val < atom_num[a]);
  // jnp.select precedence of atoms.py:54-60, default False.
  int op = atom_op[a];
  bool sat = false;
  if (op == OP_IN) sat = any_pair;
  else if (op == OP_NOT_IN) sat = !any_pair;
  else if (op == OP_EXISTS) sat = exists;
  else if (op == OP_DOES_NOT_EXIST) sat = !exists;
  else if (op == OP_GT) sat = gt;
  else if (op == OP_LT) sat = lt;
  out[cell] = sat && atom_valid[a];
}

}  // namespace

extern "C" const char* tpusched_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int tpusched_atom_sat(const int* label_pairs, const int* label_keys,
                                 const float* label_nums, int B, int X, int L,
                                 const int* atom_key,
                                 const signed char* atom_op,
                                 const int* atom_pairs, const float* atom_num,
                                 const bool* atom_valid, int A, int V,
                                 bool* out, void* stream) {
  long long cells = (long long)B * X * A;
  int threads = 256;
  unsigned blocks = (unsigned)((cells + threads - 1) / threads);
  atom_sat_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      label_pairs, label_keys, label_nums, X, L, atom_key, atom_op,
      atom_pairs, atom_num, atom_valid, B, A, V, out);
  return (int)cudaGetLastError();
}
