// K13: the DoNotSchedule spread validator of the fast rounds, three
// entry points that serve every spread slot of a call at once.
//
// Replaces tpusched/kernels/assign.py:1093 _spread_excess_mask, which for
// each spread slot c reverts the kept members of each (signature, domain)
// group beyond the longest rank-ordered prefix whose size respects every
// prefix member's skew allowance against the end-of-round counts.
//
// excess_keys: the per-signature key table key[s, n] = counts[s, dom[s,
// n]] where node n is valid and has the key, +inf elsewhere (:1113-1117,
// with the node_valid test of :1127 folded in). [S, N] f32, one thread an
// entry. It takes the dom row, node_valid and the dependent counts
// gather out of the [P, N] pass.
//
// excess_min: the [P, N] pass (:1127-1134) and each slot's per-pod steps
// (:1120-1146). One warp a pod row, WARPS rows a CTA. The aff_ok row is
// read once for all C slots, in 16-byte vector loads (16 nodes a lane,
// streamed past L1) where N % 16 == 0 and the rows are aligned, a byte a
// lane otherwise; the slots' key rows are read as float4s through L1 (the
// table is S * N * 4 bytes, 80 KB at S = 4). The min over nodes is exact
// in any order (warp shuffles at the end). Then lane c of the warp takes
// slot c: member, T = min_end + maxSkew, cnt_total, the sort key (gid <<
// 32) + rank (gid = the (signature, domain) cell of a member, S * N for
// the rest), and an integer atomic count of each group's members (JAX's
// g_tab: exact in any order). Bound: bytes, aff_ok [P, N] read once (52
// MB at 10240 x 5120, 0.016 ms at 3.35 TB/s).
//
// excess_survive / excess_walk: after the caller's torch.sort of each
// slot's keys, the group walk (:1147-1172): per group the running member
// count q (1-based) and the running minimum of the members' allowances T;
// a member survives iff b_fixed + q <= that minimum, else bad. One warp
// takes the groups that start among 32 sorted rows and walks each, 32
// rows a step: a prefix-min of T by shuffles, q from a ballot's popcount,
// the carry in lane 31. Both are exact, so the plain version's log-step
// segmented scan gives the same bits. excess_walk reads the gid from the
// sorted key and b_fixed = cnt_total - the group's count, and ORs every
// slot into one bad row (only true is stored; the wrapper zeroes it);
// excess_survive takes the older form (gid_s, perm, member, T, b_fixed),
// one slot. The non-member group (gid S * N) is not walked.
//
// Tenant axis (tpusched/tenants.py:75 solve_many): every entry point
// takes B first and every array gains a leading [B] axis; the last grid
// dimension is the tenant. The caller sorts each tenant's and slot's rows
// on their own, so a group's segment never runs into the next one.
#include <math.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_C = 16;
constexpr int DO_NOT_SCHEDULE = 0;

__global__ void __launch_bounds__(THREADS)
excess_keys_kernel(int S, int N, const int* __restrict__ dom,
                   const float* __restrict__ counts,
                   const bool* __restrict__ node_valid,
                   float* __restrict__ key) {
  const long long SN = (long long)S * N, b = blockIdx.y;
  dom += b * SN;
  counts += b * SN;
  node_valid += b * N;
  key += b * SN;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < SN;
       i += (long long)gridDim.x * THREADS) {
    const long long s = i / N;
    const int d = dom[i];
    key[i] = (d >= 0 && node_valid[i - s * N]) ? counts[s * N + d] : INFINITY;
  }
}

// The min of lo and the four keys whose aff_ok byte in w is set.
__device__ __forceinline__ float min4(float lo, unsigned w, float4 k) {
  lo = fminf(lo, (w & 0xffu) ? k.x : INFINITY);
  lo = fminf(lo, (w & 0xff00u) ? k.y : INFINITY);
  lo = fminf(lo, (w & 0xff0000u) ? k.z : INFINITY);
  return fminf(lo, (w & 0xff000000u) ? k.w : INFINITY);
}

template <int CMAX, bool VEC>
__global__ void __launch_bounds__(THREADS)
excess_min_kernel(int P, int S, int N, int C, const float* __restrict__ key,
                  const bool* __restrict__ aff_ok,
                  const int* __restrict__ ts_sig,
                  const bool* __restrict__ ts_valid,
                  const signed char* __restrict__ ts_when,
                  const float* __restrict__ ts_skew,
                  const int* __restrict__ choice,
                  const bool* __restrict__ kept,
                  const int* __restrict__ rank, const int* __restrict__ dom,
                  const float* __restrict__ counts, float* __restrict__ T,
                  float* __restrict__ cnt_total, long long* __restrict__ gkey,
                  int* __restrict__ g_cnt) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp
  {  // blockIdx.y: the tenant.
    const long long b = blockIdx.y, SN = (long long)S * N;
    key += b * SN;
    aff_ok += b * P * N;
    ts_sig += b * P * C;
    ts_valid += b * P * C;
    ts_when += b * P * C;
    ts_skew += b * P * C;
    choice += b * P;
    kept += b * P;
    rank += b * P;
    dom += b * SN;
    counts += b * SN;
    T += b * C * P;
    cnt_total += b * C * P;
    gkey += b * C * P;
    g_cnt += b * C * (SN + 1);
  }
  const long long pc = (long long)p * C;
  const int my_s = lane < C ? max(ts_sig[pc + lane], 0) : 0;
  const float* krow[CMAX];
  float lo[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    krow[c] = key + (long long)__shfl_sync(FULL, my_s, c < C ? c : 0) * N;
    lo[c] = INFINITY;
  }
  const bool* arow = aff_ok + (long long)p * N;
  if (VEC) {
    for (int n0 = lane * 16; n0 < N; n0 += 32 * 16) {
      const uint4 a = __ldcs(reinterpret_cast<const uint4*>(arow + n0));
      if ((a.x | a.y | a.z | a.w) == 0u) continue;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c >= C) break;
        const float4* k = reinterpret_cast<const float4*>(krow[c] + n0);
        lo[c] = min4(lo[c], a.x, __ldg(k));
        lo[c] = min4(lo[c], a.y, __ldg(k + 1));
        lo[c] = min4(lo[c], a.z, __ldg(k + 2));
        lo[c] = min4(lo[c], a.w, __ldg(k + 3));
      }
    }
  } else {
    for (int n = lane; n < N; n += 32) {
      if (!arow[n]) continue;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) lo[c] = fminf(lo[c], __ldg(krow[c] + n));
    }
  }
  float mine = INFINITY;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    float v = lo[c];
    for (int off = 16; off > 0; off >>= 1)
      v = fminf(v, __shfl_xor_sync(FULL, v, off));
    if (lane == c) mine = v;
  }
  if (lane >= C) return;
  // Lane c: slot c's per-pod steps.
  const long long SN = (long long)S * N, s = my_s, i = pc + lane;
  const int ch = choice[p];
  const int d = dom[s * N + min(max(ch, 0), N - 1)];
  const bool member = kept[p] && ts_valid[i] && ts_when[i] == DO_NOT_SCHEDULE
                      && ch >= 0 && d >= 0;
  const long long cell = s * N + max(d, 0);
  const long long gid = member ? cell : SN;
  const long long o = (long long)lane * P + p;
  T[o] = (isinf(mine) ? 0.0f : mine) + ts_skew[i];
  cnt_total[o] = counts[cell];
  gkey[o] = (gid << 32) + (long long)rank[p];
  if (member) atomicAdd(g_cnt + lane * (SN + 1) + gid, 1);
}

// The group of a sorted key: (gid << 32) + rank for any int32 rank.
__device__ __forceinline__ long long gid_of(long long k) {
  return (k + 0x80000000LL) >> 32;
}

// KEYS: excess_walk's form (sorted int64 keys and perm, b_fixed from the
// counts); else excess_survive's (int32 gid_s and perm, member, b_fixed).
template <bool KEYS>
__global__ void __launch_bounds__(THREADS)
excess_walk_kernel(int P, int C, long long SN,
                   const long long* __restrict__ key_s,
                   const long long* __restrict__ perm64,
                   const int* __restrict__ gid_s,
                   const int* __restrict__ perm32,
                   const bool* __restrict__ member,
                   const float* __restrict__ T,
                   const float* __restrict__ cnt_total,
                   const int* __restrict__ g_cnt,
                   const float* __restrict__ b_fixed,
                   bool* __restrict__ bad) {
  const int lane = threadIdx.x & 31;
  const long long i0 =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * 32;
  if (i0 >= P) return;  // the whole warp
  {  // blockIdx.z: the tenant; blockIdx.y: the slot.
    const long long b = blockIdx.z, row = (b * C + blockIdx.y) * P;
    if (KEYS) {
      key_s += row;
      perm64 += row;
      cnt_total += row;
      g_cnt += (b * C + blockIdx.y) * (SN + 1);
    } else {
      gid_s += row;
      perm32 += row;
      member += row;
      b_fixed += row;
    }
    T += row;
    bad += b * P;
  }
  auto gid_at = [&](long long i) -> long long {
    return KEYS ? gid_of(key_s[i]) : (long long)gid_s[i];
  };
  const long long i = i0 + lane;
  long long g = -1;
  bool start = false;
  if (i < P) {
    g = gid_at(i);
    start = (i == 0 || gid_at(i - 1) != g) && (!KEYS || g < SN);
  }
  const unsigned le = lane == 31 ? FULL : (2u << lane) - 1u;
  for (unsigned starts = __ballot_sync(FULL, start); starts;
       starts &= starts - 1u) {
    const int L = __ffs(starts) - 1;
    const long long gs = __shfl_sync(FULL, g, L);
    const float gb = KEYS ? (float)g_cnt[gs] : 0.0f;
    float q = 0.0f, pm = INFINITY;
    for (long long j0 = i0 + L; j0 < P; j0 += 32) {
      const long long j = j0 + lane;
      const bool in = j < P && gid_at(j) == gs;
      long long p = 0;
      bool mem = false;
      float t = INFINITY, bf = 0.0f;
      if (in) {
        p = KEYS ? perm64[j] : (long long)perm32[j];
        mem = KEYS || member[p];
        if (mem) {
          t = T[p];
          bf = KEYS ? cnt_total[p] - gb : b_fixed[p];
        }
      }
      const unsigned mb = __ballot_sync(FULL, mem);
      float m = t;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(FULL, m, off);
        if (lane >= off) m = fminf(m, v);
      }
      m = fminf(m, pm);
      const float qi = q + (float)__popc(mb & le);
      if (mem && !(bf + qi <= m)) bad[p] = true;
      pm = __shfl_sync(FULL, m, 31);
      q = q + (float)__popc(mb);
      if (__ballot_sync(FULL, in) != FULL) break;
    }
  }
}

}  // namespace

extern "C" int tpusched_excess_keys(int B, int S, int N, const int* dom,
                                    const float* counts,
                                    const bool* node_valid, float* key,
                                    void* stream) {
  const long long SN = (long long)S * N;
  const int blocks = (int)((SN + THREADS - 1) / THREADS);
  excess_keys_kernel<<<dim3(blocks, B), THREADS, 0, (cudaStream_t)stream>>>(
      S, N, dom, counts, node_valid, key);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_excess_min(
    int B, int P, int S, int N, int C, const float* key, const bool* aff_ok,
    const int* ts_sig, const bool* ts_valid, const signed char* ts_when,
    const float* ts_skew, const int* choice, const bool* kept,
    const int* rank, const int* dom, const float* counts, float* T,
    float* cnt_total, long long* gkey, int* g_cnt, void* stream) {
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  // 16-byte rows: N a multiple of 16 and an aligned base (the key table
  // is the wrapper's own allocation).
  const bool vec = N % 16 == 0 && ((uintptr_t)aff_ok & 15u) == 0;
  const dim3 grid((P + WARPS - 1) / WARPS, B);
  cudaStream_t st = (cudaStream_t)stream;
#define EXCESS_MIN(CM, V)                                                   \
  excess_min_kernel<CM, V><<<grid, THREADS, 0, st>>>(                       \
      P, S, N, C, key, aff_ok, ts_sig, ts_valid, ts_when, ts_skew, choice,  \
      kept, rank, dom, counts, T, cnt_total, gkey, g_cnt)
#define EXCESS_MIN_C(CM) \
  if (vec) EXCESS_MIN(CM, true); else EXCESS_MIN(CM, false)
  if (C == 1) {
    EXCESS_MIN_C(1);
  } else if (C == 2) {
    EXCESS_MIN_C(2);
  } else if (C <= 4) {
    EXCESS_MIN_C(4);
  } else if (C <= 8) {
    EXCESS_MIN_C(8);
  } else {
    EXCESS_MIN_C(16);
  }
#undef EXCESS_MIN_C
#undef EXCESS_MIN
  return (int)cudaGetLastError();
}

extern "C" int tpusched_excess_walk(int B, int C, int P, int S, int N,
                                    const long long* key_s,
                                    const long long* perm, const float* T,
                                    const float* cnt_total, const int* g_cnt,
                                    bool* bad, void* stream) {
  const dim3 grid((P + THREADS - 1) / THREADS, C, B);
  excess_walk_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      P, C, (long long)S * N, key_s, perm, nullptr, nullptr, nullptr, T,
      cnt_total, g_cnt, nullptr, bad);
  return (int)cudaGetLastError();
}

extern "C" int tpusched_excess_survive(int B, int P, const int* gid_s,
                                       const int* perm, const bool* member,
                                       const float* T, const float* b_fixed,
                                       bool* bad, void* stream) {
  const dim3 grid((P + THREADS - 1) / THREADS, 1, B);
  excess_walk_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      P, 1, 0, nullptr, nullptr, gid_s, perm, member, T, nullptr, nullptr,
      b_fixed, bad);
  return (int)cudaGetLastError();
}
