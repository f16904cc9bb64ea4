// Successive-shortest-path rectangular LAP run by one warp, shared by
// lap_rect.cu (the per-joint LAP kernel) and group_mega.cu (the grouping
// mega-kernel's exact solver).
//
// It computes what rtpe_tpu/ops/pallas_lap.py:_lap_kernel and
// rtpe_tpu/ops/pallas_group.py:_lap_on_scratch compute: the potentials
// formulation with the row potentials held per COLUMN (u_col[l] is the
// potential of the row assigned to column l, and moves with it along the
// augmenting walk), masked entries at 1e18, and the argmin that takes the
// smallest column on ties.  Column index l runs 0..32 Q - 1: l = 0 hosts
// the entering row, l = 1..m is cost column l - 1.
//
// Design.  Lane t holds the Q contiguous columns Q t .. Q t + Q - 1 in
// registers (Q a template parameter: 2 up to 63 cost columns, 4 up to
// 127; lanes_q), so the lowest lane among tied minima holds the smallest
// column.  A Dijkstra step's argmin is then one __reduce_min_sync over an
// order-preserving uint32 image of each lane's best (min_key: -0 equal to
// +0, the smallest q on ties), one ballot of the lanes at the minimum and
// __ffs for the owner; delta (the owner's float, not decoded from the key:
// the sign of a zero stays), the potential u and the row p of the winning
// column come from the owner by shuffles issued together, each lane
// having picked its candidate's u and p before the reduction.  The parent
// design held columns lane + 32 q and found (delta, j1) by a 5-round
// shuffle butterfly on (value, column), then read u and p at j1 by two
// more dependent shuffles.  The step has no branch but the loop's (every
// per-column choice is a select) and loads the row by a 32-bit shared
// address made once (lds), so its dependent chain is the row's load, ~20
// ALU operations, the reduction, the ballot and one round of shuffles.
//
// Every float operation is an explicit round-to-nearest intrinsic, so nvcc
// contracts no multiply-add: `cur = crow - u - v` is two roundings in that
// order, as in JAX.

#pragma once

#include <cuda_runtime.h>

namespace lapcore {

constexpr float INF = 1e18f;
constexpr unsigned FULL = 0xffffffffu;

// Columns a lane holds for m cost columns (plus the entering column).
__host__ __device__ constexpr int lanes_q(int m) {
  return m + 1 <= 64 ? 2 : 4;
}
static_assert(lanes_q(63) == 2 && lanes_q(64) == 4, "Q is 2 or 4");

// An order-preserving uint32 image of a masked distance (never NaN: the
// step masks a NaN as INF, and the parent's comparisons never took one):
// -0 + 0 is +0, so the two zeros share a key; then the sign-flip map of
// the float order.  Branch-free, as is every step below: a divergent
// branch in the chain costs more than the select.
__device__ __forceinline__ unsigned min_key(float c) {
  const unsigned u = __float_as_uint(__fadd_rn(c, 0.0f));
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

// A float from shared memory at a 32-bit shared address.  The solve
// addresses its rows this way: through the generic pointer, nvcc rebuilt
// the shared window's base (S2UR of the CTA id) on every Dijkstra step,
// inside the dependent chain.
__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// a[q] for a q that may differ between lanes, without indexing the
// register array.
template <int Q, typename T>
__device__ __forceinline__ T pick(const T (&a)[Q], int q) {
  T r = a[0];
#pragma unroll
  for (int i = 1; i < Q; ++i) r = i == q ? a[i] : r;
  return r;
}

// Column l's element of a per-lane array, read from the lane that owns it.
template <int Q, typename T>
__device__ __forceinline__ T col_read(const T (&a)[Q], int l) {
  return __shfl_sync(FULL, pick<Q>(a, l % Q), l / Q);
}

// The smallest of a lane's Q keys, its q (the smallest on ties) and its
// masked distance.
template <int Q>
__device__ __forceinline__ void lane_best(const unsigned (&k)[Q],
                                          const float (&mk)[Q], unsigned &kb,
                                          int &qb, float &fb) {
  const bool s01 = k[1] < k[0];
  kb = s01 ? k[1] : k[0];
  qb = s01;
  fb = s01 ? mk[1] : mk[0];
  if constexpr (Q == 4) {
    const bool s23 = k[3] < k[2];
    const unsigned kc = s23 ? k[3] : k[2];
    const float fc = s23 ? mk[3] : mk[2];
    const bool s = kc < kb;
    kb = s ? kc : kb;
    qb = s ? 2 + s23 : qb;
    fb = s ? fc : fb;
  }
}

// Inserts rows 1..n_rows of the cost held in shared memory (cost_s, a
// pointer into the block's shared memory)
// (cost(r, l) = cost_s[r * stride + l], r < n_rows, 1 <= l <= m) and
// leaves in p[q] the 1-indexed row assigned to column l = Q lane + q
// (0: none; always 0 for l = 0 and l > m).  Needs m <= 32 Q - 1, and
// cost_s readable up to (n_rows - 1) * stride + 32 Q - 1 (every lane loads
// all its columns; those outside 1..m are masked).  Returns false, with p
// incomplete, when a row finds no free column below 1e18 (costs that are
// not finite): the loops are bounded, so such input cannot hang the warp.
template <int Q>
__device__ inline bool lap_warp(const float *cost_s, int stride, int n_rows,
                                int m, int lane, int (&p)[Q]) {
  float v[Q], u[Q];
  bool valid[Q];
  const unsigned cost_lane =
      (unsigned)__cvta_generic_to_shared(cost_s) + 4u * Q * lane;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    v[q] = 0.0f;
    u[q] = 0.0f;
    p[q] = 0;
    valid[q] = Q * lane + q >= 1 && Q * lane + q <= m;
  }
  for (int i = 1; i <= n_rows; ++i) {
    // column 0 hosts the entering row i; its potential starts at 0
    if (lane == 0) {
      p[0] = i;
      u[0] = 0.0f;
    }
    float minv[Q];
    int way[Q];
    bool used[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      minv[q] = INF;
      way[q] = 0;
      used[q] = false;
    }
    int j0 = 0, pj0 = i;
    float uj0 = 0.0f;
    // each pass marks one more column used: at most m + 1 passes
    for (int pass = 0; pj0 != 0; ++pass) {
      if (pass > m) return false;
      const unsigned crow = cost_lane + 4u * (unsigned)((pj0 - 1) * stride);
      float c[Q], mk[Q];
      unsigned k[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) c[q] = lds(crow + 4u * q);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        used[q] = used[q] || Q * lane + q == j0;
        const float cur = __fsub_rn(__fsub_rn(c[q], uj0), v[q]);
        const bool upd = valid[q] && !used[q] && cur < minv[q];
        minv[q] = upd ? cur : minv[q];
        way[q] = upd ? j0 : way[q];
        // INF for a used or invalid column, and for a NaN distance, which
        // the parent never took
        mk[q] = (used[q] || !valid[q] || minv[q] != minv[q]) ? INF : minv[q];
        k[q] = min_key(mk[q]);
      }
      // the lane's best, the smallest q on ties: a tree of strict compares
      unsigned kb;
      int qb;
      float fb;
      lane_best<Q>(k, mk, kb, qb, fb);
      // the candidate's potential and row (its column is not used, so
      // this step's update leaves them as they are)
      const float uc = pick<Q>(u, qb);
      const int rc = (pick<Q>(p, qb) << 3) | qb;
      const unsigned kmin = __reduce_min_sync(FULL, kb);
      const int owner = __ffs(__ballot_sync(FULL, kb == kmin)) - 1;
      const float delta = __shfl_sync(FULL, fb, owner);
      uj0 = __shfl_sync(FULL, uc, owner);
      const int rw = __shfl_sync(FULL, rc, owner);
      if (!(delta < INF)) return false;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float un = __fadd_rn(u[q], delta);
        const float vn = __fsub_rn(v[q], delta);
        const float mn = __fsub_rn(minv[q], delta);
        u[q] = used[q] ? un : u[q];
        v[q] = used[q] ? vn : v[q];
        minv[q] = used[q] ? minv[q] : mn;
      }
      j0 = Q * owner + (rw & 7);
      pj0 = rw >> 3;
    }
    // augmenting walk j0 -> way[j0] -> ... -> 0, moving each (row,
    // potential) pair one column forward; a path visits each column once
    for (int pass = 0; j0 != 0; ++pass) {
      if (pass > m) return false;
      const int j1 = col_read<Q>(way, j0);
      const int pj1 = col_read<Q>(p, j1);
      const float uj1 = col_read<Q>(u, j1);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const bool at = Q * lane + q == j0;
        p[q] = at ? pj1 : p[q];
        u[q] = at ? uj1 : u[q];
      }
      j0 = j1;
    }
  }
  if (lane == 0) p[0] = 0;
  return true;
}

}  // namespace lapcore
