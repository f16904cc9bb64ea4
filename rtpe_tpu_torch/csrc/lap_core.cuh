// Successive-shortest-path rectangular LAP run by one warp, shared by
// lap_rect.cu (the per-joint LAP kernel) and group_mega.cu (the grouping
// mega-kernel's exact solver).
//
// It computes what rtpe_tpu/ops/pallas_lap.py:_lap_kernel and
// rtpe_tpu/ops/pallas_group.py:_lap_on_scratch compute: the potentials
// formulation with the row potentials held per COLUMN (u_col[l] is the
// potential of the row assigned to column l, and moves with it along the
// augmenting walk), masked entries at 1e18, and the argmin that takes the
// smallest column on ties.  Column index l runs 0..127: l = 0 hosts the
// entering row, l = 1..m is cost column l - 1.  Each lane holds columns
// lane + 32 q, q = 0..3, in registers; the per-iteration (delta, j1) is a
// shuffle butterfly on (value, column), and the scalars p[j1] / u_col[j1]
// come from the owning lane by one shuffle each.
//
// Every float operation is an explicit round-to-nearest intrinsic, so nvcc
// contracts no multiply-add: `cur = crow - u - v` is two roundings in that
// order, as in JAX.

#pragma once

#include <cuda_runtime.h>
#include <climits>

namespace lapcore {

constexpr int Q = 4;  // columns per lane: 128 columns
constexpr float INF = 1e18f;
constexpr unsigned FULL = 0xffffffffu;

// a[q] for a warp-uniform q, without indexing the register array.
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[Q], int q) {
  T r = a[0];
#pragma unroll
  for (int i = 1; i < Q; ++i)
    if (i == q) r = a[i];
  return r;
}

// Column l's element of a per-lane array, read from the lane that owns it.
template <typename T>
__device__ __forceinline__ T col_read(const T (&a)[Q], int l) {
  return __shfl_sync(FULL, pick(a, l >> 5), l & 31);
}

// Warp-wide lexicographic minimum of (value, column): the smallest column
// among those holding the smallest value.  Every lane gets the result.
__device__ __forceinline__ void warp_argmin(float &v, int &c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oc = __shfl_xor_sync(FULL, c, off);
    if (ov < v || (ov == v && oc < c)) {
      v = ov;
      c = oc;
    }
  }
}

// Inserts rows 1..n_rows of the cost held in shared memory
// (cost(r, l) = cost_s[r * stride + l], r < n_rows, 1 <= l <= m) and
// leaves in p[q] the 1-indexed row assigned to column l = lane + 32 q
// (0: none; always 0 for l = 0 and l > m).  Returns false, with p
// incomplete, when a row finds no free column below 1e18 (costs that are
// not finite): the loops are bounded, so such input cannot hang the warp.
__device__ inline bool lap_warp(const float *cost_s, int stride, int n_rows,
                                int m, int lane, int (&p)[Q]) {
  float v[Q], u[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    v[q] = 0.0f;
    u[q] = 0.0f;
    p[q] = 0;
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
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (lane + 32 * q == j0) used[q] = true;
      const float *crow = cost_s + (pj0 - 1) * stride;
      float best = INF;
      int best_l = INT_MAX;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int l = lane + 32 * q;
        const bool valid = l >= 1 && l <= m;
        if (valid && !used[q]) {
          const float cur = __fsub_rn(__fsub_rn(crow[l], uj0), v[q]);
          if (cur < minv[q]) {
            minv[q] = cur;
            way[q] = j0;
          }
        }
        const float masked = (used[q] || !valid) ? INF : minv[q];
        if (masked < best || (masked == best && l < best_l)) {
          best = masked;
          best_l = l;
        }
      }
      warp_argmin(best, best_l);
      if (!(best < INF)) return false;
      const float delta = best;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (used[q]) {
          u[q] = __fadd_rn(u[q], delta);
          v[q] = __fsub_rn(v[q], delta);
        } else {
          minv[q] = __fsub_rn(minv[q], delta);
        }
      }
      // j1 is not used, so the update above left its u untouched
      j0 = best_l;
      uj0 = col_read(u, j0);
      pj0 = col_read(p, j0);
    }
    // augmenting walk j0 -> way[j0] -> ... -> 0, moving each (row,
    // potential) pair one column forward; a path visits each column once
    for (int pass = 0; j0 != 0; ++pass) {
      if (pass > m) return false;
      const int j1 = col_read(way, j0);
      const int pj1 = col_read(p, j1);
      const float uj1 = col_read(u, j1);
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (lane + 32 * q == j0) {
          p[q] = pj1;
          u[q] = uj1;
        }
      j0 = j1;
    }
  }
  if (lane == 0) p[0] = 0;
  return true;
}

}  // namespace lapcore
