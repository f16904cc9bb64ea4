// The whole associative-embedding grouping of a batch of images, one
// joint after another, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel rtpe_tpu/ops/pallas_group.py:match_by_tag_kernel
// (_group_kernel, _group_step, _lap_on_scratch).  Per image, for each joint
// j in order, against the person state (keys, tag sums and counts per
// slot, npv = the number of people):
//   cost build (against the tag means frozen at joint entry): row r, slot
//     s < p_cur = min(npv, m) costs round_half_even(||tag - mean||) * 100
//     - val (or the plain distance), clamped at 1000, plus the tie bias
//     ((2m - r) * s) * 1e-8 in float32; slots p_cur..2m-1 are the dummy
//     columns at BIG; a row at or below the detection threshold costs
//     HUGE on real slots and 0 on dummies;
//   assignment, by the template's solver:
//     lap:    the exact rectangular LAP (lapcore::lap_warp, the same
//             device function as lap_rect.cu) over rows up to the last
//             valid detection, none when p_cur == 0 or the joint is
//             skipped (ignore_too_much at m people); a row matches when
//             its column is a real slot and the unrounded distance there
//             is below the tag threshold;
//     greedy: rows in top-k order each take the cheapest unused real slot
//             (smallest slot on ties) and match under the same two tests
//             (the lockstep kernel's function, row for row);
//   update, row by row in order: a matched row adds its tag to its slot;
//     an unmatched active row merges onto the first person whose key
//     equals its first tag dimension exactly (setdefault), else appends a
//     new person at min(npv, p_max - 1); the people row of every slot
//     written at this joint is the last row that wrote it.
//
// Design.  The TPU walks a sequential grid=(B, J) and carries the state in
// output blocks; Hopper blocks carry nothing between launches and run in
// no order.  So one warp (one block) owns one image and loops over the
// joints itself, state in registers: 128 people slots, 4 per lane
// (slot = lane + 32 q).  The joint's cost and tag distances are built in
// shared memory (32 x 128 f32 each), one row at a time with the row's
// tags broadcast by shuffles.  The solver is a template parameter, so the
// two solvers share the build and the update.  Rows are processed in
// order inside the warp, so last-writer-wins holds and the kernel writes
// the people table itself.  Every float operation is an explicit
// round-to-nearest intrinsic: nvcc contracts no multiply-add.
//
// Bound: latency.  Per joint the dependent chain is K row broadcasts for
// the build, then K warp argmins (greedy) or one LAP (a warp argmin per
// visited column of each inserted row), then K update steps; the bytes
// take well under a microsecond.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "lap_core.cuh"

namespace {

using lapcore::FULL;
using lapcore::INF;
using lapcore::Q;

constexpr int ROWS = 32;
constexpr int LANES = 128;
constexpr int DMAX = 8;
constexpr float COST_CLAMP = 1000.0f;
constexpr float BIG = 2048.0f;
constexpr float HUGE_COST = 4096.0f;

template <bool GREEDY>
__global__ void __launch_bounds__(32)
group_mega_kernel(const float *__restrict__ tag, const float *__restrict__ loc,
                  const float *__restrict__ val, int J, int K, int D, int m,
                  int p_max, float det_thr, float tag_thr, int use_val,
                  int ignore_too_much, float *__restrict__ people,
                  int *__restrict__ n_people) {
  __shared__ float cost_s[ROWS * LANES];  // (row, column l = slot + 1)
  __shared__ float diff_s[ROWS * LANES];  // (row, slot) unrounded distance
  __shared__ int col_s[ROWS];             // assigned column of each row
  __shared__ int match_s[ROWS];           // greedy: the row matched
  const int lane = threadIdx.x;
  const int b = blockIdx.x;

  float keys[Q], tcnt[Q], tsum[DMAX][Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    keys[q] = CUDART_INF_F;
    tcnt[q] = 0.0f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) tsum[d][q] = 0.0f;
  }
  int npv = 0;
  bool ok = true;
  const int row_w = 3 + D;
  const int m2 = 2 * m;

  for (int j = 0; j < J; ++j) {
    // this lane's detection row (lane < K); padded rows never pass
    const long long row = ((long long)b * J + j) * K + lane;
    float r_val = 0.0f, r_x = 0.0f, r_y = 0.0f, r_tag[DMAX];
#pragma unroll
    for (int d = 0; d < DMAX; ++d) r_tag[d] = 0.0f;
    if (lane < K) {
      r_val = val[row];
      r_x = loc[row * 2];
      r_y = loc[row * 2 + 1];
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) r_tag[d] = tag[row * D + d];
    }
    const bool my_valid = lane < K && r_val > det_thr;

    const int p_cur = min(npv, m);
    const bool skip_all = ignore_too_much && p_cur == m;
    float mean[DMAX][Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float cnt = fmaxf(tcnt[q], 1.0f);
#pragma unroll
      for (int d = 0; d < DMAX; ++d) mean[d][q] = __fdiv_rn(tsum[d][q], cnt);
    }

    // ---- cost build
    for (int r = 0; r < K; ++r) {
      const float v_r = __shfl_sync(FULL, r_val, r);
      const bool valid_r = __shfl_sync(FULL, (int)my_valid, r);
      float t_r[DMAX];
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        t_r[d] = d < D ? __shfl_sync(FULL, r_tag[d], r) : 0.0f;
      const float tie_row = (float)(m2 - r);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int s = lane + 32 * q;
        float sq = 0.0f;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) {
            const float dl = __fsub_rn(t_r[d], mean[d][q]);
            sq = __fadd_rn(sq, __fmul_rn(dl, dl));
          }
        const float diff = __fsqrt_rn(sq);
        diff_s[r * LANES + s] = diff;
        if (s < m2) {
          float dn = use_val ? __fsub_rn(__fmul_rn(rintf(diff), 100.0f), v_r)
                             : diff;
          dn = fminf(dn, COST_CLAMP);
          const bool col_real = s < p_cur;
          const float tie = __fmul_rn(__fmul_rn(tie_row, (float)s), 1e-8f);
          const float padded = __fadd_rn(s < m ? dn : 0.0f, tie);
          const float block = col_real ? padded : BIG;
          cost_s[r * LANES + s + 1] =
              valid_r ? block : (col_real ? HUGE_COST : 0.0f);
        }
      }
    }
    __syncwarp();

    // ---- assignment
    if (GREEDY) {
      bool used[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) used[q] = false;
      for (int r = 0; r < K; ++r) {
        const bool active =
            __shfl_sync(FULL, (int)my_valid, r) && !skip_all;
        float best = INF;
        int best_l = INT_MAX;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int l = lane + 32 * q + 1;  // column of slot l - 1
          const bool cand = l <= p_cur && !used[q];
          const float masked = cand ? cost_s[r * LANES + l] : INF;
          if (masked < best || (masked == best && l < best_l)) {
            best = masked;
            best_l = l;
          }
        }
        lapcore::warp_argmin(best, best_l);
        const int s_at = best_l - 1;  // 0..127
        const float d_at = diff_s[r * LANES + s_at];
        const bool matched = active && best < BIG && d_at < tag_thr;
        if (matched && lane == (s_at & 31)) {
#pragma unroll
          for (int q = 0; q < Q; ++q)
            if (q == (s_at >> 5)) used[q] = true;
        }
        if (lane == 0) {
          col_s[r] = matched ? s_at : m2;
          match_s[r] = matched;
        }
      }
    } else {
      // rows up to the last valid detection; none when there is no one
      // to match or the joint is skipped
      int n_valid = my_valid ? lane + 1 : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        n_valid = max(n_valid, __shfl_xor_sync(FULL, n_valid, off));
      const int n_rows = (p_cur == 0 || skip_all) ? 0 : n_valid;
      int p[Q];
      ok = lapcore::lap_warp(cost_s, LANES, n_rows, m2, lane, p) && ok;
      col_s[lane] = 0;  // ROWS == 32: one row per lane
      __syncwarp();
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int l = lane + 32 * q;
        if (l >= 1 && l <= m2 && p[q] >= 1) col_s[p[q] - 1] = l - 1;
      }
    }
    __syncwarp();

    // ---- update, row by row with evolving keys / npv
    int win[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) win[q] = -1;
    for (int r = 0; r < K; ++r) {
      const bool active = __shfl_sync(FULL, (int)my_valid, r) && !skip_all;
      float t_r[DMAX];
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        t_r[d] = d < D ? __shfl_sync(FULL, r_tag[d], r) : 0.0f;
      const int col = col_s[r];
      bool matched;
      if (GREEDY) {
        matched = match_s[r] != 0;
      } else {
        const float d_at = diff_s[r * LANES + min(max(col, 0), m - 1)];
        matched = active && col < p_cur && d_at < tag_thr;
      }
      const bool is_new = active && !matched;
      const float key_r = t_r[0];
      const int slot_m = min(max(col, 0), p_max - 1);

      int hit_slot = INT_MAX;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int s = lane + 32 * q;
        const unsigned bal = __ballot_sync(FULL, s < npv && keys[q] == key_r);
        if (bal && hit_slot == INT_MAX) hit_slot = 32 * q + __ffs(bal) - 1;
      }
      const bool has_hit = hit_slot != INT_MAX;
      const int slot_n = has_hit ? hit_slot : min(npv, p_max - 1);
      const bool alloc = is_new && !has_hit;
      const int slot_r = matched ? slot_m : slot_n;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int s = lane + 32 * q;
        const bool sel_m = matched && s == slot_m;
        const bool sel_n = is_new && s == slot_n;
        if ((matched || is_new) && s == slot_r) win[q] = r;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D)
            tsum[d][q] = sel_m ? __fadd_rn(tsum[d][q], t_r[d])
                               : (sel_n ? t_r[d] : tsum[d][q]);
        tcnt[q] = sel_m ? __fadd_rn(tcnt[q], 1.0f) : (sel_n ? 1.0f : tcnt[q]);
        if (alloc && s == slot_n) keys[q] = key_r;
      }
      if (alloc) npv = min(npv + 1, p_max);
    }
    __syncwarp();  // the next joint's build overwrites the shared arrays

    // ---- people rows of this joint: last writer per slot, else zeros
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int s = lane + 32 * q;
      const int src = max(win[q], 0);
      const float px = __shfl_sync(FULL, r_x, src);
      const float py = __shfl_sync(FULL, r_y, src);
      const float pv = __shfl_sync(FULL, r_val, src);
      float pt[DMAX];
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        pt[d] = d < D ? __shfl_sync(FULL, r_tag[d], src) : 0.0f;
      if (s < p_max) {
        const bool w = win[q] >= 0;
        float *out = people + (((long long)b * p_max + s) * J + j) * row_w;
        out[0] = w ? px : 0.0f;
        out[1] = w ? py : 0.0f;
        out[2] = w ? pv : 0.0f;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) out[3 + d] = w ? pt[d] : 0.0f;
      }
    }
  }
  // a solve that found no free column (non-finite input) marks the image
  if (lane == 0) n_people[b] = ok ? npv : -1;
}

}  // namespace

extern "C" int group_mega_launch(const float *tag, const float *loc,
                                 const float *val, int B, int J, int K, int D,
                                 int m, int p_max, float det_thr,
                                 float tag_thr, int use_val,
                                 int ignore_too_much, int greedy,
                                 float *people, int *n_people, void *stream) {
  if (B < 1 || J < 1 || K < 1 || K > ROWS || K > m || 2 * m + 1 > LANES ||
      D < 1 || D > DMAX || p_max < 1 || p_max > 96)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (greedy)
    group_mega_kernel<true><<<B, 32, 0, s>>>(
        tag, loc, val, J, K, D, m, p_max, det_thr, tag_thr, use_val,
        ignore_too_much, people, n_people);
  else
    group_mega_kernel<false><<<B, 32, 0, s>>>(
        tag, loc, val, J, K, D, m, p_max, det_thr, tag_thr, use_val,
        ignore_too_much, people, n_people);
  return (int)cudaGetLastError();
}
