// Greedy associative-embedding grouping, one joint at a time, CUDA C++
// for sm_90a.
//
// Replaces the TPU kernel
// rtpe_tpu/ops/pallas_group_lockstep.py:_lockstep_kernel
// (match_by_tag_lockstep) together with its people-table rebuild.
//
// Semantics, per image, for each joint j in order (state: person keys,
// tag sums and counts per slot, and npv, the number of people):
//   loop 1 (against the means frozen at joint entry): row r, in top-k
//     order, takes the lowest-cost unused column among the first
//     min(npv, m) slots; cost = round_half_even(||tag - mean||) * 100
//     - val, clamped at 1000, plus the tie bias (2m - r) * 1e-8 * slot,
//     or HUGE for an inactive row (val <= detection threshold, or the
//     joint skipped under ignore_too_much); the row matches when that
//     cost < BIG and the unrounded distance < tag_threshold.  A NaN cost
//     (a NaN tag or tag mean) survives the clamp and wins the argmin, as
//     jnp.min and torch.argmin propagate it, so that row matches no one;
//   loop 2 (row by row, evolving state): a matched row adds its tag to
//     its slot; an unmatched active row merges onto the first person
//     whose key equals its first tag dimension exactly (setdefault),
//     else appends a new person at min(npv, p_max - 1);
//   the people row (x, y, val, tag...) of every slot written at this
//     joint is the last row that wrote it.
//
// Design.  On the TPU the grid walks the joints in order with the state
// in scratch, every image on its own sublane.  Here blocks run in
// parallel with nothing carried between them, so one warp owns one
// image and loops over the joints itself.  The 128 people slots sit on
// the lanes, 4 per lane (slot = lane + 32 q); detection rows (K <= 32)
// sit one per lane and are broadcast with shuffles; the per-row argmin
// is a warp butterfly on (cost, slot).  Rows are processed in order
// inside the warp, so last-writer-wins holds without the slot-decision
// detour Mosaic forced, and the kernel writes the people table itself.
// Every float operation is an explicit round-to-nearest intrinsic, so
// nvcc cannot contract a multiply-add and drift from the plain version.
//
// Bound: latency.  The dependent chain is J * K * 2 warp reductions
// (17 * 30 * 2 on the main path); the bytes (inputs once, the people
// table once) take well under a microsecond.

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace {

constexpr int WARPS_PER_BLOCK = 4;
constexpr int Q = 4;  // slots per lane: 128 slots
constexpr int DMAX = 8;
constexpr float COST_CLAMP = 1000.0f;
constexpr float BIG = 2048.0f;
constexpr float HUGE_COST = 4096.0f;
constexpr float MASKED = 1e18f;
constexpr unsigned FULL = 0xffffffffu;

// (a, sa) comes before (b, sb) in the row's argmin: a NaN first (jnp.min
// and torch.argmin propagate it), then the smaller cost, then the smaller
// slot.
__device__ __forceinline__ bool before(float a, int sa, float b, int sb) {
  const bool a_nan = a != a, b_nan = b != b;
  if (a_nan || b_nan) return a_nan && (!b_nan || sa < sb);
  return a < b || (a == b && sa < sb);
}

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
lockstep_kernel(const float *__restrict__ tag, const float *__restrict__ loc,
                const float *__restrict__ val, int B, int J, int K, int D,
                int m, int p_max, float det_thr, float tag_thr, int use_val,
                int ignore_too_much, float *__restrict__ people,
                int *__restrict__ n_people) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps exit together

  float keys[Q], tcnt[Q], tsum[DMAX][Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    keys[q] = CUDART_INF_F;
    tcnt[q] = 0.0f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) tsum[d][q] = 0.0f;
  }
  int npv = 0;
  const int row_w = 3 + D;

  for (int j = 0; j < J; ++j) {
    // this lane's detection row (lane < K)
    const long long row = ((long long)b * J + j) * K + lane;
    float r_val = -1.0f, r_x = 0.0f, r_y = 0.0f, r_tag[DMAX];
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

    const int p_cur = min(npv, m);
    const bool skip_all = ignore_too_much && p_cur == m;
    float mean[DMAX][Q];
    bool used[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      used[q] = false;
      const float cnt = fmaxf(tcnt[q], 1.0f);
#pragma unroll
      for (int d = 0; d < DMAX; ++d) mean[d][q] = __fdiv_rn(tsum[d][q], cnt);
    }

    // ---- loop 1: greedy decisions against the frozen means
    int my_col = 0;
    bool my_match = false, my_active = false;
    for (int r = 0; r < K; ++r) {
      const float v_r = __shfl_sync(FULL, r_val, r);
      float t_r[DMAX];
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        t_r[d] = d < D ? __shfl_sync(FULL, r_tag[d], r) : 0.0f;
      const bool active = v_r > det_thr && !skip_all;
      const float tie_coef = (float)((double)(2 * m - r) * 1e-8);
      float diff[Q];
      float best = MASKED;
      int best_s = INT_MAX;
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
        diff[q] = __fsqrt_rn(sq);
        float cost = use_val ? __fsub_rn(__fmul_rn(rintf(diff[q]), 100.0f), v_r)
                             : diff[q];
        cost = cost > COST_CLAMP ? COST_CLAMP : cost;  // keeps a NaN
        const float crow =
            active ? __fadd_rn(cost, __fmul_rn(tie_coef, (float)s)) : HUGE_COST;
        const float masked = (s < p_cur && !used[q]) ? crow : MASKED;
        if (before(masked, s, best, best_s)) {
          best = masked;
          best_s = s;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off);
        const int os = __shfl_xor_sync(FULL, best_s, off);
        if (before(ob, os, best, best_s)) {
          best = ob;
          best_s = os;
        }
      }
      // the distance at the chosen slot, from the lane that owns it
      const int q_at = best_s >> 5;
      float d_mine = diff[0];
#pragma unroll
      for (int q = 1; q < Q; ++q)
        if (q == q_at) d_mine = diff[q];
      const float d_at = __shfl_sync(FULL, d_mine, best_s & 31);
      const bool matched = active && best < BIG && d_at < tag_thr;
      if (matched && lane == (best_s & 31)) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if (q == q_at) used[q] = true;
      }
      if (lane == r) {
        my_col = best_s;
        my_match = matched;
        my_active = active;
      }
    }

    // ---- loop 2: state update with evolving keys / npv
    int win[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) win[q] = -1;
    for (int r = 0; r < K; ++r) {
      const bool matched = __shfl_sync(FULL, (int)my_match, r);
      const bool active = __shfl_sync(FULL, (int)my_active, r);
      const int col = __shfl_sync(FULL, my_col, r);
      float t_r[DMAX];
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        t_r[d] = d < D ? __shfl_sync(FULL, r_tag[d], r) : 0.0f;
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
  if (lane == 0) n_people[b] = npv;
}

}  // namespace

extern "C" int group_lockstep_launch(const float *tag, const float *loc,
                                     const float *val, int B, int J, int K,
                                     int D, int m, int p_max, float det_thr,
                                     float tag_thr, int use_val,
                                     int ignore_too_much, float *people,
                                     int *n_people, void *stream) {
  if (K < 1 || K > 32 || D < 1 || D > DMAX || p_max < 1 || p_max > 32 * Q ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  lockstep_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      tag, loc, val, B, J, K, D, m, p_max, det_thr, tag_thr, use_val,
      ignore_too_much, people, n_people);
  return (int)cudaGetLastError();
}
