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
//     - val, clamped at 1000, plus the tie bias f32((2m - r) * 1e-8) * slot,
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
// parallel with nothing carried between them, so one block owns one
// image and loops over the joints itself: group_core.cuh (the cost
// build on every warp, the greedy chain as one __reduce_min_sync and one
// ballot a row, the update's slot decisions and a thread per slot).  Its
// LOCKSTEP solver is this kernel's greedy with this kernel's tie bias.
//
// Bound: latency.  The dependent chain is one (min, ballot) step per
// active row for the argmins, about one more for the update (17 * 30 of
// each on the main path); the bytes (inputs once, the people table once)
// take well under a microsecond.

#include "group_core.cuh"

namespace {

using namespace groupcore;

template <int D, int Q>
__global__ void __launch_bounds__(NT)
lockstep_kernel(const float *__restrict__ tag, const float *__restrict__ loc,
                const float *__restrict__ val, int J, int K, int m,
                int p_max, float det_thr, float tag_thr, int use_val,
                int ignore_too_much, float *__restrict__ people,
                int *__restrict__ n_people) {
  group_image<LOCKSTEP, D, Q>(tag, loc, val, J, K, m, p_max, det_thr,
                              tag_thr, use_val, ignore_too_much, people,
                              n_people);
}

}  // namespace

extern "C" int group_lockstep_launch(const float *tag, const float *loc,
                                     const float *val, int B, int J, int K,
                                     int D, int m, int p_max, float det_thr,
                                     float tag_thr, int use_val,
                                     int ignore_too_much, float *people,
                                     int *n_people, void *stream) {
  if (K < 1 || K > ROWS || D < 1 || D > DMAX || p_max < 1 ||
      p_max > SLOTS || B < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{tag, loc, val, B, J, K, D, m, p_max, det_thr, tag_thr,
               use_val, ignore_too_much, people, n_people};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)dispatch<4>(a, [&](auto d, auto q) {
    lockstep_kernel<decltype(d)::value, decltype(q)::value>
        <<<a.B, NT, 0, st>>>(a.tag, a.loc, a.val, a.J, a.K, a.m, a.p_max,
                             a.det_thr, a.tag_thr, a.use_val,
                             a.ignore_too_much, a.people, a.n_people);
  });
}
