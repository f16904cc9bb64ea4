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
//             (the lockstep kernel's function, row for row).  A NaN cost
//             (a NaN tag or tag mean) survives the clamp and wins the
//             argmin, as jnp.min and torch.argmin propagate it, so that
//             row matches no one;
//   update, row by row in order: a matched row adds its tag to its slot;
//     an unmatched active row merges onto the first person whose key
//     equals its first tag dimension exactly (setdefault), else appends a
//     new person at min(npv, p_max - 1); the people row of every slot
//     written at this joint is the last row that wrote it.
//
// Design.  The TPU walks a sequential grid=(B, J) and carries the state in
// output blocks; Hopper blocks carry nothing between launches and run in
// no order.  So one block owns one image and loops over the joints
// itself: group_core.cuh, shared with the lockstep kernel (the cost build
// on every warp, the greedy chain as one __reduce_min_sync and one ballot
// a row, the update's slot decisions and a thread per slot).  The solver
// is a template parameter (GREEDY or LAP); the exact solver is
// lapcore::lap_warp, the same device function as lap_rect.cu, on the
// 32 x 128 cost in shared memory, column 0 for the entering row.
//
// Bound: latency.  Per joint the dependent chain is one (min, ballot)
// step per active row (greedy) or one LAP (a warp argmin per visited
// column of each inserted row), then about one step per row for the
// update; the bytes take well under a microsecond.

#include "group_core.cuh"

namespace {

using namespace groupcore;

template <int S, int D, int Q>
__global__ void __launch_bounds__(NT)
group_mega_kernel(const float *__restrict__ tag, const float *__restrict__ loc,
                  const float *__restrict__ val, int J, int K, int m,
                  int p_max, float det_thr, float tag_thr, int use_val,
                  int ignore_too_much, float *__restrict__ people,
                  int *__restrict__ n_people) {
  group_image<S, D, Q>(tag, loc, val, J, K, m, p_max, det_thr, tag_thr,
                       use_val, ignore_too_much, people, n_people);
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
  const Args a{tag, loc, val, B, J, K, D, m, p_max, det_thr, tag_thr,
               use_val, ignore_too_much, people, n_people};
  const cudaStream_t st = (cudaStream_t)stream;
  auto launch = [&](auto solver, auto d, auto q) {
    group_mega_kernel<decltype(solver)::value, decltype(d)::value,
                      decltype(q)::value>
        <<<a.B, NT, 0, st>>>(a.tag, a.loc, a.val, a.J, a.K, a.m, a.p_max,
                             a.det_thr, a.tag_thr, a.use_val,
                             a.ignore_too_much, a.people, a.n_people);
  };
  // the candidates are at most min(m, p_max) <= 63 people: Q <= 2
  if (greedy)
    return (int)dispatch<2>(a, [&](auto d, auto q) {
      launch(std::integral_constant<int, GREEDY>{}, d, q);
    });
  return (int)dispatch<1>(a, [&](auto d, auto q) {
    launch(std::integral_constant<int, LAP>{}, d, q);
  });
}
