// Fused CAM op F2 and its backward F2b, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of rtpe_tpu/ops/pallas_cam.py:
//   F2  (_f2_call, _f2_kernel): s_t (2, C) = [sum, sum of squares] of
//       t = bf16(sum_i bf16(relu(BN_i(bf16(conv3x3_dil_i(x))))) . kt[i]),
//       the top 1x1 conv over the normalised branches;
//   F2b (_f2b_call, _f2b_kernel): given dst, recompute t, dt = dst[0] +
//       2 t dst[1], dkt[i] = sum a_i^T bf16(dt), da = bf16(dt) . kt[i]^T,
//       dz = (z > 0) da, dS (2 nb, hc) = [sum dz, sum dz (c - mean)],
//       dc = dz scale inv, dkh = sum x_tap^T bf16(dc) (phase 0), then
//       dx = sum_i convT_i(bf16(dc_i)) (phase 1).
// x (B, H, W, C) bf16, kh (nb, 3, 3, C, hc) bf16, kt (nb, hc, C) bf16,
// bnh (4 nb, hc) f32 rows [mean, inv, scale, bias] per branch.  F2 runs
// f2_wg_kernel (cam_wg.cuh: F2b's products without the branch backward,
// F1's column sums of bf16(t) and t^2 over the tile's pixels in the image
// after each 64-column chunk; the per-tile rows are summed in tile order,
// reduce_rows, no float atomics), F2b's phase 0 f2b_wg_kernel (F3b's body
// without x kr^T), both on x padded to kc channels and the weights
// re-laid by ops/cam.py:_wg_weights (F2's the prefix of F2b's before its
// kt[i]^T stages), and F2b's phase 1 dx_wg_kernel (_dx_weights).
//
// Bound at the steps' CAM (B=16, 113 x 113, C=163, hc=40, dils 1..3):
// operations.  F2 does 9 nb C hc + nb hc C = 195.6 K multiply-adds a
// pixel: 0.081 ms at 989 TFLOP/s (bf16 dense); F2b about 3x.  At
// --inplanes 128's step CAM (C = 259, hc = 64) 497.3 K, 0.206 ms.

#include "cam_wg.cuh"

namespace cam {
namespace {

struct F2bWs {
  bf16 *a, *dt, *dc, *cb;
  float *part, *part_h, *part_t;
  WgPlan ph, pt;   // dkh; dkt
  bool ok;
};

// dc (M, nb khc) with zero padding columns, as f2b_wg_kernel writes it;
// a (M, knh) and dt (M, kc) have 16-byte rows (their padding columns are
// written only by f2b_wg_kernel, which reads them back: only outputs
// k < NH, n < C of the weight gradients are kept); f2b_wg_kernel's c
// (M, knh) last.  xpad may be null for sizing.
F2bWs carve_f2b(const Geo &g, const tile::TGeo &t, void *base,
                const bf16 *xpad, int64_t *bytes) {
  Carve cv(base);
  F2bWs w;
  w.a = cv.take<bf16>(static_cast<int64_t>(g.M) * g.knh);
  w.dt = cv.take<bf16>(static_cast<int64_t>(g.M) * g.kc);
  w.dc = cv.take<bf16>(static_cast<int64_t>(g.M) * t.ldc);
  w.part = cv.take<float>(static_cast<int64_t>(t.n_tiles) * 2 * g.NH);
  const WgJob jt = plain_job(w.a, g.knh, g.NH, w.dt, g.kc, g.C, 0);
  w.ok = tile::dkh_plan(g, t, xpad, w.dc, &w.ph) &&
         plain_plan(&jt, 1, static_cast<int64_t>(g.NH) * g.C, g, &w.pt);
  if (w.ok) {
    w.part_h = cv.take<float>(wg_part_floats(w.ph));
    w.part_t = cv.take<float>(wg_part_floats(w.pt));
  }
  w.cb = cv.take<bf16>(static_cast<int64_t>(g.M) * g.knh);
  *bytes = cv.off;
  return w;
}

}  // namespace
}  // namespace cam

using namespace cam;

// F2's per-tile partial rows, then a (M, knh) bf16 where f2_wg_kernel
// keeps it out of shared memory.
static int64_t carve_f2(const Geo &g, const tile::TGeo &t,
                        const tile::FPlan &P, void *base, float **part,
                        bf16 **a) {
  Carve cv(base);
  *part = cv.take<float>(static_cast<int64_t>(t.n_tiles) * 2 * g.C);
  *a = cv.take<bf16>(P.a_res ? 0 : static_cast<int64_t>(g.M) * g.knh);
  return cv.off;
}

// F2's workspace, bytes.
extern "C" long long cam_f2_workspace(const int *geo) {
  Geo g;
  tile::TGeo t;
  tile::FPlan P;
  if (!tile::fwd_geo(geo, tile::F2, &g, &t, &P)) return -1;
  float *part;
  bf16 *a;
  return carve_f2(g, t, P, nullptr, &part, &a);
}

// F2's plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f2_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F2, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0 the weights re-laid
// by ops/cam.py:_wg_weights("f2", ...).  s_t (2, C) f32.  ws:
// cam_f2_workspace(geo) bytes.
extern "C" int cam_f2_launch(const int *geo, const void *xpad,
                             const void *w0, const void *bnh, void *ws,
                             void *s_t, void *stream) {
  Geo g;
  tile::TGeo t;
  tile::FPlan P;
  if (!tile::fwd_geo(geo, tile::F2, &g, &t, &P))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  float *part;
  bf16 *a;
  carve_f2(g, t, P, ws, &part, &a);
  const auto *xx = static_cast<const bf16 *>(xpad);
  const auto *w = static_cast<const bf16 *>(w0);
  const auto *h = static_cast<const float *>(bnh);
  CAM_TRY(CAM_WG_LAUNCH(tile::f2_wg_kernel, g, t, P, st, xx, w, h, part, a));
  CAM_TRY(reduce_rows(part, 2 * g.C, 0, 2 * g.C, t.n_tiles, 1,
                      static_cast<float *>(s_t), 0, st));
  return 0;
}

extern "C" long long cam_f2b_workspace(const int *geo) {
  Geo g;
  tile::TGeo t;
  if (!tile::tile_geo(geo, tile::F2B, &g, &t)) return -1;
  int64_t bytes = 0;
  return carve_f2b(g, t, nullptr, nullptr, &bytes).ok ? bytes : -1;
}

// F2b's plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f2b_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F2B, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0, w1 the weights
// re-laid by ops/cam.py:_wg_weights("f2b", ...) and _dx_weights.  dx (B, H, W,
// C) bf16, dkh (nb, 3, 3, C, hc), dkt (nb, hc, C) and dS (2 nb, hc) f32.
extern "C" int cam_f2b_launch(const int *geo, const void *xpad,
                              const void *w0, const void *w1,
                              const void *bnh, const void *dst, void *ws,
                              void *dx, void *dkh, void *dkt, void *dS,
                              void *stream) {
  Geo g;
  tile::TGeo t;
  tile::FPlan P;
  tile::DPlan D;
  if (!tile::bwd_geo(geo, tile::F2B, &g, &t, &P, &D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int64_t bytes = 0;
  const auto *xx = static_cast<const bf16 *>(xpad);
  const F2bWs w = carve_f2b(g, t, ws, xx, &bytes);
  if (!w.ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto *w_ = static_cast<const bf16 *>(w0);
  const auto *h = static_cast<const float *>(bnh);
  const auto *d = static_cast<const float *>(dst);
  CAM_TRY(CAM_WG_LAUNCH(tile::f2b_wg_kernel, g, t, P, st, xx, w_, h, d,
                        w.a, w.dt, w.dc, w.part, w.cb));
  CAM_TRY(reduce_rows(w.part, 2 * g.NH, 0, 2 * g.NH, t.n_tiles, 1,
                      static_cast<float *>(dS), 0, st));
  CAM_TRY(wgrad(w.ph, w.part_h, static_cast<float *>(dkh), st));
  CAM_TRY(wgrad(w.pt, w.part_t, static_cast<float *>(dkt), st));
  return static_cast<int>(tile::launch_dx_wg<false, false>(
      g, t, D, nullptr, w.dc, static_cast<const bf16 *>(w1), nullptr, 0.0f,
      static_cast<bf16 *>(dx), st));
}
