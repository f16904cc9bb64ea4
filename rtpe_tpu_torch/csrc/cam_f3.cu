// Fused CAM op F3 and its backward F3b, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of rtpe_tpu/ops/pallas_cam.py:
//   F3  (_f3_call, _f3_kernel): the CAM output
//       out = bf16(relu(res + y gate[b])), res = relu(BN_r(bf16(x . kr))),
//       y = relu(BN_t(bf16(t))), t the top conv over the normalised
//       branches (as F2);
//   F3b (_f3b_call, _f3b_kernel): given the output cotangent g, the full
//       recompute; do = (pre > 0) g, dgate[b] = sum do y, the residual and
//       top BN backward (dSr, dSt, dr, dt), dkr = sum x^T bf16(dr),
//       dkt[i] = sum a_i^T bf16(dt), the branch backward as F2b (dS_h, dc,
//       dkh) (phase 0), then dx = bf16(dr) . kr^T + sum_i convT_i(dc_i)
//       (phase 1).
// x (B, H, W, C) bf16, kr (C, C), kh (nb, 3, 3, C, hc), kt (nb, hc, C)
// bf16; bnr, bnt (4, C) and bnh (4 nb, hc) f32 rows [mean, inv, scale,
// bias]; gate (B, C) f32.  F3 runs f3_wg_kernel and F3b's phase 0
// f3b_wg_kernel (cam_wg.cuh: 8 x 8-pixel tiles, wgmma, whole branches),
// both on x padded to kc channels and the weights re-laid by
// ops/cam.py:_wg_weights (F3's the prefix of F3b's before its kt[i]^T
// stages); F3b's phase 1 runs dx_wg_kernel (_dx_weights).
//
// Fault of the TPU kernel not copied: _f3b_kernel's phase 1 reads image
// 0's gate for every image (pallas_cam.py:507, gate_ref[0:1, :]), so its
// dx is wrong for images b >= 1.  Here both phases use image b's gate:
// phase 0 writes dr with it and phase 1 only reads dr.
//
// Bound at the steps' CAM (B=16, 113 x 113, C=163, hc=40, dils 1..3):
// operations.  F3 does C^2 + 9 nb C hc + nb hc C = 222.2 K multiply-adds
// a pixel: 0.092 ms at 989 TFLOP/s (bf16 dense); F3b 3x: 0.275 ms.

#include "cam_wg.cuh"

namespace cam {
namespace {

struct F3bWs {
  bf16 *dr, *a, *dt, *dc, *cb;
  float *part, *part_h, *part_rt;
  WgPlan ph, prt;   // dkh; dkr and dkt in one launch
  bool ok;
};

// dr (M, kc) and dc (M, nb khc) with zero padding columns, as f3b_wg_kernel
// writes them; a (M, knh) and dt (M, kc) have 16-byte rows (their padding
// columns are written only where f3b_wg_kernel reads them back: only outputs k
// < NH, n < C of the weight gradients are kept); its c (M, knh) last.  xpad
// may be null for sizing.
F3bWs carve_f3b(const Geo &g, const tile::TGeo &t, void *base,
                const bf16 *xpad, int64_t *bytes) {
  Carve cv(base);
  F3bWs w;
  w.dr = cv.take<bf16>(static_cast<int64_t>(g.M) * g.kc);
  w.a = cv.take<bf16>(static_cast<int64_t>(g.M) * g.knh);
  w.dt = cv.take<bf16>(static_cast<int64_t>(g.M) * g.kc);
  w.dc = cv.take<bf16>(static_cast<int64_t>(g.M) * t.ldc);
  w.part = cv.take<float>(static_cast<int64_t>(t.n_tiles) *
                          (5 * g.C + 2 * g.NH));
  // dkr and dkt end to end: dkr (C, C), then dkt (NH, C)
  const int64_t n_rr = static_cast<int64_t>(g.C) * g.C;
  const WgJob jrt[2] = {plain_job(xpad, g.kc, g.C, w.dr, g.kc, g.C, 0),
                        plain_job(w.a, g.knh, g.NH, w.dt, g.kc, g.C, n_rr)};
  w.ok = tile::dkh_plan(g, t, xpad, w.dc, &w.ph) &&
         plain_plan(jrt, 2, n_rr + static_cast<int64_t>(g.NH) * g.C, g,
                    &w.prt);
  if (w.ok) {
    w.part_h = cv.take<float>(wg_part_floats(w.ph));
    w.part_rt = cv.take<float>(wg_part_floats(w.prt));
  }
  w.cb = cv.take<bf16>(static_cast<int64_t>(g.M) * g.knh);
  *bytes = cv.off;
  return w;
}

}  // namespace
}  // namespace cam

using namespace cam;

// F3's plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f3_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F3, what);
}

// F3's workspace, bytes: a (M, knh) bf16 where f3_wg_kernel keeps it out
// of shared memory, else none.
extern "C" long long cam_f3_workspace(const int *geo) {
  Geo g;
  tile::TGeo t;
  tile::FPlan P;
  if (!tile::fwd_geo(geo, tile::F3, &g, &t, &P)) return -1;
  Carve cv(nullptr);
  cv.take<bf16>(P.a_res ? 0 : static_cast<int64_t>(g.M) * g.knh);
  return cv.off;
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0 the weights re-laid
// by ops/cam.py:_wg_weights("f3", ...).  out (B, H, W, C) bf16.  ws:
// cam_f3_workspace(geo) bytes.
extern "C" int cam_f3_launch(const int *geo, const void *xpad,
                             const void *w0, const void *bnr,
                             const void *bnh, const void *bnt,
                             const void *gate, void *ws, void *out,
                             void *stream) {
  Geo g;
  tile::TGeo t;
  tile::FPlan P;
  if (!tile::fwd_geo(geo, tile::F3, &g, &t, &P))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto *xx = static_cast<const bf16 *>(xpad);
  const auto *w = static_cast<const bf16 *>(w0);
  const auto *r = static_cast<const float *>(bnr);
  const auto *h = static_cast<const float *>(bnh);
  const auto *tt = static_cast<const float *>(bnt);
  const auto *gt = static_cast<const float *>(gate);
  auto *o = static_cast<bf16 *>(out);
  return static_cast<int>(CAM_WG_LAUNCH(tile::f3_wg_kernel, g, t, P, st, xx,
                                        w, r, h, tt, gt, o,
                                        static_cast<bf16 *>(ws)));
}

extern "C" long long cam_f3b_workspace(const int *geo) {
  Geo g;
  tile::TGeo t;
  tile::FPlan P;
  tile::DPlan D;
  if (!tile::bwd_geo(geo, tile::F3B, &g, &t, &P, &D)) return -1;
  int64_t bytes = 0;
  return carve_f3b(g, t, nullptr, nullptr, &bytes).ok ? bytes : -1;
}

// F3b's plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f3b_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F3B, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0, w1 the weights
// re-laid by ops/cam.py:_wg_weights("f3b", ...) and _dx_weights.  dx (B, H, W,
// C) bf16; dkr (C, C), dkh (nb, 3, 3, C, hc), dkt (nb, hc, C), dSr (2, C), dSh
// (2 nb, hc), dSt (2, C), dgate (B, C) f32.
extern "C" int cam_f3b_launch(const int *geo, const void *xpad,
                              const void *w0, const void *w1,
                              const void *bnr, const void *bnh,
                              const void *bnt, const void *gate,
                              const void *gout, void *ws, void *dx,
                              void *dkr, void *dkh, void *dkt, void *dSr,
                              void *dSh, void *dSt, void *dgate,
                              void *stream) {
  Geo g;
  tile::TGeo t;
  tile::FPlan P;
  tile::DPlan D;
  if (!tile::bwd_geo(geo, tile::F3B, &g, &t, &P, &D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int64_t bytes = 0;
  const auto *xx = static_cast<const bf16 *>(xpad);
  const F3bWs w = carve_f3b(g, t, ws, xx, &bytes);
  if (!w.ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto *w_ = static_cast<const bf16 *>(w0);
  const auto *r = static_cast<const float *>(bnr);
  const auto *h = static_cast<const float *>(bnh);
  const auto *tt = static_cast<const float *>(bnt);
  const auto *gt = static_cast<const float *>(gate);
  const auto *go = static_cast<const bf16 *>(gout);
  CAM_TRY(CAM_WG_LAUNCH(tile::f3b_wg_kernel, g, t, P, st, xx, w_, r, h, tt,
                        gt, go, w.dr, w.a, w.dt, w.dc, w.part, w.cb));
  const int64_t ld = 5 * g.C + 2 * g.NH;
  CAM_TRY(reduce_rows(w.part, ld, 0, 2 * g.C, t.n_tiles, 1,
                      static_cast<float *>(dSr), 0, st));
  CAM_TRY(reduce_rows(w.part, ld, 2 * g.C, 2 * g.C, t.n_tiles, 1,
                      static_cast<float *>(dSt), 0, st));
  CAM_TRY(reduce_rows(w.part, ld, 4 * g.C, 2 * g.NH, t.n_tiles, 1,
                      static_cast<float *>(dSh), 0, st));
  // tiles are numbered image-major: image b's tpi rows are contiguous
  CAM_TRY(reduce_rows(w.part, ld, 4 * g.C + 2 * g.NH, g.C, t.tpi, g.B,
                      static_cast<float *>(dgate), g.C, st));
  CAM_TRY(wgrad(w.ph, w.part_h, static_cast<float *>(dkh), st));
  // dkr and dkt in one walk; each range is reduced straight into its
  // output
  const int64_t n_rr = static_cast<int64_t>(g.C) * g.C;
  CAM_TRY(wgrad(w.prt, w.part_rt, nullptr, st));
  CAM_TRY(reduce_rows(w.part_rt, w.prt.total, 0, n_rr, w.prt.slots, 1,
                      static_cast<float *>(dkr), 0, st));
  CAM_TRY(reduce_rows(w.part_rt, w.prt.total, n_rr, w.prt.total - n_rr,
                      w.prt.slots, 1, static_cast<float *>(dkt), 0, st));
  return static_cast<int>(tile::launch_dx_wg<true, false>(
      g, t, D, w.dr, w.dc, static_cast<const bf16 *>(w1), nullptr, 0.0f,
      static_cast<bf16 *>(dx), st));
}
