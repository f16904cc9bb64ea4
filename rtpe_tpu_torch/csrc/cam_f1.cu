// Fused CAM op F1 and its backward F1b, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of rtpe_tpu/ops/pallas_cam.py:
//   F1  (_f1_call, _f1_kernel): the batch statistics of the CAM's convs,
//       s_r (2, C) = [sum, sum of squares] of bf16(x . kr), s_h (2 nb, hc)
//       the same of each bf16(conv3x3_dil_i(x)), and gap (B, C) = the sum
//       of x over each image's pixels;
//   F1b (_f1b_call, _f1b_kernel): given the cotangents dsr, dsh of those
//       sums and dgap of the mean gap, dc_i = dsh[2i] + 2 c_i dsh[2i+1]
//       and dr = dsr[0] + 2 rc dsr[1] (phase 0, with dkh = sum x_tap^T
//       bf16(dc_i) and dkr = sum x^T bf16(dr)), then
//       dx = bf16(dr) . kr^T + sum_i convT_i(bf16(dc_i)) + dgap[b] / (H W)
//       (phase 1).
// x (B, H, W, C) bf16 NHWC, kr (C, C) bf16 [in, out], kh (nb, 3, 3, C, hc)
// bf16 HWIO (the JAX layout).  F1 runs f1_wg_kernel and F1b's phase 0
// f1b_wg_kernel (cam_wg.cuh: 8 x 8-pixel tiles, wgmma, whole branches,
// F1's products in F1's order), both on x padded to kc channels and the
// same weights re-laid by ops/cam.py:_wg_weights; F1b's phase 1 runs
// dx_wg_kernel (_dx_weights).
//
// Bound at the steps' CAM (B=16, 113 x 113, C=163, hc=40, dils 1..3):
// operations.  F1 does C^2 + 9 nb C hc = 202.6 K multiply-adds a pixel,
// 41.4 GMAC over 204,304 pixels: 0.084 ms at 989 TFLOP/s (bf16 dense)
// against 0.02 ms for the bytes (x read once).  F1b recomputes the convs,
// adds the same count of weight-gradient products and as many transposed
// products: about 3x F1.
//
// This file also exports the weight-gradient kernels alone
// (cam_wgrad_workspace, cam_wgrad_plan, cam_wgrad_launch; ops/cam.py:
// cam_wgrad), which the card checks hold to a float64 product.

#include "cam_wg.cuh"

namespace cam {
namespace {

struct F1bWs {
  bf16 *dr, *dc;
  float *part_h, *part_r;
  WgPlan ph, pr;   // dkh; dkr
  bool ok;
};

// dr (M, kc) and dc (M, nb khc) with zero padding columns, as f1b_wg_kernel
// writes them; then the weight gradients' partial rows.  xpad may be null for
// sizing.
F1bWs carve_f1b(const Geo &g, const tile::TGeo &t, void *base,
                const bf16 *xpad, int64_t *bytes) {
  Carve cv(base);
  F1bWs w;
  w.dr = cv.take<bf16>(static_cast<int64_t>(g.M) * g.kc);
  w.dc = cv.take<bf16>(static_cast<int64_t>(g.M) * t.ldc);
  const WgJob jr = plain_job(xpad, g.kc, g.C, w.dr, g.kc, g.C, 0);
  w.ok = tile::dkh_plan(g, t, xpad, w.dc, &w.ph) &&
         plain_plan(&jr, 1, static_cast<int64_t>(g.C) * g.C, g, &w.pr);
  if (w.ok) {
    w.part_h = cv.take<float>(wg_part_floats(w.ph));
    w.part_r = cv.take<float>(wg_part_floats(w.pr));
  }
  *bytes = cv.off;
  return w;
}

}  // namespace
}  // namespace cam

using namespace cam;

// F1's per-tile partial rows, bytes.
extern "C" long long cam_f1_workspace(const int *geo) {
  Geo g;
  tile::TGeo t;
  tile::FPlan P;
  if (!tile::fwd_geo(geo, tile::F1, &g, &t, &P)) return -1;
  Carve cv(nullptr);
  cv.take<float>(static_cast<int64_t>(t.n_tiles) * (3 * g.C + 2 * g.NH));
  return cv.off;
}

// F1's plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f1_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F1, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0 the weights re-laid
// by ops/cam.py:_wg_weights("f1", ...).  s_r (2, C), s_h (2 nb, hc), gap (B,
// C) f32: the sums (gap not yet divided by H W).  ws: cam_f1_workspace(geo)
// bytes.
extern "C" int cam_f1_launch(const int *geo, const void *xpad,
                             const void *w0, void *ws, void *s_r, void *s_h,
                             void *gap, void *stream) {
  Geo g;
  tile::TGeo t;
  tile::FPlan P;
  if (!tile::fwd_geo(geo, tile::F1, &g, &t, &P))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto *part = static_cast<float *>(ws);
  const auto *xx = static_cast<const bf16 *>(xpad);
  const auto *w = static_cast<const bf16 *>(w0);
  CAM_TRY(CAM_WG_LAUNCH(tile::f1_wg_kernel, g, t, P, st, xx, w, part));
  const int64_t ld = 3 * g.C + 2 * g.NH;
  CAM_TRY(reduce_rows(part, ld, 0, 2 * g.C, t.n_tiles, 1,
                      static_cast<float *>(s_r), 0, st));
  CAM_TRY(reduce_rows(part, ld, 2 * g.C, 2 * g.NH, t.n_tiles, 1,
                      static_cast<float *>(s_h), 0, st));
  // tiles are numbered image-major: image b's tpi rows are contiguous
  CAM_TRY(reduce_rows(part, ld, 2 * g.C + 2 * g.NH, g.C, t.tpi, g.B,
                      static_cast<float *>(gap), g.C, st));
  return 0;
}

extern "C" long long cam_f1b_workspace(const int *geo) {
  Geo g;
  tile::TGeo t;
  if (!tile::tile_geo(geo, tile::F1B, &g, &t)) return -1;
  int64_t bytes = 0;
  return carve_f1b(g, t, nullptr, nullptr, &bytes).ok ? bytes : -1;
}

// F1b's plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f1b_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F1B, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0, w1 the weights
// re-laid by ops/cam.py:_wg_weights("f1b", ...) and _dx_weights.  dx (B, H, W,
// C) bf16, dkr (C, C) f32, dkh (nb, 3, 3, C, hc) f32.
extern "C" int cam_f1b_launch(const int *geo, const void *xpad,
                              const void *w0, const void *w1,
                              const void *dsr, const void *dsh,
                              const void *dgap, void *ws, void *dx,
                              void *dkr, void *dkh, void *stream) {
  Geo g;
  tile::TGeo t;
  tile::FPlan P;
  tile::DPlan D;
  if (!tile::bwd_geo(geo, tile::F1B, &g, &t, &P, &D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int64_t bytes = 0;
  const auto *xx = static_cast<const bf16 *>(xpad);
  const F1bWs w = carve_f1b(g, t, ws, xx, &bytes);
  if (!w.ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto *w_ = static_cast<const bf16 *>(w0);
  const auto *r = static_cast<const float *>(dsr);
  const auto *h = static_cast<const float *>(dsh);
  CAM_TRY(CAM_WG_LAUNCH(tile::f1b_wg_kernel, g, t, P, st, xx, w_, r, h,
                        w.dr, w.dc));
  CAM_TRY(wgrad(w.ph, w.part_h, static_cast<float *>(dkh), st));
  CAM_TRY(wgrad(w.pr, w.part_r, static_cast<float *>(dkr), st));
  const float inv_n = static_cast<float>(1.0 / g.HW);
  return static_cast<int>(tile::launch_dx_wg<true, true>(
      g, t, D, w.dr, w.dc, static_cast<const bf16 *>(w1),
      static_cast<const float *>(dgap), inv_n, static_cast<bf16 *>(dx), st));
}

// ------------------------------------------------------------ wgrad alone

namespace {

// p = {B, H, W, K, N, d, ldu, ldv}: u (B, H, W, ldu) and v (B, H, W, ldv)
// bf16, channels from 0; d >= 1: the 9 taps at dilation d, out
// (3, 3, K, N); d = 0: one unshifted product, out (K, N); float32.
bool wgrad_alone(const int *p, const void *u, const void *v, WgPlan *P) {
  if (p[5] < 0) return false;
  WgPlan q{};
  q.njobs = 1;
  q.job[0] = plain_job(static_cast<const bf16 *>(u), p[6], p[3],
                       static_cast<const bf16 *>(v), p[7], p[4], 0);
  q.job[0].d = p[5];
  const int taps = p[5] > 0 ? 9 : 1;
  q.total = static_cast<int64_t>(taps) * p[3] * p[4];
  if (!wg_plan(q, taps, p[0], p[1], p[2])) return false;
  *P = q;
  return true;
}

}  // namespace

// Bytes of cam_wgrad_launch's workspace (its partial rows), or -1.
extern "C" long long cam_wgrad_workspace(const int *p) {
  WgPlan P;
  if (!wgrad_alone(p, nullptr, nullptr, &P)) return -1;
  Carve cv(nullptr);
  cv.take<float>(wg_part_floats(P));
  return cv.off;
}

// cam_wgrad_launch's plan: what = 0 shared memory bytes, 1 partial rows,
// 2 m16 tiles a K slice, 3 tile rows, 4 ring stages, 5 tiles, 6 combos,
// 7 the wgmma's n8 tiles, 8 rows of a V plane, 9 blocks; -1 for an
// invalid call.
extern "C" long long cam_wgrad_plan(const int *p, int what) {
  WgPlan P;
  if (!wgrad_alone(p, nullptr, nullptr, &P)) return -1;
  const long long v[] = {wg_smem_bytes(P), P.slots, P.mt, P.ty, P.ns,
                         P.n_tiles, P.ncombo, P.nt, P.vrows, P.blocks};
  return what >= 0 && what < 10 ? v[what] : -1;
}

// The weight-gradient kernel alone (ops/cam.py:cam_wgrad) and its
// reduction into out; ws: cam_wgrad_workspace(p) bytes.
extern "C" int cam_wgrad_launch(const int *p, const void *u, const void *v,
                                void *ws, void *out, void *stream) {
  WgPlan P;
  if (!wgrad_alone(p, u, v, &P))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto *part = static_cast<float *>(ws);
  auto *o = static_cast<float *>(out);
  return static_cast<int>(wgrad(P, part, o, st));
}
