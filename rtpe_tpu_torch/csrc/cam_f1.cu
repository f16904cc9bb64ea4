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
// bf16 HWIO (the JAX layout).  Both (2-D tiles, one halo per tile, 16-byte
// async copies; cam_tile.cuh) read x padded to kc channels and the
// weights re-laid by ops/cam.py:_tile_weights, the same w0 for both.
// Where make_tgeo takes the wide plan, F1 runs f1_wg_kernel and F1b's
// phase 0 f1b_wg_kernel (cam_wg.cuh: wgmma, whole branches, F1's products
// in F1's order) on their own layout (_wg_weights), and F1b's phase 1
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
namespace tile {

// F1 on one 8 x 8 tile: the per-tile partial row [S_r (2C) | S_h (2 NH) |
// the sum of x (C)], the first two the column sums of bf16(x . kr) and
// of each branch's bf16(c) and their squares over the tile's pixels in the
// image (a pixel outside it is masked: its taps can reach into the image).
// Where make_tgeo takes the wide plan, f1_wg_kernel (cam_wg.cuh) runs
// instead.
__global__ void __launch_bounds__(TT, 1)
f1_tile_kernel(Geo g, TGeo t, const bf16 *__restrict__ xpad,
               const bf16 *__restrict__ w0, float *__restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xp = g.kc + 8, C = g.C;
  const int wbuf = WROWS * (t.kw0 + 8);
  bf16 *sH = reinterpret_cast<bf16 *>(smem);
  bf16 *sW = sH + t.hr * xp;                // NBUF buffers
  const Lane L = lane_of(t);
  const uint32_t aH = halo_row(sH, xp, t, L);
  float *prow = part + static_cast<int64_t>(blockIdx.x) * (3 * C + 2 * g.NH);
  Ring ring{w0, sW, wbuf, L.lane, 0};

  stage_halo(sH, xpad, g.kc, g, t, L.pos);
  ring.start(g, t);

  // the lane's fragment rows in the image (e < 2: row r, else r + 8)
  const bool in0 = tile_pix(g, L.pos, frag_row(L.wm, L.lane, 0)) >= 0;
  const bool in1 = tile_pix(g, L.pos, frag_row(L.wm, L.lane, 2)) >= 0;
  constexpr int GB = (NTB + 1) / 2;
  auto epi_h = [&](const Slice &sl, const Split &sb,
                   const float (&acc)[GB][4]) {
    float v[GB][4];
#pragma unroll
    for (int j = 0; j < GB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[j][e] = (e < 2 ? in0 : in1) ? bfr(acc[j][e]) : 0.0f;
    ring_colsums<GB>(v, L, sb.j0, L.wn ? NTB - GB : GB, ring.spent(),
                     prow + 2 * C + 2 * sl.i * g.hc + sl.s0, g.hc, sl.w);
  };
  constexpr int GC = (NTC + 1) / 2;
  auto epi_r = [&](int n0, const Split &sc, float (&acr)[GC][4],
                   float (&)[GC][4]) {
    float v[GC][4];
#pragma unroll
    for (int j = 0; j < GC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[j][e] = (e < 2 ? in0 : in1) ? bfr(acr[j][e]) : 0.0f;
    ring_colsums<GC>(v, L, sc.j0, L.wn ? NTC - GC : GC, ring.spent(),
                     prow + n0, C, C - n0 < NC ? C - n0 : NC);
  };
  branch_convs(g, t, ring, aH, L, epi_h);
  conv1x1_chunks<true, false>(g, t, ring, aH, 0, L, epi_r);
  // the sum of x over the halo's 64 centre rows (zero outside the image)
  const bf16 *centre = sH + (t.dmax * t.hs + t.dmax) * xp;
  for (int c = threadIdx.x; c < C; c += TT) {
    float acc = 0.0f;
    for (int r = 0; r < TP; ++r)
      acc += bf2f(centre[((r >> 3) * t.hs + (r & 7)) * xp + c]);
    prow[2 * C + 2 * g.NH + c] = acc;
  }
}

// Phase 0 of F1b on one 8 x 8 tile: dc (M, nb khc) and dr (M, kc) in
// bf16 with zero padding columns, dc_i = bf16(dsh[2i] + 2 c_i dsh[2i+1]),
// dr = bf16(dsr[0] + 2 bf16(x . kr) dsr[1]).  No per-tile sums.  Where
// make_tgeo takes the wide plan, f1b_wg_kernel (cam_wg.cuh) runs instead.
__global__ void __launch_bounds__(TT, 1)
f1b_tile_kernel(Geo g, TGeo t, const bf16 *__restrict__ xpad,
                const bf16 *__restrict__ w0, const float *__restrict__ dsr,
                const float *__restrict__ dsh, bf16 *__restrict__ dr_out,
                bf16 *__restrict__ dc_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xp = g.kc + 8, C = g.C;
  const int wbuf = WROWS * (t.kw0 + 8);
  bf16 *sH = reinterpret_cast<bf16 *>(smem);
  bf16 *sW = sH + t.hr * xp;                // NBUF buffers
  float *sDr = reinterpret_cast<float *>(sW + NBUF * wbuf);
  float *sDh = sDr + 2 * C;
  const Lane L = lane_of(t);
  const uint32_t aH = halo_row(sH, xp, t, L);
  Ring ring{w0, sW, wbuf, L.lane, 0};

  stage_halo(sH, xpad, g.kc, g, t, L.pos);
  ring.start(g, t);
  for (int i = threadIdx.x; i < 2 * C; i += TT) sDr[i] = dsr[i];
  for (int i = threadIdx.x; i < 2 * g.NH; i += TT) sDh[i] = dsh[i];

  constexpr int GB = (NTB + 1) / 2;
  auto epi_h = [&](const Slice &sl, const Split &sb,
                   const float (&acc)[GB][4]) {
    const int i = sl.i;
#pragma unroll
    for (int j = 0; j < GB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = frag_col(L.lane, sb.j0 + j, e);
        const int64_t p = tile_pix(g, L.pos, frag_row(L.wm, L.lane, e));
        if (n >= sl.w || p < 0) continue;
        const int col = sl.s0 + n;
        const float cb = bfr(acc[j][e]);
        const float dc = __fadd_rn(
            sDh[2 * i * g.hc + col],
            __fmul_rn(__fmul_rn(2.0f, cb), sDh[(2 * i + 1) * g.hc + col]));
        dc_out[p * t.ldc + i * g.khc + col] = f2bf(dc);
      }
  };
  constexpr int GC = (NTC + 1) / 2;
  auto epi_r = [&](int n0, const Split &sc, float (&acr)[GC][4],
                   float (&)[GC][4]) {
#pragma unroll
    for (int j = 0; j < GC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n0 + frag_col(L.lane, sc.j0 + j, e);
        const int64_t p = tile_pix(g, L.pos, frag_row(L.wm, L.lane, e));
        if (p < 0 || c >= C || j >= sc.cnt) continue;
        const float rb = bfr(acr[j][e]);
        dr_out[p * g.kc + c] = f2bf(
            __fadd_rn(sDr[c], __fmul_rn(__fmul_rn(2.0f, rb), sDr[C + c])));
      }
  };
  branch_convs(g, t, ring, aH, L, epi_h);
  conv1x1_chunks<true, false>(g, t, ring, aH, 0, L, epi_r);
  zero_pad_cols(dr_out, g.kc, 1, g.kc, C, g, L.pos);
  zero_pad_cols(dc_out, t.ldc, g.nb, g.khc, g.hc, g, L.pos);
}

}  // namespace tile
}  // namespace cam

namespace cam {
namespace {

struct F1bWs {
  bf16 *dr, *dc;
  float *part_h, *part_r;
  WgPlan ph, pr;   // dkh; dkr
  bool ok;
};

// dr (M, kc) and dc (M, nb khc) keep the zero padding the tile kernels
// stage; then the weight gradients' partial rows.  xpad may be null for
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

// F1's tile plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f1_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F1, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0 the weights
// re-laid by ops/cam.py:_tile_weights("f1", ...) (_wg_weights where
// f1_wg_kernel runs).  s_r (2, C), s_h (2 nb, hc), gap (B, C) f32: the
// sums (gap not yet divided by H W).  ws: cam_f1_workspace(geo) bytes.
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
  if (t.wide)
    CAM_TRY(CAM_WG_LAUNCH(tile::f1_wg_kernel, g, t, P, st, xx, w, part));
  else
    CAM_TRY(tile::launch(tile::f1_tile_kernel, dim3(t.n_tiles),
                         tile::smem0_bytes(g, t), st, g, t, xx, w, part));
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

// F1b's tile plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f1b_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F1B, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0, w1 the weights
// re-laid by ops/cam.py:_tile_weights("f1b", ...) (_wg_weights and
// _dx_weights on the wide plan).  dx (B, H, W, C) bf16, dkr (C, C) f32, dkh
// (nb, 3, 3, C, hc) f32.
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
  if (t.wide)
    CAM_TRY(CAM_WG_LAUNCH(tile::f1b_wg_kernel, g, t, P, st, xx, w_, r, h,
                          w.dr, w.dc));
  else
    CAM_TRY(tile::launch(tile::f1b_tile_kernel, dim3(t.n_tiles),
                         tile::smem0_bytes(g, t), st, g, t, xx, w_, r, h,
                         w.dr, w.dc));
  CAM_TRY(wgrad(w.ph, w.part_h, static_cast<float *>(dkh), st));
  CAM_TRY(wgrad(w.pr, w.part_r, static_cast<float *>(dkr), st));
  const float inv_n = static_cast<float>(1.0 / g.HW);
  return static_cast<int>(tile::launch_phase1<true, true>(
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
