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
// bnh (4 nb, hc) f32 rows [mean, inv, scale, bias] per branch.  Both (2-D
// tiles, one halo per tile, 16-byte async copies; cam_tile.cuh) read x
// padded to kc channels and the weights re-laid by
// ops/cam.py:_tile_weights; F2's w0 is the prefix of F2b's before its
// kt[i] stages.  F2 is F2b's phase 0 without the branch backward: the
// branch convs into sA (shared memory only), the kt^T chunks, and an
// epilogue that rounds t to bf16 and sums t and t^2 per column over the
// tile's pixels in the image, through a spent ring buffer
// (cam_tile.cuh:ring_colsums); the per-tile rows are summed in tile
// order (reduce_rows), no float atomics.  Where make_tgeo takes the wide
// plan, cam_wg.cuh's wgmma kernels run instead, on their own layout
// (_wg_weights, in which F2's w0 is again the prefix of F2b's):
// f2_wg_kernel (F2b's products without the branch backward, F1's column
// sums of bf16(t) and t^2 after each 64-column chunk, the same tile-order
// reduction), F2b's phase 0 f2b_wg_kernel (F3b's body without x kr^T)
// and its phase 1 dx_wg_kernel (_dx_weights).
//
// Bound at the steps' CAM (B=16, 113 x 113, C=163, hc=40, dils 1..3):
// operations.  F2 does 9 nb C hc + nb hc C = 195.6 K multiply-adds a
// pixel: 0.081 ms at 989 TFLOP/s (bf16 dense); F2b about 3x.  At
// --inplanes 128's step CAM (C = 259, hc = 64) 497.3 K, 0.206 ms.

#include "cam_wg.cuh"

namespace cam {
namespace tile {

// F2 on one 8 x 8 tile: the per-tile partial row [S_t sums (C) | S_t
// sums of squares (C)] of t = bf16(a . kt) over the tile's pixels in the
// image (a pixel outside it is masked: its BN bias and dilated taps make
// its t nonzero), a = bf16(relu(BN_h(bf16(c)))) kept in shared memory only.
// Where make_tgeo takes the wide plan, f2_wg_kernel (cam_wg.cuh) runs
// instead.
__global__ void __launch_bounds__(TT, 1)
f2_tile_kernel(Geo g, TGeo t, const bf16 *__restrict__ xpad,
               const bf16 *__restrict__ w0, const float *__restrict__ bnh,
               float *__restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xp = g.kc + 8, C = g.C;
  const int wbuf = WROWS * (t.kw0 + 8);
  bf16 *sH = reinterpret_cast<bf16 *>(smem);
  bf16 *sW = sH + t.hr * xp;                // NBUF buffers
  bf16 *sA = sW + NBUF * wbuf;
  float *sBh = reinterpret_cast<float *>(sA + TP * g.nhp);
  const Lane L = lane_of(t);
  const uint32_t aH = halo_row(sH, xp, t, L);
  float *prow = part + static_cast<int64_t>(blockIdx.x) * 2 * C;
  Ring ring{w0, sW, wbuf, L.lane, 0};

  stage_halo(sH, xpad, g.kc, g, t, L.pos);
  ring.start(g, t);
  for (int i = threadIdx.x; i < 4 * g.NH; i += TT) sBh[i] = bnh[i];
  zero_top_pads(g, sA, nullptr);

  // the lane's fragment rows in the image (e < 2: row r, else r + 8)
  const bool in0 = tile_pix(g, L.pos, frag_row(L.wm, L.lane, 0)) >= 0;
  const bool in1 = tile_pix(g, L.pos, frag_row(L.wm, L.lane, 2)) >= 0;
  constexpr int GC = (NTC + 1) / 2;
  auto epi_t = [&](int n0, const Split &sc, float (&)[GC][4],
                   float (&at)[GC][4]) {
    float v[GC][4];
#pragma unroll
    for (int j = 0; j < GC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[j][e] = (e < 2 ? in0 : in1) ? bfr(at[j][e]) : 0.0f;
    ring_colsums<GC>(v, L, sc.j0, L.wn ? NTC - GC : GC, ring.spent(),
                     prow + n0, C, C - n0 < NC ? C - n0 : NC);
  };
  branch_convs(g, t, ring, aH, L,
               ToActivations<false>{g, L, sBh, nullptr, sA, nullptr});
  conv1x1_chunks<false, true>(g, t, ring, 0, tile_row(sA, g.nhp, L), L,
                              epi_t);
}

// Phase 0 of F2b on one 8 x 8 tile: a (M, knh), dt (M, kc) and dc
// (M, nb khc, zero padding columns) in bf16, dt = bf16(dst[0] + 2 t
// dst[1]); per-tile partial row dS_h (2 NH).  Where make_tgeo takes the
// wide plan, f2b_wg_kernel (cam_wg.cuh) runs instead.
__global__ void __launch_bounds__(TT, 1)
f2b_tile_kernel(Geo g, TGeo t, const bf16 *__restrict__ xpad,
                const bf16 *__restrict__ w0, const float *__restrict__ bnh,
                const float *__restrict__ dst, bf16 *__restrict__ a_out,
                bf16 *__restrict__ dt_out, bf16 *__restrict__ dc_out,
                float *__restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xp = g.kc + 8, C = g.C;
  const int wbuf = WROWS * (t.kw0 + 8);
  bf16 *sH = reinterpret_cast<bf16 *>(smem);
  bf16 *sW = sH + t.hr * xp;                // NBUF buffers
  bf16 *sCb = sW + NBUF * wbuf;
  bf16 *sA = sCb + TP * g.nhp;
  bf16 *sD = sA + TP * g.nhp;
  float *red = reinterpret_cast<float *>(sD + TP * xp);
  float *sDt = red + NWARPS * NRED * NC;    // dst rows, then bnh
  float *sBh = sDt + 2 * C;
  const Lane L = lane_of(t);
  const uint32_t aH = halo_row(sH, xp, t, L);
  float *prow_h = part + static_cast<int64_t>(blockIdx.x) * 2 * g.NH;
  Ring ring{w0, sW, wbuf, L.lane, 0};

  stage_halo(sH, xpad, g.kc, g, t, L.pos);
  ring.start(g, t);
  for (int i = threadIdx.x; i < 2 * C; i += TT) sDt[i] = dst[i];
  for (int i = threadIdx.x; i < 4 * g.NH; i += TT) sBh[i] = bnh[i];
  zero_top_pads(g, sA, sD);

  constexpr int GC = (NTC + 1) / 2;
  auto epi_t = [&](int n0, const Split &sc, float (&)[GC][4],
                   float (&at)[GC][4]) {
#pragma unroll
    for (int j = 0; j < GC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(L.wm, L.lane, e);
        const int c = n0 + frag_col(L.lane, sc.j0 + j, e);
        if (c >= C || j >= sc.cnt) continue;
        const int64_t p = tile_pix(g, L.pos, r);
        bf16 dtb = bzero();
        if (p >= 0) {
          const float tb = bfr(at[j][e]);
          dtb = f2bf(__fadd_rn(
              sDt[c], __fmul_rn(__fmul_rn(2.0f, tb), sDt[C + c])));
          dt_out[p * g.kc + c] = dtb;
        }
        sD[r * xp + c] = dtb;
      }
  };
  branch_convs(g, t, ring, aH, L,
               ToActivations<true>{g, L, sBh, sCb, sA, a_out});
  conv1x1_chunks<false, true>(g, t, ring, 0, tile_row(sA, g.nhp, L), L,
                              epi_t);
  branch_backward(g, t, ring, tile_row(sD, xp, L), sCb, sBh, red, L,
                  dc_out, prow_h);
  zero_pad_cols(dc_out, t.ldc, g.nb, g.khc, g.hc, g, L.pos);
}

}  // namespace tile
}  // namespace cam

namespace cam {
namespace {

struct F2bWs {
  bf16 *a, *dt, *dc, *cb;
  float *part, *part_h, *part_t;
  WgPlan ph, pt;   // dkh; dkt
  bool ok;
};

// dc (M, nb khc) keeps the zero padding the tile kernels stage; a
// (M, knh) and dt (M, kc) have 16-byte rows (their padding columns are
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
  w.cb = cv.take<bf16>(t.wide ? static_cast<int64_t>(g.M) * g.knh : 0);
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
  *a = cv.take<bf16>(t.wide && !P.a_res ? static_cast<int64_t>(g.M) * g.knh
                                        : 0);
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

// F2's tile plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f2_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F2, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0 the weights
// re-laid by ops/cam.py:_tile_weights("f2", ...) (_wg_weights where
// f2_wg_kernel runs).  s_t (2, C) f32.  ws: cam_f2_workspace(geo) bytes.
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
  if (t.wide)
    CAM_TRY(CAM_WG_LAUNCH(tile::f2_wg_kernel, g, t, P, st, xx, w, h, part,
                          a));
  else
    CAM_TRY(tile::launch(tile::f2_tile_kernel, dim3(t.n_tiles),
                         tile::smem0_bytes(g, t), st, g, t, xx, w, h, part));
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

// F2b's tile plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f2b_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F2B, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0, w1 the weights
// re-laid by ops/cam.py:_tile_weights("f2b", ...) (_wg_weights and
// _dx_weights on the wide plan).  dx (B, H, W, C) bf16,
// dkh (nb, 3, 3, C, hc), dkt (nb, hc, C) and dS (2 nb, hc) f32.
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
  if (t.wide)
    CAM_TRY(CAM_WG_LAUNCH(tile::f2b_wg_kernel, g, t, P, st, xx, w_, h, d,
                          w.a, w.dt, w.dc, w.part, w.cb));
  else
    CAM_TRY(tile::launch(tile::f2b_tile_kernel, dim3(t.n_tiles),
                         tile::smem0_bytes(g, t), st, g, t, xx, w_, h, d,
                         w.a, w.dt, w.dc, w.part));
  CAM_TRY(reduce_rows(w.part, 2 * g.NH, 0, 2 * g.NH, t.n_tiles, 1,
                      static_cast<float *>(dS), 0, st));
  CAM_TRY(wgrad(w.ph, w.part_h, static_cast<float *>(dkh), st));
  CAM_TRY(wgrad(w.pt, w.part_t, static_cast<float *>(dkt), st));
  return static_cast<int>(tile::launch_phase1<false, false>(
      g, t, D, nullptr, w.dc, static_cast<const bf16 *>(w1), nullptr, 0.0f,
      static_cast<bf16 *>(dx), st));
}
