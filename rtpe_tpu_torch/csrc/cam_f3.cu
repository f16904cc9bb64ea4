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
// bias]; gate (B, C) f32.  Both (2-D tiles, one halo per tile, 16-byte
// async copies; cam_tile.cuh) read x padded to kc channels and the
// weights re-laid by ops/cam.py:_tile_weights; F3's w0 is the prefix of
// F3b's before its kt[i] stages.  Where make_tgeo takes the wide plan, F3
// runs f3_wg_kernel and F3b's phase 0 f3b_wg_kernel (cam_wg.cuh: wgmma,
// whole branches) on their own layout (_wg_weights), and F3b's phase 1
// dx_wg_kernel (_dx_weights).
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
namespace tile {

// F3 on one 8 x 8 tile: out (M, C) bf16 = relu(relu(BN_r(bf16(x . kr))) +
// relu(BN_t(bf16(a . kt))) gate[b]), a = bf16(relu(BN_h(bf16(c)))) kept
// in shared memory only; the _rn operations in the first design's order.
// Where make_tgeo takes the wide plan, f3_wg_kernel (cam_wg.cuh) runs
// instead.
__global__ void __launch_bounds__(TT, 1)
f3_tile_kernel(Geo g, TGeo t, const bf16 *__restrict__ xpad,
               const bf16 *__restrict__ w0, const float *__restrict__ bnr,
               const float *__restrict__ bnh, const float *__restrict__ bnt,
               const float *__restrict__ gate, bf16 *__restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xp = g.kc + 8, C = g.C;
  const int wbuf = WROWS * (t.kw0 + 8);
  bf16 *sH = reinterpret_cast<bf16 *>(smem);
  bf16 *sW = sH + t.hr * xp;                // NBUF buffers
  bf16 *sA = sW + NBUF * wbuf;
  float *sBr = reinterpret_cast<float *>(sA + TP * g.nhp);
  float *sBt = sBr + 4 * C;                 // then image b's gate, bnh
  float *sG = sBt + 4 * C;
  float *sBh = sG + C;
  const Lane L = lane_of(t);
  const uint32_t aH = halo_row(sH, xp, t, L);
  Ring ring{w0, sW, wbuf, L.lane, 0};

  stage_halo(sH, xpad, g.kc, g, t, L.pos);
  ring.start(g, t);
  for (int i = threadIdx.x; i < 4 * C; i += TT) {
    sBr[i] = bnr[i];
    sBt[i] = bnt[i];
  }
  for (int i = threadIdx.x; i < C; i += TT) sG[i] = gate[L.pos.b * C + i];
  for (int i = threadIdx.x; i < 4 * g.NH; i += TT) sBh[i] = bnh[i];
  zero_top_pads(g, sA, nullptr);

  constexpr int GC = (NTC + 1) / 2;
  auto epi = [&](int n0, const Split &sc, float (&acr)[GC][4],
                 float (&at)[GC][4]) {
#pragma unroll
    for (int j = 0; j < GC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n0 + frag_col(L.lane, sc.j0 + j, e);
        const int64_t p = tile_pix(g, L.pos, frag_row(L.wm, L.lane, e));
        if (p < 0 || c >= C || j >= sc.cnt) continue;
        const float res = relu(bn_apply(bfr(acr[j][e]), sBr[c],
                                        sBr[C + c], sBr[2 * C + c],
                                        sBr[3 * C + c]));
        const float y = relu(bn_apply(bfr(at[j][e]), sBt[c], sBt[C + c],
                                      sBt[2 * C + c], sBt[3 * C + c]));
        const float pre = __fadd_rn(res, __fmul_rn(y, sG[c]));
        out[p * C + c] = f2bf(relu(pre));
      }
  };
  branch_convs(g, t, ring, aH, L,
               ToActivations<false>{g, L, sBh, nullptr, sA, nullptr});
  conv1x1_chunks<true, true>(g, t, ring, aH, tile_row(sA, g.nhp, L), L,
                             epi);
}

// Phase 0 of F3b on one 8 x 8 tile: dr (M, kc), a (M, knh), dt (M, kc),
// dc (M, nb khc) in bf16 (dr and dc with zero padding columns); per-tile
// partial row [dSr (2C) | dSt (2C) | dS_h (2 NH) | dgate (C)].  Where
// make_tgeo takes the wide plan, f3b_wg_kernel (cam_wg.cuh) runs instead.
__global__ void __launch_bounds__(TT, 1)
f3b_tile_kernel(Geo g, TGeo t, const bf16 *__restrict__ xpad,
                const bf16 *__restrict__ w0, const float *__restrict__ bnr,
                const float *__restrict__ bnh, const float *__restrict__ bnt,
                const float *__restrict__ gate,
                const bf16 *__restrict__ gout, bf16 *__restrict__ dr_out,
                bf16 *__restrict__ a_out, bf16 *__restrict__ dt_out,
                bf16 *__restrict__ dc_out, float *__restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xp = g.kc + 8, C = g.C;
  const int wbuf = WROWS * (t.kw0 + 8);
  bf16 *sH = reinterpret_cast<bf16 *>(smem);
  bf16 *sW = sH + t.hr * xp;                // NBUF buffers
  bf16 *sCb = sW + NBUF * wbuf;
  bf16 *sA = sCb + TP * g.nhp;
  bf16 *sD = sA + TP * g.nhp;
  float *red = reinterpret_cast<float *>(sD + TP * xp);
  float *sBr = red + NWARPS * NRED * NC;    // bnr rows, then bnt, gate, bnh
  float *sBt = sBr + 4 * C;
  float *sG = sBt + 4 * C;
  float *sBh = sG + C;
  const Lane L = lane_of(t);
  const uint32_t aH = halo_row(sH, xp, t, L);
  float *prow = part + static_cast<int64_t>(blockIdx.x) * (5 * C + 2 * g.NH);
  Ring ring{w0, sW, wbuf, L.lane, 0};

  stage_halo(sH, xpad, g.kc, g, t, L.pos);
  ring.start(g, t);
  for (int i = threadIdx.x; i < 4 * C; i += TT) {
    sBr[i] = bnr[i];
    sBt[i] = bnt[i];
  }
  for (int i = threadIdx.x; i < C; i += TT) sG[i] = gate[L.pos.b * C + i];
  for (int i = threadIdx.x; i < 4 * g.NH; i += TT) sBh[i] = bnh[i];
  zero_top_pads(g, sA, sD);
  float *red_w = red + L.wm * NRED * NC;

  // the residual and top convs: their BN backward, dr, dt (-> sD), and
  // the five per-tile column sums
  constexpr int GC = (NTC + 1) / 2;
  auto epi = [&](int n0, const Split &sc, float (&acr)[GC][4],
                 float (&at)[GC][4]) {
    float vg[GC][4], vt1[GC][4], vt2[GC][4];
#pragma unroll
    for (int j = 0; j < GC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(L.wm, L.lane, e);
        const int c = n0 + frag_col(L.lane, sc.j0 + j, e);
        const int64_t p = tile_pix(g, L.pos, r);
        float dzr = 0.0f, rmm = 0.0f, dzt = 0.0f, tmm = 0.0f, dgy = 0.0f;
        bf16 dtb = bzero();
        if (p >= 0 && c < C && j < sc.cnt) {
          const float rb = bfr(acr[j][e]), tb = bfr(at[j][e]);
          const float mr = sBr[c], ir = sBr[C + c], sr = sBr[2 * C + c];
          const float mt = sBt[c], it = sBt[C + c], stt = sBt[2 * C + c];
          const float zr = bn_apply(rb, mr, ir, sr, sBr[3 * C + c]);
          const float zt = bn_apply(tb, mt, it, stt, sBt[3 * C + c]);
          const float y = relu(zt);
          const float gt = sG[c];
          const float pre = __fadd_rn(relu(zr), __fmul_rn(y, gt));
          const float d_o = pre > 0.0f ? bf2f(gout[p * C + c]) : 0.0f;
          dgy = __fmul_rn(d_o, y);
          dzr = zr > 0.0f ? d_o : 0.0f;
          rmm = __fsub_rn(rb, mr);
          dr_out[p * g.kc + c] = f2bf(__fmul_rn(dzr, __fmul_rn(sr, ir)));
          const float dy = __fmul_rn(d_o, gt);
          dzt = zt > 0.0f ? dy : 0.0f;
          tmm = __fsub_rn(tb, mt);
          dtb = f2bf(__fmul_rn(dzt, __fmul_rn(stt, it)));
          dt_out[p * g.kc + c] = dtb;
        }
        if (c < C && j < sc.cnt) sD[r * xp + c] = dtb;
        vg[j][e] = dgy;
        acr[j][e] = dzr;
        at[j][e] = __fmul_rn(dzr, rmm);
        vt1[j][e] = dzt;
        vt2[j][e] = __fmul_rn(dzt, tmm);
      }
    const int c0 = sc.j0 * 8, jn = L.wn ? NTC - GC : GC;  // its columns
    group_colsum<GC>(acr, red_w + c0, L.lane, jn);
    group_colsum<GC>(at, red_w + NC + c0, L.lane, jn);
    group_colsum<GC>(vt1, red_w + 2 * NC + c0, L.lane, jn);
    group_colsum<GC>(vt2, red_w + 3 * NC + c0, L.lane, jn);
    group_colsum<GC>(vg, red_w + 4 * NC + c0, L.lane, jn);
    __syncthreads();
    for (int c = threadIdx.x; c < NC && n0 + c < C; c += TT) {
      prow[n0 + c] = block_col(red, 0, c);
      prow[C + n0 + c] = block_col(red, 1, c);
      prow[2 * C + n0 + c] = block_col(red, 2, c);
      prow[3 * C + n0 + c] = block_col(red, 3, c);
      prow[4 * C + 2 * g.NH + n0 + c] = block_col(red, 4, c);
    }
  };
  branch_convs(g, t, ring, aH, L,
               ToActivations<true>{g, L, sBh, sCb, sA, a_out});
  conv1x1_chunks<true, true>(g, t, ring, aH, tile_row(sA, g.nhp, L), L,
                             epi);
  branch_backward(g, t, ring, tile_row(sD, xp, L), sCb, sBh, red, L,
                  dc_out, prow + 4 * C);
  zero_pad_cols(dr_out, g.kc, 1, g.kc, C, g, L.pos);
  zero_pad_cols(dc_out, t.ldc, g.nb, g.khc, g.hc, g, L.pos);
}

}  // namespace tile
}  // namespace cam

namespace cam {
namespace {

struct F3bWs {
  bf16 *dr, *a, *dt, *dc, *cb;
  float *part, *part_h, *part_rt;
  WgPlan ph, prt;   // dkh; dkr and dkt in one launch
  bool ok;
};

// dr (M, kc) and dc (M, nb khc) keep the zero padding the tile kernels
// stage; a (M, knh) and dt (M, kc) have 16-byte rows (their padding
// columns are written only where f3b_wg_kernel reads them back: only
// outputs k < NH, n < C of the weight gradients are kept); its c
// (M, knh) last.  xpad may be null for sizing.
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
  w.cb = cv.take<bf16>(t.wide ? static_cast<int64_t>(g.M) * g.knh : 0);
  *bytes = cv.off;
  return w;
}

}  // namespace
}  // namespace cam

using namespace cam;

// F3's tile plan (cam_wg.cuh:op_plan).
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
  cv.take<bf16>(t.wide && !P.a_res ? static_cast<int64_t>(g.M) * g.knh : 0);
  return cv.off;
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0 the weights
// re-laid by ops/cam.py:_tile_weights("f3", ...) (_wg_weights where
// f3_wg_kernel runs).  out (B, H, W, C) bf16.  ws: cam_f3_workspace(geo)
// bytes.
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
  if (t.wide)
    return static_cast<int>(CAM_WG_LAUNCH(tile::f3_wg_kernel, g, t, P, st,
                                          xx, w, r, h, tt, gt, o,
                                          static_cast<bf16 *>(ws)));
  return static_cast<int>(tile::launch(tile::f3_tile_kernel,
                                       dim3(t.n_tiles),
                                       tile::smem0_bytes(g, t), st, g, t, xx,
                                       w, r, h, tt, gt, o));
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

// F3b's tile plan (cam_wg.cuh:op_plan).
extern "C" long long cam_f3b_plan(const int *geo, int what) {
  return tile::op_plan(geo, tile::F3B, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0, w1 the weights
// re-laid by ops/cam.py:_tile_weights("f3b", ...) (_wg_weights and
// _dx_weights on the wide plan).  dx (B, H, W, C) bf16;
// dkr (C, C), dkh (nb, 3, 3, C, hc), dkt (nb, hc, C), dSr (2, C),
// dSh (2 nb, hc), dSt (2, C), dgate (B, C) f32.
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
  if (t.wide)
    CAM_TRY(CAM_WG_LAUNCH(tile::f3b_wg_kernel, g, t, P, st, xx, w_, r, h, tt,
                          gt, go, w.dr, w.a, w.dt, w.dc, w.part, w.cb));
  else
    CAM_TRY(tile::launch(tile::f3b_tile_kernel, dim3(t.n_tiles),
                         tile::smem0_bytes(g, t), st, g, t, xx, w_, r, h, tt,
                         gt, go, w.dr, w.a, w.dt, w.dc, w.part));
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
  return static_cast<int>(tile::launch_phase1<true, false>(
      g, t, D, w.dr, w.dc, static_cast<const bf16 *>(w1), nullptr, 0.0f,
      static_cast<bf16 *>(dx), st));
}
