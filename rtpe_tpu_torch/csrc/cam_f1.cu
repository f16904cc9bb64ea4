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
// bf16 HWIO: the JAX layout, read as it is by F1, whose design is in
// cam_core.cuh.  F1b (2-D tiles, one halo per tile, 16-byte async copies;
// cam_tile.cuh) reads x padded to kc channels and the weights re-laid by
// ops/cam.py:_tile_weights.
//
// Bound at the steps' CAM (B=16, 113 x 113, C=163, hc=40, dils 1..3):
// operations.  F1 does C^2 + 9 nb C hc = 202.6 K multiply-adds a pixel,
// 41.4 GMAC over 204,304 pixels: 0.084 ms at 989 TFLOP/s (bf16 dense)
// against 0.02 ms for the bytes (x read once).  F1b recomputes the convs,
// adds the same count of weight-gradient products and as many transposed
// products: about 3x F1.

#include "cam_tile.cuh"

namespace cam {
namespace tile {

// Phase 0 of F1b on one 8 x 8 tile: dc (M, nb khc) and dr (M, kc) in
// bf16 with zero padding columns, dc_i = bf16(dsh[2i] + 2 c_i dsh[2i+1]),
// dr = bf16(dsr[0] + 2 bf16(x . kr) dsr[1]).  No per-tile sums.
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

  branch_convs(g, t, ring, aH, L, [&](int i, int r, int n, float v) {
    const int64_t p = tile_pix(g, L.pos, r);
    if (p < 0) return;
    const float cb = bfr(v);
    const float dc = __fadd_rn(
        sDh[2 * i * g.hc + n],
        __fmul_rn(__fmul_rn(2.0f, cb), sDh[(2 * i + 1) * g.hc + n]));
    dc_out[p * t.ldc + i * g.khc + n] = f2bf(dc);
  });
  constexpr int GC = (NTC + 1) / 2;
  conv1x1_chunks<true, false>(
      g, t, ring, aH, 0, L,
      [&](int n0, const Split &sc, float (&acr)[GC][4], float (&)[GC][4]) {
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
      });
  zero_pad_cols(dr_out, g.kc, 1, g.kc, C, g, L.pos);
  zero_pad_cols(dc_out, t.ldc, g.nb, g.khc, g.hc, g, L.pos);
}

}  // namespace tile
}  // namespace cam

namespace cam {
namespace {

// Per-tile partial row: [s_r (2C) | s_h (2 NH) | sum of x (C)].
__global__ void __launch_bounds__(THREADS)
f1_kernel(Geo g, const bf16 *__restrict__ x, const bf16 *__restrict__ kr,
          const bf16 *__restrict__ kh, float *__restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PixSmem s = pix_smem(g, smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = blockIdx.x, b = T / g.tpi, p0 = (T % g.tpi) * TP;
  const int nvalid = g.HW - p0 < TP ? g.HW - p0 : TP;
  float *prow = part + static_cast<int64_t>(T) * (3 * g.C + 2 * g.NH);

  stage_rows(s.sX, g.xp, x, g.C, 0, g.C, g.kc, g, b, p0, 0, 0);
  __syncthreads();
  for (int c = threadIdx.x; c < g.C; c += THREADS) {
    float acc = 0.0f;
    for (int r = 0; r < TP; ++r) acc += bf2f(s.sX[r * g.xp + c]);
    prow[2 * g.C + 2 * g.NH + c] = acc;
  }
  for (int n0 = 0; n0 < g.C; n0 += NC) {
    __syncthreads();
    stage_w(s.sW, g.xp, kr, g.C, g.C, g.C, n0, g.kc, NC);
    __syncthreads();
    float acc[NTC][4];
    zero_acc(acc);
    warp_mma<NTC>(acc, s.sX + warp * 16 * g.xp, g.xp, s.sW, g.xp, g.kc / 16,
                  lane);
    float v1[NTC][4], v2[NTC][4];
#pragma unroll
    for (int j = 0; j < NTC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = frag_row(warp, lane, e) < nvalid;
        v1[j][e] = ok ? bfr(acc[j][e]) : 0.0f;
        v2[j][e] = v1[j][e] * v1[j][e];
      }
    warp_colsum<NTC>(v1, s.red + warp * NRED * NC, lane);
    warp_colsum<NTC>(v2, s.red + warp * NRED * NC + NC, lane);
    __syncthreads();
    for (int c = threadIdx.x; c < NC && n0 + c < g.C; c += THREADS) {
      prow[n0 + c] = block_col(s.red, 0, c);
      prow[g.C + n0 + c] = block_col(s.red, 1, c);
    }
  }
  for (int i = 0; i < g.nb; ++i) {
    float acc[NTB][4];
    branch_conv(acc, g, x, kh, i, b, p0, s.sX, s.sW);
    float v1[NTB][4], v2[NTB][4];
#pragma unroll
    for (int j = 0; j < NTB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = frag_row(warp, lane, e) < nvalid;
        v1[j][e] = ok ? bfr(acc[j][e]) : 0.0f;
        v2[j][e] = v1[j][e] * v1[j][e];
      }
    warp_colsum<NTB>(v1, s.red + warp * NRED * NC, lane);
    warp_colsum<NTB>(v2, s.red + warp * NRED * NC + NC, lane);
    __syncthreads();
    for (int c = threadIdx.x; c < g.hc; c += THREADS) {
      prow[2 * g.C + 2 * i * g.hc + c] = block_col(s.red, 0, c);
      prow[2 * g.C + (2 * i + 1) * g.hc + c] = block_col(s.red, 1, c);
    }
  }
}

struct F1bWs {
  bf16 *dr, *dc;
  float *part_h, *part_r;
};

// dr (M, kc) and dc (M, nb khc) keep the zero padding the tile kernels
// stage.
F1bWs carve_f1b(const Geo &g, const tile::TGeo &t, void *base,
                int64_t *bytes) {
  Carve cv(base);
  F1bWs w;
  w.dr = cv.take<bf16>(static_cast<int64_t>(g.M) * g.kc);
  w.dc = cv.take<bf16>(static_cast<int64_t>(g.M) * t.ldc);
  w.part_h = cv.take<float>(
      wgrad_part_floats(g, static_cast<int64_t>(9) * g.NH * g.C));
  w.part_r = cv.take<float>(
      wgrad_part_floats(g, static_cast<int64_t>(g.C) * g.C));
  *bytes = cv.off;
  return w;
}

}  // namespace
}  // namespace cam

using namespace cam;

extern "C" long long cam_f1_workspace(const int *geo) {
  Geo g;
  if (!make_geo(geo, &g)) return -1;
  Carve cv(nullptr);
  cv.take<float>(static_cast<int64_t>(g.n_tiles) * (3 * g.C + 2 * g.NH));
  return cv.off;
}

// s_r (2, C), s_h (2 nb, hc), gap (B, C) f32: the sums (gap not yet
// divided by H W).  ws: cam_f1_workspace(geo) bytes.
extern "C" int cam_f1_launch(const int *geo, const void *x, const void *kr,
                             const void *kh, void *ws, void *s_r, void *s_h,
                             void *gap, void *stream) {
  Geo g;
  if (!make_geo(geo, &g)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto *part = static_cast<float *>(ws);
  CAM_TRY(set_pix_smem(f1_kernel, g));
  f1_kernel<<<g.n_tiles, THREADS, pix_smem_bytes(g), st>>>(
      g, static_cast<const bf16 *>(x), static_cast<const bf16 *>(kr),
      static_cast<const bf16 *>(kh), part);
  CAM_TRY(cudaGetLastError());
  const int64_t ld = 3 * g.C + 2 * g.NH;
  CAM_TRY(reduce_rows(part, ld, 0, 2 * g.C, g.n_tiles, 1,
                      static_cast<float *>(s_r), 0, st));
  CAM_TRY(reduce_rows(part, ld, 2 * g.C, 2 * g.NH, g.n_tiles, 1,
                      static_cast<float *>(s_h), 0, st));
  CAM_TRY(reduce_rows(part, ld, 2 * g.C + 2 * g.NH, g.C, g.tpi, g.B,
                      static_cast<float *>(gap), g.C, st));
  return 0;
}

extern "C" long long cam_f1b_workspace(const int *geo) {
  Geo g;
  tile::TGeo t;
  if (!tile::tile_geo(geo, tile::F1B, &g, &t)) return -1;
  int64_t bytes = 0;
  carve_f1b(g, t, nullptr, &bytes);
  return bytes;
}

// F1b's tile plan (cam_tile.cuh:tile_plan).
extern "C" long long cam_f1b_plan(const int *geo, int what) {
  return tile::tile_plan(geo, tile::F1B, what);
}

// xpad (B, H, W, kc) bf16, x with zero channels C..kc; w0, w1 the weights
// re-laid by ops/cam.py:_tile_weights("f1b", ...).  dx (B, H, W, C) bf16,
// dkr (C, C) f32, dkh (nb, 3, 3, C, hc) f32.
extern "C" int cam_f1b_launch(const int *geo, const void *xpad,
                              const void *w0, const void *w1,
                              const void *dsr, const void *dsh,
                              const void *dgap, void *ws, void *dx,
                              void *dkr, void *dkh, void *stream) {
  Geo g;
  tile::TGeo t;
  if (!tile::tile_geo(geo, tile::F1B, &g, &t))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int64_t bytes = 0;
  const F1bWs w = carve_f1b(g, t, ws, &bytes);
  const auto *xx = static_cast<const bf16 *>(xpad);
  CAM_TRY(tile::launch(tile::f1b_tile_kernel, dim3(t.n_tiles),
                       tile::smem0_bytes(g, t), st, g, t, xx,
                       static_cast<const bf16 *>(w0),
                       static_cast<const float *>(dsr),
                       static_cast<const float *>(dsh), w.dr, w.dc));
  CAM_TRY(wgrad<NTB>(tile::dkh_jobs(g, t, xx, w.dc), g, g.C, g.hc, w.part_h,
                     static_cast<int64_t>(9) * g.NH * g.C,
                     static_cast<float *>(dkh), st));
  WJobs jr;
  jr.n = 1;
  jr.j[0] = plain_job(xx, g.kc, g.C, w.dr, g.kc, g.C, 0);
  CAM_TRY(wgrad<NTC>(jr, g, g.C, g.C, w.part_r,
                     static_cast<int64_t>(g.C) * g.C,
                     static_cast<float *>(dkr), st));
  const float inv_n = static_cast<float>(1.0 / g.HW);
  return static_cast<int>(tile::launch_dx<true, true>(
      g, t, w.dr, w.dc, static_cast<const bf16 *>(w1),
      static_cast<const float *>(dgap), inv_n, static_cast<bf16 *>(dx), st));
}
