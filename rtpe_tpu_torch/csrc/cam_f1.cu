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
// bf16 HWIO: the JAX layout, read as it is.  Design in cam_core.cuh.
//
// Bound at the steps' CAM (B=16, 113 x 113, C=163, hc=40, dils 1..3):
// operations.  F1 does C^2 + 9 nb C hc = 202.6 K multiply-adds a pixel,
// 41.4 GMAC over 204,304 pixels: 0.084 ms at 989 TFLOP/s (bf16 dense)
// against 0.02 ms for the bytes (x read once).  F1b recomputes the convs,
// adds the same count of weight-gradient products and as many transposed
// products: about 3x F1.

#include "cam_core.cuh"

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
    stage_w(s.sW, g.xp, kr, g.C, true, g.C, g.C, n0, g.kc, NC);
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

// Phase 0 of F1b: dr (M, C) and dc (M, NH) in bf16.
__global__ void __launch_bounds__(THREADS)
f1b_kernel(Geo g, const bf16 *__restrict__ x, const bf16 *__restrict__ kr,
           const bf16 *__restrict__ kh, const float *__restrict__ dsr,
           const float *__restrict__ dsh, bf16 *__restrict__ dr_out,
           bf16 *__restrict__ dc_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PixSmem s = pix_smem(g, smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = blockIdx.x, b = T / g.tpi, p0 = (T % g.tpi) * TP;
  const int nvalid = g.HW - p0 < TP ? g.HW - p0 : TP;
  const int64_t pix0 = static_cast<int64_t>(b) * g.HW + p0;

  stage_rows(s.sX, g.xp, x, g.C, 0, g.C, g.kc, g, b, p0, 0, 0);
  for (int n0 = 0; n0 < g.C; n0 += NC) {
    __syncthreads();
    stage_w(s.sW, g.xp, kr, g.C, true, g.C, g.C, n0, g.kc, NC);
    __syncthreads();
    float acc[NTC][4];
    zero_acc(acc);
    warp_mma<NTC>(acc, s.sX + warp * 16 * g.xp, g.xp, s.sW, g.xp, g.kc / 16,
                  lane);
#pragma unroll
    for (int j = 0; j < NTC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(warp, lane, e), c = n0 + frag_col(lane, j, e);
        if (r >= nvalid || c >= g.C) continue;
        const float rb = bfr(acc[j][e]);
        const float dr =
            __fadd_rn(dsr[c], __fmul_rn(__fmul_rn(2.0f, rb), dsr[g.C + c]));
        dr_out[(pix0 + r) * g.C + c] = f2bf(dr);
      }
  }
  for (int i = 0; i < g.nb; ++i) {
    float acc[NTB][4];
    branch_conv(acc, g, x, kh, i, b, p0, s.sX, s.sW);
#pragma unroll
    for (int j = 0; j < NTB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(warp, lane, e), n = frag_col(lane, j, e);
        if (r >= nvalid || n >= g.hc) continue;
        const float cb = bfr(acc[j][e]);
        const float dc = __fadd_rn(
            dsh[2 * i * g.hc + n],
            __fmul_rn(__fmul_rn(2.0f, cb), dsh[(2 * i + 1) * g.hc + n]));
        dc_out[(pix0 + r) * g.NH + i * g.hc + n] = f2bf(dc);
      }
  }
}

struct F1bWs {
  bf16 *dr, *dc;
  float *part_h, *part_r;
};

F1bWs carve_f1b(const Geo &g, void *base, int64_t *bytes) {
  Carve cv(base);
  F1bWs w;
  w.dr = cv.take<bf16>(static_cast<int64_t>(g.M) * g.C);
  w.dc = cv.take<bf16>(static_cast<int64_t>(g.M) * g.NH);
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
  if (!make_geo(geo, &g)) return -1;
  int64_t bytes = 0;
  carve_f1b(g, nullptr, &bytes);
  return bytes;
}

// dx (B, H, W, C) bf16, dkr (C, C) f32, dkh (nb, 3, 3, C, hc) f32.
extern "C" int cam_f1b_launch(const int *geo, const void *x, const void *kr,
                              const void *kh, const void *dsr,
                              const void *dsh, const void *dgap, void *ws,
                              void *dx, void *dkr, void *dkh, void *stream) {
  Geo g;
  if (!make_geo(geo, &g)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int64_t bytes = 0;
  const F1bWs w = carve_f1b(g, ws, &bytes);
  const auto *xx = static_cast<const bf16 *>(x);
  const auto *krr = static_cast<const bf16 *>(kr);
  const auto *khh = static_cast<const bf16 *>(kh);
  CAM_TRY(set_pix_smem(f1b_kernel, g));
  f1b_kernel<<<g.n_tiles, THREADS, pix_smem_bytes(g), st>>>(
      g, xx, krr, khh, static_cast<const float *>(dsr),
      static_cast<const float *>(dsh), w.dr, w.dc);
  CAM_TRY(cudaGetLastError());
  CAM_TRY(wgrad<NTB>(dkh_jobs(g, xx, w.dc), g, g.C, g.hc, w.part_h,
                     static_cast<int64_t>(9) * g.NH * g.C,
                     static_cast<float *>(dkh), st));
  WJobs jr;
  jr.n = 1;
  jr.j[0] = plain_job(xx, g.C, g.C, w.dr, g.C, g.C, 0);
  CAM_TRY(wgrad<NTC>(jr, g, g.C, g.C, w.part_r,
                     static_cast<int64_t>(g.C) * g.C,
                     static_cast<float *>(dkr), st));
  const float inv_n = static_cast<float>(1.0 / g.HW);
  CAM_TRY((launch_dx<true, true>(g, w.dr, krr, w.dc, khh,
                                 static_cast<const float *>(dgap), inv_n,
                                 static_cast<bf16 *>(dx), st)));
  return 0;
}
