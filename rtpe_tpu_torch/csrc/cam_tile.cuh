// The 2-D tile kernels of F3b (the backward of the fused CAM op F3),
// CUDA C++ for sm_90a; only cam_f3.cu includes this header.
//
// Replaces, with cam_f3.cu, the TPU kernel _f3b_call / _f3b_kernel of
// rtpe_tpu/ops/pallas_cam.py (lines 675 and 388): phase 0, the full
// recompute of the CAM with the per-pixel cotangents and the per-tile
// sums (f3b_tile_kernel), and phase 1, dx (f3b_dx_kernel).
//
// Bound at the steps' CAM (B=16, 113 x 113, C=163, hc=40, dils 1..3):
// operations.  F3b does 3 x 222.2 K multiply-adds a pixel, 0.275 ms at
// 989 TFLOP/s (bf16 dense tensor cores).  The first design (cam_core.cuh,
// kept by F1, F1b, F2, F2b and F3) staged each tap's 64 shifted pixel rows
// and its weights one bf16 per lane, with a divide per row and element,
// 27 times per branch set: ~600 KB of x moved per 64-pixel tile, loads and
// MMAs never overlapped, and the dx kernel restaged the dc halo 27 times
// in each of 3 channel chunks.  What this design does about it:
//
//   - a tile is 8 x 8 pixels of one image (tiles numbered image-major, so
//     a per-tile partial is a per-image partial); its halo at the largest
//     dilation, (8 + 2 dmax)^2 pixel rows at full channel depth, is staged
//     once with 16-byte cp.async (zero fill outside the image through the
//     src-size operand) and every tap of every branch reads its A operand
//     straight out of it by per-lane ldmatrix row addresses: ~72 KB of x
//     per tile at C = 163 instead of ~600 KB, in 16-byte copies;
//   - the wrapper lays every weight out once per call in the order the
//     kernel walks it, [n][k] with k padded to 16 (ops/cam.py:
//     _f3b_weights), so each stage's B tile is one contiguous cp.async
//     copy, in a ring of three buffers: stages s + 1 and s + 2 load while
//     stage s multiplies; the copy loops keep their row and chunk indices
//     without a divide per chunk;
//   - 8 warps a block, 2 on each of the SM's 4 schedulers: one block fits
//     an SM (205 KB of shared memory at C = 163, 133 KB at 83), and a
//     single warp per scheduler exposed every latency of the MMA loop and
//     the epilogues (on one H100 at 700 W, phase 0 at the steps' shape
//     took 3.6 ms with 4 warps, 2.7 ms with 8).  The 4 row warps (16
//     pixel rows each) of each of 2 column groups split every product's
//     n8 tiles between the groups;
//   - the epilogues read the BN rows and image b's gate from shared
//     memory, staged once per tile;
//   - it reads a channel-padded copy of x (C -> kc, zeros) and writes dr
//     with pitch kc and dc with each branch padded to khc zero columns, so
//     every staged row is 16-byte aligned and its k padding is zero;
//   - phase 1 stages the tile's dr rows and one dc halo (all branches) and
//     computes up to 168 output channels per block (all of them at C = 163
//     and 83), so dc is staged once per tile;
//   - each output keeps the first design's accumulation order (branch
//     conv: taps 0..8, k-steps ascending; 1x1 convs: k-steps ascending;
//     dx: dr kr^T, then branch i, taps 0..8, k-steps over khc) on the same
//     mma.sync m16n8k16 bf16 -> f32 with the same zero padding, so every
//     per-pixel output (dr, a, dt, dc, dx) and the weight gradients built
//     from them are bitwise those of the first design; only the per-tile
//     sums (dS_r, dS_h, dS_t, dgate) add their pixels in another order.
//
// Ragged tiles: 113 = 14 x 8 + 1, so 15 x 15 tiles cover a 113 x 113
// image, 12.8 % more pixels than it has (57^2: 26 %, 29^2: 22 %); a pixel
// outside the image has zero rows, its outputs are not written and it adds
// 0 to every per-tile sum.

#pragma once

#include "cam_core.cuh"

namespace cam {
namespace tile {

constexpr int TS = 8;             // tile side; TS * TS == TP
constexpr int TT = 256;           // threads: 4 row warps x 2 column groups
constexpr int NW = TT / 32;
constexpr int WROWS = NC;         // rows of a phase-0 weight stage at most
constexpr int NBUF = 3;           // weight stages in shared memory
constexpr int NTX = 21;           // n8 tiles of a dx block
constexpr int NX = NTX * 8;       // output channels of a dx block
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of a block

inline int up8(int v) { return (v + 7) / 8 * 8; }

// The tiling of one F3b call; ops/cam.py:f3b_plan computes the same.
struct TGeo {
  int tiles_x, tpi, n_tiles;  // tiles per image row, per image, in all
  int dmax, hs, hr;           // largest dilation, halo side, halo rows
  int brows;                  // rows of a branch weight stage: hc to 8
  int nchr;                   // phase 0's 1x1-conv chunks of NC channels
  int kw0;                    // widest phase-0 stage: max(kc, knh)
  int ldc;                    // dc row pitch: nb khc
  int nst0;                   // phase-0 weight stages
  int nxr, nchx;              // dx stage rows, dx channel chunks
  int nksr, nst1;             // dx stages of dr kr^T, dx stages per chunk
};

inline TGeo make_tgeo(const Geo &g) {
  TGeo t;
  t.tiles_x = (g.W + TS - 1) / TS;
  t.tpi = t.tiles_x * ((g.H + TS - 1) / TS);
  t.n_tiles = g.B * t.tpi;
  t.dmax = 1;
  for (int i = 0; i < g.nb; ++i)
    t.dmax = g.dil[i] > t.dmax ? g.dil[i] : t.dmax;
  t.hs = TS + 2 * t.dmax;
  t.hr = t.hs * t.hs;
  t.brows = up8(g.hc);
  t.nchr = (g.C + NC - 1) / NC;
  t.kw0 = g.kc > g.knh ? g.kc : g.knh;
  t.ldc = g.nb * g.khc;
  t.nst0 = 9 * g.nb + 2 * t.nchr + g.nb;
  t.nxr = up8(g.C) < NX ? up8(g.C) : NX;
  t.nchx = (g.C + NX - 1) / NX;
  t.nksr = (g.kc + g.khc - 1) / g.khc;
  t.nst1 = t.nksr + 9 * g.nb;
  return t;
}

// Shared memory of phase 0: the x halo (hr x (kc + 8)), NBUF weight
// buffers (WROWS x (kw0 + 8)), sCb and sA (TP x nhp), sD (TP x (kc + 8))
// in bf16, then in f32 the column-sum scratch (NWARPS row warps) and the
// epilogues' BN rows and gate (bnr, bnt: 4C each; image b's gate: C;
// bnh: 4 NH).
inline int64_t smem0_bytes(const Geo &g, const TGeo &t) {
  const int64_t xp = g.kc + 8;
  const int64_t el = t.hr * xp + 1LL * NBUF * WROWS * (t.kw0 + 8) +
                     2LL * TP * g.nhp + TP * xp;
  return el * 2 + 4LL * (NWARPS * NRED * NC + 9LL * g.C + 4LL * g.NH);
}

// Shared memory of phase 1: the tile's dr rows (TP x (kc + 8)), the dc
// halo (hr x (ldc + 8)), NBUF weight buffers (nxr x (khc + 8)), bf16.
inline int64_t smem1_bytes(const Geo &g, const TGeo &t) {
  return 2LL * (TP * (g.kc + 8LL) + t.hr * (t.ldc + 8LL) +
                1LL * NBUF * t.nxr * (g.khc + 8));
}

// bf16 elements of the two re-laid weight buffers.
inline int64_t w0_elems(const Geo &g, const TGeo &t) {
  return 10LL * g.nb * t.brows * g.kc +
         static_cast<int64_t>(t.nchr) * NC * (g.kc + g.knh);
}
inline int64_t w1_elems(const Geo &g, const TGeo &t) {
  return static_cast<int64_t>(t.nchx) * t.nst1 * t.nxr * g.khc;
}

// Phase-0 weight stage s: its offset in w0, its rows and its k width.
// Order: the branch taps (nb x 9 of [brows][kc], kh^T), then per chunk of
// NC output channels kr^T [NC][kc] and kt^T [NC][knh], then per branch
// kt[i] [brows][kc].
__device__ __forceinline__ void stage0(const Geo &g, const TGeo &t, int s,
                                       int64_t *off, int *rows, int *kw) {
  const int nbr = 9 * g.nb;
  const int64_t wb = static_cast<int64_t>(t.brows) * g.kc;
  const int64_t pair = static_cast<int64_t>(NC) * (g.kc + g.knh);
  *rows = t.brows;
  *kw = g.kc;
  if (s < nbr) {
    *off = s * wb;
    return;
  }
  s -= nbr;
  if (s < 2 * t.nchr) {
    *off = nbr * wb + (s >> 1) * pair + ((s & 1) ? NC * g.kc : 0);
    *rows = NC;
    *kw = (s & 1) ? g.knh : g.kc;
    return;
  }
  *off = nbr * wb + t.nchr * pair + (s - 2 * t.nchr) * wb;
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t saddr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp16(uint32_t dst, const void *src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group (the newest stage) is still in flight.
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t a, uint32_t &r0, uint32_t &r1,
                                      uint32_t &r2, uint32_t &r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void ldsm2(uint32_t a, uint32_t &r0,
                                      uint32_t &r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// A lane's ldmatrix row for an A operand (16 rows x 16 k of a warp):
// fragment row (0..15) and k half (0 or 8).
__device__ __forceinline__ int lm_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
// ... and for a B tile pair stored [n][k]: n row (0..15) and k half.
__device__ __forceinline__ int lm_brow(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int lm_bk(int lane) {
  return ((lane >> 3) & 1) * 8;
}

// acc[j] += A (16 x 16 ksteps) . B^T for the first nt of its n8 tiles; a
// is this lane's A row address (lm_row, k half (lane >> 4) * 8), b its B
// address (lm_brow, lm_bk) at the group's first n8 tile of a [n][k] tile
// of pitch bp bytes.  Each acc[j] adds its k-steps in ascending order, as
// warp_mma does.
template <int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], uint32_t a,
                                         uint32_t b, int bp, int ksteps,
                                         int nt) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a0, a1, a2, a3;
    ldsm4(a + ks * 32, a0, a1, a2, a3);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) break;
      const uint32_t bj = b + j * 8 * bp + ks * 32;
      if (j + 1 < NT && j + 1 < nt) {
        uint32_t b0, b1, b2, b3;
        ldsm4(bj, b0, b1, b2, b3);
        mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
        mma_bf16(acc[j + 1], a0, a1, a2, a3, b2, b3);
      } else {
        uint32_t b0, b1;
        ldsm2(bj, b0, b1);
        mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
      }
    }
  }
}

// A warp's place in the block: row warp wm (pixel rows 16 wm ..) of
// column group wn, which takes n8 tiles [j0, j0 + cnt) of a product with
// nt of them, split NT ways as (NT + 1) / 2 + NT / 2.
struct Split {
  int j0, cnt;
};
template <int NT>
__device__ __forceinline__ Split split(int wn, int nt) {
  constexpr int H = (NT + 1) / 2;
  const int j0 = wn * H;
  const int c = nt - j0 < H ? nt - j0 : H;
  return {j0, c < 0 ? 0 : c};
}

// warp_colsum for a column group: the column sums of its first jn n8
// tiles (rows already masked to 0), in the same fixed order, into
// red_w[j * 8 + col]; the group's other tiles write nothing, so that the
// two groups never write each other's columns.
template <int NT>
__device__ __forceinline__ void group_colsum(const float (&v)[NT][4],
                                             float *red_w, int lane, int jn) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = v[j][h] + v[j][2 + h];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (lane < 4 && j < jn) red_w[j * 8 + lane * 2 + h] = x;
    }
}

// f(row, chunk) for rows x cpr 16-byte chunks, spread over the block
// without a divide per chunk: a warp covers 32 / cpr rows at a time
// (or one row in steps of 32 chunks when cpr > 32).
template <typename F>
__device__ __forceinline__ void for_chunks(int rows, int cpr, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (cpr > 32) {
    for (int r = warp; r < rows; r += NW)
      for (int c = lane; c < cpr; c += 32) f(r, c);
    return;
  }
  const int rpi = 32 / cpr, sub = lane / cpr, c = lane - sub * cpr;
  if (sub >= rpi) return;
  for (int r = warp * rpi + sub; r < rows; r += NW * rpi) f(r, c);
}

// Copy rows x kw bf16 (contiguous) into shared rows of pitch kw + 8.
__device__ __forceinline__ void copy_stage(bf16 *dst, const bf16 *src,
                                           int rows, int kw) {
  const uint32_t d = saddr(dst);
  for_chunks(rows, kw / 8, [&](int r, int c) {
    cp16(d + (r * (kw + 8) + c * 8) * 2,
         src + static_cast<int64_t>(r) * kw + c * 8, true);
  });
}

// The tile's place: image b, top-left pixel (y0, x0).
struct TilePos {
  int b, y0, x0;
};

__device__ __forceinline__ TilePos tile_pos(const TGeo &t, int T) {
  const int u = T % t.tpi;
  return {T / t.tpi, (u / t.tiles_x) * TS, (u % t.tiles_x) * TS};
}

// Flat pixel index (b H W + y W + x) of fragment row r (0..63) of the
// tile, or -1 for a pixel outside the image.
__device__ __forceinline__ int64_t tile_pix(const Geo &g, const TilePos &p,
                                            int r) {
  const int y = p.y0 + (r >> 3), x = p.x0 + (r & 7);
  if (y >= g.H || x >= g.W) return -1;
  return (static_cast<int64_t>(p.b) * g.H + y) * g.W + x;
}

// Stage the tile's halo of src (flat pixel rows of pitch ld, ld / 8 16-byte
// chunks each) into shared rows of pitch ld + 8, zero outside the image.
__device__ __forceinline__ void stage_halo(bf16 *dst, const bf16 *src, int ld,
                                           const Geo &g, const TGeo &t,
                                           const TilePos &p) {
  const uint32_t d = saddr(dst);
  for_chunks(t.hr, ld / 8, [&](int h, int c) {
    const int hy = h / t.hs;
    const int y = p.y0 - t.dmax + hy, x = p.x0 - t.dmax + h - hy * t.hs;
    const bool ok = y >= 0 && y < g.H && x >= 0 && x < g.W;
    const int64_t row = ok ? (static_cast<int64_t>(p.b) * g.H + y) * g.W + x
                           : 0;
    cp16(d + (h * (ld + 8) + c * 8) * 2, src + row * ld + c * 8, ok);
  });
}

// A ring of NBUF weight buffers, two stages in flight: wait until stage
// s has landed (s + 1 may still be loading), then, after the barrier (no
// warp still reads stage s - 1's buffer), start stage s + 2 there.  Every
// step commits one group, empty past the last stage, so that
// wait_group 1 always means "all but the newest".
__device__ __forceinline__ void next_stage(bf16 *dst, const bf16 *src,
                                           int rows, int kw, bool more) {
  cp_wait_one();
  __syncthreads();
  if (more) copy_stage(dst, src, rows, kw);
  cp_commit();
}

// ------------------------------------------------------------ phase 0

// Phase 0 of F3b on one 8 x 8 tile: dr (M, kc), a (M, NH), dt (M, C),
// dc (M, nb khc) in bf16 (dr and dc with zero padding columns); per-tile
// partial row [dSr (2C) | dSt (2C) | dS_h (2 NH) | dgate (C)].
__global__ void __launch_bounds__(TT, 1)
f3b_tile_kernel(Geo g, TGeo t, const bf16 *__restrict__ xpad,
                const bf16 *__restrict__ w0, const float *__restrict__ bnr,
                const float *__restrict__ bnh, const float *__restrict__ bnt,
                const float *__restrict__ gate,
                const bf16 *__restrict__ gout, bf16 *__restrict__ dr_out,
                bf16 *__restrict__ a_out, bf16 *__restrict__ dt_out,
                bf16 *__restrict__ dc_out, float *__restrict__ part) {
  constexpr int GB = (NTB + 1) / 2, GC = (NTC + 1) / 2;  // tiles per group
  extern __shared__ __align__(16) unsigned char smem[];
  const int xp = g.kc + 8;
  const int wbuf = WROWS * (t.kw0 + 8);      // one weight buffer
  bf16 *sH = reinterpret_cast<bf16 *>(smem);
  bf16 *sW = sH + t.hr * xp;                // NBUF buffers
  bf16 *sCb = sW + NBUF * wbuf;
  bf16 *sA = sCb + TP * g.nhp;
  bf16 *sD = sA + TP * g.nhp;
  float *red = reinterpret_cast<float *>(sD + TP * xp);
  float *sBr = red + NWARPS * NRED * NC;    // bnr rows, then bnt, gate, bnh
  float *sBt = sBr + 4 * g.C;
  float *sG = sBt + 4 * g.C;
  float *sBh = sG + g.C;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int T = blockIdx.x;
  const TilePos pos = tile_pos(t, T);
  const int C = g.C, ntb = t.brows / 8;
  const Split sb = split<NTB>(wn, ntb);
  float *prow = part + static_cast<int64_t>(T) * (5 * C + 2 * g.NH);
  float *red_w = red + wm * NRED * NC;

  // this lane's ldmatrix addresses: the halo at the pixel of its A row,
  // sA and sD at that row, and its B row in a weight tile
  const int lr = wm * 16 + lm_row(lane), ak = (lane >> 4) * 8;
  const uint32_t aH = saddr(sH + (((lr >> 3) + t.dmax) * t.hs +
                                  (lr & 7) + t.dmax) * xp + ak);
  const uint32_t aA = saddr(sA + lr * g.nhp + ak);
  const uint32_t aD = saddr(sD + lr * xp + ak);
  int64_t off;
  int rows, kw;

  stage_halo(sH, xpad, g.kc, g, t, pos);
  stage0(g, t, 0, &off, &rows, &kw);
  copy_stage(sW, w0 + off, rows, kw);
  cp_commit();
  stage0(g, t, 1, &off, &rows, &kw);     // nst0 >= 12
  copy_stage(sW + wbuf, w0 + off, rows, kw);
  cp_commit();
  for (int i = threadIdx.x; i < 4 * C; i += TT) {
    sBr[i] = bnr[i];
    sBt[i] = bnt[i];
  }
  for (int i = threadIdx.x; i < C; i += TT) sG[i] = gate[pos.b * C + i];
  for (int i = threadIdx.x; i < 4 * g.NH; i += TT) sBh[i] = bnh[i];
  // the K padding of sA (NH..knh) and sD (C..kc)
  const int pa = g.knh - g.NH, pd = g.kc - C;
  for (int i = threadIdx.x; i < TP * pa; i += TT)
    sA[(i / pa) * g.nhp + g.NH + i % pa] = bzero();
  for (int i = threadIdx.x; i < TP * pd; i += TT)
    sD[(i / pd) * xp + C + i % pd] = bzero();

  // stage s sits in buffer s % NBUF with pitch kw + 8: wait for it,
  // start stage s + 2, return this lane's B address in stage s
  int s = 0;
  auto advance = [&]() -> uint32_t {
    int64_t o = 0;
    int r = 0, k = 0;
    const bool more = s + 2 < t.nst0;
    if (more) stage0(g, t, s + 2, &o, &r, &k);
    next_stage(sW + ((s + 2) % NBUF) * wbuf, w0 + o, r, k, more);
    stage0(g, t, s, &off, &rows, &kw);
    const uint32_t b = saddr(sW + (s % NBUF) * wbuf +
                             lm_brow(lane) * (kw + 8) + lm_bk(lane));
    ++s;
    return b;
  };

  // the branch convs -> sCb = bf16(c), sA = bf16(relu(BN(c))), a_out
  for (int i = 0; i < g.nb; ++i) {
    const int d = g.dil[i];
    float acc[GB][4];
    zero_acc(acc);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t b = advance() + sb.j0 * 8 * (g.kc + 8) * 2;
      const int sh = ((tap / 3 - 1) * t.hs + (tap % 3 - 1)) * d;
      mma_rows<GB>(acc, aH + sh * xp * 2, b, (g.kc + 8) * 2, g.kc / 16,
                   sb.cnt);
    }
#pragma unroll
    for (int j = 0; j < GB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(wm, lane, e);
        const int n = frag_col(lane, sb.j0 + j, e);
        if (n >= g.hc) continue;
        const float cb = bfr(acc[j][e]);
        const float *bn = sBh + 4 * i * g.hc + n;
        const float z = bn_apply(cb, bn[0], bn[g.hc], bn[2 * g.hc],
                                 bn[3 * g.hc]);
        const bf16 ab = f2bf(relu(z));
        sCb[r * g.nhp + i * g.hc + n] = f2bf(cb);
        sA[r * g.nhp + i * g.hc + n] = ab;
        const int64_t p = tile_pix(g, pos, r);
        if (p >= 0) a_out[p * g.NH + i * g.hc + n] = ab;
      }
  }

  // the residual and top convs in chunks of NC channels: their BN
  // backward, dr, dt (-> sD), and the five per-tile column sums
  for (int n0 = 0; n0 < C; n0 += NC) {
    const int ntc = (C - n0 + 7) / 8 < NTC ? (C - n0 + 7) / 8 : NTC;
    const Split sc = split<NTC>(wn, ntc);
    float acr[GC][4], at[GC][4];
    zero_acc(acr);
    zero_acc(at);
    uint32_t b = advance() + sc.j0 * 8 * (g.kc + 8) * 2;
    mma_rows<GC>(acr, aH, b, (g.kc + 8) * 2, g.kc / 16, sc.cnt);
    b = advance() + sc.j0 * 8 * (g.knh + 8) * 2;
    mma_rows<GC>(at, aA, b, (g.knh + 8) * 2, g.knh / 16, sc.cnt);
    float vg[GC][4], vt1[GC][4], vt2[GC][4];
#pragma unroll
    for (int j = 0; j < GC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(wm, lane, e);
        const int c = n0 + frag_col(lane, sc.j0 + j, e);
        const int64_t p = tile_pix(g, pos, r);
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
          dt_out[p * C + c] = dtb;
        }
        if (c < C && j < sc.cnt) sD[r * xp + c] = dtb;
        vg[j][e] = dgy;
        acr[j][e] = dzr;
        at[j][e] = __fmul_rn(dzr, rmm);
        vt1[j][e] = dzt;
        vt2[j][e] = __fmul_rn(dzt, tmm);
      }
    const int c0 = sc.j0 * 8, jn = wn ? NTC - GC : GC;   // its columns
    group_colsum<GC>(acr, red_w + c0, lane, jn);
    group_colsum<GC>(at, red_w + NC + c0, lane, jn);
    group_colsum<GC>(vt1, red_w + 2 * NC + c0, lane, jn);
    group_colsum<GC>(vt2, red_w + 3 * NC + c0, lane, jn);
    group_colsum<GC>(vg, red_w + 4 * NC + c0, lane, jn);
    __syncthreads();
    for (int c = threadIdx.x; c < NC && n0 + c < C; c += TT) {
      prow[n0 + c] = block_col(red, 0, c);
      prow[C + n0 + c] = block_col(red, 1, c);
      prow[2 * C + n0 + c] = block_col(red, 2, c);
      prow[3 * C + n0 + c] = block_col(red, 3, c);
      prow[4 * C + 2 * g.NH + n0 + c] = block_col(red, 4, c);
    }
  }

  // the branch backward: da = dt . kt[i]^T, dz, dS_h sums, dc
  float *prow_h = prow + 4 * C;
  for (int i = 0; i < g.nb; ++i) {
    const uint32_t b = advance() + sb.j0 * 8 * (g.kc + 8) * 2;
    float acc[GB][4];
    zero_acc(acc);
    mma_rows<GB>(acc, aD, b, (g.kc + 8) * 2, g.kc / 16, sb.cnt);
    float v1[GB][4], v2[GB][4];
#pragma unroll
    for (int j = 0; j < GB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(wm, lane, e);
        const int n = frag_col(lane, sb.j0 + j, e);
        const int64_t p = tile_pix(g, pos, r);
        v1[j][e] = 0.0f;
        v2[j][e] = 0.0f;
        if (n >= g.hc || p < 0) continue;
        const float cb = bf2f(sCb[r * g.nhp + i * g.hc + n]);
        const float *bn = sBh + 4 * i * g.hc + n;
        const float mean = bn[0], inv = bn[g.hc], scale = bn[2 * g.hc];
        const float z = bn_apply(cb, mean, inv, scale, bn[3 * g.hc]);
        const float dz = z > 0.0f ? acc[j][e] : 0.0f;
        v1[j][e] = dz;
        v2[j][e] = __fmul_rn(dz, __fsub_rn(cb, mean));
        dc_out[p * t.ldc + i * g.khc + n] =
            f2bf(__fmul_rn(dz, __fmul_rn(scale, inv)));
      }
    const int jn = wn ? NTB - GB : GB;
    group_colsum<GB>(v1, red_w + sb.j0 * 8, lane, jn);
    group_colsum<GB>(v2, red_w + NC + sb.j0 * 8, lane, jn);
    __syncthreads();
    for (int c = threadIdx.x; c < g.hc; c += TT) {
      prow_h[2 * i * g.hc + c] = block_col(red, 0, c);
      prow_h[(2 * i + 1) * g.hc + c] = block_col(red, 1, c);
    }
  }

  // the zero padding columns of dr (C..kc) and dc (hc..khc per branch)
  const int pc = g.khc - g.hc;
  for (int k = threadIdx.x; k < TP * pd; k += TT) {
    const int64_t p = tile_pix(g, pos, k / pd);
    if (p >= 0) dr_out[p * g.kc + C + k % pd] = bzero();
  }
  for (int k = threadIdx.x; k < TP * g.nb * pc; k += TT) {
    const int r = k / (g.nb * pc), u = k % (g.nb * pc);
    const int64_t p = tile_pix(g, pos, r);
    if (p >= 0) dc_out[p * t.ldc + (u / pc) * g.khc + g.hc + u % pc] = bzero();
  }
}

// ------------------------------------------------------------ phase 1

// dx = bf16(dr . kr^T + sum over branches i and taps of dc_i(p - tap
// offset) . kh[i, tap]^T) for up to NX output channels of one tile.
// grid (n_tiles, nchx).  w1 holds, per chunk of NX channels, nksr stages
// of kr [n][khc-wide k slice] and then nb x 9 stages of kh[i, tap]
// [n][khc], each nxr x khc.
__global__ void __launch_bounds__(TT, 1)
f3b_dx_kernel(Geo g, TGeo t, const bf16 *__restrict__ dr,
              const bf16 *__restrict__ dc, const bf16 *__restrict__ w1,
              bf16 *__restrict__ dx) {
  constexpr int GX = (NTX + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xp = g.kc + 8, cp = t.ldc + 8, wp = g.khc + 8;
  bf16 *sR = reinterpret_cast<bf16 *>(smem);
  bf16 *sC = sR + TP * xp;
  bf16 *sW = sC + t.hr * cp;                // NBUF buffers of nxr x wp

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const TilePos pos = tile_pos(t, blockIdx.x);
  const int n0 = blockIdx.y * NX;
  const int nt = (g.C - n0 + 7) / 8 < NTX ? (g.C - n0 + 7) / 8 : NTX;
  const Split sx = split<NTX>(wn, nt);
  const int64_t wst = static_cast<int64_t>(t.nxr) * g.khc;
  const bf16 *wch = w1 + static_cast<int64_t>(blockIdx.y) * t.nst1 * wst;

  // the tile's dr rows, zero for pixels outside the image
  const uint32_t dR = saddr(sR);
  for_chunks(TP, g.kc / 8, [&](int r, int c) {
    const int64_t p = tile_pix(g, pos, r);
    cp16(dR + (r * xp + c * 8) * 2, dr + (p < 0 ? 0 : p) * g.kc + c * 8,
         p >= 0);
  });
  stage_halo(sC, dc, t.ldc, g, t, pos);
  copy_stage(sW, wch, t.nxr, g.khc);
  cp_commit();
  copy_stage(sW + t.nxr * wp, wch + wst, t.nxr, g.khc);   // nst1 >= 10
  cp_commit();

  const int lr = wm * 16 + lm_row(lane), ak = (lane >> 4) * 8;
  const uint32_t aR = saddr(sR + lr * xp + ak);
  const uint32_t aC = saddr(sC + (((lr >> 3) + t.dmax) * t.hs + (lr & 7) +
                                  t.dmax) * cp + ak);
  const int bofs = ((sx.j0 * 8 + lm_brow(lane)) * wp + lm_bk(lane)) * 2;

  float acc[GX][4];
  zero_acc(acc);
#pragma unroll 1
  for (int s = 0; s < t.nst1; ++s) {
    const bool more = s + 2 < t.nst1;
    next_stage(sW + ((s + 2) % NBUF) * t.nxr * wp,
               wch + (more ? (s + 2) * wst : 0), t.nxr, g.khc, more);
    const uint32_t b = saddr(sW + (s % NBUF) * t.nxr * wp) + bofs;
    if (s < t.nksr) {
      const int k0 = s * g.khc;
      const int kw = g.kc - k0 < g.khc ? g.kc - k0 : g.khc;
      mma_rows<GX>(acc, aR + k0 * 2, b, wp * 2, kw / 16, sx.cnt);
    } else {
      const int u = s - t.nksr, i = u / 9, tap = u % 9, d = g.dil[i];
      const int sh = -((tap / 3 - 1) * t.hs + (tap % 3 - 1)) * d;
      mma_rows<GX>(acc, aC + (sh * cp + i * g.khc) * 2, b, wp * 2,
                   g.khc / 16, sx.cnt);
    }
  }
#pragma unroll
  for (int j = 0; j < GX; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = frag_row(wm, lane, e);
      const int c = n0 + frag_col(lane, sx.j0 + j, e);
      const int64_t p = tile_pix(g, pos, r);
      if (p >= 0 && c < g.C && j < sx.cnt) dx[p * g.C + c] = f2bf(acc[j][e]);
    }
}

}  // namespace tile
}  // namespace cam
