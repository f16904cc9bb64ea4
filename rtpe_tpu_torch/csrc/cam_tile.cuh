// The 2-D tile kernels of the fused-CAM ops: the three backwards F1b, F2b
// and F3b and the three forwards F1, F2 and F3, CUDA C++ for sm_90a;
// cam_f1.cu, cam_f2.cu and cam_f3.cu include this header through
// cam_wg.cuh.
//
// Replaces, with those files, the TPU kernels _f1_call / _f1_kernel,
// _f2_call / _f2_kernel, _f3_call / _f3_kernel, _f1b_call / _f1b_kernel,
// _f2b_call / _f2b_kernel and _f3b_call / _f3b_kernel of
// rtpe_tpu/ops/pallas_cam.py: each forward in one tile kernel
// (f1_tile_kernel and f2_tile_kernel with their per-tile sums,
// f3_tile_kernel), each backward in phase 0, the recompute of the convs it
// needs with the per-pixel cotangents (f1b_tile_kernel, f2b_tile_kernel,
// f3b_tile_kernel, each with its per-tile sums), and phase 1, dx
// (dx_kernel, one template for all three).  Each op takes any C, branch
// width and 1..6 dilations: where a branch has at most 40 columns and the
// tile's halo at full channel depth fits a block's shared memory (the
// train step's CAMs at the default --inplanes 80) the kernels below run
// as described here; elsewhere ("the wide plan" below: make_tgeo's
// limits) every forward and both phases of every backward run the wgmma
// kernels of cam_wg.cuh.  Every op refuses only a largest dilation whose
// halo of one 16-channel chunk does not fit those limits (at C = 163:
// 19 and up for F1b and F3b, 20 and up for the others).
//
// Bound at the steps' CAM (B=16, 113 x 113, C=163, hc=40, dils 1..3):
// operations.  F3b does 3 x 222.2 K multiply-adds a pixel, 0.275 ms at
// 989 TFLOP/s (bf16 dense tensor cores); F1b 3 x 202.6 K, F2b 3 x 195.6 K;
// F3 222.2 K (0.092 ms), F1 202.6 K (0.084 ms), F2 195.6 K (0.081 ms).
// The first design (64 consecutive pixels a block) staged each tap's 64
// shifted pixel rows and its weights one bf16 per lane, with a divide per
// row and element, 27 times per branch set: ~600 KB of x moved per
// 64-pixel tile, loads and MMAs never overlapped, and its dx kernel
// restaged the dc halo 27 times in each of 3 channel chunks.  What this
// design does about it:
//   - a tile is 8 x 8 pixels of one image (tiles numbered image-major, so
//     a per-tile partial is a per-image partial); its halo at the largest
//     dilation, (8 + 2 dmax)^2 pixel rows at full channel depth, is staged
//     once with 16-byte cp.async (zero fill outside the image through the
//     src-size operand) and every tap of every branch reads its A operand
//     straight out of it by per-lane ldmatrix row addresses: ~72 KB of x
//     per tile at C = 163 instead of ~600 KB, in 16-byte copies;
//   - the wrapper lays every weight out once per call in the order the
//     kernel walks it, [n][k] with k padded to 16 (ops/cam.py:
//     _tile_weights), so each stage's B tile is one contiguous cp.async
//     copy, in a ring of three buffers: stages s + 1 and s + 2 load while
//     stage s multiplies; the copy loops keep their row and chunk indices
//     without a divide per chunk;
//   - 8 warps a block, 2 on each of the SM's 4 schedulers: one block fits
//     an SM (205 KB of shared memory at C = 163, 133 KB at 83, for F3b),
//     and a single warp per scheduler exposed every latency of the MMA
//     loop and the epilogues (on one H100 at 700 W, F3b's phase 0 at the
//     steps' shape took 3.6 ms with 4 warps, 2.7 ms with 8).  The 4 row
//     warps (16 pixel rows each) of each of 2 column groups split every
//     product's n8 tiles between the groups;
//   - the epilogues read the BN rows, the statistics' cotangents and
//     image b's gate from shared memory, staged once per tile;
//   - they read a channel-padded copy of x (C -> kc, zeros) and write dr
//     with pitch kc and dc with each branch padded to khc zero columns, so
//     every staged row is 16-byte aligned and its k padding is zero;
//   - phase 1 stages the tile's dr rows (F1b, F3b) and one dc halo (all
//     branches) and computes up to 168 output channels per block (all of
//     them at C = 163 and 83), so dc is staged once per tile;
//   - each output keeps the first design's accumulation order (branch
//     conv: taps 0..8, k-steps ascending; 1x1 convs: k-steps ascending;
//     dx: dr kr^T, then branch i, taps 0..8, k-steps over khc, then
//     F1b's dgap / (H W)) on the same mma.sync m16n8k16 bf16 -> f32 with
//     the same zero padding, so every per-pixel output (F3's out; dr, a,
//     dt, dc, dx; F2's t) is bitwise the first design's; the per-tile sums
//     (F1's S_r, S_h and GAP; F2's S_t; dS_r, dS_h, dS_t, dgate) and the
//     weight gradients (cam_core.cuh) add their pixels in another order.
//
// The six phase-0 kernels (f1_tile_kernel and f1b_tile_kernel in
// cam_f1.cu, f2_tile_kernel and f2b_tile_kernel in cam_f2.cu,
// f3_tile_kernel and f3b_tile_kernel in cam_f3.cu) share the sections here
// (branch_convs, conv1x1_chunks, branch_backward, ring_colsums,
// zero_pad_cols) and differ in their epilogues and in which sections they
// run:
//
//   F1:  branch convs -> S_h; kr^T chunks -> S_r; the tile's sum of x
//   F2:  branch convs -> a (shared memory only); kt^T chunks -> S_t
//   F3:  branch convs -> a (shared memory only); kr^T and kt^T chunks ->
//        out = relu(res + y gate[b])
//   F1b: branch convs -> dc = dsh[2i] + 2 c dsh[2i+1]; kr^T chunks -> dr
//   F2b: branch convs -> a; kt^T chunks -> dt; branch backward -> dc, dS_h
//   F3b: branch convs -> a; kr^T and kt^T chunks -> dr, dt, dS_r, dS_t,
//        dgate; branch backward -> dc, dS_h
//
// A forward is a phase 0 without the branch backward and has no phase 1,
// so F1's weight stages are F1b's and F2's and F3's are F2b's and F3b's
// without the last nb (kt[i]); its shared memory is its backward's phase 0
// less what it does not run (F1: F1b's cotangent rows; F2: sCb, sD, the
// dst rows and the column-sum scratch; F3: sCb, sD and the column-sum
// scratch), and F1's and F2's column sums go through a spent weight
// buffer (Ring::spent, ring_colsums), so a forward takes every geometry
// its backward takes.
//
// Ragged tiles: 113 = 14 x 8 + 1, so 15 x 15 tiles cover a 113 x 113
// image, 12.8 % more pixels than it has (57^2: 26 %, 29^2: 22 %); a pixel
// outside the image has zero rows, its outputs are not written and every
// per-tile sum masks it (its dilated taps can reach into the image, and
// its BN bias alone makes its activations nonzero, so its convs are not
// zero).

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

// The backwards, then the forwards.
enum Op { F1B = 1, F2B = 2, F3B = 3, F1 = 4, F3 = 5, F2 = 6 };

inline int up8(int v) { return (v + 7) / 8 * 8; }

// The tiling of one call; ops/cam.py:tile_plan computes the same.
struct TGeo {
  int op;                     // F1B, F2B, F3B, F1, F3 or F2
  int res, top, bb;           // phase 0 runs kr^T chunks, kt^T chunks and
                              // the branch backward
  int bwd;                    // a backward: it has a phase 1 (dx)
  int tiles_x, tpi, n_tiles;  // tiles per image row, per image, in all
  int dmax, hs, hr;           // largest dilation, halo side, halo rows
  int brows;                  // rows of a branch weight stage: hc to 8
  int nchr;                   // phase 0's 1x1-conv chunks of NC channels
  int kw0;                    // widest phase-0 stage: kc, or max(kc, knh)
  int ldc;                    // dc row pitch: nb khc
  int nst0;                   // phase-0 weight stages
  int nxr, nchx;              // dx stage rows, dx channel chunks
  int nksr, nst1;             // dx stages of dr kr^T, dx stages per chunk
  // The wide plan (wide = 1), for a branch wider than SW_MAX or a
  // geometry whose whole-depth halo and stages do not fit: both phases
  // run cam_wg.cuh's kernels on plans of their own, and the fields below
  // are the limits every op is refused by ("wide plan" below); else 0
  // and they describe the one chunk of the plan above.
  int wide;
  int kq, nq, kqa, nqa;       // phase-0 K chunks of kc (x, dt) and of knh
                              // (a): width, count
  int kqm;                    // widest phase-0 chunk (the buffers' pitch - 8)
};

// Chunks of K (a multiple of 16) at most kmax wide: as few as fit, of
// even width (to 16), the last one what is left.
inline void k_chunks(int K, int kmax, int *w, int *n) {
  *n = (K + kmax - 1) / kmax;
  *w = ((K + *n - 1) / *n + 15) / 16 * 16;
}

// The widest chunk (a multiple of 16, -1 if none) whose buffers fit
// SMEM_MAX: two halo buffers of hr rows, NBUF ring slots of `slot` rows,
// each of pitch chunk + 8 bf16, and `fixed` bytes more.
inline int k_fit(int hr, int slot, int64_t fixed) {
  const int64_t per = 2LL * (2LL * hr + 1LL * NBUF * slot);
  const int64_t k = (SMEM_MAX - fixed) / per - 8;
  return k < 16 ? -1 : static_cast<int>(k / 16 * 16);
}

inline int64_t smem0_bytes(const Geo &g, const TGeo &t);
inline int64_t smem1_bytes(const Geo &g, const TGeo &t);

inline TGeo make_tgeo(const Geo &g, int op) {
  TGeo t;
  t.op = op;
  t.res = op != F2B && op != F2;
  t.top = op == F2B || op == F3B || op == F3 || op == F2;
  t.bb = op == F2B || op == F3B;
  t.bwd = op <= F3B;
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
  t.kw0 = t.top && g.knh > g.kc ? g.knh : g.kc;
  t.ldc = g.nb * g.khc;
  t.nst0 = 9 * g.nb + (t.res + t.top) * t.nchr + t.bb * g.nb;
  t.nxr = up8(g.C) < NX ? up8(g.C) : NX;
  t.nchx = (g.C + NX - 1) / NX;
  t.nksr = t.res ? (g.kc + g.khc - 1) / g.khc : 0;
  t.nst1 = t.nksr + 9 * g.nb;
  t.wide = 0;
  t.kq = t.kqm = g.kc;
  t.nq = 1;
  t.kqa = g.knh;
  t.nqa = 1;
  if (g.hc <= SW_MAX && smem0_bytes(g, t) <= SMEM_MAX &&
      smem1_bytes(g, t) <= SMEM_MAX)
    return t;
  // the wide plan's limits: K chunks of mma.sync stages (branch slices
  // of at most SW_MAX columns) as wide as shared memory takes (kq = -1:
  // it takes none).  A backward is also refused where a K-chunked phase
  // 1 of mma.sync stages (two halo buffers of a 16-channel chunk and
  // NBUF slots of nxr weight and TP dr rows) would not fit: the limit the
  // ops have always had; cam_wg.cuh's kernels, which run both phases
  // there, need less
  t.wide = 1;
  const int k0 = k_fit(t.hr, WROWS + TP, t.bb ? 4LL * NWARPS * NRED * NC : 0);
  const int k1 = t.bwd ? k_fit(t.hr, t.nxr + t.res * TP, 0) : 16;
  if (k0 < 0 || k1 < 0) {
    t.kq = -1;
    return t;
  }
  k_chunks(g.kc, k0, &t.kq, &t.nq);
  k_chunks(g.knh, k0, &t.kqa, &t.nqa);
  t.kqm = t.top && t.kqa > t.kq ? t.kqa : t.kq;
  return t;
}

// Shared memory of phase 0: the x halo (hr x (kc + 8)) and NBUF weight
// buffers (WROWS x (kw0 + 8)) in bf16; with the top conv (F2b, F3b, F3,
// F2) also sA (TP x nhp), with the branch backward (F2b, F3b) sCb
// (TP x nhp) and sD (TP x (kc + 8)); then in f32 the column-sum scratch
// (NWARPS row warps; F2b, F3b) and the epilogues' rows: F1b dsr (2C) and
// dsh (2 NH); F2b dst (2C) and bnh (4 NH); F2 bnh (4 NH); F3b and F3 bnr
// and bnt (4C each), image b's gate (C) and bnh (4 NH).  F1's and F2's
// column sums go through a weight buffer (Ring::spent), so F1 needs F1b's
// phase 0 less its rows and F2 F2b's less sCb, sD, the dst rows and the
// scratch: each fits wherever its backward does.  The wide plan's limit:
// two halo buffers of hr x (kqm + 8) and NBUF slots of WROWS weight rows
// and TP A rows of pitch kqm + 8, then the column-sum scratch (F2b,
// F3b): every op's refusal (tile_geo); no kernel carves it.
inline int64_t smem0_bytes(const Geo &g, const TGeo &t) {
  if (t.wide)
    return 2LL * (2LL * t.hr + 1LL * NBUF * (WROWS + TP)) * (t.kqm + 8) +
           (t.bb ? 4LL * NWARPS * NRED * NC : 0);
  const int64_t xp = g.kc + 8;
  int64_t el = t.hr * xp + 1LL * NBUF * WROWS * (t.kw0 + 8);
  int64_t f = t.op == F3B || t.op == F3 ? 9LL * g.C + 4LL * g.NH
              : t.op == F2B             ? 2LL * g.C + 4LL * g.NH
              : t.op == F1B             ? 2LL * g.C + 2LL * g.NH
              : t.op == F2              ? 4LL * g.NH
                                        : 0;
  if (t.top) el += 1LL * TP * g.nhp;
  if (t.bb) {
    el += 1LL * TP * g.nhp + TP * xp;
    f += 1LL * NWARPS * NRED * NC;
  }
  return el * 2 + 4 * f;
}

// Shared memory of phase 1 (a backward's; 0 for a forward): the tile's dr
// rows (TP x (kc + 8), F1b and F3b), the dc halo (hr x (ldc + 8)), NBUF
// weight buffers (nxr x (khc + 8)), bf16.  0 for the wide plan (its
// phase 1 is cam_wg.cuh:dx_wg_kernel, with a plan of its own).
inline int64_t smem1_bytes(const Geo &g, const TGeo &t) {
  if (!t.bwd || t.wide) return 0;
  return 2LL * ((t.res ? TP * (g.kc + 8LL) : 0) + t.hr * (t.ldc + 8LL) +
                1LL * NBUF * t.nxr * (g.khc + 8));
}

// bf16 elements of the whole-depth plan's two re-laid weight buffers (w1:
// a backward's phase 1; the wide plan's are cam_wg.cuh:make_fplan's and
// make_dplan's).
inline int64_t w0_elems(const Geo &g, const TGeo &t) {
  return (9LL + t.bb) * g.nb * t.brows * g.kc +
         static_cast<int64_t>(t.nchr) * NC *
             (t.res * g.kc + t.top * g.knh);
}
inline int64_t w1_elems(const Geo &g, const TGeo &t) {
  if (!t.bwd || t.wide) return 0;
  return static_cast<int64_t>(t.nchx) * t.nst1 * t.nxr * g.khc;
}

// A geometry the op's tile kernels take, or false: one whose largest
// dilation's halo, in 16-channel chunks, does not fit is refused.
inline bool tile_geo(const int *geo, int op, Geo *g, TGeo *t) {
  if (op < F1B || op > F2 || !make_geo(geo, g)) return false;
  *t = make_tgeo(*g, op);
  return t->kq > 0 && smem0_bytes(*g, *t) <= SMEM_MAX &&
         smem1_bytes(*g, *t) <= SMEM_MAX;
}

// Phase-0 weight stage s: its offset in w0, its rows and its k width.
// Order: the branch taps (nb x 9 of [brows][kc], kh^T), then per chunk of
// NC output channels kr^T [NC][kc] (res: F1, F3, F1b, F3b) and kt^T
// [NC][knh] (top: F2, F3, F2b, F3b), then per branch kt[i] [brows][kc]
// (bb: F2b, F3b).
__device__ __forceinline__ void stage0(const Geo &g, const TGeo &t, int s,
                                       int64_t *off, int *rows, int *kw) {
  const int nbr = 9 * g.nb, per = t.res + t.top;
  const int64_t wb = static_cast<int64_t>(t.brows) * g.kc;
  const int64_t pair = static_cast<int64_t>(NC) *
                       (t.res * g.kc + t.top * g.knh);
  *rows = t.brows;
  *kw = g.kc;
  if (s < nbr) {
    *off = s * wb;
    return;
  }
  s -= nbr;
  if (s < per * t.nchr) {
    // u: 0 for kr^T, 1 for kt^T
    const int q = per == 2 ? s >> 1 : s, u = per == 2 ? s & 1 : t.top;
    *off = nbr * wb + q * pair + (u ? t.res * NC * g.kc : 0);
    *rows = NC;
    *kw = u ? g.knh : g.kc;
    return;
  }
  *off = nbr * wb + t.nchr * pair + (s - per * t.nchr) * wb;
}

// ------------------------------------------------------------ primitives

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
// of pitch bp bytes.  Each acc[j] adds its k-steps in ascending order.
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

// The column sums of a column group's warp over its 16 rows: its first jn
// n8 tiles (rows already masked to 0), in a fixed order, into
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

// Stage columns c0 .. c0 + kw of the tile's halo of src (pixel rows of
// pitch ld) into shared rows of pitch kw + 8, zero outside the image.
__device__ __forceinline__ void stage_halo_cols(bf16 *dst, const bf16 *src,
                                                int ld, int c0, int kw,
                                                const Geo &g, const TGeo &t,
                                                const TilePos &p) {
  const uint32_t d = saddr(dst);
  for_chunks(t.hr, kw / 8, [&](int h, int c) {
    const int hy = h / t.hs;
    const int y = p.y0 - t.dmax + hy, x = p.x0 - t.dmax + h - hy * t.hs;
    const bool ok = y >= 0 && y < g.H && x >= 0 && x < g.W;
    const int64_t row = ok ? (static_cast<int64_t>(p.b) * g.H + y) * g.W + x
                           : 0;
    cp16(d + (h * (kw + 8) + c * 8) * 2, src + row * ld + c0 + c * 8, ok);
  });
}

// ... its whole rows (ld / 8 16-byte chunks each), pitch ld + 8.
__device__ __forceinline__ void stage_halo(bf16 *dst, const bf16 *src, int ld,
                                           const Geo &g, const TGeo &t,
                                           const TilePos &p) {
  stage_halo_cols(dst, src, ld, 0, ld, g, t, p);
}

// Columns c0 .. c0 + kw of the tile's 64 pixel rows of src (pitch ld),
// zero for pixels outside the image, into shared rows of pitch kw + 8.
__device__ __forceinline__ void stage_rows_cols(bf16 *dst, const bf16 *src,
                                                int ld, int c0, int kw,
                                                const Geo &g,
                                                const TilePos &p) {
  const uint32_t d = saddr(dst);
  for_chunks(TP, kw / 8, [&](int r, int c) {
    const int64_t q = tile_pix(g, p, r);
    cp16(d + (r * (kw + 8) + c * 8) * 2,
         src + (q < 0 ? 0 : q) * ld + c0 + c * 8, q >= 0);
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

// Phase 0's weight stages in the ring: stage s sits in buffer s % NBUF
// with pitch kw + 8.
struct Ring {
  const bf16 *w0;
  bf16 *sW;
  int wbuf, lane, s;

  // Start stages 0 and 1 (every op has nst0 >= 10), each its own group.
  __device__ __forceinline__ void start(const Geo &g, const TGeo &t) {
    int64_t o;
    int r, k;
    for (int u = 0; u < 2; ++u) {
      stage0(g, t, u, &o, &r, &k);
      copy_stage(sW + u * wbuf, w0 + o, r, k);
      cp_commit();
    }
  }

  // Wait for stage s, start stage s + 2, return this lane's B address
  // in stage s.
  __device__ __forceinline__ uint32_t next(const Geo &g, const TGeo &t) {
    int64_t o = 0;
    int r = 0, k = 0;
    const bool more = s + 2 < t.nst0;
    if (more) stage0(g, t, s + 2, &o, &r, &k);
    next_stage(sW + ((s + 2) % NBUF) * wbuf, w0 + o, r, k, more);
    stage0(g, t, s, &o, &r, &k);
    const uint32_t b = saddr(sW + (s % NBUF) * wbuf +
                             lm_brow(lane) * (k + 8) + lm_bk(lane));
    ++s;
    return b;
  }

  // The buffer of the stage next() returned last: free once every warp
  // has multiplied it (a barrier), until the following next() starts
  // loading stage s + 2 there (after its own barrier).
  __device__ __forceinline__ float *spent() const {
    return reinterpret_cast<float *>(sW + ((s + NBUF - 1) % NBUF) * wbuf);
  }
};

// A lane's place in the block and in its tile.
struct Lane {
  int lane, wm, wn;   // lane, row warp, column group
  TilePos pos;
};

__device__ __forceinline__ Lane lane_of(const TGeo &t) {
  const int warp = threadIdx.x >> 5;
  return {static_cast<int>(threadIdx.x & 31), warp & 3, warp >> 2,
          tile_pos(t, blockIdx.x)};
}

// This lane's ldmatrix address of its A row (pixel 16 wm + lm_row) in
// the halo's centre, whose rows have pitch ld (bf16).
__device__ __forceinline__ uint32_t halo_row(const bf16 *sH, int ld,
                                             const TGeo &t, const Lane &L) {
  const int lr = L.wm * 16 + lm_row(L.lane), ak = (L.lane >> 4) * 8;
  return saddr(sH + (((lr >> 3) + t.dmax) * t.hs + (lr & 7) + t.dmax) * ld +
               ak);
}

// ... and of its A row in a tile-sized buffer of pitch ld.
__device__ __forceinline__ uint32_t tile_row(const bf16 *s, int ld,
                                             const Lane &L) {
  return saddr(s + (L.wm * 16 + lm_row(L.lane)) * ld + (L.lane >> 4) * 8);
}

// A branch's columns s0 .. s0 + w of branch i (the whole branch: s0 = 0
// and w = hc).
struct Slice {
  int i, s0, w;
};

// The branch convs: for each branch i, acc = the sum over taps 0..8 of
// the halo rows shifted by the tap's offset . kh[i, tap] (k-steps
// ascending), then epi(slice, split, acc) on the column group's GB n8
// tiles.  Stages: the nb x 9 taps.
template <typename Epi>
__device__ __forceinline__ void branch_convs(const Geo &g, const TGeo &t,
                                             Ring &ring, uint32_t aH,
                                             const Lane &L, Epi epi) {
  constexpr int GB = (NTB + 1) / 2;   // n8 tiles per column group
  const int xp = g.kc + 8;
  const Split sb = split<NTB>(L.wn, t.brows / 8);
  for (int i = 0; i < g.nb; ++i) {
    const int d = g.dil[i];
    float acc[GB][4];
    zero_acc(acc);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t b = ring.next(g, t) + sb.j0 * 8 * xp * 2;
      const int sh = ((tap / 3 - 1) * t.hs + (tap % 3 - 1)) * d;
      mma_rows<GB>(acc, aH + sh * xp * 2, b, xp * 2, g.kc / 16, sb.cnt);
    }
    epi(Slice{i, 0, g.hc}, sb, acc);
  }
}

// The 1x1 convs in chunks of NC output channels from n0: per chunk, with
// RES acr = the halo's centre rows (aH) . kr^T (kc), with TOP at = sA
// (aA) . kt^T (knh), k-steps ascending, then epi(n0, split, acr, at).
// Stages: per chunk kr^T, then kt^T.
template <bool RES, bool TOP, typename Epi>
__device__ __forceinline__ void conv1x1_chunks(const Geo &g, const TGeo &t,
                                               Ring &ring, uint32_t aH,
                                               uint32_t aA, const Lane &L,
                                               Epi epi) {
  constexpr int GC = (NTC + 1) / 2;   // n8 tiles per column group
  for (int n0 = 0; n0 < g.C; n0 += NC) {
    const int ntc = (g.C - n0 + 7) / 8 < NTC ? (g.C - n0 + 7) / 8 : NTC;
    const Split sc = split<NTC>(L.wn, ntc);
    float acr[GC][4], at[GC][4];
    zero_acc(acr);
    zero_acc(at);
    if (RES) {
      const uint32_t b = ring.next(g, t) + sc.j0 * 8 * (g.kc + 8) * 2;
      mma_rows<GC>(acr, aH, b, (g.kc + 8) * 2, g.kc / 16, sc.cnt);
    }
    if (TOP) {
      const uint32_t b = ring.next(g, t) + sc.j0 * 8 * (g.knh + 8) * 2;
      mma_rows<GC>(at, aA, b, (g.knh + 8) * 2, g.knh / 16, sc.cnt);
    }
    epi(n0, sc, acr, at);
  }
}

// The branch convs' epilogue of F2, F3, F2b and F3b: sA =
// bf16(relu(BN(c))) from the BN rows sBh; with BWD (F2b, F3b) also sCb =
// bf16(c) and a_out = the same a.
template <bool BWD>
struct ToActivations {
  const Geo &g;
  const Lane &L;
  const float *sBh;
  bf16 *sCb, *sA, *a_out;
  template <int GB>
  __device__ __forceinline__ void operator()(const Slice &sl, const Split &sb,
                                             const float (&acc)[GB][4]) const {
    const int i = sl.i;
#pragma unroll
    for (int j = 0; j < GB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = frag_col(L.lane, sb.j0 + j, e);
        if (n >= sl.w) continue;
        const int r = frag_row(L.wm, L.lane, e), col = sl.s0 + n;
        const float cb = bfr(acc[j][e]);
        const float *bn = sBh + 4 * i * g.hc + col;
        const float z = bn_apply(cb, bn[0], bn[g.hc], bn[2 * g.hc],
                                 bn[3 * g.hc]);
        const bf16 ab = f2bf(relu(z));
        if (BWD) sCb[r * g.nhp + i * g.hc + col] = f2bf(cb);
        sA[r * g.nhp + i * g.hc + col] = ab;
        if (BWD) {
          const int64_t p = tile_pix(g, L.pos, r);
          if (p >= 0) a_out[p * g.knh + i * g.hc + col] = ab;
        }
      }
  }
};

// The branch backward, given sD = bf16(dt) (k padding zero) and sCb: per
// branch da = dt . kt[i]^T, dz = (z > 0) da, dc = dz scale inv -> dc_out
// (pitch ldc, branch i at i khc), and the tile's column sums of dz and
// dz (c - mean) -> prow_h[2 i hc + n], prow_h[(2 i + 1) hc + n].  Stages:
// the nb kt[i].
__device__ __forceinline__ void branch_backward(
    const Geo &g, const TGeo &t, Ring &ring, uint32_t aD, const bf16 *sCb,
    const float *sBh, float *red, const Lane &L, bf16 *dc_out,
    float *prow_h) {
  constexpr int GB = (NTB + 1) / 2;
  const Split sb = split<NTB>(L.wn, t.brows / 8);
  float *red_w = red + L.wm * NRED * NC;
  for (int i = 0; i < g.nb; ++i) {
    const uint32_t b = ring.next(g, t) + sb.j0 * 8 * (g.kc + 8) * 2;
    float acc[GB][4];
    zero_acc(acc);
    mma_rows<GB>(acc, aD, b, (g.kc + 8) * 2, g.kc / 16, sb.cnt);
    float v1[GB][4], v2[GB][4];
#pragma unroll
    for (int j = 0; j < GB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(L.wm, L.lane, e);
        const int n = frag_col(L.lane, sb.j0 + j, e);
        const int64_t p = tile_pix(g, L.pos, r);
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
    const int jn = L.wn ? NTB - GB : GB;
    group_colsum<GB>(v1, red_w + sb.j0 * 8, L.lane, jn);
    group_colsum<GB>(v2, red_w + NC + sb.j0 * 8, L.lane, jn);
    __syncthreads();
    for (int c = threadIdx.x; c < g.hc; c += TT) {
      prow_h[2 * i * g.hc + c] = block_col(red, 0, c);
      prow_h[(2 * i + 1) * g.hc + c] = block_col(red, 1, c);
    }
  }
}

// The column sums of one forward epilogue (F1's, F2's): the masked
// values v and their squares (NT n8 tiles from the column group's first,
// jn of them its own) summed over the tile's rows into out[c] and
// out[c + sq] for c < n, through red ([row warp][2][NC] f32 in the ring
// buffer of the stage just multiplied, Ring::spent): free from the first
// barrier (every warp past its MMA) until the next stage starts loading
// there, after the next stage's barrier.
constexpr int RING_SLOTS = 2;
static_assert(NWARPS * RING_SLOTS * NC * 4 <= WROWS * (16 + 8) * 2,
              "the column sums fit the smallest weight buffer");

template <int NT>
__device__ __forceinline__ void ring_colsums(const float (&v)[NT][4],
                                             const Lane &L, int j0, int jn,
                                             float *red, float *out, int sq,
                                             int n) {
  float v2[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) v2[j][e] = v[j][e] * v[j][e];
  float *red_w = red + L.wm * RING_SLOTS * NC + j0 * 8;
  __syncthreads();
  group_colsum<NT>(v, red_w, L.lane, jn);
  group_colsum<NT>(v2, red_w + NC, L.lane, jn);
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += TT) {
    out[c] = block_col<RING_SLOTS>(red, 0, c);
    out[c + sq] = block_col<RING_SLOTS>(red, 1, c);
  }
}

// Zero the padding columns of the tile's rows of out (pitch ld): in each
// of n groups of pitch gp, the columns w..gp (dr: one group of kc with C
// written; dc: nb groups of khc with hc written).
__device__ __forceinline__ void zero_pad_cols(bf16 *out, int ld, int n,
                                              int gp, int w, const Geo &g,
                                              const TilePos &pos) {
  const int pw = gp - w, row = n * pw;
  for (int k = threadIdx.x; k < TP * row; k += TT) {
    const int64_t p = tile_pix(g, pos, k / row);
    const int u = k % row;
    if (p >= 0) out[p * ld + (u / pw) * gp + w + u % pw] = bzero();
  }
}

// Zero the K padding of sA (columns NH..knh) and, given, sD (C..kc).
__device__ __forceinline__ void zero_top_pads(const Geo &g, bf16 *sA,
                                              bf16 *sD) {
  const int pa = g.knh - g.NH, pd = g.kc - g.C;
  for (int i = threadIdx.x; i < TP * pa; i += TT)
    sA[(i / pa) * g.nhp + g.NH + i % pa] = bzero();
  if (sD)
    for (int i = threadIdx.x; i < TP * pd; i += TT)
      sD[(i / pd) * (g.kc + 8) + g.C + i % pd] = bzero();
}

// ------------------------------------------------------------ phase 1

// dx = bf16(dr . kr^T (HAS_DR) + the sum over branches i and taps of
// dc_i(p - tap offset) . kh[i, tap]^T (+ dgap[b] inv_n, HAS_GAP, added
// to the f32 sum before its one rounding)) for up to NX output channels
// of one tile.  grid (n_tiles, nchx).  w1 holds, per chunk of NX
// channels, nksr stages of kr [n][khc-wide k slice] (none without
// HAS_DR) and then nb x 9 stages of kh[i, tap] [n][khc], each nxr x khc.
template <bool HAS_DR, bool HAS_GAP>
__global__ void __launch_bounds__(TT, 1)
dx_kernel(Geo g, TGeo t, const bf16 *__restrict__ dr,
          const bf16 *__restrict__ dc, const bf16 *__restrict__ w1,
          const float *__restrict__ dgap, float inv_n,
          bf16 *__restrict__ dx) {
  constexpr int GX = (NTX + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xp = g.kc + 8, cp = t.ldc + 8, wp = g.khc + 8;
  bf16 *sR = reinterpret_cast<bf16 *>(smem);   // HAS_DR only
  bf16 *sC = sR + (HAS_DR ? TP * xp : 0);
  bf16 *sW = sC + t.hr * cp;                // NBUF buffers of nxr x wp
  const Lane L = lane_of(t);
  const int n0 = blockIdx.y * NX;
  const int nt = (g.C - n0 + 7) / 8 < NTX ? (g.C - n0 + 7) / 8 : NTX;
  const Split sx = split<NTX>(L.wn, nt);
  const int64_t wst = static_cast<int64_t>(t.nxr) * g.khc;
  const bf16 *wch = w1 + static_cast<int64_t>(blockIdx.y) * t.nst1 * wst;

  // the tile's dr rows, zero for pixels outside the image
  if (HAS_DR) stage_rows_cols(sR, dr, g.kc, 0, g.kc, g, L.pos);
  stage_halo(sC, dc, t.ldc, g, t, L.pos);
  copy_stage(sW, wch, t.nxr, g.khc);
  cp_commit();
  copy_stage(sW + t.nxr * wp, wch + wst, t.nxr, g.khc);   // nst1 >= 9
  cp_commit();

  const uint32_t aR = tile_row(sR, xp, L);
  const uint32_t aC = halo_row(sC, cp, t, L);
  const int bofs = ((sx.j0 * 8 + lm_brow(L.lane)) * wp + lm_bk(L.lane)) * 2;

  float acc[GX][4];
  zero_acc(acc);
#pragma unroll 1
  for (int s = 0; s < t.nst1; ++s) {
    const bool more = s + 2 < t.nst1;
    next_stage(sW + ((s + 2) % NBUF) * t.nxr * wp,
               wch + (more ? (s + 2) * wst : 0), t.nxr, g.khc, more);
    const uint32_t b = saddr(sW + (s % NBUF) * t.nxr * wp) + bofs;
    if (HAS_DR && s < t.nksr) {
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
      const int c = n0 + frag_col(L.lane, sx.j0 + j, e);
      const int64_t p = tile_pix(g, L.pos, frag_row(L.wm, L.lane, e));
      if (p < 0 || c >= g.C || j >= sx.cnt) continue;
      float v = acc[j][e];
      if (HAS_GAP)
        v = __fadd_rn(v, __fmul_rn(dgap[L.pos.b * g.C + c], inv_n));
      dx[p * g.C + c] = f2bf(v);
    }
}

// ------------------------------------------------------------ host side

// Launch a tile kernel (TT threads, smem bytes of dynamic shared memory).
template <typename... P, typename... A>
cudaError_t launch(void (*kern)(P...), dim3 grid, int64_t smem,
                   cudaStream_t st, A... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, TT, static_cast<size_t>(smem), st>>>(args...);
  return cudaGetLastError();
}

// Phase 1 of the plan above: dx from dr (pitch kc; HAS_DR) and dc (pitch
// ldc); cam_wg.cuh:launch_phase1 picks it or dx_wg_kernel.
template <bool HAS_DR, bool HAS_GAP>
cudaError_t launch_dx(const Geo &g, const TGeo &t, const bf16 *dr,
                      const bf16 *dc, const bf16 *w1, const float *dgap,
                      float inv_n, bf16 *dx, cudaStream_t st) {
  return launch(dx_kernel<HAS_DR, HAS_GAP>, dim3(t.n_tiles, t.nchx),
                smem1_bytes(g, t), st, g, t, dr, dc, w1, dgap, inv_n, dx);
}

// The dkh product: x (padded, pitch kc) at each branch's 9 taps against
// that branch's dc columns (pitch ldc, branch i at i khc); out laid out as
// kh, (nb, 3, 3, C, hc).  Pointers may be null for sizing.
inline bool dkh_plan(const Geo &g, const TGeo &t, const bf16 *xpad,
                     const bf16 *dc, WgPlan *P) {
  WgPlan p{};
  p.njobs = g.nb;
  for (int i = 0; i < g.nb; ++i) {
    WgJob &w = p.job[i];
    w.u = xpad; w.ldu = g.kc; w.u0 = 0; w.K = g.C;
    w.v = dc; w.ldv = t.ldc; w.v0 = i * g.khc; w.N = g.hc;
    w.d = g.dil[i];
    w.out_off = static_cast<int64_t>(i) * 9 * g.C * g.hc;
  }
  p.total = 9LL * g.NH * g.C;
  if (!wg_plan(p, 9, g.B, g.H, g.W)) return false;
  *P = p;
  return true;
}

}  // namespace tile
}  // namespace cam
