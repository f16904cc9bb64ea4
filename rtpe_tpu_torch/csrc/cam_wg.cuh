// The fused-CAM forwards F1 and F3 at the student's wider geometries,
// CUDA C++ for sm_90a (cam_f1.cu and cam_f3.cu include this header):
// f1_wg_kernel and f3_wg_kernel, one tile kernel each, for every geometry
// where cam_tile.cuh:make_tgeo does not take the whole-depth plan (a
// branch wider than SW_MAX = 40 columns, or a whole-depth halo and stages
// that do not fit: every --inplanes above 80, six dilations up to 6 or 8
// at C = 163).  The other four ops keep cam_tile.cuh's wide plan there.
//
// Replaces, at those geometries, the TPU kernels _f1_call / _f1_kernel
// (the batch statistics S_r, S_h and the per-image sum of x) and _f3_call
// / _f3_kernel (out = relu(relu(BN_r(x kr)) + relu(BN_t(a kt)) gate[b]),
// a = relu(BN_h(c)), c the three dilated 3x3 branch convs) of
// rtpe_tpu/ops/pallas_cam.py, with the rounding points of the port's F1
// and F3 (bf16 of every conv before its statistics and BN, bf16(a)).
//
// Bound at --inplanes 128's step CAM (B = 16, 113 x 113, C = 259,
// hc = 64, dilations 1-3): operations.  F3 does C^2 + 9 nb C hc + nb hc C
// = 564.4 K multiply-adds a pixel, 0.233 ms at 989 TFLOP/s (bf16 dense);
// F1 C^2 + 9 nb C hc = 514.6 K, 0.213 ms.  x is read once in 0.03 ms.
//
// cam_tile.cuh's wide plan ran F1 and F3 there as 128 stages a 64-pixel
// tile (F3 at that shape): 108 of branch convs (9 taps x 3 branches x 2
// slices of 32 columns x 2 K chunks of 144) and 20 of 1x1 convs, each
// ~0.3 M multiply-adds of mma.sync m16n8k16 behind a __syncthreads, the
// x halo staged again for every branch slice, a written to global memory
// and read back, the BN rows and the gate read from global memory.  What
// this design does about it:
//   - a product's N is the whole branch (up to 128 columns: hc = 48, 64,
//     128 in one slice; wider branches in slices of at most 128), so a
//     branch's accumulators stay in registers across its taps and K
//     stages; the 1x1 convs go in chunks of 64 output columns.  Two
//     consumer warpgroups (8 warps) multiply the tile's 64 pixels by
//     wgmma m64 x N/2 x 16, each against half of every product's columns
//     (its own accumulators and epilogue), so one's epilogue and waits
//     overlap the other's wgmmas;
//   - A and B both come from shared memory by descriptor, so a stage's
//     k-steps issue back to back as one wgmma group, and the next stage's
//     group issues while it runs (a product's first wgmma starts its
//     accumulators: nothing else writes them, and the warp index is a
//     broadcast, so ptxas sees uniform control flow and serialises no
//     wgmma): the x halo is laid out as wgmma's K-major core matrices
//     (planes of 8 channels, one 16-byte row a halo pixel), so a tap is
//     the descriptor's start moved by the tap's shift and the tile's next
//     row of 8 pixels is hs rows on (the stride offset); a, and rows
//     staged for a stage, are planes of 64 rows;
//   - B, the weights the wrapper re-lays once per call in walking order
//     (ops/cam.py:_wg_weights; each stage a [N / 8][kw][8] block, the
//     wgmma's N-major core matrices), arrives by one bulk copy a stage
//     into a ring of 4 slots that one producer warp keeps full, each slot
//     with a full and an empty mbarrier: no block-wide barrier a stage;
//   - the x halo is staged once a tile at full depth where it fits (C =
//     259: 196 rows x 272 channels, 107 KB), else in K chunks (C = 515),
//     once per branch and chunk;
//   - a stays in shared memory (64 x 192 at C = 259) for the kt^T
//     product; the BN rows and image b's gate are staged there once a
//     tile.  Only a geometry where these do not fit reads its rows from
//     global memory and takes a (and x's rows for kr^T) through rows
//     staged a stage at a time.
// The per-pixel rounding points are cam_tile.cuh's; the products add
// their K stages, taps and k-steps in another order than the wide plan.

#pragma once

#include "cam_tile.cuh"

namespace cam {

// d = A (64 x 16 bf16) . B (16 x 8 NT) + (scale_d ? d : 0), both operands
// in shared memory: A by descriptor da, K-major core matrices (8 rows x 16
// bytes, no swizzle), B by descriptor db, N-major core matrices (as
// WgmmaRA's B); f32 accumulators in WgmmaRA's layout.  A product's first
// wgmma starts its accumulators (scale_d = 0), so no other instruction
// writes them while wgmmas are in flight.
template <int NT>
struct WgmmaSS;

template <>
struct WgmmaSS<1> {
  __device__ __forceinline__ static void mma(float (&d)[1][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, "
        "%4, %5, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<3> {
  __device__ __forceinline__ static void mma(float (&d)[3][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
        "}, "
        "%12, %13, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<2> {
  __device__ __forceinline__ static void mma(float (&d)[2][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, "
        "%8, %9, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<4> {
  __device__ __forceinline__ static void mma(float (&d)[4][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, "
        "%16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<6> {
  __device__ __forceinline__ static void mma(float (&d)[6][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, "
        "%24, %25, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<8> {
  __device__ __forceinline__ static void mma(float (&d)[8][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};


namespace tile {

constexpr int FWG = 2;               // consumer warpgroups: N halves
constexpr int FC = 128 * FWG;        // consumer threads
constexpr int FT = FC + 32;          // and the producer warp
constexpr int FNS = 4;               // ring slots
constexpr int FN1 = 64;              // columns of a 1x1-conv chunk
constexpr int FNT1 = FN1 / 8;
constexpr int FNB_MAX = 16;          // n8 tiles of a branch slice at most
constexpr int FBAR = 128;            // bytes before the ring: the mbarriers
constexpr int FRED = 4 * 2 * FNB_MAX * 8;   // F1's column-sum scratch, f32
                                            // (a half each warpgroup)

// The plan of f1_wg_kernel / f3_wg_kernel at one geometry;
// ops/cam.py:_wg_plan computes the same.
struct FPlan {
  int f3;               // F3 (else F1)
  int ntb, sw, nsl;     // a branch slice's n8 tiles and columns; slices
  int nch1;             // 1x1-conv chunks of FN1 output columns
  int kq, nq;           // the x halo's K chunks: width, count
  int kbx;              // a stage's K width within an x chunk (at most)
  int kba, nba;         // F3: the kt^T stages' K width over knh, count
  int a_res;            // F3: a kept in shared memory (else in global
                        // rows, restaged a stage at a time)
  int rows_smem;        // F3: BN rows and the gate in shared memory
  int slot;             // bf16 elements of a ring slot
  int nst;              // weight stages a tile; -1: nothing fits
  int64_t smem;         // dynamic shared memory, bytes
  int64_t w_elems;      // bf16 elements of the re-laid weights
};

// n8 tiles of a branch slice: the kernels' instances.
inline int fplan_ntb(int per) {
  const int set[] = {2, 4, 6, 8, 12, 16};
  for (int v : set)
    if (v >= per) return v;
  return -1;
}

// Shared memory besides the ring: the mbarriers, the x halo (chunk of kq
// channels: kq / 8 planes of hr 16-byte rows), a (F3, a_res: knh / 8
// planes of 64 rows), then in f32 the BN rows and the gate (F3,
// rows_smem: bnr, bnt 4C each, gate C, bnh 4 NH) or F1's column-sum
// scratch.
inline int64_t fplan_fixed(const Geo &g, const TGeo &t, int f3, int kq,
                           int a_res, int rows_smem) {
  int64_t b = FBAR + 2LL * t.hr * kq;
  if (f3 && a_res) b += 2LL * TP * g.knh;
  if (f3)
    b += rows_smem ? 4LL * (9LL * g.C + 4LL * g.NH) : 0;
  else
    b += 4LL * FRED;
  return b;
}

// The plan: the first of these that fits SMEM_MAX with stages at least
// min(64, kq) wide (else 16): a and the rows in shared memory, then the
// rows in global memory, then a too (F3); within each, the x halo in as
// few K chunks as leave that room for FNS ring slots.
inline FPlan make_fplan(const Geo &g, const TGeo &t, int op) {
  FPlan p{};
  p.f3 = op == F3;
  const int n8 = (g.hc + 7) / 8;
  p.nsl = (n8 + FNB_MAX - 1) / FNB_MAX;
  p.ntb = fplan_ntb((n8 + p.nsl - 1) / p.nsl);
  p.sw = 8 * p.ntb;
  p.nch1 = (g.C + FN1 - 1) / FN1;
  const int nw = p.sw > FN1 ? p.sw : FN1;
  p.nst = -1;
  int kb = -1;
  for (int thr = 64; thr >= 16 && kb < 0; thr -= 48)
    for (int m = 0; m < (p.f3 ? 3 : 1) && kb < 0; ++m) {
      const int a_res = p.f3 && m < 2, rows = p.f3 && m < 1;
      int prev = 0;
      for (int nq = 1;; ++nq) {
        const int kq = up16((g.kc + nq - 1) / nq);
        if (kq == prev) continue;
        prev = kq;
        const int64_t avail =
            SMEM_MAX - fplan_fixed(g, t, p.f3, kq, a_res, rows);
        const int64_t k = avail < 0 ? -1 : avail / (2LL * FNS * nw) / 16 * 16;
        if (k >= (thr < kq ? thr : kq)) {
          kb = static_cast<int>(k);
          p.kq = kq;
          p.a_res = a_res;
          p.rows_smem = rows;
          break;
        }
        if (kq <= 16) break;
      }
    }
  if (kb < 0) return p;
  p.nq = (g.kc + p.kq - 1) / p.kq;
  int n;
  k_chunks(p.kq, kb, &p.kbx, &n);
  p.kba = p.nba = 0;
  if (p.f3) {
    // restaged a rows (64 a plane) share the halo buffer
    int ka = kb;
    if (!p.a_res) {
      const int64_t cap = 1LL * t.hr * p.kq / TP;
      ka = static_cast<int>(cap < ka ? cap : ka) / 16 * 16;
    }
    k_chunks(g.knh, ka, &p.kba, &p.nba);
  }
  p.slot = (p.kbx > p.kba ? p.kbx : p.kba) * nw;
  p.smem = fplan_fixed(g, t, p.f3, p.kq, p.a_res, p.rows_smem) +
           2LL * FNS * p.slot;
  int nu = 0;   // K stages over all of x's chunks
  for (int q = 0; q < p.nq; ++q) {
    const int wq = g.kc - q * p.kq < p.kq ? g.kc - q * p.kq : p.kq;
    nu += (wq + p.kbx - 1) / p.kbx;
  }
  p.nst = 9 * g.nb * p.nsl * nu + p.nch1 * (nu + p.f3 * p.nba);
  p.w_elems = 9LL * g.nb * p.nsl * g.kc * p.sw +
              static_cast<int64_t>(p.nch1) * FN1 * (g.kc + p.f3 * g.knh);
  return p;
}

// ------------------------------------------------------------ primitives

// The consumers' barrier (the producer warp never joins it), and one
// consumer warpgroup's (wg 0 or 1).
__device__ __forceinline__ void cons_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FC) : "memory");
}
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// bytes (a multiple of 16) global -> shared by one bulk copy, completing
// on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void *src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// f(row, chunk) for rows x cpr 16-byte chunks over the consumer warps
// (cam_tile.cuh:for_chunks over FC threads).
template <typename F>
__device__ __forceinline__ void cons_chunks(int rows, int cpr, F f) {
  constexpr int W = FC / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (cpr > 32) {
    for (int r = warp; r < rows; r += W)
      for (int c = lane; c < cpr; c += 32) f(r, c);
    return;
  }
  const int rpi = 32 / cpr, sub = lane / cpr, c = lane - sub * cpr;
  if (sub >= rpi) return;
  for (int r = warp * rpi + sub; r < rows; r += W * rpi) f(r, c);
}

// Columns c0 .. c0 + kw of the tile's halo of src (pixel rows of pitch
// ld) as wgmma's K-major core matrices: kw / 8 planes of hr 16-byte rows
// (8 channels of a halo pixel), zero outside the image; then the wait,
// the proxy fence and the barrier.
__device__ __forceinline__ void cons_halo(bf16 *dst, const bf16 *src, int ld,
                                          int c0, int kw, const Geo &g,
                                          const TGeo &t, const TilePos &p) {
  const uint32_t d = saddr(dst);
  cons_chunks(t.hr, kw / 8, [&](int h, int c) {
    const int hy = h / t.hs;
    const int y = p.y0 - t.dmax + hy, x = p.x0 - t.dmax + h - hy * t.hs;
    const bool ok = y >= 0 && y < g.H && x >= 0 && x < g.W;
    const int64_t row = ok ? (static_cast<int64_t>(p.b) * g.H + y) * g.W + x
                           : 0;
    cp16(d + (c * t.hr + h) * 16, src + row * ld + c0 + c * 8, ok);
  });
  cp_commit();
  cp_wait_all();
  fence_proxy_async();
  cons_sync();
}

// Columns c0 .. c0 + kw of the tile's 64 pixel rows of src (pitch ld,
// global memory, possibly written by this block: the fence and barrier
// come first) as kw / 8 planes of 64 16-byte rows, zero outside the
// image.
__device__ __forceinline__ void cons_rows(bf16 *dst, const bf16 *src, int ld,
                                          int c0, int kw, const Geo &g,
                                          const TilePos &p) {
  __threadfence_block();
  cons_sync();   // every warp is done with what dst held
  const uint32_t d = saddr(dst);
  cons_chunks(TP, kw / 8, [&](int r, int c) {
    const int64_t q = tile_pix(g, p, r);
    cp16(d + (c * TP + r) * 16, src + (q < 0 ? 0 : q) * ld + c0 + c * 8,
         q >= 0);
  });
  cp_commit();
  cp_wait_all();
  fence_proxy_async();
  cons_sync();
}

// An A operand in shared memory: K-major core matrices at address a, K
// planes lbo bytes apart, groups of 8 rows sbo apart.
struct AOp {
  uint32_t a, lbo, sbo;
};

// A consumer warpgroup's walk of the weight ring: stage s waits for its
// full barrier, issues its kw / 16 wgmmas on the warpgroup's columns
// (k-steps ascending; a product's first stage starts its accumulators)
// as one group, then waits for the stage before it (so one group is in
// flight while the next is issued) and releases that one's slot (the
// empty barrier counts both warpgroups).
struct Pipe {
  uint32_t bar0, ring;
  int slot_bytes, s, pend;

  // NT: the warpgroup's n8 tiles, from the stage's n8 tile j0
  template <int NT>
  __device__ __forceinline__ void stage(float (&acc)[NT][4], const AOp &A,
                                        int kw, int j0, bool first) {
    const int slot = s % FNS;
    mbar_wait(bar0 + 8 * slot, (s / FNS) & 1);
    const uint32_t sbo = kw * 16, b = ring + slot * slot_bytes + j0 * sbo;
    wgmma_fence();
    for (int ks = 0; ks < kw / 16; ++ks)
      WgmmaSS<NT>::mma(acc, wg_desc(A.a + ks * 2 * A.lbo, A.lbo, A.sbo),
                       wg_desc(b + ks * 256, 128, sbo), !first || ks > 0);
    wgmma_commit();
    if (pend >= 0) {
      wgmma_wait<1>();
      mbar_arrive(bar0 + 8 * (FNS + pend % FNS));
    }
    pend = s++;
  }

  // every issued wgmma done (their A may be overwritten), the last slot
  // released
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    if (pend >= 0) mbar_arrive(bar0 + 8 * (FNS + pend % FNS));
    pend = -1;
  }
};

// The producer warp's lane 0: every weight stage of the tile, in the
// consumers' order, by one bulk copy into slot s % FNS once the stage
// that held it has been released.
__device__ __forceinline__ void fwd_produce(const Geo &g, const FPlan &P,
                                            const bf16 *w, uint32_t ring,
                                            uint32_t bar0) {
  int s = 0;
  int64_t off = 0;
  auto issue = [&](int kw, int n) {
    const int slot = s % FNS;
    if (s >= FNS) mbar_wait(bar0 + 8 * (FNS + slot), ((s / FNS) - 1) & 1);
    const uint32_t bytes = 2u * kw * n;
    mbar_expect_tx(bar0 + 8 * slot, bytes);
    bulk_load(ring + slot * 2 * P.slot, w + off, bytes, bar0 + 8 * slot);
    off += static_cast<int64_t>(kw) * n;
    ++s;
  };
  // the x stages of one K walk: per chunk, per tap (taps 9), per stage
  auto xwalk = [&](int taps, int n) {
    for (int q = 0; q < P.nq; ++q) {
      const int wq = g.kc - q * P.kq < P.kq ? g.kc - q * P.kq : P.kq;
      for (int tap = 0; tap < taps; ++tap)
        for (int u = 0; u < wq; u += P.kbx)
          issue(wq - u < P.kbx ? wq - u : P.kbx, n);
    }
  };
  for (int i = 0; i < g.nb; ++i)
    for (int sl = 0; sl < P.nsl; ++sl) xwalk(9, P.sw);
  for (int c = 0; c < P.nch1; ++c) {
    xwalk(1, FN1);
    if (P.f3)
      for (int v = 0; v < g.knh; v += P.kba)
        issue(g.knh - v < P.kba ? g.knh - v : P.kba, FN1);
  }
}

// The column sums over the tile's 64 rows of v (masked) and of its
// squares (a warpgroup's NT n8 tiles), in a fixed order: each warp's 16
// rows by shuffles into red (the warpgroup's [warp][2][8 NT]), then the
// four warps in order into out[c] and out[c + sq] for c < n.
template <int NT>
__device__ __forceinline__ void wg_colsums(const float (&v)[NT][4],
                                           float *red, int wg, int wm,
                                           int lane, float *out, int sq,
                                           int n) {
  constexpr int W = NT * 8;
  wg_sync(wg);   // the previous sums are read
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = v[j][h] + v[j][2 + h];
      float y = __fadd_rn(__fmul_rn(v[j][h], v[j][h]),
                          __fmul_rn(v[j][2 + h], v[j][2 + h]));
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, m);
        y += __shfl_xor_sync(0xffffffffu, y, m);
      }
      if (lane < 4) {
        red[(2 * wm) * W + j * 8 + lane * 2 + h] = x;
        red[(2 * wm + 1) * W + j * 8 + lane * 2 + h] = y;
      }
    }
  wg_sync(wg);
  for (int c = threadIdx.x & 127; c < n; c += 128) {
    out[c] = ((red[c] + red[2 * W + c]) + red[4 * W + c]) + red[6 * W + c];
    out[c + sq] = ((red[W + c] + red[3 * W + c]) + red[5 * W + c]) +
                  red[7 * W + c];
  }
}

// F1 (F3 = false) or F3 on one 8 x 8 tile of the plan P (see the note at
// the top): threads 0..255 the two consumer warpgroups, each the tile's
// 64 pixels against half of every product's columns, 256..287 the
// producer warp.  F1 writes the tile's partial row [S_r (2C) | S_h
// (2 NH) | the sum of x (C)] (pixels outside the image masked); F3 out
// (M, C) bf16, with a in a_ws (pitch knh, by pixel) where P keeps it out
// of shared memory.
template <int NTB, bool F3>
__device__ __forceinline__ void fwd_wg_body(
    const Geo &g, const TGeo &t, const FPlan &P, const bf16 *xpad,
    const bf16 *w, const float *bnr, const float *bnh, const float *bnt,
    const float *gate, bf16 *out, bf16 *a_ws, float *part) {
  constexpr int HB = NTB / 2, H1 = FNT1 / 2;   // a warpgroup's n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar0 = saddr(smem);   // full[FNS], then empty[FNS]
  bf16 *sW = reinterpret_cast<bf16 *>(smem + FBAR);
  bf16 *sH = sW + FNS * P.slot;        // kq / 8 planes of hr rows
  bf16 *sA = sH + t.hr * P.kq;         // knh / 8 planes of 64 rows
  float *sF = reinterpret_cast<float *>(sA + (F3 && P.a_res ? TP * g.knh : 0));
  // the warp's index, warp-uniform to the compiler (a broadcast): the
  // roles' branches and the wgmmas' control flow are not divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FNS; ++s) {
      mbar_init(bar0 + 8 * s, 1);
      mbar_init(bar0 + 8 * (FNS + s), FC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == FC / 32) {
    if (lane == 0) fwd_produce(g, P, w, saddr(sW), bar0);
    return;
  }

  // ---- the consumers: warpgroup wg's warp wm has pixel rows 16 wm ..
  // and the n8 tiles [wg HB, (wg + 1) HB) of a branch slice, [wg H1,
  // (wg + 1) H1) of a 1x1 chunk
  const int wg = warp >> 2, wm = warp & 3, C = g.C;
  const TilePos pos = tile_pos(t, blockIdx.x);
  Pipe pipe{bar0, saddr(sW), 2 * P.slot, 0, -1};
  // A operands: the halo's centre (a tile row of 8 pixels hs halo rows
  // after the last), a, and rows staged for a stage
  const uint32_t cen = saddr(sH) + (t.dmax * t.hs + t.dmax) * 16;
  const uint32_t hlbo = t.hr * 16, hsbo = t.hs * 16;
  const uint32_t rlbo = TP * 16, rsbo = 8 * 16;
  // x's rows for kr^T come from the halo unless it is chunked or the
  // halo buffer carries restaged a rows (F3 without a_res)
  const bool xrows = P.nq > 1 || (F3 && !P.a_res);
  float *prow =
      F3 ? nullptr
         : part + static_cast<int64_t>(blockIdx.x) * (3 * C + 2 * g.NH);
  float *red = sF + wg * (FRED / 2);   // F1: the warpgroup's sums

  const float *rBr = bnr, *rBt = bnt, *rBh = bnh;
  const float *rG = gate + static_cast<int64_t>(pos.b) * C;
  if (F3 && P.rows_smem) {
    float *sBr = sF, *sBt = sBr + 4 * C, *sG = sBt + 4 * C, *sBh = sG + C;
    for (int i = threadIdx.x; i < 4 * C; i += FC) {
      sBr[i] = bnr[i];
      sBt[i] = bnt[i];
    }
    for (int i = threadIdx.x; i < C; i += FC) sG[i] = rG[i];
    for (int i = threadIdx.x; i < 4 * g.NH; i += FC) sBh[i] = bnh[i];
    rBr = sBr;
    rBt = sBt;
    rG = sG;
    rBh = sBh;
  }
  if (F3) {
    // a's K padding (columns NH .. knh) is zero
    const int pa = g.knh - g.NH;
    for (int i = threadIdx.x; i < TP * pa; i += FC) {
      const int r = i / pa, k = g.NH + i % pa;
      if (P.a_res) {
        sA[((k >> 3) * TP + r) * 8 + (k & 7)] = bzero();
      } else {
        const int64_t p = tile_pix(g, pos, r);
        if (p >= 0) a_ws[p * g.knh + k] = bzero();
      }
    }
  }
  // the lane's fragment rows in the image (e < 2: row r, else r + 8)
  const bool in0 = tile_pix(g, pos, frag_row(wm, lane, 0)) >= 0;
  const bool in1 = tile_pix(g, pos, frag_row(wm, lane, 2)) >= 0;

  // the branch convs: per branch slice, its chunks, taps and stages
  for (int i = 0; i < g.nb; ++i) {
    const int d = g.dil[i];
    for (int sl = 0; sl < P.nsl; ++sl) {
      float acc[HB][4];
      for (int q = 0; q < P.nq; ++q) {
        const int k0 = q * P.kq, wq = g.kc - k0 < P.kq ? g.kc - k0 : P.kq;
        if (P.nq > 1 || (i == 0 && sl == 0)) {
          if (pipe.s > 0) {   // every wgmma is done with the last chunk
            pipe.drain();
            cons_sync();
          }
          cons_halo(sH, xpad, g.kc, k0, wq, g, t, pos);
        }
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int sh = ((tap / 3 - 1) * t.hs + (tap % 3 - 1)) * d;
          for (int u = 0; u < wq; u += P.kbx) {
            const int kw = wq - u < P.kbx ? wq - u : P.kbx;
            pipe.stage<HB>(acc, AOp{cen + (u / 8 * t.hr + sh) * 16, hlbo,
                                    hsbo}, kw, wg * HB,
                           q == 0 && tap == 0 && u == 0);
          }
        }
      }
      pipe.drain();
      fence_acc(acc);
      // the warpgroup's columns of the slice: s0 + n, n < wsl
      const int s0 = sl * P.sw + wg * HB * 8;
      const int wsl = g.hc - s0 < HB * 8 ? g.hc - s0 : HB * 8;
      if (F3) {
        // a = bf16(relu(BN_h(bf16(c)))): a column's BN row loaded once for
        // the lane's two fragment rows
#pragma unroll
        for (int j = 0; j < HB; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = frag_col(lane, j, h);
            const float *bn = rBh + 4 * i * g.hc + s0 + (n < wsl ? n : 0);
            const float mean = bn[0], inv = bn[g.hc], scale = bn[2 * g.hc],
                        bias = bn[3 * g.hc];
            const int k = i * g.hc + s0 + n;
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int e = h + 2 * e2, r = frag_row(wm, lane, e);
              const bf16 ab = f2bf(relu(bn_apply(bfr(acc[j][e]), mean, inv,
                                                 scale, bias)));
              if (n >= wsl) continue;
              if (P.a_res) {
                sA[((k >> 3) * TP + r) * 8 + (k & 7)] = ab;
              } else {
                const int64_t p = tile_pix(g, pos, r);
                if (p >= 0) a_ws[p * g.knh + k] = ab;
              }
            }
          }
      } else {
        float v[HB][4];
#pragma unroll
        for (int j = 0; j < HB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[j][e] = (e < 2 ? in0 : in1) ? bfr(acc[j][e]) : 0.0f;
        if (wsl > 0)
          wg_colsums<HB>(v, red, wg, wm, lane,
                         prow + 2 * C + 2 * i * g.hc + s0, g.hc, wsl);
      }
    }
  }
  if (!F3) {
    // the sum of x over the tile's pixels in the image: the halo's
    // centre rows (zero outside the image), or x's rows where the halo
    // went in chunks
    for (int c = threadIdx.x; c < C; c += FC) {
      const bf16 *plane = sH + (c >> 3) * t.hr * 8 + (c & 7);
      float sum = 0.0f;
      for (int r = 0; r < TP; ++r) {
        if (P.nq == 1) {
          sum += bf2f(plane[(((r >> 3) + t.dmax) * t.hs + (r & 7) + t.dmax) *
                            8]);
        } else {
          const int64_t p = tile_pix(g, pos, r);
          if (p >= 0) sum += bf2f(xpad[p * g.kc + c]);
        }
      }
      prow[2 * C + 2 * g.NH + c] = sum;
    }
  }
  if (F3 && P.a_res) {   // a is whole in sA for every warp's wgmmas
    fence_proxy_async();
    cons_sync();
  }

  // the 1x1 convs in chunks of FN1 output columns: kr^T over x's K
  // stages, then (F3) kt^T over a's
  for (int c = 0; c < P.nch1; ++c) {
    const int n0 = c * FN1 + wg * H1 * 8;   // the warpgroup's columns
    float acr[H1][4], at[H1][4];
    for (int q = 0; q < P.nq; ++q) {
      const int k0 = q * P.kq, wq = g.kc - k0 < P.kq ? g.kc - k0 : P.kq;
      for (int u = 0; u < wq; u += P.kbx) {
        const int kw = wq - u < P.kbx ? wq - u : P.kbx;
        AOp A{cen + u / 8 * t.hr * 16, hlbo, hsbo};
        if (xrows) {
          pipe.drain();
          cons_rows(sH, xpad, g.kc, k0 + u, kw, g, pos);
          A = AOp{saddr(sH), rlbo, rsbo};
        }
        pipe.stage<H1>(acr, A, kw, wg * H1, q == 0 && u == 0);
      }
    }
    if (F3) {
      for (int v = 0; v < g.knh; v += P.kba) {
        const int kw = g.knh - v < P.kba ? g.knh - v : P.kba;
        AOp A{saddr(sA) + v / 8 * TP * 16, rlbo, rsbo};
        if (!P.a_res) {
          pipe.drain();
          cons_rows(sH, a_ws, g.knh, v, kw, g, pos);
          A = AOp{saddr(sH), rlbo, rsbo};
        }
        pipe.stage<H1>(at, A, kw, wg * H1, v == 0);
      }
    }
    pipe.drain();
    fence_acc(acr);
    if (F3) fence_acc(at);
    if (F3) {
      // out = bf16(relu(relu(BN_r(bf16(x kr))) + relu(BN_t(bf16(a kt)))
      // gate)): a column's rows and gate loaded once for the lane's two
      // fragment rows, only the stores masked
      const int64_t p0 = tile_pix(g, pos, frag_row(wm, lane, 0));
      const int64_t p1 = tile_pix(g, pos, frag_row(wm, lane, 2));
#pragma unroll
      for (int j = 0; j < H1; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + frag_col(lane, j, h);
          const int cc = col < C ? col : C - 1;
          const float mr = rBr[cc], ir = rBr[C + cc], sr = rBr[2 * C + cc],
                      br = rBr[3 * C + cc];
          const float mt = rBt[cc], it = rBt[C + cc], st = rBt[2 * C + cc],
                      bt = rBt[3 * C + cc];
          const float gt = rG[cc];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int e = h + 2 * e2;
            const float res = relu(bn_apply(bfr(acr[j][e]), mr, ir, sr, br));
            const float y = relu(bn_apply(bfr(at[j][e]), mt, it, st, bt));
            const float pre = __fadd_rn(res, __fmul_rn(y, gt));
            const int64_t p = e2 ? p1 : p0;
            if (p >= 0 && col < C) out[p * C + col] = f2bf(relu(pre));
          }
        }
    } else {
      float v[H1][4];
#pragma unroll
      for (int j = 0; j < H1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[j][e] = (e < 2 ? in0 : in1) ? bfr(acr[j][e]) : 0.0f;
      if (n0 < C)
        wg_colsums<H1>(v, red, wg, wm, lane, prow + n0, C,
                       C - n0 < H1 * 8 ? C - n0 : H1 * 8);
    }
  }
}

// F1's partial rows (n_tiles x (3C + 2 NH) f32) on the plan P.
template <int NTB>
__global__ void __launch_bounds__(FT, 1)
f1_wg_kernel(Geo g, TGeo t, FPlan P, const bf16 *__restrict__ xpad,
             const bf16 *__restrict__ w, float *__restrict__ part) {
  fwd_wg_body<NTB, false>(g, t, P, xpad, w, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, part);
}

// F3's output (M, C) bf16 on the plan P; a_ws (M, knh) where P keeps a
// out of shared memory.
template <int NTB>
__global__ void __launch_bounds__(FT, 1)
f3_wg_kernel(Geo g, TGeo t, FPlan P, const bf16 *__restrict__ xpad,
             const bf16 *__restrict__ w, const float *__restrict__ bnr,
             const float *__restrict__ bnh, const float *__restrict__ bnt,
             const float *__restrict__ gate, bf16 *__restrict__ out,
             bf16 *__restrict__ a_ws) {
  fwd_wg_body<NTB, true>(g, t, P, xpad, w, bnr, bnh, bnt, gate, out, a_ws,
                         nullptr);
}

// ------------------------------------------------------------ host side

// tile_geo for F1 and F3 (op), with the plan here (P) where cam_tile.cuh
// would take its wide plan (t->wide); it refuses what that plan refuses.
inline bool fwd_geo(const int *geo, int op, Geo *g, TGeo *t, FPlan *P) {
  if (!tile_geo(geo, op, g, t)) return false;
  *P = FPlan{};
  if (!t->wide) return true;
  *P = make_fplan(*g, *t, op);
  return P->nst > 0 && P->smem <= SMEM_MAX;
}

// cam_f1_plan / cam_f3_plan: tile_plan's values (what 0..9), where the
// plan here runs (wide) its shared memory (0), re-laid weights (2), x's
// K chunk (5), a's stage width (6) and branch slices (9); then 10: the
// plan here runs, 11: its n8 tiles of a slice, 12: its x stage width,
// 13: a in shared memory, 14: the BN rows there, 15: its stages a tile
// (0 for 10..15 where it does not run); -1 for an invalid geometry.
inline long long fwd_plan(const int *geo, int op, int what) {
  Geo g;
  TGeo t;
  FPlan P;
  if (!fwd_geo(geo, op, &g, &t, &P)) return -1;
  if (!t.wide) return what < 10 ? tile_plan(geo, op, what) : 0;
  switch (what) {
    case 0: return P.smem;
    case 1: return 0;
    case 2: return P.w_elems;
    case 3: return 0;
    case 4: return 1;
    case 5: return P.kq;
    case 6: return P.kba;
    case 7: return t.kq1r;
    case 8: return t.kq1c;
    case 9: return P.nsl;
    case 10: return 1;
    case 11: return P.ntb;
    case 12: return P.kbx;
    case 13: return P.a_res;
    case 14: return P.rows_smem;
    case 15: return P.nst;
    default: return -1;
  }
}

// Launch kernel K<ntb> of P (FT threads, P.smem bytes of shared memory).
template <typename... P_, typename... A>
cudaError_t launch_fwd(void (*kern)(P_...), int64_t smem, int n_tiles,
                       cudaStream_t st, A... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<n_tiles, FT, static_cast<size_t>(smem), st>>>(args...);
  return cudaGetLastError();
}

#define CAM_WG_LAUNCH(K, g, t, P, st, ...)                                  \
  [&]() -> cudaError_t {                                                    \
    switch ((P).ntb) {                                                      \
      case 2: return tile::launch_fwd(K<2>, (P).smem, (t).n_tiles, st, g, t, \
                                      P, __VA_ARGS__);                      \
      case 4: return tile::launch_fwd(K<4>, (P).smem, (t).n_tiles, st, g, t, \
                                      P, __VA_ARGS__);                      \
      case 6: return tile::launch_fwd(K<6>, (P).smem, (t).n_tiles, st, g, t, \
                                      P, __VA_ARGS__);                      \
      case 8: return tile::launch_fwd(K<8>, (P).smem, (t).n_tiles, st, g, t, \
                                      P, __VA_ARGS__);                      \
      case 12: return tile::launch_fwd(K<12>, (P).smem, (t).n_tiles, st, g, \
                                       t, P, __VA_ARGS__);                  \
      case 16: return tile::launch_fwd(K<16>, (P).smem, (t).n_tiles, st, g, \
                                       t, P, __VA_ARGS__);                  \
      default: return cudaErrorInvalidValue;                                \
    }                                                                       \
  }()

}  // namespace tile
}  // namespace cam
