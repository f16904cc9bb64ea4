// The fused-CAM ops' kernels, CUDA C++ for sm_90a (cam_f1.cu, cam_f2.cu
// and cam_f3.cu include this header): f1_wg_kernel, f2_wg_kernel,
// f3_wg_kernel and the three backwards' phase 0, f1b_wg_kernel,
// f2b_wg_kernel and f3b_wg_kernel (one body, fwd_wg_body, in six modes),
// and dx_wg_kernel (phase 1 of all three backwards), at every geometry
// the ops take: the train step's CAMs at the default --inplanes 80 (C =
// 163, hc = 40, dilations 1-3; C = 83, hc = 20, 1-4), every wider
// --inplanes, six dilations up to 6 or 8 at C = 163.
//
// Replaces the TPU kernels _f1_call / _f1_kernel (the batch statistics
// S_r, S_h and the per-image sum of x), _f2_call / _f2_kernel (s_t, the
// sums of t = bf16(a kt) and t^2), _f3_call / _f3_kernel (out =
// relu(relu(BN_r(x kr)) + relu(BN_t(a kt)) gate[b]), a = relu(BN_h(c)), c
// the dilated 3x3 branch convs), the phase 0 of _f1b_call / _f1b_kernel
// (F1's recompute, dc_i = dsh[2i] + 2 c_i dsh[2i+1], dr = dsr[0] + 2
// bf16(x kr) dsr[1]), of _f2b_call / _f2b_kernel (the branch convs and t
// = a kt, dt = dst[0] + 2 t dst[1], the branch backward dc, dS_h) and of
// _f3b_call / _f3b_kernel (F3's recompute, do, dgate, the residual and
// top BN backward dr, dt, the branch backward dc, dS_h) and the phase 1
// of all three (dx = bf16(dr) kr^T + the transposed branch convs of dc,
// F1b's + dgap / (H W)) of rtpe_tpu/ops/pallas_cam.py, with the rounding
// points of the port's ops: bf16 of every conv before its statistics and
// BN, bf16(a), bf16 of dr, dt and dc, dx rounded once; the BN and
// cotangent arithmetic in the _rn intrinsics in the JAX order.
//
// Bound at the train step's CAMs (B = 16, 113 x 113, 204,304 pixels;
// 989 TFLOP/s bf16 dense): operations.  At C = 163, hc = 40, dilations
// 1-3, F3 does C^2 + 9 nb C hc + nb hc C = 222.2 K multiply-adds a pixel
// (0.092 ms), F1 and F1b's phase 0 C^2 + 9 nb C hc = 202.6 K (0.084 ms),
// F2 9 nb C hc + nb hc C = 195.6 K (0.081 ms); each backward about 3x its
// forward.  At --inplanes 128's step CAM (C = 259, hc = 64) F3 564.4 K
// (0.233 ms), F1 514.6 K (0.213 ms), F2b's phase 0 547.0 K (0.226 ms),
// F3b's 614.1 K (0.254 ms), F2 497.3 K (0.206 ms), dx 514.6 K (F2b,
// without dr, 447.6 K): 0.213 / 0.185 ms.  x is read once in 0.03 ms.
//
// The first designs (cam_tile.cuh, gone) ran mma.sync m16n8k16 tiles:
// at the train step's shapes the whole-depth plan (a branch of at most 40
// columns, the x halo at full depth, 56-column 1x1 chunks, a ring of three
// cp.async stages behind a __syncthreads each; dx 168 output channels a
// block), 1.8-1.97 ms a forward call and 3.8-4.9 a backward at C = 163 on
// one H100 (700 W); wider geometries a K-chunked plan of ~100 stages a
// tile that restaged the halo for every branch slice.  What this design
// does about it:
//   - a tile is 8 x 8 pixels of one image, numbered image-major (a
//     per-tile partial is a per-image partial, as the GAP needs): 113 =
//     14 x 8 + 1, so 15 x 15 tiles cover a 113 x 113 image, 12.8 % more
//     pixels than it has; a pixel outside the image has zero rows, its
//     outputs are not written and every per-tile sum masks it (its
//     dilated taps can reach into the image, and its BN bias alone makes
//     its activations nonzero);
//   - a product's N is the whole branch (up to 128 columns: hc = 20, 40,
//     48, 64, 128 in one slice; wider branches in slices of at most 128),
//     so a branch's accumulators stay in registers across its taps and K
//     stages; the 1x1 convs go in chunks of 64 output columns; dx takes
//     every output column in one block (column passes of 16 NTW n8
//     tiles, NTW <= 17: one pass up to C = 272).  Two consumer
//     warpgroups (8 warps) multiply the tile's 64 pixels by wgmma
//     m64 x N/2 x 16, each against half of every product's columns (its
//     own accumulators and epilogue), so one's epilogue and waits overlap
//     the other's wgmmas;
//   - A and B both come from shared memory by descriptor, so a stage's
//     k-steps issue back to back as one wgmma group, and the next stage's
//     group issues while it runs (a product's first wgmma starts its
//     accumulators: nothing else writes them, and the warp index is a
//     broadcast, so ptxas sees uniform control flow and serialises no
//     wgmma): a halo (x, or dx's dc) is laid out as wgmma's K-major core
//     matrices (planes of 8 channels, one 16-byte row a halo pixel), so a
//     tap is the descriptor's start moved by the tap's shift (dx's by
//     minus it) and the tile's next row of 8 pixels is hs rows on (the
//     stride offset); a, dr's and dt's rows, and rows staged for a stage,
//     are planes of 64 rows;
//   - B, the weights the wrapper re-lays once per call in walking order
//     (ops/cam.py:_wg_weights, _dx_weights, one gather a call; each stage
//     a [N / 8][kw][8] block, the wgmma's N-major core matrices), arrives
//     by one bulk copy a stage into a ring of 4 slots that one producer
//     warp keeps full, each slot with a full and an empty mbarrier: no
//     block-wide barrier a stage (at C = 163 one stage a tap, K = 176);
//   - the x halo is staged once a tile at full depth where it fits (C =
//     163: 196 rows x 176 channels, 69 KB; C = 259: 107 KB), else in K
//     chunks (C = 515), once per branch and chunk, with 16-byte cp.async
//     (zero fill outside the image through the src-size operand); dx's dc
//     halo once a tile, whole where it fits beside dr's rows and the
//     ring, else a branch (or a K chunk of one) at a time in two buffers,
//     the next chunk's copies in flight while this one multiplies;
//   - a stays in shared memory (64 x 128 at C = 163) for the kt^T
//     product; the BN rows and image b's gate are staged there once a
//     tile.  Only a geometry where these do not fit reads its rows from
//     global memory and takes a (and x's rows for kr^T) through rows
//     staged a stage at a time;
//   - the branch backward (F2b, F3b) keeps c out of shared memory (each
//     thread writes its fragment of c to c's global rows and reads the
//     same elements back) and dt too: its rows go to global memory for dkt
//     and come back into the halo's buffer once x's last product has
//     completed, whole where they fit (else in chunks);
//   - F1b's and F2b's phase 0 are F1's and F3b's bodies with other
//     epilogues: F1b stores dc after each branch slice and dr after each
//     1x1 chunk (no column sums; dsr and dsh staged where F1 keeps its
//     column-sum scratch), F2b runs no x kr^T and stores dt = dst[0] +
//     2 t dst[1] where F3b runs F3's epilogue; F2 is F2b's products
//     without the branch backward, its epilogue F1's column sums of
//     bf16(t) and t^2 (bnh staged where it fits, the scratch after it);
//   - a backward's phase 0 writes what dx and the weight gradients read
//     (dr, dt of pitch kc; a, c of pitch knh; dc of pitch nb khc, zero
//     padding columns) to the workspace; dx is a second launch, since it
//     reads dc across tiles.
// Every reduction over pixels is a per-tile partial row summed over tiles
// in a fixed order (cam_core.cuh:reduce_rows), no float atomics.  The
// per-pixel rounding points are the first design's; each product adds its
// K stages, taps and k-steps in ascending order.

#pragma once

#include "cam_core.cuh"

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


template <>
struct WgmmaSS<12> {
  __device__ __forceinline__ static void mma(float (&d)[12][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47"
        "}, "
        "%48, %49, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<14> {
  __device__ __forceinline__ static void mma(float (&d)[14][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55"
        "}, "
        "%56, %57, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<17> {
  __device__ __forceinline__ static void mma(float (&d)[17][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67"
        "}, "
        "%68, %69, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};


namespace tile {

// ------------------------------------------------------------ tiles

constexpr int TS = 8;             // tile side; TS * TS == TP
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of a block

// The backwards, then the forwards.
enum Op { F1B = 1, F2B = 2, F3B = 3, F1 = 4, F3 = 5, F2 = 6 };

// The tiling of one call; ops/cam.py:tile_plan computes the same.
struct TGeo {
  int op;                     // F1B, F2B, F3B, F1, F3 or F2
  int res, top, bb;           // phase 0 runs x kr^T, a kt^T and the
                              // branch backward
  int bwd;                    // a backward: it has a phase 1 (dx)
  int tiles_x, tpi, n_tiles;  // tiles per image row, per image, in all
  int dmax, hs, hr;           // largest dilation, halo side, halo rows
  int ldc;                    // dc row pitch: nb khc
};

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
  t.ldc = g.nb * g.khc;
  return t;
}

// Chunks of K (a multiple of 16) at most kmax wide: as few as fit, of
// even width (to 16), the last one what is left.
inline void k_chunks(int K, int kmax, int *w, int *n) {
  *n = (K + kmax - 1) / kmax;
  *w = ((K + *n - 1) / *n + 15) / 16 * 16;
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

// 16 bytes global -> shared, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp16(uint32_t dst, const void *src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
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

// ------------------------------------------------------------ plans

constexpr int FWG = 2;               // consumer warpgroups: N halves
constexpr int FC = 128 * FWG;        // consumer threads
constexpr int FT = FC + 32;          // and the producer warp
constexpr int FNS = 4;               // ring slots
constexpr int FN1 = 64;              // columns of a 1x1-conv chunk
constexpr int FNT1 = FN1 / 8;
constexpr int FNB_MAX = 16;          // n8 tiles of a branch slice at most
constexpr int FBAR = 128;            // bytes before the ring: the mbarriers
constexpr int FRED = 4 * 2 * FNB_MAX * 8;   // F1's and F2's column-sum
                                            // scratch, f32 (a half each
                                            // warpgroup)
constexpr int FRED3 = 2 * 4 * 5 * FN1 / 2;  // the branch backward's (F2b,
                                            // F3b): 4 warps x 5 sums x a
                                            // warpgroup's 32 1x1 columns
                                            // (F3b), or 2 sums x 64
                                            // columns of a branch slice
                                            // each

// The plan of f1_wg_kernel, f2_wg_kernel, f3_wg_kernel and the
// backwards' phase-0 kernels (f1b_wg_kernel, f2b_wg_kernel,
// f3b_wg_kernel) at one geometry; ops/cam.py:_wg_plan computes the same.
struct FPlan {
  int res, top, bb;     // the products: x kr^T (F1, F3, F1b, F3b), a kt^T
                        // (F2, F3, F2b, F3b), the branch backward (F2b,
                        // F3b)
  int ntb, sw, nsl;     // a branch slice's n8 tiles and columns; slices
  int nch1;             // 1x1-conv chunks of FN1 output columns
  int kq, nq;           // the x halo's K chunks: width, count
  int kbx;              // a stage's K width within an x chunk (at most)
  int kba, nba;         // top: the kt^T stages' K width over knh, count
  int a_res;            // top: a kept in shared memory (else in global
                        // rows, restaged a stage at a time)
  int rows_smem;        // the epilogues' rows in shared memory: F3's and
                        // F3b's BN rows and gate, F2b's dst and bnh, F2's
                        // bnh (else read from global memory); F1b's dsr
                        // and dsh always
  int kdq, nd, kbd;     // bb: dt's chunks of kc staged in the halo's
                        // buffer (width, count) and their stages' width
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

// f32 elements of the rows op's epilogues read: F1b dsr (2C) and dsh
// (2 NH), F2b dst (2C) and bnh (4 NH), F2 bnh (4 NH), F3 and F3b bnr and
// bnt (4C each), image b's gate (C) and bnh (4 NH).
__host__ __device__ inline int64_t fplan_rows(const Geo &g, int op) {
  return op == F1B   ? 2LL * g.C + 2LL * g.NH
         : op == F2B ? 2LL * g.C + 4LL * g.NH
         : op == F2  ? 4LL * g.NH
         : op == F1  ? 0
                     : 9LL * g.C + 4LL * g.NH;
}

// Shared memory besides the ring: the mbarriers, the x halo (chunk of kq
// channels: kq / 8 planes of hr 16-byte rows), a (top, a_res: knh / 8
// planes of 64 rows), then in f32 the epilogues' rows (rows_smem) and the
// column-sum scratch (F1's and F2's, or the branch backward's).
inline int64_t fplan_fixed(const Geo &g, const TGeo &t, int kq, int a_res,
                           int rows_smem) {
  int64_t b = FBAR + 2LL * t.hr * kq;
  if (t.top && a_res) b += 2LL * TP * g.knh;
  if (rows_smem) b += 4LL * fplan_rows(g, t.op);
  if (t.bb) b += 4LL * FRED3;
  if (t.op == F1 || t.op == F2) b += 4LL * FRED;
  return b;
}

// The plan: the first of these that fits SMEM_MAX with stages at least
// min(64, kq) wide (else 16): a and the rows in shared memory, then the
// rows in global memory, then a too (top); within each, the x halo in as
// few K chunks as leave that room for FNS ring slots.  The branch
// backward keeps no more: c goes to its global rows (each thread reads
// back what it wrote), dt to its global rows and back into the halo's
// buffer once the last product that reads x has completed (whole where
// 64 kc fits the buffer, else in chunks).
inline FPlan make_fplan(const Geo &g, const TGeo &t) {
  FPlan p{};
  p.res = t.res;
  p.top = t.top;
  p.bb = t.bb;
  const int n8 = (g.hc + 7) / 8;
  p.nsl = (n8 + FNB_MAX - 1) / FNB_MAX;
  p.ntb = fplan_ntb((n8 + p.nsl - 1) / p.nsl);
  p.sw = 8 * p.ntb;
  p.nch1 = (g.C + FN1 - 1) / FN1;
  const int nw = p.sw > FN1 ? p.sw : FN1;
  p.nst = -1;
  int kb = -1;
  for (int thr = 64; thr >= 16 && kb < 0; thr -= 48)
    for (int m = 0; m < (p.top ? 3 : 1) && kb < 0; ++m) {
      const int a_res = p.top && m < 2;
      const int rows = p.top ? m < 1 : t.op == F1B;
      int prev = 0;
      for (int nq = 1;; ++nq) {
        const int kq = up16((g.kc + nq - 1) / nq);
        if (kq == prev) continue;
        prev = kq;
        const int64_t avail = SMEM_MAX - fplan_fixed(g, t, kq, a_res, rows);
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
  // rows restaged into the halo buffer (64 a plane): at most cap wide
  const int64_t cap = 1LL * t.hr * p.kq / TP / 16 * 16;
  if (p.top) {
    int ka = kb;
    if (!p.a_res) ka = static_cast<int>(cap < ka ? cap : ka);
    k_chunks(g.knh, ka, &p.kba, &p.nba);
  }
  p.kdq = p.nd = p.kbd = 0;
  int nud = 0;   // bb: dt's stages over its chunks
  if (p.bb) {
    if (g.kc <= cap) {
      p.kdq = g.kc;
      p.nd = 1;
    } else {
      k_chunks(g.kc, static_cast<int>(cap), &p.kdq, &p.nd);
    }
    k_chunks(p.kdq, kb, &p.kbd, &n);
    for (int q = 0; q < p.nd; ++q) {
      const int wd = g.kc - q * p.kdq < p.kdq ? g.kc - q * p.kdq : p.kdq;
      nud += (wd + p.kbd - 1) / p.kbd;
    }
  }
  int kmax = p.kbx > p.kba ? p.kbx : p.kba;
  kmax = p.kbd > kmax ? p.kbd : kmax;
  p.slot = kmax * nw;
  p.smem = fplan_fixed(g, t, p.kq, p.a_res, p.rows_smem) + 2LL * FNS * p.slot;
  int nu = 0;   // K stages over all of x's chunks
  for (int q = 0; q < p.nq; ++q) {
    const int wq = g.kc - q * p.kq < p.kq ? g.kc - q * p.kq : p.kq;
    nu += (wq + p.kbx - 1) / p.kbx;
  }
  p.nst = 9 * g.nb * p.nsl * nu + p.nch1 * (p.res * nu + p.top * p.nba) +
          p.bb * g.nb * p.nsl * nud;
  p.w_elems = 9LL * g.nb * p.nsl * g.kc * p.sw +
              static_cast<int64_t>(p.nch1) * FN1 *
                  (p.res * g.kc + p.top * g.knh) +
              1LL * p.bb * g.nb * p.nsl * g.kc * p.sw;
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
// (a warp covers 32 / cpr rows at a time, or one row in steps of 32
// chunks when cpr > 32).
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

// The copies (one commit group) of columns c0 .. c0 + kw of the tile's
// halo of src (pixel rows of pitch ld) as wgmma's K-major core matrices:
// kw / 8 planes of hr 16-byte rows (8 channels of a halo pixel), zero
// outside the image.
__device__ __forceinline__ void halo_copies(bf16 *dst, const bf16 *src,
                                            int ld, int c0, int kw,
                                            const Geo &g, const TGeo &t,
                                            const TilePos &p) {
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
}

// ... and of columns c0 .. c0 + kw of the tile's 64 pixel rows of src as
// kw / 8 planes of 64 16-byte rows, zero outside the image.
__device__ __forceinline__ void rows_copies(bf16 *dst, const bf16 *src,
                                            int ld, int c0, int kw,
                                            const Geo &g, const TilePos &p) {
  const uint32_t d = saddr(dst);
  cons_chunks(TP, kw / 8, [&](int r, int c) {
    const int64_t q = tile_pix(g, p, r);
    cp16(d + (c * TP + r) * 16, src + (q < 0 ? 0 : q) * ld + c0 + c * 8,
         q >= 0);
  });
  cp_commit();
}

// Zero the padding columns of the tile's rows of out (pitch ld), over the
// consumer threads: in each of n groups of pitch gp, the columns w..gp
// (dc: nb groups of khc with hc written).
__device__ __forceinline__ void zero_pad_cols(bf16 *out, int ld, int n,
                                              int gp, int w, const Geo &g,
                                              const TilePos &pos) {
  const int pw = gp - w, row = n * pw;
  for (int k = threadIdx.x; k < TP * row; k += FC) {
    const int64_t p = tile_pix(g, pos, k / row);
    const int u = k % row;
    if (p >= 0) out[p * ld + (u / pw) * gp + w + u % pw] = bzero();
  }
}

// The consumers' copies landed, seen by the async proxy and every warp.
__device__ __forceinline__ void cons_landed() {
  cp_wait_all();
  fence_proxy_async();
  cons_sync();
}

// The tile's halo columns (halo_copies), landed.
__device__ __forceinline__ void cons_halo(bf16 *dst, const bf16 *src, int ld,
                                          int c0, int kw, const Geo &g,
                                          const TGeo &t, const TilePos &p) {
  halo_copies(dst, src, ld, c0, kw, g, t, p);
  cons_landed();
}

// The tile's row columns (rows_copies) from global memory possibly
// written by this block (the fence and barrier come first), landed.
__device__ __forceinline__ void cons_rows(bf16 *dst, const bf16 *src, int ld,
                                          int c0, int kw, const Geo &g,
                                          const TilePos &p) {
  __threadfence_block();
  cons_sync();   // every warp is done with what dst held
  rows_copies(dst, src, ld, c0, kw, g, p);
  cons_landed();
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
    if (P.res) xwalk(1, FN1);
    if (P.top)
      for (int v = 0; v < g.knh; v += P.kba)
        issue(g.knh - v < P.kba ? g.knh - v : P.kba, FN1);
  }
  // the branch backward: per branch slice, dt's chunks and stages
  if (P.bb)
    for (int i = 0; i < g.nb * P.nsl; ++i)
      for (int q = 0; q < g.kc; q += P.kdq) {
        const int wd = g.kc - q < P.kdq ? g.kc - q : P.kdq;
        for (int u = 0; u < wd; u += P.kbd)
          issue(wd - u < P.kbd ? wd - u : P.kbd, P.sw);
      }
}

// The column sums over the tile's 64 rows of the K arrays v (masked; a
// warpgroup's NT n8 tiles), in a fixed order: each warp's 16 rows by
// shuffles into red (the warpgroup's [warp][K][8 NT]), then the four
// warps in order into out[off[k] + c] for c < n.
template <int NT, int K>
__device__ __forceinline__ void wg_sums(const float (&v)[K][NT][4],
                                        float *red, int wg, int wm,
                                        int lane, float *out,
                                        const int (&off)[K], int n) {
  constexpr int W = NT * 8;
  wg_sync(wg);   // the previous sums are read
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = v[k][j][h] + v[k][j][2 + h];
#pragma unroll
        for (int m = 4; m < 32; m <<= 1)
          x += __shfl_xor_sync(0xffffffffu, x, m);
        if (lane < 4) red[(wm * K + k) * W + j * 8 + lane * 2 + h] = x;
      }
  wg_sync(wg);
  for (int c = threadIdx.x & 127; c < n; c += 128)
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[off[k] + c] = ((red[k * W + c] + red[(K + k) * W + c]) +
                         red[(2 * K + k) * W + c]) +
                        red[(3 * K + k) * W + c];
}

// A backward's phase-0 operands besides the forwards': the output
// cotangent (M, C; F3b), the statistics' cotangents (F1b dsr (2, C) and
// dsh (2 nb, hc); F2b dst (2, C)) and the scratch rows it writes: dr and
// dt (pitch kc, zero past C), dc (pitch ldc, branch i at i khc, zero past
// hc) and c (pitch knh).
struct BwdRows {
  const bf16 *gout;
  const float *dsr, *dsh, *dst;
  bf16 *dr, *dt, *dc, *cb;
};

enum WgMode {
  WG_F1 = 0, WG_F3 = 1, WG_F3B = 2, WG_F1B = 3, WG_F2B = 4, WG_F2 = 5
};

// A forward or a backward's phase 0 (MODE) on one 8 x 8 tile of the plan
// P (see the note at the top): threads 0..255 the two consumer
// warpgroups, each the tile's 64 pixels against half of every product's
// columns, 256..287 the producer warp.  F1 writes the tile's partial row
// [S_r (2C) | S_h (2 NH) | the sum of x (C)], F2 its [S_t (C) | S_t^2
// (C)] (pixels outside the image masked); F3 out (M, C) bf16; F2 and F3
// put a in a_ws (pitch knh, by pixel) where P keeps it out of shared
// memory.  F1b runs F1's products and writes dc and dr to
// R's rows; F2b runs the branch convs and a kt^T, writes a to a_ws, c, dt
// and dc to R's rows and the partial row dS_h (2 NH); F3b recomputes F3's
// products and writes a to a_ws, c, dr, dt and dc to R's rows and the
// partial row [dSr (2C) | dSt (2C) | dS_h (2 NH) | dgate (C)]; each with
// the first design's arithmetic and rounding points (see the note at the
// top).
template <int NTB, int MODE>
__device__ __forceinline__ void fwd_wg_body(
    const Geo &g, const TGeo &t, const FPlan &P, const bf16 *xpad,
    const bf16 *w, const float *bnr, const float *bnh, const float *bnt,
    const float *gate, bf16 *out, bf16 *a_ws, float *part,
    const BwdRows &R) {
  constexpr bool F3 = MODE == WG_F3 || MODE == WG_F3B;
  constexpr bool RES = MODE != WG_F2B && MODE != WG_F2;   // x kr^T
  constexpr bool TOP = F3 || MODE == WG_F2B || MODE == WG_F2;   // a kt^T
  constexpr bool BB = MODE == WG_F3B || MODE == WG_F2B;
  constexpr int HB = NTB / 2, H1 = FNT1 / 2;   // a warpgroup's n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar0 = saddr(smem);   // full[FNS], then empty[FNS]
  bf16 *sW = reinterpret_cast<bf16 *>(smem + FBAR);
  bf16 *sH = sW + FNS * P.slot;        // kq / 8 planes of hr rows
  bf16 *sA = sH + t.hr * P.kq;         // knh / 8 planes of 64 rows
  float *sF = reinterpret_cast<float *>(sA + (TOP && P.a_res ? TP * g.knh : 0));
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
  // halo buffer carries restaged a rows (without a_res)
  const bool xrows = P.nq > 1 || (TOP && !P.a_res);
  // the partial row: F1's, F2's, F3b's or F2b's (dS_h only)
  const int64_t pld = MODE == WG_F1    ? 3 * C + 2 * g.NH
                      : MODE == WG_F2  ? 2 * C
                      : MODE == WG_F3B ? 5 * C + 2 * g.NH
                                       : 2 * g.NH;
  float *prow = MODE == WG_F1 || MODE == WG_F2 || BB
                    ? part + static_cast<int64_t>(blockIdx.x) * pld
                    : nullptr;
  // F1's, F2's and the branch backward's column sums: the warpgroup's
  // scratch, after the rows staged there (F2, F2b, F3b)
  float *red = sF + (P.rows_smem ? fplan_rows(g, t.op) : 0) +
               wg * ((BB ? FRED3 : FRED) / 2);

  // the epilogues' rows: BN (F3, F3b: bnr, bnt, gate[b]; bnh), F2b's
  // dst and bnh, F2's bnh, F1b's dsr and dsh, staged once a tile where
  // P.rows_smem
  const float *rBr = bnr, *rBt = bnt, *rBh = bnh;
  const float *rG = F3 ? gate + static_cast<int64_t>(pos.b) * C : nullptr;
  const float *rD0 = MODE == WG_F1B ? R.dsr : R.dst, *rDh = R.dsh;
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
  if ((MODE == WG_F2B && P.rows_smem) || MODE == WG_F1B) {
    // [d0 (2C) | F2b: bnh (4 NH), F1b: dsh (2 NH)]
    float *sD0 = sF, *sD1 = sF + 2 * C;
    const float *d1 = MODE == WG_F2B ? bnh : R.dsh;
    for (int i = threadIdx.x; i < 2 * C; i += FC) sD0[i] = rD0[i];
    for (int i = threadIdx.x; i < (MODE == WG_F2B ? 4 : 2) * g.NH; i += FC)
      sD1[i] = d1[i];
    rD0 = sD0;
    if (MODE == WG_F2B)
      rBh = sD1;
    else
      rDh = sD1;
  }
  if (MODE == WG_F2 && P.rows_smem) {
    for (int i = threadIdx.x; i < 4 * g.NH; i += FC) sF[i] = bnh[i];
    rBh = sF;
  }
  if (TOP) {
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
  const int64_t p0 = tile_pix(g, pos, frag_row(wm, lane, 0));
  const int64_t p1 = tile_pix(g, pos, frag_row(wm, lane, 2));

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
      if (TOP) {
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
              const float cv = bfr(acc[j][e]);
              const bf16 ab = f2bf(relu(bn_apply(cv, mean, inv, scale, bias)));
              if (n >= wsl) continue;
              if (P.a_res) sA[((k >> 3) * TP + r) * 8 + (k & 7)] = ab;
              if (BB || !P.a_res) {   // a for dkt, c for the backward
                const int64_t p = e2 ? p1 : p0;
                if (p >= 0) {
                  a_ws[p * g.knh + k] = ab;
                  if (BB) R.cb[p * g.knh + k] = f2bf(cv);
                }
              }
            }
          }
      } else if (MODE == WG_F1B) {
        // dc_i = bf16(dsh[2i] + 2 bf16(c) dsh[2i + 1]): a column's rows
        // loaded once for the lane's two fragment rows
#pragma unroll
        for (int j = 0; j < HB; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = frag_col(lane, j, h), col = s0 + n;
            const float *ds = rDh + 2 * i * g.hc + (n < wsl ? col : 0);
            const float d0 = ds[0], d1 = ds[g.hc];
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int64_t p = e2 ? p1 : p0;
              if (n >= wsl || p < 0) continue;
              const float cb = bfr(acc[j][h + 2 * e2]);
              R.dc[p * t.ldc + i * g.khc + col] =
                  f2bf(__fadd_rn(d0, __fmul_rn(__fmul_rn(2.0f, cb), d1)));
            }
          }
      } else {
        // F1: the column sums of bf16(c) and of its squares
        float v[2][HB][4];
#pragma unroll
        for (int j = 0; j < HB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[0][j][e] = (e < 2 ? in0 : in1) ? bfr(acc[j][e]) : 0.0f;
            v[1][j][e] = __fmul_rn(v[0][j][e], v[0][j][e]);
          }
        const int off[2] = {2 * C + 2 * i * g.hc + s0,
                            2 * C + (2 * i + 1) * g.hc + s0};
        if (wsl > 0) wg_sums<HB, 2>(v, red, wg, wm, lane, prow, off, wsl);
      }
    }
  }
  if (MODE == WG_F1) {
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
  if (TOP && P.a_res) {   // a is whole in sA for every warp's wgmmas
    fence_proxy_async();
    cons_sync();
  }

  // the 1x1 convs in chunks of FN1 output columns: kr^T over x's K
  // stages (RES), then kt^T over a's (TOP)
  for (int c = 0; c < P.nch1; ++c) {
    const int n0 = c * FN1 + wg * H1 * 8;   // the warpgroup's columns
    float acr[H1][4], at[H1][4];
    if (RES)
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
    if (TOP) {
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
    if (RES) fence_acc(acr);
    if (TOP) fence_acc(at);
    if (MODE == WG_F3B) {
      // F3b: do = (pre > 0) g, dgate, the residual and top BN backward:
      // dr, dt (zero on the K padding C .. kc, which dt's restaging and
      // dx read) and the five column sums, as the first design's epilogue
      // computes them; a column's rows and gate loaded once
      float v[5][H1][4];
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
            const int64_t p = e2 ? p1 : p0;
            float dzr = 0.0f, rmm = 0.0f, dzt = 0.0f, tmm = 0.0f, dgy = 0.0f;
            if (p >= 0 && col < C) {
              const float rb = bfr(acr[j][e]), tb = bfr(at[j][e]);
              const float zr = bn_apply(rb, mr, ir, sr, br);
              const float zt = bn_apply(tb, mt, it, st, bt);
              const float y = relu(zt);
              const float pre = __fadd_rn(relu(zr), __fmul_rn(y, gt));
              const float d_o = pre > 0.0f ? bf2f(R.gout[p * C + col]) : 0.0f;
              dgy = __fmul_rn(d_o, y);
              dzr = zr > 0.0f ? d_o : 0.0f;
              rmm = __fsub_rn(rb, mr);
              R.dr[p * g.kc + col] = f2bf(__fmul_rn(dzr, __fmul_rn(sr, ir)));
              const float dy = __fmul_rn(d_o, gt);
              dzt = zt > 0.0f ? dy : 0.0f;
              tmm = __fsub_rn(tb, mt);
              R.dt[p * g.kc + col] = f2bf(__fmul_rn(dzt, __fmul_rn(st, it)));
            } else if (p >= 0 && col < g.kc) {
              R.dr[p * g.kc + col] = bzero();
              R.dt[p * g.kc + col] = bzero();
            }
            v[0][j][e] = dzr;
            v[1][j][e] = __fmul_rn(dzr, rmm);
            v[2][j][e] = dzt;
            v[3][j][e] = __fmul_rn(dzt, tmm);
            v[4][j][e] = dgy;
          }
        }
      if (n0 < C) {
        const int off[5] = {n0, C + n0, 2 * C + n0, 3 * C + n0,
                            4 * C + 2 * g.NH + n0};
        wg_sums<H1, 5>(v, red, wg, wm, lane, prow, off,
                       C - n0 < H1 * 8 ? C - n0 : H1 * 8);
      }
    } else if (MODE == WG_F1B || MODE == WG_F2B) {
      // F1b: dr = bf16(dsr[0] + 2 bf16(x kr) dsr[1]); F2b: dt =
      // bf16(dst[0] + 2 bf16(a kt) dst[1]); zero on the K padding
      // C .. kc (dx, and F2b's restaging of dt, read it); a column's rows
      // loaded once for the lane's two fragment rows
      bf16 *o = MODE == WG_F1B ? R.dr : R.dt;
#pragma unroll
      for (int j = 0; j < H1; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + frag_col(lane, j, h);
          const int cc = col < C ? col : C - 1;
          const float d0 = rD0[cc], d1 = rD0[C + cc];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int64_t p = e2 ? p1 : p0;
            if (p < 0 || col >= g.kc) continue;
            const float v = bfr(MODE == WG_F1B ? acr[j][h + 2 * e2]
                                               : at[j][h + 2 * e2]);
            o[p * g.kc + col] =
                col < C ? f2bf(__fadd_rn(d0, __fmul_rn(__fmul_rn(2.0f, v), d1)))
                        : bzero();
          }
        }
    } else if (F3) {
      // out = bf16(relu(relu(BN_r(bf16(x kr))) + relu(BN_t(bf16(a kt)))
      // gate)): a column's rows and gate loaded once for the lane's two
      // fragment rows, only the stores masked
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
      // F1: the column sums of bf16(x kr) and of its squares; F2: of
      // t = bf16(a kt) (a pixel outside the image masked: its BN bias
      // and dilated taps make its t nonzero)
      float v[2][H1][4];
#pragma unroll
      for (int j = 0; j < H1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[0][j][e] = (e < 2 ? in0 : in1)
                           ? bfr(MODE == WG_F2 ? at[j][e] : acr[j][e])
                           : 0.0f;
          v[1][j][e] = __fmul_rn(v[0][j][e], v[0][j][e]);
        }
      const int off[2] = {n0, C + n0};
      if (n0 < C)
        wg_sums<H1, 2>(v, red, wg, wm, lane, prow, off,
                       C - n0 < H1 * 8 ? C - n0 : H1 * 8);
    }
  }
  if constexpr (BB) {
    // the branch backward, per branch slice: da = dt . kt[i]^T with dt
    // back from its global rows into the halo's buffer (x's last product
    // has completed: every warp drained), whole or a chunk at a time; dz =
    // (z > 0) da with z from c, which this thread wrote to its global rows
    // for the same fragment elements; dc = bf16(dz scale inv) and the
    // column sums of dz and dz (c - mean) into dS_h
    float *prow_h = prow + (MODE == WG_F3B ? 4 * C : 0);
    for (int i = 0; i < g.nb; ++i)
      for (int sl = 0; sl < P.nsl; ++sl) {
        float acc[HB][4];
        for (int q = 0; q < P.nd; ++q) {
          const int k0 = q * P.kdq, wd = g.kc - k0 < P.kdq ? g.kc - k0 : P.kdq;
          if (P.nd > 1 || (i == 0 && sl == 0)) {
            pipe.drain();
            cons_rows(sH, R.dt, g.kc, k0, wd, g, pos);
          }
          for (int u = 0; u < wd; u += P.kbd) {
            const int kw = wd - u < P.kbd ? wd - u : P.kbd;
            pipe.stage<HB>(acc, AOp{saddr(sH) + u / 8 * TP * 16, rlbo, rsbo},
                           kw, wg * HB, q == 0 && u == 0);
          }
        }
        pipe.drain();
        fence_acc(acc);
        const int s0 = sl * P.sw + wg * HB * 8;
        const int wsl = g.hc - s0 < HB * 8 ? g.hc - s0 : HB * 8;
        float v[2][HB][4];
#pragma unroll
        for (int j = 0; j < HB; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = frag_col(lane, j, h), col = s0 + n;
            const float *bn = rBh + 4 * i * g.hc + (n < wsl ? col : 0);
            const float mean = bn[0], inv = bn[g.hc], scale = bn[2 * g.hc],
                        bias = bn[3 * g.hc];
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int e = h + 2 * e2;
              const int64_t p = e2 ? p1 : p0;
              v[0][j][e] = 0.0f;
              v[1][j][e] = 0.0f;
              if (n >= wsl || p < 0) continue;
              const float cv = bf2f(R.cb[p * g.knh + i * g.hc + col]);
              const float z = bn_apply(cv, mean, inv, scale, bias);
              const float dz = z > 0.0f ? acc[j][e] : 0.0f;
              v[0][j][e] = dz;
              v[1][j][e] = __fmul_rn(dz, __fsub_rn(cv, mean));
              R.dc[p * t.ldc + i * g.khc + col] =
                  f2bf(__fmul_rn(dz, __fmul_rn(scale, inv)));
            }
          }
        if (wsl > 0) {
          const int off[2] = {2 * i * g.hc + s0, (2 * i + 1) * g.hc + s0};
          wg_sums<HB, 2>(v, red, wg, wm, lane, prow_h, off, wsl);
        }
      }
  }
  if (BB || MODE == WG_F1B)
    zero_pad_cols(R.dc, t.ldc, g.nb, g.khc, g.hc, g, pos);
}

// F1's partial rows (n_tiles x (3C + 2 NH) f32) on the plan P.
template <int NTB>
__global__ void __launch_bounds__(FT, 1)
f1_wg_kernel(Geo g, TGeo t, FPlan P, const bf16 *__restrict__ xpad,
             const bf16 *__restrict__ w, float *__restrict__ part) {
  fwd_wg_body<NTB, WG_F1>(g, t, P, xpad, w, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, part, BwdRows{});
}

// F2's partial rows (n_tiles x 2C f32: the sums of t and of t^2) on the
// plan P; a_ws (M, knh) where P keeps a out of shared memory.
template <int NTB>
__global__ void __launch_bounds__(FT, 1)
f2_wg_kernel(Geo g, TGeo t, FPlan P, const bf16 *__restrict__ xpad,
             const bf16 *__restrict__ w, const float *__restrict__ bnh,
             float *__restrict__ part, bf16 *__restrict__ a_ws) {
  fwd_wg_body<NTB, WG_F2>(g, t, P, xpad, w, nullptr, bnh, nullptr, nullptr,
                          nullptr, a_ws, part, BwdRows{});
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
  fwd_wg_body<NTB, WG_F3>(g, t, P, xpad, w, bnr, bnh, bnt, gate, out, a_ws,
                          nullptr, BwdRows{});
}

// F1b's phase 0 on the plan P: dr and dc (M rows each, pitches kc and
// ldc, zero padding columns), the scratch of cam_f1.cu:carve_f1b.
template <int NTB>
__global__ void __launch_bounds__(FT, 1)
f1b_wg_kernel(Geo g, TGeo t, FPlan P, const bf16 *__restrict__ xpad,
              const bf16 *__restrict__ w, const float *__restrict__ dsr,
              const float *__restrict__ dsh, bf16 *__restrict__ dr,
              bf16 *__restrict__ dc) {
  fwd_wg_body<NTB, WG_F1B>(
      g, t, P, xpad, w, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, BwdRows{nullptr, dsr, dsh, nullptr, dr, nullptr, dc, nullptr});
}

// F2b's phase 0 on the plan P: a, dt, dc and c (M rows each, pitches
// knh, kc, ldc and knh) and the partial rows (n_tiles x 2 NH f32: dS_h),
// the workspace of cam_f2.cu:carve_f2b.
template <int NTB>
__global__ void __launch_bounds__(FT, 1)
f2b_wg_kernel(Geo g, TGeo t, FPlan P, const bf16 *__restrict__ xpad,
              const bf16 *__restrict__ w, const float *__restrict__ bnh,
              const float *__restrict__ dst, bf16 *__restrict__ a,
              bf16 *__restrict__ dt, bf16 *__restrict__ dc,
              float *__restrict__ part, bf16 *__restrict__ cb) {
  fwd_wg_body<NTB, WG_F2B>(
      g, t, P, xpad, w, nullptr, bnh, nullptr, nullptr, nullptr, a, part,
      BwdRows{nullptr, nullptr, nullptr, dst, nullptr, dt, dc, cb});
}

// F3b's phase 0 on the plan P: dr, a, dt, dc and c (M rows each, pitches
// kc, knh, kc, ldc and knh) and the partial rows (n_tiles x (5C + 2 NH)
// f32), the workspace of cam_f3.cu:carve_f3b.
template <int NTB>
__global__ void __launch_bounds__(FT, 1)
f3b_wg_kernel(Geo g, TGeo t, FPlan P, const bf16 *__restrict__ xpad,
              const bf16 *__restrict__ w, const float *__restrict__ bnr,
              const float *__restrict__ bnh, const float *__restrict__ bnt,
              const float *__restrict__ gate, const bf16 *__restrict__ gout,
              bf16 *__restrict__ dr, bf16 *__restrict__ a,
              bf16 *__restrict__ dt, bf16 *__restrict__ dc,
              float *__restrict__ part, bf16 *__restrict__ cb) {
  fwd_wg_body<NTB, WG_F3B>(
      g, t, P, xpad, w, bnr, bnh, bnt, gate, nullptr, a, part,
      BwdRows{gout, nullptr, nullptr, nullptr, dr, dt, dc, cb});
}

// ------------------------------------------------------------ dx
//
// dx_wg_kernel: phase 1 of F1b, F2b and F3b, dx = bf16(dr . kr^T (HAS_DR) +
// the sum over branches i and taps of dc_i(p - tap offset d_i) . kh[i, tap]^T
// (+ dgap[b] / (H W), HAS_GAP, before the one rounding)), from the scratch
// phase 0 leaves (dr of pitch kc, dc of pitch ldc, branch i at i khc).  One
// block a tile and all C output columns in it: the column pass's 16 NTW n8
// tiles (NTW a consumer warpgroup's, one wgmma m64 x 8 NTW; wider C in
// passes), so the dc halo is staged once a tile, as wgmma's K-major core
// matrices (a tap moves the descriptor's start by minus its shift), whole
// where it fits, else a branch (or a K chunk of one) at a time into two
// buffers, the next chunk loading while this one multiplies; dr's 64 rows are
// an A operand too (whole, or a stage at a time).  B, kr and kh[i, tap]
// re-laid once a call in walking order (ops/cam.py:_dx_weights), arrives by
// bulk copy into the FNS-slot ring the producer warp keeps full.

// n8 tiles of a consumer warpgroup's columns in one pass: the kernel's
// instances.
inline int dplan_ntw(int per) {
  const int set[] = {8, 12, 14, 17};
  for (int v : set)
    if (v >= per) return v;
  return -1;
}
constexpr int DNTW_MAX = 17;

// The plan of dx_wg_kernel at one geometry; ops/cam.py:_dx_plan computes
// the same.
struct DPlan {
  int ntw, npass, np;   // n8 tiles a warpgroup, column passes, columns a pass
  int hres;             // the whole dc halo in shared memory (else two
                        // buffers of one chunk)
  int kq, nq;           // a branch's halo chunks: width, count
  int dr_res;           // dr's rows whole in shared memory (else a stage
                        // at a time)
  int kbr, kbc;         // stage widths over dr's kc and a halo chunk
  int slot;             // bf16 elements of a ring slot
  int nst;              // weight stages a tile; -1: nothing fits
  int64_t smem;         // dynamic shared memory, bytes
  int64_t w_elems;      // bf16 elements of the re-laid weights
};

// Shared memory besides the ring and the restaged dr rows: the
// mbarriers, the dc halo (all nb khc channels, or two chunks of kq), dr's
// rows (dr_res).
inline int64_t dplan_fixed(const Geo &g, const TGeo &t, int hres, int kq,
                           int dr_res) {
  return FBAR + 2LL * t.hr * (hres ? t.ldc : 2 * kq) +
         (t.res && dr_res ? 2LL * TP * g.kc : 0);
}

// The plan: the first of these with stages at least min(64, chunk) wide
// (else 16): the halo whole and dr's rows whole, the halo in two branch
// buffers, the halo whole with dr a stage at a time, two branch buffers
// with that; then branches in K chunks of two buffers (as few as fit).
inline DPlan make_dplan(const Geo &g, const TGeo &t) {
  DPlan p{};
  const int n8 = (g.C + 7) / 8;
  p.npass = (n8 + 2 * DNTW_MAX - 1) / (2 * DNTW_MAX);
  p.ntw = dplan_ntw((n8 + 2 * p.npass - 1) / (2 * p.npass));
  p.np = 16 * p.ntw;
  p.nst = -1;
  int kb = -1;
  const int modes[4][2] = {{1, 1}, {0, 1}, {1, 0}, {0, 0}};
  for (int thr = 64; thr >= 16 && kb < 0; thr -= 48)
    for (int m = 0; m < 4 && kb < 0; ++m) {
      const int hres = modes[m][0], dr_res = modes[m][1];
      if (!t.res && !dr_res) continue;
      int prev = 0;
      for (int nq = 1; kb < 0; ++nq) {
        const int kq = up16((g.khc + nq - 1) / nq);
        if (kq == prev) continue;
        prev = kq;
        const int64_t avail = SMEM_MAX - dplan_fixed(g, t, hres, kq, dr_res);
        const int64_t per =
            2LL * (FNS * p.np + (t.res && !dr_res ? TP : 0));
        const int64_t k = avail < 0 ? -1 : avail / per / 16 * 16;
        if (k >= (thr < kq ? thr : kq)) {
          kb = static_cast<int>(k);
          p.hres = hres;
          p.kq = kq;
          p.dr_res = dr_res;
        }
        if (hres || kq <= 16) break;
      }
    }
  if (kb < 0) return p;
  p.nq = (g.khc + p.kq - 1) / p.kq;
  int n;
  p.kbr = 0;
  if (t.res) k_chunks(g.kc, kb, &p.kbr, &n);
  k_chunks(p.kq, kb, &p.kbc, &n);
  p.slot = (p.kbr > p.kbc ? p.kbr : p.kbc) * p.np;
  p.smem = dplan_fixed(g, t, p.hres, p.kq, p.dr_res) + 2LL * FNS * p.slot +
           (t.res && !p.dr_res ? 2LL * TP * p.kbr : 0);
  int nu = 0;   // a tap's stages over a branch's chunks
  for (int q = 0; q < p.nq; ++q) {
    const int wq = g.khc - q * p.kq < p.kq ? g.khc - q * p.kq : p.kq;
    nu += (wq + p.kbc - 1) / p.kbc;
  }
  p.nst = p.npass * ((t.res ? (g.kc + p.kbr - 1) / p.kbr : 0) + 9 * g.nb * nu);
  p.w_elems = static_cast<int64_t>(p.npass) * p.np *
              (t.res * g.kc + 9LL * g.nb * g.khc);
  return p;
}

// The producer warp's lane 0: every weight stage of the tile in the
// consumers' order (per pass: dr's stages, then per branch, chunk and tap
// the chunk's stages), each [np / 8][kw][8], by one bulk copy into slot
// s % FNS once the stage that held it has been released.
__device__ __forceinline__ void dx_produce(const Geo &g, const TGeo &t,
                                           const DPlan &D, const bf16 *w,
                                           uint32_t ring, uint32_t bar0) {
  int s = 0;
  int64_t off = 0;
  auto issue = [&](int kw) {
    const int slot = s % FNS;
    if (s >= FNS) mbar_wait(bar0 + 8 * (FNS + slot), ((s / FNS) - 1) & 1);
    const uint32_t bytes = 2u * kw * D.np;
    mbar_expect_tx(bar0 + 8 * slot, bytes);
    bulk_load(ring + slot * 2 * D.slot, w + off, bytes, bar0 + 8 * slot);
    off += static_cast<int64_t>(kw) * D.np;
    ++s;
  };
  for (int pc = 0; pc < D.npass; ++pc) {
    if (t.res)
      for (int u = 0; u < g.kc; u += D.kbr)
        issue(g.kc - u < D.kbr ? g.kc - u : D.kbr);
    for (int z = 0; z < g.nb * D.nq; ++z) {
      const int k0 = (z % D.nq) * D.kq;
      const int wq = g.khc - k0 < D.kq ? g.khc - k0 : D.kq;
      for (int tap = 0; tap < 9; ++tap)
        for (int u = 0; u < wq; u += D.kbc)
          issue(wq - u < D.kbc ? wq - u : D.kbc);
    }
  }
}

// The consumers' copies of dc's halo chunk z (branch z / nq, its
// columns (z % nq) kq ..) into buf, one commit group.
__device__ __forceinline__ void dx_halo_issue(bf16 *buf, const bf16 *dc,
                                              int z, const Geo &g,
                                              const TGeo &t, const DPlan &D,
                                              const TilePos &pos) {
  const int k0 = (z % D.nq) * D.kq;
  halo_copies(buf, dc, t.ldc, (z / D.nq) * g.khc + k0,
              g.khc - k0 < D.kq ? g.khc - k0 : D.kq, g, t, pos);
}

// dx (M, C) bf16 on the plan D: threads 0..255 the two consumer
// warpgroups (warpgroup wg the pass's n8 tiles [wg NTW, (wg + 1) NTW)),
// 256..287 the producer warp.
template <int NTW, bool HAS_DR, bool HAS_GAP>
__global__ void __launch_bounds__(FT, 1)
dx_wg_kernel(Geo g, TGeo t, DPlan D, const bf16 *__restrict__ dr,
             const bf16 *__restrict__ dc, const bf16 *__restrict__ w,
             const float *__restrict__ dgap, float inv_n,
             bf16 *__restrict__ dx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar0 = saddr(smem);   // full[FNS], then empty[FNS]
  bf16 *sW = reinterpret_cast<bf16 *>(smem + FBAR);
  bf16 *sH = sW + FNS * D.slot;        // the halo, or two chunk buffers
  bf16 *sR = sH + t.hr * (D.hres ? t.ldc : 2 * D.kq);   // dr's rows
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
    if (lane == 0) dx_produce(g, t, D, w, saddr(sW), bar0);
    return;
  }

  const int wg = warp >> 2, wm = warp & 3, C = g.C;
  const TilePos pos = tile_pos(t, blockIdx.x);
  Pipe pipe{bar0, saddr(sW), 2 * D.slot, 0, -1};
  const uint32_t hlbo = t.hr * 16, hsbo = t.hs * 16;
  const uint32_t rlbo = TP * 16, rsbo = 8 * 16;
  const uint32_t cen = (t.dmax * t.hs + t.dmax) * 16;
  const int nz = g.nb * D.nq, nzt = D.npass * nz;
  auto chunk_buf = [&](int zg) {   // chunk zg's buffer (two of them)
    return sH + (zg & 1) * t.hr * D.kq;
  };

  // dr's rows and the halo (or its first chunk), then the second chunk
  if (HAS_DR && D.dr_res) rows_copies(sR, dr, g.kc, 0, g.kc, g, pos);
  if (D.hres)
    halo_copies(sH, dc, t.ldc, 0, t.ldc, g, t, pos);
  else
    dx_halo_issue(chunk_buf(0), dc, 0, g, t, D, pos);
  cons_landed();
  if (!D.hres && nzt > 1) dx_halo_issue(chunk_buf(1), dc, 1 % nz, g, t, D, pos);

  const int64_t p0 = tile_pix(g, pos, frag_row(wm, lane, 0));
  const int64_t p1 = tile_pix(g, pos, frag_row(wm, lane, 2));
  for (int pc = 0; pc < D.npass; ++pc) {
    float acc[NTW][4];
    bool first = true;
    if (HAS_DR)
      for (int u = 0; u < g.kc; u += D.kbr) {
        const int kw = g.kc - u < D.kbr ? g.kc - u : D.kbr;
        AOp A{saddr(sR) + u / 8 * TP * 16, rlbo, rsbo};
        if (!D.dr_res) {
          pipe.drain();
          cons_rows(sR, dr, g.kc, u, kw, g, pos);
          A = AOp{saddr(sR), rlbo, rsbo};
        }
        pipe.stage<NTW>(acc, A, kw, wg * NTW, first);
        first = false;
      }
    for (int z = 0; z < nz; ++z) {
      const int zg = pc * nz + z, i = z / D.nq, d = g.dil[i];
      const int k0 = (z % D.nq) * D.kq;
      const int wq = g.khc - k0 < D.kq ? g.khc - k0 : D.kq;
      if (!D.hres && zg > 0) {
        // chunk zg has landed; chunk zg - 1's wgmmas are done, so chunk
        // zg + 1 may load into its buffer
        pipe.drain();
        cons_landed();
        if (zg + 1 < nzt)
          dx_halo_issue(chunk_buf(zg + 1), dc, (zg + 1) % nz, g, t, D, pos);
      }
      const uint32_t base =
          (D.hres ? saddr(sH) + i * t.hr * g.khc * 2 : saddr(chunk_buf(zg))) +
          cen;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int sh = -((tap / 3 - 1) * t.hs + (tap % 3 - 1)) * d;
        for (int u = 0; u < wq; u += D.kbc) {
          const int kw = wq - u < D.kbc ? wq - u : D.kbc;
          pipe.stage<NTW>(acc, AOp{base + (u / 8 * t.hr + sh) * 16, hlbo,
                                   hsbo}, kw, wg * NTW, first);
          first = false;
        }
      }
    }
    pipe.drain();
    fence_acc(acc);
    // dx = bf16(acc (+ dgap[b] inv_n)): a column's gap term once for the
    // lane's two fragment rows, only the stores masked
    const int n0 = pc * D.np + wg * NTW * 8;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + frag_col(lane, j, h);
        const float gap =
            HAS_GAP && col < C
                ? __fmul_rn(dgap[static_cast<int64_t>(pos.b) * C + col], inv_n)
                : 0.0f;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int64_t p = e2 ? p1 : p0;
          float v = acc[j][h + 2 * e2];
          if (HAS_GAP) v = __fadd_rn(v, gap);
          if (p >= 0 && col < C) dx[p * C + col] = f2bf(v);
        }
      }
  }
}

// ------------------------------------------------------------ host side

// The ops' limit: a geometry is taken where the mma.sync tile plans that
// first ran the ops took it, and refused elsewhere (a largest dilation
// whose halo does not fit: at C = 163, 19 and up for F1b and F3b, 20 and
// up for the others); the plans here need less wherever those fit.  That
// is the whole-depth plan's shared memory (a branch of at most LIM_SW
// columns; phase 0: the x halo at full depth, LIM_SLOTS weight slots of
// LIM_ROWS rows of the widest K, a's and the branch backward's rows, the
// epilogues' rows and column-sum scratch; a backward's dx: dr's rows, the
// dc halo, LIM_SLOTS slots of up to LIM_NX rows of khc), or else the
// K-chunked plan's (k_fit: two halo buffers of a 16-channel chunk and
// LIM_SLOTS slots of LIM_ROWS weight and TP A rows; for a backward also
// two dc halo buffers and LIM_SLOTS slots of up to LIM_NX weight and TP
// dr rows).  ops/cam.py:_limit computes the same.
constexpr int LIM_SW = 40, LIM_SLOTS = 3, LIM_ROWS = 56, LIM_NX = 168;
constexpr int64_t LIM_RED = 4LL * 4 * 5 * LIM_ROWS;   // bytes: 4 warps x 5
                                                      // column sums

// The widest chunk (a multiple of 16, -1 if none) whose buffers fit
// SMEM_MAX: two halo buffers of hr rows, LIM_SLOTS slots of `slot` rows,
// each of pitch chunk + 8 bf16, and `fixed` bytes more.
inline int k_fit(int hr, int slot, int64_t fixed) {
  const int64_t per = 2LL * (2LL * hr + 1LL * LIM_SLOTS * slot);
  const int64_t k = (SMEM_MAX - fixed) / per - 8;
  return k < 16 ? -1 : static_cast<int>(k / 16 * 16);
}

inline bool within_limit(const Geo &g, const TGeo &t) {
  const int nxr = (g.C + 7) / 8 * 8 < LIM_NX ? (g.C + 7) / 8 * 8 : LIM_NX;
  const int kw0 = t.top && g.knh > g.kc ? g.knh : g.kc;
  const int64_t el = 1LL * t.hr * (g.kc + 8) +
                     1LL * LIM_SLOTS * LIM_ROWS * (kw0 + 8) +
                     (t.top ? 1LL * TP * g.nhp : 0) +
                     (t.bb ? 1LL * TP * g.nhp + TP * (g.kc + 8LL) : 0);
  const int64_t smem0 = 2 * el + 4 * fplan_rows(g, t.op) +
                        (t.bb ? LIM_RED : 0);
  const int64_t smem1 =
      t.bwd ? 2LL * ((t.res ? TP * (g.kc + 8LL) : 0) +
                     1LL * t.hr * (t.ldc + 8) +
                     1LL * LIM_SLOTS * nxr * (g.khc + 8))
            : 0;
  if (g.hc <= LIM_SW && smem0 <= SMEM_MAX && smem1 <= SMEM_MAX) return true;
  return k_fit(t.hr, LIM_ROWS + TP, t.bb ? LIM_RED : 0) >= 0 &&
         (!t.bwd || k_fit(t.hr, nxr + t.res * TP, 0) >= 0);
}

// The geometry of a call of op and the tiling, or false: an invalid
// geometry or one past the ops' limit.
inline bool tile_geo(const int *geo, int op, Geo *g, TGeo *t) {
  if (op < F1B || op > F2 || !make_geo(geo, g)) return false;
  *t = make_tgeo(*g, op);
  return within_limit(*g, *t);
}

// tile_geo for a forward (op), with its plan (P); the plan fits wherever
// the limit lets a geometry through.
inline bool fwd_geo(const int *geo, int op, Geo *g, TGeo *t, FPlan *P) {
  if (!tile_geo(geo, op, g, t)) return false;
  *P = make_fplan(*g, *t);
  return P->nst > 0 && P->smem <= SMEM_MAX;
}

// tile_geo for a backward (op), with its plans: phase 0 (P) and dx (D).
inline bool bwd_geo(const int *geo, int op, Geo *g, TGeo *t, FPlan *P,
                    DPlan *D) {
  if (!fwd_geo(geo, op, g, t, P)) return false;
  *D = make_dplan(*g, *t);
  return D->nst > 0 && D->smem <= SMEM_MAX;
}

// cam_<op>_plan of every op, as ops/cam.py:tile_plan computes them: 0
// phase 0's shared memory, 1 phase 1's (0 for a forward), 2 and 3 the
// re-laid weights of phase 0 and phase 1 (0 for a forward), 4: 1 (the
// op's kernels take the geometry), 5 x's K chunk, 6 the kt^T stages'
// width over a (0 without kt^T), 7 and 8 dx_wg_kernel's stage width over
// a halo chunk and the chunk's width, 9 branch slices, 10 phase 0's n8
// tiles of a slice, 11 x's stage width, 12 a in shared memory, 13 the
// epilogues' rows there, 14 phase 0's stages a tile; for a backward (else
// 0) 15: 1, 16 dx's n8 tiles a warpgroup, 17 column passes, 18 the whole
// dc halo in shared memory, 19 dr's rows there, 20 dx's stages a tile; -1
// for a refused geometry or an invalid code.
inline long long op_plan(const int *geo, int op, int what) {
  Geo g;
  TGeo t;
  FPlan P{};
  DPlan D{};
  const bool bwd = op >= F1B && op <= F3B;
  const bool ok = bwd ? bwd_geo(geo, op, &g, &t, &P, &D)
                      : fwd_geo(geo, op, &g, &t, &P);
  if (!ok || what < 0 || what > 20) return -1;
  if (what >= 15) {
    const long long v[] = {1, D.ntw, D.npass, D.hres, D.dr_res, D.nst};
    return bwd ? v[what - 15] : 0;
  }
  const long long v[] = {P.smem,  bwd ? D.smem : 0,   P.w_elems,
                         bwd ? D.w_elems : 0,         1,
                         P.kq,    P.kba,   D.kbc,     D.kq,
                         P.nsl,   P.ntb,   P.kbx,     P.a_res,
                         P.rows_smem,      P.nst};
  return v[what];
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


// Phase 1 on the plan D: dx from dr (pitch kc; HAS_DR) and dc (pitch ldc).
template <bool HAS_DR, bool HAS_GAP>
cudaError_t launch_dx_wg(const Geo &g, const TGeo &t, const DPlan &D,
                         const bf16 *dr, const bf16 *dc, const bf16 *w1,
                         const float *dgap, float inv_n, bf16 *dx,
                         cudaStream_t st) {
  switch (D.ntw) {
    case 8: return launch_fwd(dx_wg_kernel<8, HAS_DR, HAS_GAP>, D.smem,
                              t.n_tiles, st, g, t, D, dr, dc, w1, dgap,
                              inv_n, dx);
    case 12: return launch_fwd(dx_wg_kernel<12, HAS_DR, HAS_GAP>, D.smem,
                               t.n_tiles, st, g, t, D, dr, dc, w1, dgap,
                               inv_n, dx);
    case 14: return launch_fwd(dx_wg_kernel<14, HAS_DR, HAS_GAP>, D.smem,
                               t.n_tiles, st, g, t, D, dr, dc, w1, dgap,
                               inv_n, dx);
    case 17: return launch_fwd(dx_wg_kernel<17, HAS_DR, HAS_GAP>, D.smem,
                               t.n_tiles, st, g, t, D, dr, dc, w1, dgap,
                               inv_n, dx);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tile
}  // namespace cam
