// n fused BasicBlocks with folded BatchNorm, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel rtpe_tpu/ops/pallas_blocks.py:basicblock_chain
// (_chain_kernel).  For each block i of the chain, with zero "same" padding:
//   y = bf16(relu(conv3x3(x, w[i,0]) + b[i,0]))   f32 accumulate, one rounding
//   y = bf16(conv3x3(y, w[i,1]) + b[i,1])         f32 accumulate, one rounding
//   x = bf16(relu(f32(y) + f32(x)))               the residual add in bf16
// x (B, H, W, C) bf16 NHWC, w (n, 2, 3, 3, C, C) bf16 HWIO, b (n, 2, C) f32:
// the JAX layout, read as it is.
//
// Bound: operations.  One chain at B=8 on any of the three branch shapes of
// a 640 x 640 forward (80x80x96, 40x40x192, 20x20x384) is 2n * B*H*W *
// 9*C*C multiply-adds = 67.9 GFLOP for n=4: 0.0687 ms at 989 TFLOP/s (bf16
// dense), 0.0086 ms at B=1; the bytes (x once, w once, the output once)
// take ~0.01 ms.
//
// The TPU kernel keeps one image's whole activation in VMEM for the chain,
// grid=(B,).  One image here is 1.2 MB / 614 KB / 307 KB, far above a
// block's 227 KB of shared memory, so each 3x3 conv is its own launch, an
// implicit GEMM with M = B*H*W pixels (flattened over the batch: ragged H
// and W cost nothing but a mask), N = C output channels and K = 9*C
// (tap-major, then input channel: the HWIO weights are the [9C][C] B
// matrix as they lie).  The first design (mma.sync m16n8k16, 4 warps on a
// 128 x 32/64 tile, two cp.async stages of 32 channels in static shared
// memory) exposed every copy and ldmatrix latency over K loops of 27-108
// steps, staged each pixel tile's shifted rows 3-6 times (once per N
// tile) and left most SMs idle at B=1 (24 blocks at 20x20x384).  This
// design:
//   - tensor cores by wgmma.mma_async m64nNk16 (bf16 in, f32 accumulators
//     in registers), both operands in shared memory: 2 warpgroups a block,
//     each MT m64 row tiles x BN channels; BN = the widest of 192, 96, 64,
//     32 that divides C (all of C at C = 96 and 192, half at 384), so a
//     pixel tile's rows are staged once (twice at C = 384); MT = 2 (256
//     pixels a block, each B stage used twice as often) where BN <= 96 and
//     the 256-pixel tiles alone fill the card, else 1;
//   - K in steps of KC = 64 of the flattened 9C (a step may straddle two
//     taps: each 16-byte chunk finds its own tap), zero past 9C (C = 96:
//     864 -> 896);
//   - a ring of STAGES = 4 stages in dynamic shared memory (16 KB of A rows
//     per 128 pixels and 8 KB per 64 channels of B a stage, 160 KB at BN =
//     192), filled by 16-byte cp.async from all 256 threads two steps
//     ahead, one cp.async group and one barrier a step; one wgmma batch
//     stays in flight while the next stage's copies are issued.  Each
//     thread keeps its rows' pixel pointers and a 9-bit mask of the taps
//     that stay inside the image, so a step's addressing is one divide and
//     an add per chunk;
//   - A (tap-shifted pixel rows x 64 channels, zero-filled outside the
//     image and past M through the src-size operand) K-major and B
//     (64 x BN of the weights) N-major (the wgmma transpose immediate), both
//     in the 128-byte swizzle the descriptors name, written chunk by chunk
//     with the swizzle applied, so no re-laid weight copy exists;
//   - a grid that fills one wave of the card: a plan (basicblock_chain_plan,
//     mirrored by ops/blocks.py:chain_plan) splits the K steps into S
//     contiguous ranges when the pixel and channel tiles alone give fewer
//     than 132 blocks, as many as keep the grid within 132 blocks (B=1:
//     S = 2 / 10 / 16 for the three shapes; B=8: 1 / 1 / 2), each of at
//     least 2 steps; a second wave cost more than any split saved in a
//     sweep on one H100.  A split writes its f32 partial tile to a
//     workspace; one small epilogue launch per conv sums the S partials in
//     split order and applies the epilogue.  No float atomics: a run
//     repeats bitwise;
//   - the epilogue adds the f32 bias and rounds once (ReLU for conv 1; the
//     bf16 residual add and ReLU for conv 2) into a tile in the freed
//     ring, then writes whole 16-byte row chunks, each thread loading all
//     its residual chunks before its first store (`res` may alias `out`,
//     so a load after a store would wait for it).
// Each output element sums its K steps in the first design's order
// (k16 chunks ascending), so an unsplit conv is bitwise the first
// design's; a split one adds its partials in split order.
// One C entry point launches the chain's 2n convs (and their split
// epilogues) on the caller's stream, so the host makes one call per chain.
// The wrapper allocates two scratch tensors and the split workspace: conv
// 1 writes `tmp`; conv 2 reads `tmp` and the block's input and writes
// `out`, in place from the second block on (a pixel's residual is read by
// the thread that then overwrites it).
// Later work: one persistent kernel over the chain's 2n convs (each block
// now spends ~2-3 us filling its ring before its first wgmma), TMA and a
// producer warp in place of the 256 threads' copies and barrier a step
// (a step runs at ~50-60 % of the tensor cores' rate).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KC = 64;                // K per stage: one 128-byte row
constexpr int STAGES = 4;             // the ring of copy stages
constexpr int THREADS = 256;          // 2 warpgroups
constexpr int ROW_BYTES = KC * 2;     // a stage's A row: one pixel

constexpr int SMS = 132;              // the H100's SMs: the grid's target
constexpr int MIN_SPLIT_STEPS = 2;    // K steps of a split at least
constexpr int SMEM_MAX = 232448;      // dynamic shared memory of a block

enum Mode { RELU = 0, RESIDUAL = 1, PARTIAL = 2 };

// The tiling of one conv of the chain; ops/blocks.py:chain_plan computes
// the same.
struct Plan {
  int bn, na;              // N tile; its 64-channel swizzle atoms
  int bm;                  // pixel tile: 128, or 256 where BN <= 96
  int tiles_m, tiles_n;    // pixel tiles, channel tiles
  int nsteps, splits;      // K steps of 64, K ranges
  int64_t smem, ws_bytes;  // dynamic shared memory, split workspace
};

inline bool make_plan(int B, int H, int W, int C, Plan *p) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 32) return false;
  const int64_t M = static_cast<int64_t>(B) * H * W;
  if (M >= (1LL << 31)) return false;   // pixel indices are int
  Plan r;
  r.bn = C % 192 == 0 ? 192 : C % 96 == 0 ? 96 : C % 64 == 0 ? 64 : 32;
  r.na = (r.bn + 63) / 64;
  // two m64 row tiles a warpgroup (BN <= 96: 2 x BN / 2 f32 registers a
  // thread) where that alone still fills the card
  r.tiles_n = C / r.bn;
  r.bm = r.bn <= 96 && (M + 255) / 256 * r.tiles_n >= SMS ? 256 : 128;
  r.tiles_m = static_cast<int>((M + r.bm - 1) / r.bm);
  r.nsteps = (9 * C + KC - 1) / KC;
  const int64_t base = static_cast<int64_t>(r.tiles_m) * r.tiles_n;
  // split K only while the grid stays within one wave of the card: a
  // second wave costs more than the split saves (on an H100, 20x20x384 at
  // B=8: 2 splits, 100 blocks, 0.26 ms a chain; 3 splits, 150 blocks,
  // 0.36 ms)
  r.splits = 1;
  if (base < SMS) {
    const int fit = static_cast<int>(SMS / base);
    const int most = r.nsteps / MIN_SPLIT_STEPS;
    r.splits = fit < most ? fit : most;
    if (r.splits < 1) r.splits = 1;
  }
  r.smem = static_cast<int64_t>(STAGES) *
               (r.bm * ROW_BYTES + KC / 8 * r.na * 1024) +
           1024;
  r.ws_bytes = r.splits > 1 ? 4LL * r.splits * M * C : 0;
  *p = r;
  return r.smem <= SMEM_MAX;
}

// ------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t saddr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp16(uint32_t dst, const void *src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The copies' shared-memory writes, seen by the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the accumulators where the wgmma pipeline leaves them: no read or
// write of them moves across this point.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ULL << 62);
}

// d += A (64 x 16, K-major) . B (16 x N, N-major), f32 accumulators: the
// register fragment of m64nNk16 (d[4i + e]: row 16 warp + lane / 4 +
// 8 (e >> 1), column 8i + 2 (lane % 4) + (e & 1)).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15 "
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47 "
        "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  __device__ __forceinline__ static void mma(float (&d)[96], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95 "
        "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95])
        : "l"(da), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// ------------------------------------------------------------ kernels

// One 3x3 conv, C -> C channels, zero "same" padding, K steps
// [split nsteps / splits, (split + 1) nsteps / splits) of an implicit GEMM
// for 128 MT pixels x BN channels (each warpgroup MT m64 row tiles).
// RELU:     out = bf16(relu(conv + bias)).
// RESIDUAL: out = bf16(relu(f32(bf16(conv + bias)) + f32(res))).
// PARTIAL:  part[split][p][n] = this split's f32 sum (no bias).
// `res` may alias `out`; `in` does not alias either.
template <int BN, int MODE, int MT>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_kernel(const bf16 *__restrict__ in, const bf16 *__restrict__ w,
               const float *__restrict__ bias, const bf16 *res, bf16 *out,
               float *__restrict__ part, int H, int W, int C, int M,
               int nsteps, int splits) {
  constexpr int BM = 128 * MT, A_BYTES = BM * ROW_BYTES;
  constexpr int NA = (BN + 63) / 64;          // B's swizzle atoms along N
  constexpr int STAGE = A_BYTES + KC / 8 * NA * 1024;
  constexpr int BCH = BN / 8;                 // 16-byte chunks of a B row
  constexpr int B_PER = KC * BCH / THREADS;   // ... of this thread a stage
  static_assert(KC * BCH % THREADS == 0, "B tile split");
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms are 1024-byte aligned
  const uint32_t base = (saddr(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int s0 = static_cast<int>(static_cast<int64_t>(split) * nsteps /
                                  splits);
  const int s1 = static_cast<int>(static_cast<int64_t>(split + 1) * nsteps /
                                  splits);
  const int HW = H * W, K = 9 * C;

  // this thread's A chunks: column ac (8 channels) of rows tid / 8 + 32 i,
  // each row's pixel in x and a bit per tap that reaches inside the image
  // (none past M)
  constexpr int AR = BM / 32;
  const int ac = tid & 7;
  const bf16 *a_src[AR];
  uint32_t a_ok[AR], a_dst[AR];
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int r = (tid >> 3) + 32 * i, p = m0 + r;
    a_dst[i] = r * 128 + ((ac ^ (r & 7)) << 4);
    a_src[i] = in;
    a_ok[i] = 0;
    if (p < M) {
      const int rem = p % HW, y = rem / W, x = rem - y * W;
      a_src[i] = in + static_cast<int64_t>(p) * C;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) a_ok[i] |= 1u << tap;
      }
    }
  }
  // ... and its B chunks: row b_row (of the stage's 64), channels b_col..+8
  int b_row[B_PER];
  const bf16 *b_src[B_PER];
  uint32_t b_dst[B_PER];
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int v = tid + THREADS * i, kr = v / BCH, jn = v - kr * BCH;
    b_row[i] = kr;
    b_src[i] = w + static_cast<int64_t>(kr) * C + n0 + jn * 8;
    b_dst[i] = A_BYTES + ((kr >> 3) * NA + (jn >> 3)) * 1024 + (kr & 7) * 128 +
               (((jn & 7) ^ (kr & 7)) << 4);
  }

  auto load = [&](int step, int stage) {
    const uint32_t sb = base + stage * STAGE;
    const int kk = step * KC + ac * 8;
    // tap 9 (past K) has no bit in a_ok: zero fill
    const int tap = kk < K ? kk / C : 9;
    const int64_t off =
        static_cast<int64_t>((tap / 3 - 1) * W + (tap % 3 - 1)) * C +
        (kk - tap * C);
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const bool ok = (a_ok[i] >> tap) & 1u;
      cp16(sb + a_dst[i], ok ? a_src[i] + off : in, ok);
    }
    const int64_t boff = static_cast<int64_t>(step) * KC * C;
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const bool ok = step * KC + b_row[i] < K;
      cp16(sb + b_dst[i], ok ? b_src[i] + boff : w, ok);
    }
  };

  float acc[MT][BN / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0.0f;
    fence_acc(acc[t]);
  }

  // steps s0 + u in stage u % STAGES, two ahead of the one multiplied
  const int n = s1 - s0;
#pragma unroll
  for (int u = 0; u < STAGES - 2; ++u) {
    if (u < n) load(s0 + u, u);
    cp_commit();
  }
#pragma unroll 1
  for (int it = 0; it < n; ++it) {
    cp_wait<STAGES - 3>();   // step it has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();         // ... every thread's; step it - 2's wgmma done
    const int nx = it + STAGES - 2;
    if (nx < n) load(s0 + nx, nx % STAGES);
    cp_commit();
    const uint32_t sa = base + (it % STAGES) * STAGE + wg * MT * 64 * 128;
    const uint32_t sbb = base + (it % STAGES) * STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KC / 16; ++k) {
      const uint64_t db = sw128_desc(sbb + k * 2 * NA * 1024, 1024, NA * 1024);
#pragma unroll
      for (int t = 0; t < MT; ++t)
        Wgmma<BN>::mma(acc[t],
                       sw128_desc(sa + t * 64 * 128 + k * 32, 16, 1024), db);
    }
    wgmma_commit();
    wgmma_wait<1>();         // step it - 1's batch is done
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < MT; ++t) fence_acc(acc[t]);

  // the epilogue, through shared memory (the ring is free: every copy has
  // landed and every warpgroup's wgmma is done): each fragment pair as
  // bf16(relu(v + bias)) (RELU), bf16(v + bias) (RESIDUAL) or the f32 v
  // (PARTIAL) into a BM x BN tile, then whole 16-byte rows out, the
  // residual added there
  cp_wait<0>();
  __syncthreads();
  constexpr bool F32 = MODE == PARTIAL;
  constexpr int P = F32 ? BN + 4 : BN + 8;    // tile pitch, elements
  unsigned char *tile = smem_raw + (base - saddr(smem_raw));
  const int wrow = ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = i * 8 + (lane & 3) * 2;
    float b0 = 0.0f, b1 = 0.0f;
    if (!F32) {
      b0 = bias[n0 + c];
      b1 = bias[n0 + c + 1];
    }
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wg * MT + t) * 64 + wrow + h * 8;
        const float v0 = acc[t][4 * i + 2 * h], v1 = acc[t][4 * i + 2 * h + 1];
        if (F32)
          *reinterpret_cast<float2 *>(tile + (r * P + c) * 4) =
              make_float2(v0, v1);
        else if (MODE == RESIDUAL)
          *reinterpret_cast<__nv_bfloat162 *>(tile + (r * P + c) * 2) =
              __floats2bfloat162_rn(v0 + b0, v1 + b1);
        else
          *reinterpret_cast<__nv_bfloat162 *>(tile + (r * P + c) * 2) =
              __floats2bfloat162_rn(relu(v0 + b0), relu(v1 + b1));
      }
  }
  __syncthreads();
  constexpr int CPR = F32 ? BN / 4 : BN / 8;   // 16-byte chunks of a row
  constexpr int NV = (BM * CPR + THREADS - 1) / THREADS;
  if (F32) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = tid + j * THREADS, r = v / CPR, ch = v - r * CPR;
      if (v >= BM * CPR || m0 + r >= M) continue;
      const uint4 v4 =
          *reinterpret_cast<const uint4 *>(tile + (r * P + ch * 4) * 4);
      *reinterpret_cast<uint4 *>(
          part + (static_cast<int64_t>(split) * M + m0 + r) * C + n0 +
          ch * 4) = v4;
    }
    return;
  }
  // every residual chunk first: `res` may alias `out`, so a load after a
  // store would wait for it (each chunk is read and written by this
  // thread alone)
  uint4 rr[NV];
  if (MODE == RESIDUAL) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = tid + j * THREADS, r = v / CPR, ch = v - r * CPR;
      const bool ok = v < BM * CPR && m0 + r < M;
      rr[j] = ok ? *reinterpret_cast<const uint4 *>(
                       res + static_cast<int64_t>(m0 + r) * C + n0 + ch * 8)
                 : make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = tid + j * THREADS, r = v / CPR, ch = v - r * CPR;
    if (v >= BM * CPR || m0 + r >= M) continue;
    uint4 y = *reinterpret_cast<const uint4 *>(tile + (r * P + ch * 8) * 2);
    if (MODE == RESIDUAL) {
      __nv_bfloat162 *yv = reinterpret_cast<__nv_bfloat162 *>(&y);
      const __nv_bfloat162 *rv =
          reinterpret_cast<const __nv_bfloat162 *>(&rr[j]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        yv[k] = __floats2bfloat162_rn(
            relu(__bfloat162float(yv[k].x) + __bfloat162float(rv[k].x)),
            relu(__bfloat162float(yv[k].y) + __bfloat162float(rv[k].y)));
    }
    *reinterpret_cast<uint4 *>(out + static_cast<int64_t>(m0 + r) * C + n0 +
                               ch * 8) = y;
  }
}

// The split epilogue: the S partials of a pair of elements summed in split
// order, then conv3x3_kernel's RELU or RESIDUAL epilogue.
template <bool RESIDUAL>
__global__ void __launch_bounds__(256)
split_epilogue_kernel(const float *__restrict__ part, int splits,
                      const float *__restrict__ bias, const bf16 *res,
                      bf16 *out, int64_t total, int C) {
  const int64_t off =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 2;
  if (off >= total) return;
  float2 v = *reinterpret_cast<const float2 *>(part + off);
  for (int s = 1; s < splits; ++s) {
    const float2 u = *reinterpret_cast<const float2 *>(part + s * total + off);
    v.x += u.x;
    v.y += u.y;
  }
  const int c = static_cast<int>(off % C);
  const float v0 = v.x + bias[c], v1 = v.y + bias[c + 1];
  if (RESIDUAL) {
    const __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
    const __nv_bfloat162 r =
        *reinterpret_cast<const __nv_bfloat162 *>(res + off);
    *reinterpret_cast<__nv_bfloat162 *>(out + off) = __floats2bfloat162_rn(
        relu(__bfloat162float(y.x) + __bfloat162float(r.x)),
        relu(__bfloat162float(y.y) + __bfloat162float(r.y)));
  } else {
    *reinterpret_cast<__nv_bfloat162 *>(out + off) =
        __floats2bfloat162_rn(relu(v0), relu(v1));
  }
}

// ------------------------------------------------------------ host side

// One conv: bias, then relu (conv 1) or the residual add (conv 2), through
// the split workspace when the plan splits K.
template <int BN, int MT>
cudaError_t conv(const Plan &pl, const bf16 *in, const bf16 *w,
                 const float *b, const bf16 *res, bf16 *out, float *ws,
                 int H, int W, int C, int M, cudaStream_t st) {
  const dim3 grid(pl.tiles_m, pl.tiles_n, pl.splits);
  const size_t smem = static_cast<size_t>(pl.smem);
  if (pl.splits == 1) {
    if (res)
      conv3x3_kernel<BN, RESIDUAL, MT><<<grid, THREADS, smem, st>>>(
          in, w, b, res, out, nullptr, H, W, C, M, pl.nsteps, 1);
    else
      conv3x3_kernel<BN, RELU, MT><<<grid, THREADS, smem, st>>>(
          in, w, b, nullptr, out, nullptr, H, W, C, M, pl.nsteps, 1);
    return cudaGetLastError();
  }
  conv3x3_kernel<BN, PARTIAL, MT><<<grid, THREADS, smem, st>>>(
      in, w, nullptr, nullptr, nullptr, ws, H, W, C, M, pl.nsteps,
      pl.splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = static_cast<int64_t>(M) * C;
  const unsigned blocks = static_cast<unsigned>((total / 2 + 255) / 256);
  if (res)
    split_epilogue_kernel<true><<<blocks, 256, 0, st>>>(ws, pl.splits, b, res,
                                                        out, total, C);
  else
    split_epilogue_kernel<false><<<blocks, 256, 0, st>>>(ws, pl.splits, b,
                                                         nullptr, out, total,
                                                         C);
  return cudaGetLastError();
}

template <int BN, int MT>
cudaError_t run_chain(const Plan &pl, const bf16 *x, const bf16 *w,
                      const float *b, bf16 *tmp, bf16 *out, float *ws, int B,
                      int H, int W, int C, int n_blocks, cudaStream_t st) {
  const int smem = static_cast<int>(pl.smem);
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err =
      cudaFuncSetAttribute(conv3x3_kernel<BN, RELU, MT>, attr, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_kernel<BN, RESIDUAL, MT>, attr, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_kernel<BN, PARTIAL, MT>, attr, smem);
  if (err != cudaSuccess) return err;
  const int M = B * H * W;
  const int64_t w_conv = 9LL * C * C;
  const bf16 *cur = x;
  for (int i = 0; i < n_blocks; ++i) {
    err = conv<BN, MT>(pl, cur, w + (2 * i) * w_conv, b + (2 * i) * C, nullptr,
                   tmp, ws, H, W, C, M, st);
    if (err != cudaSuccess) return err;
    err = conv<BN, MT>(pl, tmp, w + (2 * i + 1) * w_conv, b + (2 * i + 1) * C,
                   cur, out, ws, H, W, C, M, st);
    if (err != cudaSuccess) return err;
    cur = out;
  }
  return cudaSuccess;
}

}  // namespace

// The chain's plan at x (B, H, W, C): what = 0 the N tile, 1 pixel tiles,
// 2 channel tiles, 3 K splits, 4 K steps of 64, 5 dynamic shared memory
// (bytes), 6 split workspace (bytes), 7 the pixel tile; -1 for a shape the
// kernel refuses.
extern "C" long long basicblock_chain_plan(int B, int H, int W, int C,
                                           int what) {
  Plan p;
  if (!make_plan(B, H, W, C, &p)) return -1;
  switch (what) {
    case 0: return p.bn;
    case 1: return p.tiles_m;
    case 2: return p.tiles_n;
    case 3: return p.splits;
    case 4: return p.nsteps;
    case 5: return p.smem;
    case 6: return p.ws_bytes;
    case 7: return p.bm;
    default: return -1;
  }
}

// x (B, H, W, C) bf16, w (n, 2, 3, 3, C, C) bf16, b (n, 2, C) f32, all
// contiguous and 16-byte aligned; tmp and out (B, H, W, C) bf16 scratch,
// neither aliasing x; ws basicblock_chain_plan(..., 6) bytes (null when
// 0).  C must be a multiple of 32.  Returns the first launch error (0 on
// success); the kernels run on `stream`.
extern "C" int basicblock_chain_launch(const void *x, const void *w,
                                       const void *b, void *tmp, void *out,
                                       void *ws, int B, int H, int W, int C,
                                       int n_blocks, void *stream) {
  Plan pl;
  if (n_blocks < 1 || !make_plan(B, H, W, C, &pl) ||
      (pl.splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto *xx = static_cast<const bf16 *>(x);
  const auto *ww = static_cast<const bf16 *>(w);
  const auto *bb = static_cast<const float *>(b);
  auto *tt = static_cast<bf16 *>(tmp);
  auto *oo = static_cast<bf16 *>(out);
  auto *wsf = static_cast<float *>(ws);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const bool two = pl.bm == 256;
#define CHAIN_RUN(BN, MT)                                                   \
  run_chain<BN, MT>(pl, xx, ww, bb, tt, oo, wsf, B, H, W, C, n_blocks, s)
  switch (pl.bn) {
    case 192: err = CHAIN_RUN(192, 1); break;
    case 96: err = two ? CHAIN_RUN(96, 2) : CHAIN_RUN(96, 1); break;
    case 64: err = two ? CHAIN_RUN(64, 2) : CHAIN_RUN(64, 1); break;
    default: err = two ? CHAIN_RUN(32, 2) : CHAIN_RUN(32, 1);
  }
#undef CHAIN_RUN
  return static_cast<int>(err);
}
