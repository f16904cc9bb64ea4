// s8 implicit-GEMM convolution on Hopper's wgmma, with the epilogue of the
// int8 serving graph, CUDA C++ for sm_90a.
//
// Replaces the int8 convolution of rtpe_tpu/ops/quant.py:qconv (XLA's s8 x
// s8 -> s32 conv_general_dilated with the dequantization after it; not a
// Pallas kernel, and PyTorch has no int8 convolution on CUDA) together with
// the elementwise steps XLA fuses into it in rtpe_tpu/models/hrnet_packed.py
// (the ReLU, the residual add, the cast and the requantize of the stored
// activation: "only the int8 tensor hits HBM").  For each output pixel p
// and channel n:
//
//   acc = sum over taps and input channels c of x[p'][c] * w[n][tap][c]
//   y   = fadd_rn(fmul_rn((float)acc, alpha[oy % P][n]), bias[n])
//   y   = relu(y)                                     (relu)
//   y   = rnd(fadd_rn(rnd(y), res))                   (a residual: res in the
//         dtype, or rnd(fdiv_rn((float)r8, res_inv)) for an int8 one)
//   y   = relu(y)                                     (relu_after)
//   out_f32 = y;  out_bf16 = bf16_rn(y);
//   out_q   = clamp(rint(fmul_rn(q_rounded ? rnd(y) : y, q_inv)), -127, 127)
//
// where rnd rounds to bf16 when the graph's dtype is bf16 (else nothing).
// Each float step is rounded on its own (intrinsics: nvcc would contract
// a * b + c into an FMA), so every output is bitwise the plain version's
// composition of PyTorch ops (rtpe_tpu_torch/ops/quant.py:epilogue_plain).
// With no option set the output is the f32 y: the JAX contract.
//
// Layouts: x int8 NHWC (B, H, W, pitch) with pitch a multiple of 16 and
// at least Cpad (the channels_last view of the port's NCHW activations;
// the channels past Cin are multiplied by the kernel's zero padding);
// w int8 (Cout, KH, KW, Cpad), Cin zero-padded to a multiple of 16 once
// at quantize time; alpha f32 (P, Cout), P = 1, or 2 (by output-row
// parity) for the transposed conv; bias f32 (Cout); res and the outputs
// dense NHWC (B, Ho, Wo, Cout).  The 4 x 4 stride-2 transposed conv (its
// kernel stored flipped, as a conv over the 2x-dilated input) runs as
// four sub-pixel phases: output parity (py, px) is a 2 x 2 conv over the
// undilated input with the taps ky = py + 2 ty, kx = px + 2 tx, reading
// input row oy / 2 + ty + py - 1; no tap multiplies a dilation zero.
//
// Design:
//   - tensor cores by wgmma.mma_async m64nNk32 s32.s8.s8, both operands
//     K-major in shared memory in the 128-byte swizzle (integer wgmma has
//     no transpose: the weights (Cout, taps, Cpad) and the NHWC gather
//     already are K-major); a block is 2 warpgroups, 128 output pixels x
//     BN channels, BN the narrowest s8 N of 16, 24, 32, 48 or 64 that
//     covers Cout in tiles of at most 64 (Cout 17 -> 24, 34 -> 48, 96 as
//     two tiles of 48, 192 / 256 / 384 as 3 / 4 / 6 of 64).  Measured on
//     an H100, 64-channel tiles beat tiles that cover Cout whole (96,
//     128, 192) at every call geometry of the W48 (the int8 forward's
//     convs 25.3 -> 22.7 ms at B = 8): two blocks an SM fit, and the
//     short-K convs, which bytes bound, need the warps in flight more
//     than the wider tiles' reuse of A;
//   - K = taps x Cpad in stages of 128 bytes (four k32 steps), each
//     16-byte chunk finding its own tap, zero past K; a ring of 4 stages
//     filled two ahead by 16-byte cp.async from all 256 threads (the A
//     pixel rows gathered from the NHWC input, zero-filled outside the
//     image through the src-size operand, each thread keeping its rows'
//     pixel offsets and a bit per tap that stays inside the image);
//   - a grid that fills the card: (pixel tiles, channel tiles, phases x
//     splits).  Where the tiles alone give fewer than 132 blocks (the
//     40 x 40 and 20 x 20 convs at 192 and 384 channels, everything at
//     B = 1), K is split in S contiguous ranges, as many as keep the grid
//     within 132 blocks, each of at least 2 stages.  Each split writes its
//     int32 partial tile to a workspace; the last block of a tile to
//     arrive (a counter per tile) adds the others to its own, applies the
//     epilogue once and sets the counter back to 0.  Integer sums are
//     exact in any order, so the result is bitwise the unsplit one;
//   - the epilogue straight from the accumulator fragments, each thread's
//     two adjacent channels stored as one 8 / 4 / 2-byte word (scalars
//     where Cout is odd).
//
// Bound on the H100: the larger of 2 * B * Ho * Wo * Cout * taps * Cin
// operations at 1,979 TOP/s (dense int8) and the bytes of x and w read
// once, the residual read once and the outputs written once (bf16 2, int8
// 1 byte an element; f32 4 for the JAX contract) at 3.35 TB/s.  At a
// 640 x 640 forward's call geometries the bytes bound all convs but the
// 3 x 3 ones at 192 and 384 channels (and the 1 x 1s at Cin 256 near the
// line); with the int8 graph's stores (int8, or bf16 + int8) the bytes
// are a third to a half of the f32 contract's.  The design moves each
// input byte once from DRAM (the taps' re-reads hit L2) and writes each
// output once, in the type the next layer reads.
// Later work: TMA (its im2col mode) in place of the 256 threads' copies,
// a producer warp, a persistent kernel whose epilogue overlaps the next
// tile's loads, and stores staged through shared memory as whole rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;          // 2 warpgroups
constexpr int BM = 128;               // output pixels a block: m64 each
constexpr int ROWS_PER = THREADS / 8; // rows a pass of 16-byte chunks
constexpr int KC = 128;               // K bytes a stage: four k32 steps
constexpr int STAGES = 4;             // the ring of copy stages
constexpr int A_BYTES = BM * KC;
constexpr int MAX_BN = 64;            // the widest N tile
constexpr int SMS = 132;              // the H100's SMs: the grid's target
constexpr int MIN_SPLIT_STEPS = 2;    // K stages of a split at least
constexpr int SMEM_MAX = 232448;      // dynamic shared memory of a block
constexpr int MAX_TAPS = 31;          // bits of a row's tap mask

enum ResKind { RES_NONE = 0, RES_DTYPE = 1, RES_INT8 = 2 };

// The launch's fields, in the order of the int64 array qconv_launch takes
// (ops/quant.py:LAUNCH_FIELDS names them in the same order).
enum Field {
  F_X, F_W, F_ALPHA, F_BIAS, F_B, F_H, F_WIDTH, F_PITCH, F_CIN, F_COUT,
  F_KH, F_KW, F_STRIDE, F_PAD, F_TRANSPOSED, F_PERIOD, F_RELU, F_RES_KIND,
  F_RES, F_RES_INV, F_RELU_AFTER, F_BF16, F_OUT_F32, F_OUT_BF16, F_OUT_Q,
  F_Q_INV, F_Q_ROUNDED, F_WS, F_COUNTERS, F_COUNT
};

// The tiling of one call; ops/quant.py:qconv_plan computes the same.
struct Plan {
  int cpad, ho, wo, hm, wm;   // padded Cin; output; a phase's pixel grid
  int phases, taps_w, taps;   // 1, or 4 for the transposed conv; taps
  int bn, tiles_n, tiles_m;   // N tile, channel and pixel tiles
  int nsteps, splits;         // K stages of 128 bytes, K ranges
  long long m, smem, ws_bytes, counters;
};

inline int pick_bn(int per) {
  const int tiles[5] = {16, 24, 32, 48, 64};
  for (int n : tiles)
    if (n >= per) return n;
  return -1;
}

inline bool make_plan(int b, int h, int w, int cin, int cout, int kh, int kw,
                      int stride, int pad, int tr, Plan *p) {
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || pad < 0)
    return false;
  Plan r;
  r.cpad = (cin + 15) / 16 * 16;
  if (tr) {
    if (kh != 4 || kw != 4 || stride != 2 || pad != 1) return false;
    r.ho = 2 * h;
    r.wo = 2 * w;
    r.hm = h;
    r.wm = w;
    r.phases = 4;
    r.taps_w = 2;
    r.taps = 4;
  } else {
    r.ho = (h + 2 * pad - kh) / stride + 1;
    r.wo = (w + 2 * pad - kw) / stride + 1;
    if (r.ho <= 0 || r.wo <= 0 || kh * kw > MAX_TAPS) return false;
    r.hm = r.ho;
    r.wm = r.wo;
    r.phases = 1;
    r.taps_w = kw;
    r.taps = kh * kw;
  }
  r.m = static_cast<long long>(b) * r.hm * r.wm;
  if (r.m >= (1LL << 31)) return false;   // pixel indices are int
  r.tiles_n = (cout + MAX_BN - 1) / MAX_BN;
  r.bn = pick_bn((cout + r.tiles_n - 1) / r.tiles_n);
  r.tiles_m = static_cast<int>((r.m + BM - 1) / BM);
  r.nsteps = static_cast<int>(
      (static_cast<long long>(r.taps) * r.cpad + KC - 1) / KC);
  const long long base =
      static_cast<long long>(r.tiles_m) * r.tiles_n * r.phases;
  r.splits = 1;
  if (base < SMS) {
    const int fit = static_cast<int>(SMS / base);
    const int most = r.nsteps / MIN_SPLIT_STEPS;
    r.splits = fit < most ? fit : most;
    if (r.splits < 1) r.splits = 1;
  }
  // the ring holds a split's steps, STAGES at most
  const int per = (r.nsteps + r.splits - 1) / r.splits;
  r.smem = static_cast<long long>(per < STAGES ? per : STAGES) *
               (A_BYTES + r.bn * KC) +
           1024;
  r.counters = r.splits > 1 ? base : 0;
  r.ws_bytes = r.splits > 1 ? 4LL * base * r.splits * BM * r.bn : 0;
  *p = r;
  return r.smem <= SMEM_MAX;
}

struct Args {
  const int8_t *x, *w;
  const float *alpha, *bias;
  int h, w_, pitch, cpad, cout, kh, kw, stride, pad, tr, period;
  int ho, wo, hm, wm, taps_w, taps, tiles_m, tiles_n, nsteps, splits, m;
  int relu, res_kind, relu_after, round_bf16, q_rounded;
  const void *res;
  const float *res_inv, *q_inv;
  float *out_f32;
  bf16 *out_bf16;
  int8_t *out_q;
  int *ws, *counters;
};

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
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// d += A (64 x 32, K-major) . B (32 x N, K-major), s32 accumulators: the
// register fragment of m64nNk32 (d[4i + e]: row 16 warp + lane / 4 +
// 8 (e >> 1), column 8i + 2 (lane % 4) + (e & 1)).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(int (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<24> {
  __device__ __forceinline__ static void mma(int (&d)[12], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11 "
        "}, %12, %13, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15 "
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  __device__ __forceinline__ static void mma(int (&d)[24], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23 "
        "}, %24, %25, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31 "
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ------------------------------------------------------------ the kernel

template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
    qconv_kernel(const Args a) {
  constexpr int STAGE = A_BYTES + BN * KC;
  constexpr int B_PER = (BN * 8 + THREADS - 1) / THREADS;
  constexpr int NR = BN / 2;                   // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_last;
  __shared__ float s_alpha[BN], s_bias[BN];   // this tile's columns
  // the swizzle atoms are 1024-byte aligned
  const uint32_t base = (saddr(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int split = blockIdx.z % a.splits, phase = blockIdx.z / a.splits;
  const int py = phase >> 1, px = phase & 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int s0 = static_cast<int>(static_cast<long long>(split) * a.nsteps /
                                  a.splits);
  const int s1 = static_cast<int>(static_cast<long long>(split + 1) *
                                  a.nsteps / a.splits);
  // a phase's geometry: tap (ty, tx) of pixel (my, mx) reads input (my s -
  // pady + ty, mx s - padx + tx) and weight tap (ky0 + kst ty, kx0 + kst tx)
  const int s = a.tr ? 1 : a.stride;
  const int pady = a.tr ? 1 - py : a.pad, padx = a.tr ? 1 - px : a.pad;
  const int kst = a.tr ? 2 : 1, ky0 = a.tr ? py : 0, kx0 = a.tr ? px : 0;
  const int hw = a.hm * a.wm;
  // the dequant factors of this tile's columns (a phase's rows share the
  // parity of their output row, so one alpha row serves the block); read
  // after the main loop's first barrier
  const float *alpha = a.alpha + ((a.tr ? py : 0) % a.period) * a.cout;
  for (int i = tid; i < BN; i += THREADS) {
    const bool in_n = n0 + i < a.cout;
    s_alpha[i] = in_n ? alpha[n0 + i] : 0.0f;
    s_bias[i] = in_n ? a.bias[n0 + i] : 0.0f;
  }

  // this thread's A chunks: column ac (16 channels) of rows tid / 8 +
  // ROWS_PER i,
  // each row's input offset and a bit per tap that reaches inside the
  // image (none past M)
  const int ac = tid & 7;
  long long a_off[4];
  uint32_t a_ok[4], a_dst[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 3) + ROWS_PER * i, p = m0 + r;
    a_dst[i] = r * KC + ((ac ^ (r & 7)) << 4);
    a_off[i] = 0;
    a_ok[i] = 0;
    if (p < a.m) {
      const int pb = p / hw, rem = p - pb * hw;
      const int my = rem / a.wm, mx = rem - my * a.wm;
      const int iy0 = my * s - pady, ix0 = mx * s - padx;
      a_off[i] = ((static_cast<long long>(pb) * a.h + iy0) * a.w_ + ix0) *
                 a.pitch;
      for (int ty = 0, tap = 0; ty < a.taps / a.taps_w; ++ty) {
        const bool row_in = iy0 + ty >= 0 && iy0 + ty < a.h;
        for (int tx = 0; tx < a.taps_w; ++tx, ++tap)
          if (row_in && ix0 + tx >= 0 && ix0 + tx < a.w_) a_ok[i] |= 1u << tap;
      }
    }
  }
  // ... and its B chunks: column ac of weight rows tid / 8 + ROWS_PER i
  uint32_t b_dst[B_PER];
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int n = (tid >> 3) + ROWS_PER * i;
    b_dst[i] = A_BYTES + n * KC + ((ac ^ (n & 7)) << 4);
  }
  const int ktot = a.taps * a.cpad;
  const long long wrow = static_cast<long long>(a.kh) * a.kw * a.cpad;

  auto load = [&](int step, int stage) {
    const uint32_t sb = base + stage * STAGE;
    const int kk = step * KC + ac * 16;
    // past K: tap MAX_TAPS has no bit in a_ok, so every chunk zero-fills
    const bool in_k = kk < ktot;
    const int tap = in_k ? kk / a.cpad : MAX_TAPS;
    const int c = in_k ? kk - tap * a.cpad : 0;
    const int ty = tap / a.taps_w, tx = tap - ty * a.taps_w;
    const long long off = (static_cast<long long>(ty) * a.w_ + tx) * a.pitch +
                          c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = (a_ok[i] >> tap) & 1u;
      cp16(base + stage * STAGE + a_dst[i], ok ? a.x + a_off[i] + off : a.x,
           ok);
    }
    const long long wt =
        ((ky0 + kst * ty) * a.kw + kx0 + kst * tx) * a.cpad + c;
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int n = (tid >> 3) + ROWS_PER * i;
      if (n < BN) {
        const bool ok = in_k && n0 + n < a.cout;
        cp16(sb + b_dst[i], ok ? a.w + (n0 + n) * wrow + wt : a.w, ok);
      }
    }
  };

  int acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0;
  fence_acc(acc);

  const int n = s1 - s0;
  if (n <= STAGES) {
    // a short K (most convs of the graph): every stage in flight at once,
    // then the wgmma batches back to back
#pragma unroll 1
    for (int u = 0; u < n; ++u) load(s0 + u, u);
    cp_commit();
    cp_wait<0>();
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll 1
    for (int it = 0; it < n; ++it) {
      const uint32_t sa = base + it * STAGE + wg * 64 * KC;
      const uint32_t sbb = base + it * STAGE + A_BYTES;
#pragma unroll
      for (int k = 0; k < KC / 32; ++k)
        Wgmma<BN>::mma(acc, sw128_desc(sa + k * 32, 16, 1024),
                       sw128_desc(sbb + k * 32, 16, 1024));
    }
    wgmma_commit();
  }
  // a long K: steps s0 + u in stage u % STAGES, two ahead of the one
  // multiplied
#pragma unroll
  for (int u = 0; u < STAGES - 2; ++u) {
    if (n > STAGES && u < n) load(s0 + u, u);
    cp_commit();
  }
#pragma unroll 1
  for (int it = 0; it < (n > STAGES ? n : 0); ++it) {
    cp_wait<STAGES - 3>();   // step it has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();         // ... every thread's; step it - 2's wgmma done
    const int nx = it + STAGES - 2;
    if (nx < n) load(s0 + nx, nx % STAGES);
    cp_commit();
    const uint32_t sa = base + (it % STAGES) * STAGE + wg * 64 * KC;
    const uint32_t sbb = base + (it % STAGES) * STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KC / 32; ++k)
      Wgmma<BN>::mma(acc, sw128_desc(sa + k * 32, 16, 1024),
                     sw128_desc(sbb + k * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();         // step it - 1's batch is done
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_wait<0>();

  // split K: every split stores its partial tile (fragment order, each
  // register's 256 values contiguous); the last to arrive sums them all
  if (a.splits > 1) {
    const int tile =
        (phase * a.tiles_n + static_cast<int>(blockIdx.y)) * a.tiles_m +
        static_cast<int>(blockIdx.x);
    int *ws = a.ws + static_cast<long long>(tile) * a.splits * NR * THREADS;
#pragma unroll
    for (int i = 0; i < NR; ++i)
      ws[(static_cast<long long>(split) * NR + i) * THREADS + tid] = acc[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(a.counters + tile, 1) == a.splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int o = 0; o < a.splits; ++o) {
      if (o == split) continue;
#pragma unroll
      for (int i = 0; i < NR; ++i)
        acc[i] += __ldcg(ws + (static_cast<long long>(o) * NR + i) * THREADS +
                         tid);
    }
    if (tid == 0) a.counters[tile] = 0;   // ready for the next launch
  }

  // the epilogue, from the fragments.  The outputs never alias the
  // inputs, so every residual word of a row is loaded before its first
  // store (a load after a store to a pointer that may alias would wait
  // for it)
  const bool bf = a.round_bf16 != 0;
  const float q_inv = a.out_q ? *a.q_inv : 0.0f;
  const float r_inv = a.res_kind == RES_INT8 ? *a.res_inv : 0.0f;
  const bool pairs = (a.cout & 1) == 0;
  const int wrow16 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const bf16 *__restrict__ res_b = static_cast<const bf16 *>(a.res);
  const float *__restrict__ res_f = static_cast<const float *>(a.res);
  const int8_t *__restrict__ res_q = static_cast<const int8_t *>(a.res);
  float *__restrict__ out_f = a.out_f32;
  bf16 *__restrict__ out_b = a.out_bf16;
  int8_t *__restrict__ out_q = a.out_q;
  auto residual = [&](long long e) -> float {
    if (a.res_kind == RES_INT8) {
      const float v = __fdiv_rn(static_cast<float>(res_q[e]), r_inv);
      return bf ? rnd_bf16(v) : v;
    }
    return bf ? __bfloat162float(res_b[e]) : res_f[e];
  };
  auto finish = [&](int v, int c, float r) -> float {
    float y = __fadd_rn(__fmul_rn(__int2float_rn(v), s_alpha[c]), s_bias[c]);
    if (a.relu) y = relu(y);
    if (a.res_kind != RES_NONE) {
      y = __fadd_rn(bf ? rnd_bf16(y) : y, r);
      if (bf) y = rnd_bf16(y);
    }
    if (a.relu_after) y = relu(y);
    return y;
  };
  auto quant = [&](float y) -> int8_t {
    const float v = a.q_rounded && bf ? rnd_bf16(y) : y;
    int q = __float2int_rn(__fmul_rn(v, q_inv));
    q = q < -127 ? -127 : (q > 127 ? 127 : q);
    return static_cast<int8_t>(q);
  };
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = m0 + wrow16 + 8 * hh;
    if (p >= a.m) continue;
    const int pb = p / hw, rem = p - pb * hw;
    const int my = rem / a.wm, mx = rem - my * a.wm;
    const int oy = a.tr ? 2 * my + py : my, ox = a.tr ? 2 * mx + px : mx;
    const long long row = ((static_cast<long long>(pb) * a.ho + oy) * a.wo +
                           ox) * a.cout;
    const int c0 = 2 * (lane & 3);
    float r0[BN / 8], r1[BN / 8];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      r0[i] = r1[i] = 0.0f;
      const int nn = n0 + 8 * i + c0;
      if (a.res_kind == RES_NONE || nn >= a.cout) continue;
      const long long e = row + nn;
      if (!pairs) {
        r0[i] = residual(e);
        if (nn + 1 < a.cout) r1[i] = residual(e + 1);
      } else if (a.res_kind == RES_INT8) {
        const char2 q2 = *reinterpret_cast<const char2 *>(res_q + e);
        r0[i] = __fdiv_rn(static_cast<float>(q2.x), r_inv);
        r1[i] = __fdiv_rn(static_cast<float>(q2.y), r_inv);
        if (bf) {
          r0[i] = rnd_bf16(r0[i]);
          r1[i] = rnd_bf16(r1[i]);
        }
      } else if (bf) {
        const __nv_bfloat162 b2 =
            *reinterpret_cast<const __nv_bfloat162 *>(res_b + e);
        r0[i] = __bfloat162float(b2.x);
        r1[i] = __bfloat162float(b2.y);
      } else {
        const float2 f2 = *reinterpret_cast<const float2 *>(res_f + e);
        r0[i] = f2.x;
        r1[i] = f2.y;
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = 8 * i + c0, nn = n0 + c;
      if (nn >= a.cout) continue;
      const bool two = nn + 1 < a.cout;
      const long long e = row + nn;
      const float y0 = finish(acc[4 * i + 2 * hh], c, r0[i]);
      const float y1 = two ? finish(acc[4 * i + 2 * hh + 1], c + 1, r1[i])
                           : 0.0f;
      if (pairs) {   // two is true: Cout is even and nn is even
        if (out_f)
          *reinterpret_cast<float2 *>(out_f + e) = make_float2(y0, y1);
        if (out_b)
          *reinterpret_cast<__nv_bfloat162 *>(out_b + e) =
              __floats2bfloat162_rn(y0, y1);
        if (out_q) {
          char2 q2;
          q2.x = quant(y0);
          q2.y = quant(y1);
          *reinterpret_cast<char2 *>(out_q + e) = q2;
        }
      } else {
        if (out_f) out_f[e] = y0;
        if (out_b) out_b[e] = __float2bfloat16_rn(y0);
        if (out_q) out_q[e] = quant(y0);
        if (two) {
          if (out_f) out_f[e + 1] = y1;
          if (out_b) out_b[e + 1] = __float2bfloat16_rn(y1);
          if (out_q) out_q[e + 1] = quant(y1);
        }
      }
    }
  }
}

// ------------------------------------------------------------ host side

template <int BN>
cudaError_t launch(const Plan &pl, const Args &a, cudaStream_t st) {
  // the dynamic shared memory allowed so far, by device: set once each
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (pl.smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(qconv_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(pl.smem));
    if (err != cudaSuccess) return err;
    smem_set[dev] = static_cast<int>(pl.smem);
  }
  const dim3 grid(pl.tiles_m, pl.tiles_n, pl.phases * pl.splits);
  qconv_kernel<BN><<<grid, THREADS, static_cast<size_t>(pl.smem), st>>>(a);
  return cudaGetLastError();
}

template <typename T>
T *ptr(long long v) {
  return reinterpret_cast<T *>(static_cast<uintptr_t>(v));
}

}  // namespace

extern "C" {

// The plan of a call: what = 0 the N tile, 1 pixel tiles, 2 channel tiles,
// 3 phases, 4 taps, 5 K stages of 128 bytes, 6 K splits, 7 dynamic shared
// memory (bytes), 8 split workspace (bytes), 9 tile counters, 10 Cpad;
// -1 for a geometry the kernel refuses.
long long qconv_plan(int b, int h, int w, int cin, int cout, int kh, int kw,
                     int stride, int pad, int transposed, int what) {
  Plan p;
  if (!make_plan(b, h, w, cin, cout, kh, kw, stride, pad, transposed, &p))
    return -1;
  switch (what) {
    case 0: return p.bn;
    case 1: return p.tiles_m;
    case 2: return p.tiles_n;
    case 3: return p.phases;
    case 4: return p.taps;
    case 5: return p.nsteps;
    case 6: return p.splits;
    case 7: return p.smem;
    case 8: return p.ws_bytes;
    case 9: return p.counters;
    case 10: return p.cpad;
    default: return -1;
  }
}

// f: F_COUNT int64 fields in the order of enum Field (pointers as their
// addresses; null where an output or the residual is absent).  x, w 16-byte
// aligned, the pitch a multiple of 16 and at least Cpad; ws and counters
// (zeroed, and left zeroed) where the plan splits K.  Returns the launch's
// cudaError_t; the kernel runs on `stream`.
int qconv_launch(const long long *f, int n_fields, void *stream) {
  if (n_fields != F_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int cin = static_cast<int>(f[F_CIN]);
  if (!make_plan(static_cast<int>(f[F_B]), static_cast<int>(f[F_H]),
                 static_cast<int>(f[F_WIDTH]), cin,
                 static_cast<int>(f[F_COUT]), static_cast<int>(f[F_KH]),
                 static_cast<int>(f[F_KW]), static_cast<int>(f[F_STRIDE]),
                 static_cast<int>(f[F_PAD]), static_cast<int>(f[F_TRANSPOSED]),
                 &pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pitch = static_cast<int>(f[F_PITCH]);
  const int period = static_cast<int>(f[F_PERIOD]);
  if (pitch % 16 || pitch < pl.cpad || period < 1 ||
      (period > 1 && !f[F_TRANSPOSED]) || f[F_X] % 16 ||
      f[F_W] % 16 || (pl.splits > 1 && (!f[F_WS] || !f[F_COUNTERS])) ||
      (f[F_RES_KIND] != RES_NONE && !f[F_RES]) ||
      (f[F_RES_KIND] == RES_INT8 && !f[F_RES_INV]) ||
      (f[F_OUT_Q] && !f[F_Q_INV]))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = ptr<const int8_t>(f[F_X]);
  a.w = ptr<const int8_t>(f[F_W]);
  a.alpha = ptr<const float>(f[F_ALPHA]);
  a.bias = ptr<const float>(f[F_BIAS]);
  a.h = static_cast<int>(f[F_H]);
  a.w_ = static_cast<int>(f[F_WIDTH]);
  a.pitch = pitch;
  a.cpad = pl.cpad;
  a.cout = static_cast<int>(f[F_COUT]);
  a.kh = static_cast<int>(f[F_KH]);
  a.kw = static_cast<int>(f[F_KW]);
  a.stride = static_cast<int>(f[F_STRIDE]);
  a.pad = static_cast<int>(f[F_PAD]);
  a.tr = static_cast<int>(f[F_TRANSPOSED]);
  a.period = period;
  a.ho = pl.ho;
  a.wo = pl.wo;
  a.hm = pl.hm;
  a.wm = pl.wm;
  a.taps_w = pl.taps_w;
  a.taps = pl.taps;
  a.tiles_m = pl.tiles_m;
  a.tiles_n = pl.tiles_n;
  a.nsteps = pl.nsteps;
  a.splits = pl.splits;
  a.m = static_cast<int>(pl.m);
  a.relu = static_cast<int>(f[F_RELU]);
  a.res_kind = static_cast<int>(f[F_RES_KIND]);
  a.relu_after = static_cast<int>(f[F_RELU_AFTER]);
  a.round_bf16 = static_cast<int>(f[F_BF16]);
  a.q_rounded = static_cast<int>(f[F_Q_ROUNDED]);
  a.res = ptr<const void>(f[F_RES]);
  a.res_inv = ptr<const float>(f[F_RES_INV]);
  a.q_inv = ptr<const float>(f[F_Q_INV]);
  a.out_f32 = ptr<float>(f[F_OUT_F32]);
  a.out_bf16 = ptr<bf16>(f[F_OUT_BF16]);
  a.out_q = ptr<int8_t>(f[F_OUT_Q]);
  a.ws = ptr<int>(f[F_WS]);
  a.counters = ptr<int>(f[F_COUNTERS]);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (pl.bn) {
    case 16: err = launch<16>(pl, a, st); break;
    case 24: err = launch<24>(pl, a, st); break;
    case 32: err = launch<32>(pl, a, st); break;
    case 48: err = launch<48>(pl, a, st); break;
    default: err = launch<64>(pl, a, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
