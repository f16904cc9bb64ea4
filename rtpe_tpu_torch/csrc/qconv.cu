// s8 implicit-GEMM convolution on the tensor cores, for Hopper (sm_90a).
//
// Replaces the int8 convolution of rtpe_tpu/ops/quant.py:qconv: XLA's s8 x
// s8 -> s32 conv_general_dilated with the dequantization after it (not a
// Pallas kernel; PyTorch has no int8 convolution on CUDA).  For each output
// pixel p and channel n:
//
//   acc = sum over taps (ky, kx) and input channels c of x[p'] * w[n]
//   out = fadd_rn(fmul_rn((float)acc, alpha[oy % P][n]), bias[n])   (f32)
//
// acc is int32; each float step is rounded on its own (no FMA), so the
// result is bitwise the plain version's acc.float() * alpha + bias
// (rtpe_tpu_torch/ops/quant.py).  P is 1, or 2 for the transposed conv,
// whose weights JAX quantizes per output-row parity (its row-packed
// kernel gives each parity the taps it reads, so each (parity, channel)
// has its own scale).
//
// Layouts: x int8 NHWC (B, H, W, Cin), the channels_last view of the port's
// NCHW activations; w int8 (Cout, KH, KW, Cpad), Cin zero-padded to a
// multiple of 16 once at quantize time (K-major B operand); alpha f32
// (P, Cout), bias f32 (Cout); out f32 NHWC (B, Ho, Wo, Cout).  The
// geometry covers every convolution of the dense serving graph: KH x KW
// at stride s with padding pad, and the 4 x 4 transposed conv as a conv
// over the input dilated by 2 (dil = 2: a tap reads input row
// (oy + ky - pad) / 2 where that is even), its kernel flipped at quantize
// time.
//
// Design (simple first): mma.sync m16n8k32 s8 -> s32.  A block computes
// 128 output pixels x BN channels (BN = 32, 48 or 64, the one that pads
// Cout least) with 4 warps, each 32 pixels x BN.  K runs over (tap,
// channel) in 16-channel segments, two segments (32 bytes, one k32 step)
// at a time; a segment never straddles two taps, so each pixel row of A is
// gathered from the NHWC input with one 16-byte cp.async (zero-filled for
// padding, for the dilation's holes and past the last tap), through a
// 3-stage ring in shared memory.  Where a pixel's channel row is not a
// multiple of 16 bytes (Cin = 3 for conv1, 82 for the transposed conv's
// concat) the segment is copied byte by byte instead.  Shared rows are 48
// bytes apart, so the fragments' 32-bit reads hit 32 distinct banks.
//
// Bound on the H100: the larger of 2 * B * Ho * Wo * Cout * taps * Cin
// operations at 1,979 TOP/s dense int8 and the bytes of x and w read once
// and the f32 output written once at 3.35 TB/s.  At a 640 x 640 forward's
// 31 call geometries (B = 8) the f32 output's bytes bound all but the
// 3 x 3 convs at 192 and 384 channels, which operations bound.  This
// first design keeps the JAX contract's f32 output (the caller applies
// the ReLU and the cast); an epilogue that stores int8 (with the ReLU,
// residual and int8_act's requantize), wgmma s8, TMA and the transposed
// conv as four sub-pixel phases are later work (ROADMAP.md Queue 2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels a block
constexpr int THREADS = 128; // 4 warps, 32 pixels each
constexpr int STAGES = 3;
constexpr int ROW = 48;      // shared bytes a row: 32 data + 16 skew

struct Geo {
  int b, h, w, cin, ho, wo, cout, kh, kw, stride, pad, dil;
  int period;  // alpha sets, by output row: alpha[(oy % period) * cout + n]
  int cseg;    // 16-channel segments a tap: Cpad / 16
  int nseg;    // segments of K: kh * kw * cseg
  int ksteps;  // k32 steps: ceil(nseg / 2)
  long long m; // output pixels: b * ho * wo
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ alpha,
                 const float* __restrict__ bias, float* __restrict__ out,
                 Geo g) {
  __shared__ __align__(16) int8_t sA[STAGES][BM * ROW];
  __shared__ __align__(16) int8_t sB[STAGES][BN * ROW];
  constexpr int NT = BN / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // this thread gathers A row tid: output pixel m0 + tid
  const long long m = m0 + tid;
  const bool mvalid = m < g.m;
  int oy = 0, ox = 0;
  long long pb = 0;
  if (mvalid) {
    const long long hw = static_cast<long long>(g.ho) * g.wo;
    pb = m / hw;
    const int r = static_cast<int>(m - pb * hw);
    oy = r / g.wo;
    ox = r - oy * g.wo;
  }
  const int8_t* xb = x + pb * g.h * g.w * static_cast<long long>(g.cin);
  const long long krow = static_cast<long long>(g.nseg) * 16;

  auto load_stage = [&](int slot, int ks) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int seg = ks * 2 + h2;
      int8_t* dst = &sA[slot][tid * ROW + h2 * 16];
      const int8_t* src = x;
      int bytes = 0;
      if (mvalid && seg < g.nseg) {
        const int tap = seg / g.cseg;
        const int c0 = (seg - tap * g.cseg) * 16;
        const int ky = tap / g.kw, kx = tap - ky * g.kw;
        int iy = oy * g.stride + ky - g.pad;
        int ix = ox * g.stride + kx - g.pad;
        bool ok = iy >= 0 && ix >= 0;
        if (g.dil == 2) {
          ok = ok && !(iy & 1) && !(ix & 1);
          iy >>= 1;
          ix >>= 1;
        }
        if (ok && iy < g.h && ix < g.w && c0 < g.cin) {
          src = xb + (static_cast<long long>(iy) * g.w + ix) * g.cin + c0;
          bytes = min(16, g.cin - c0);
        }
      }
      if (ALIGNED) {
        cp_async16(dst, src, bytes);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) dst[i] = i < bytes ? src[i] : 0;
      }
    }
    for (int i = tid; i < BN * 2; i += THREADS) {
      const int r = i >> 1, h2 = i & 1;
      const int seg = ks * 2 + h2;
      const int n = n0 + r;
      const bool ok = n < g.cout && seg < g.nseg;
      const int8_t* src = ok ? wq + n * krow + seg * 16 : wq;
      cp_async16(&sB[slot][r * ROW + h2 * 16], src, ok ? 16 : 0);
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const int nk = g.ksteps;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = ks + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const int8_t* A = sA[ks % STAGES];
    const int8_t* Bs = sB[ks % STAGES];
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = warp * 32 + mt * 16 + g8;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(A + r * ROW + t4 * 4);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(A + (r + 8) * ROW + t4 * 4);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(A + r * ROW + 16 + t4 * 4);
      a[mt][3] =
          *reinterpret_cast<const uint32_t*>(A + (r + 8) * ROW + 16 + t4 * 4);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g8;
      const uint32_t b0 =
          *reinterpret_cast<const uint32_t*>(Bs + n * ROW + t4 * 4);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(Bs + n * ROW + 16 + t4 * 4);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
    }
  }
  cp_async_wait<0>();

  // epilogue: f32 dequantize and bias, each rounded on its own
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long mm = m0 + warp * 32 + mt * 16 + g8 + half * 8;
      if (mm >= g.m) continue;
      float* o = out + mm * g.cout;
      const float* al = alpha;
      if (g.period > 1) {
        const int row = static_cast<int>(mm % (static_cast<long long>(g.ho)
                                               * g.wo)) / g.wo;
        al += (row % g.period) * g.cout;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + nt * 8 + t4 * 2 + j;
          if (n < g.cout)
            o[n] = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + j]), al[n]),
                bias[n]);
        }
      }
    }
  }
}

// the N tile that pads Cout least (the larger on a tie)
int pick_bn(int cout) {
  int best = 64;
  long long best_pad = -1;
  const int opts[3] = {64, 48, 32};
  for (int bn : opts) {
    const long long pad = (cout + bn - 1) / bn * static_cast<long long>(bn);
    if (best_pad < 0 || pad < best_pad) {
      best = bn;
      best_pad = pad;
    }
  }
  return best;
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* alpha,
                   const void* bias, void* out, const Geo& g, bool aligned,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((g.m + BM - 1) / BM),
                  static_cast<unsigned>((g.cout + BN - 1) / BN));
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* ap = static_cast<const float*>(alpha);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  if (aligned)
    qconv_kernel<BN, true><<<grid, THREADS, 0, stream>>>(xp, wp, ap, bp, op, g);
  else
    qconv_kernel<BN, false><<<grid, THREADS, 0, stream>>>(xp, wp, ap, bp, op,
                                                          g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's plan for ops/quant.py:qconv_plan to hold itself against:
// what = 0 the N tile, 1 the 16-channel segments a tap, 2 the K segments,
// 3 the k32 steps.
int qconv_plan(int cin, int cout, int kh, int kw, int what) {
  const int cseg = (cin + 15) / 16;
  const int nseg = kh * kw * cseg;
  switch (what) {
    case 0: return pick_bn(cout);
    case 1: return cseg;
    case 2: return nseg;
    case 3: return (nseg + 1) / 2;
    default: return -1;
  }
}

// x (B, H, W, Cin) int8 NHWC; w (Cout, KH, KW, roundup(Cin, 16)) int8;
// alpha (period, Cout) and bias (Cout) f32; out (B, Ho, Wo, Cout) f32.
// dil is 1, or 2 for the transposed conv taken as a conv over the
// 2x-dilated input; period 1, or 2 for its per-row-parity scales.
int qconv_launch(const void* x, const void* w, const void* alpha,
                 const void* bias, void* out, int b, int h, int wd, int cin,
                 int ho, int wo, int cout, int kh, int kw, int stride,
                 int pad, int dil, int period, void* stream) {
  if (b <= 0 || h <= 0 || wd <= 0 || cin <= 0 || ho <= 0 || wo <= 0 ||
      cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || pad < 0 ||
      (dil != 1 && dil != 2) || period < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Geo g;
  g.b = b; g.h = h; g.w = wd; g.cin = cin; g.ho = ho; g.wo = wo;
  g.cout = cout; g.kh = kh; g.kw = kw; g.stride = stride; g.pad = pad;
  g.dil = dil; g.period = period;
  g.cseg = (cin + 15) / 16;
  g.nseg = kh * kw * g.cseg;
  g.ksteps = (g.nseg + 1) / 2;
  g.m = static_cast<long long>(b) * ho * wo;
  const bool aligned =
      cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (pick_bn(cout)) {
    case 64:
      return static_cast<int>(launch<64>(x, w, alpha, bias, out, g, aligned, s));
    case 48:
      return static_cast<int>(launch<48>(x, w, alpha, bias, out, g, aligned, s));
    default:
      return static_cast<int>(launch<32>(x, w, alpha, bias, out, g, aligned, s));
  }
}

}  // extern "C"
