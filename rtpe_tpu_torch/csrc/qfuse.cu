// The int8 serving graph's fused elementwise pass, CUDA C++ for sm_90a.
//
// Replaces the fusion XLA makes of the HRNet fuse sum in the int8 graph
// (rtpe_tpu/models/hrnet_packed.py:_module, the sum of the branch and the
// fuse convs' upsampled, dequantized operands, its ReLU and its store) and
// of rtpe_tpu/ops/quant.py:quantize_act where no conv epilogue produces the
// int8 (the network input before conv1, the head's concat).  For each
// output element (b, y, x, c) of a (B, H, W, C) result:
//
//   v_j = op_j[b, y / f_j, x / f_j, c]       nearest upsampling by f_j
//   v_j = fdiv_rn((float)v_j, inv_j)         an int8 operand
//   v_j = rnd(v_j)                           the operand in the dtype
//   s   = v_0; s = rnd(fadd_rn(s, v_j)) for j = 1, 2, ...
//   s   = relu(s)                            (relu)
//   out = s in the dtype (bf16 or f32);  q = clamp(rint(fmul_rn(s, q_inv)),
//         -127, 127) into channels q_off.. of a (B, H, W, q_pitch) int8
//         buffer, the q_zero channels after them set to 0
//
// rnd rounds to bf16 when the sum is taken in bf16 (else nothing), each
// float step on its own: bitwise the plain version's PyTorch ops
// (rtpe_tpu_torch/ops/qfuse.py:fuse_sum_plain).  With one operand, no ReLU
// and no rounding it is quantize_act in one pass, writing straight into a
// channel range of a padded buffer (the conv input the kernel of
// qconv.cu reads: 16-byte pixel rows).
//
// Layouts: every operand dense NHWC (B, H / f, W / f, C) in bf16, f32 or
// int8; the dtype output dense NHWC (B, H, W, C).
//
// Bound on the H100: bytes.  Each operand read once (the upsampled ones at
// their own size: a block's neighbouring pixels share a source pixel, which
// L1 / L2 serve), the outputs written once, at 3.35 TB/s; one float add a
// byte or so is far below any rate.  The design: a thread a group of 8
// channels (16-byte bf16, 8-byte int8 words) where C, the offsets and the
// pitch allow it, consecutive threads on consecutive channels and pixels,
// so every load and store is coalesced; else (3 input channels, the
// head's 34) a thread a pixel's whole row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_OPS = 4;
constexpr int THREADS = 256;

enum Kind { K_NONE = 0, K_BF16 = 1, K_F32 = 2, K_INT8 = 3 };

// The launch's fields, in the order of the int64 array qfuse_launch takes
// (ops/qfuse.py:LAUNCH_FIELDS names them in the same order): per operand
// its pointer, inverse scale (int8 only), kind and upsampling factor.
enum Field {
  F_OP0, F_INV0, F_KIND0, F_F0, F_OP1, F_INV1, F_KIND1, F_F1,
  F_OP2, F_INV2, F_KIND2, F_F2, F_OP3, F_INV3, F_KIND3, F_F3,
  F_B, F_H, F_W, F_C, F_RELU, F_BF16, F_OUT, F_OUT_F32,
  F_Q, F_Q_INV, F_Q_PITCH, F_Q_OFF, F_Q_ZERO, F_COUNT
};

struct Op {
  const void *p;
  const float *inv;
  int kind, f;
};

struct Args {
  Op op[MAX_OPS];
  int nops, h, w, c, relu, round_bf16, out_f32, q_pitch, q_off, q_zero;
  int groups;
  long long total;
  void *out;
  int8_t *q;
  const float *q_inv;
};

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// V consecutive elements of an operand from element e on, as float
template <int V>
__device__ __forceinline__ void load(const Op &o, long long e, float *v) {
  if (V == 8 && o.kind == K_BF16) {
    const uint4 u = *reinterpret_cast<const uint4 *>(
        static_cast<const bf16 *>(o.p) + e);
    const bf16 *b = reinterpret_cast<const bf16 *>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __bfloat162float(b[k]);
  } else if (V == 8 && o.kind == K_F32) {
    const float4 *s = reinterpret_cast<const float4 *>(
        static_cast<const float *>(o.p) + e);
    const float4 u0 = s[0], u1 = s[1];
    v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
    v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
  } else if (V == 8) {
    const uint2 u = *reinterpret_cast<const uint2 *>(
        static_cast<const int8_t *>(o.p) + e);
    const int8_t *b = reinterpret_cast<const int8_t *>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = static_cast<float>(b[k]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      v[k] = o.kind == K_BF16
                 ? __bfloat162float(static_cast<const bf16 *>(o.p)[e + k])
             : o.kind == K_F32
                 ? static_cast<const float *>(o.p)[e + k]
                 : static_cast<float>(static_cast<const int8_t *>(o.p)[e + k]);
  }
}

// relu(sum of the operands) of W channels c0.. of pixel (b, y, x), into s
template <int W>
__device__ __forceinline__ void fuse_values(const Args &a, long long b, int y,
                                            int x, int c0, float *s) {
  const bool bf = a.round_bf16 != 0;
  for (int j = 0; j < a.nops; ++j) {
    const Op &o = a.op[j];
    const int hf = a.h / o.f, wf = a.w / o.f;
    const long long e = ((b * hf + y / o.f) * wf + x / o.f) * a.c + c0;
    float v[W];
    load<W>(o, e, v);
    const float inv = o.kind == K_INT8 ? *o.inv : 0.0f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      float u = o.kind == K_INT8 ? __fdiv_rn(v[k], inv) : v[k];
      if (bf) u = rnd_bf16(u);
      if (j == 0) {
        s[k] = u;
      } else {
        s[k] = __fadd_rn(s[k], u);
        if (bf) s[k] = rnd_bf16(s[k]);
      }
    }
  }
  if (a.relu) {
#pragma unroll
    for (int k = 0; k < W; ++k) s[k] = s[k] < 0.0f ? 0.0f : s[k];
  }
}

// the stores of W channels c0.. of pixel p
template <int W>
__device__ __forceinline__ void store_values(const Args &a, long long p,
                                             int c0, const float *s,
                                             int8_t *qrow) {
  const long long e = p * a.c + c0;
  if (a.out && a.out_f32) {
    float *o = static_cast<float *>(a.out) + e;
#pragma unroll
    for (int k = 0; k < W; ++k) o[k] = s[k];
  } else if (a.out && W == 8) {
    uint4 u;
    bf16 *b16 = reinterpret_cast<bf16 *>(&u);
#pragma unroll
    for (int k = 0; k < W; ++k) b16[k] = __float2bfloat16_rn(s[k]);
    *reinterpret_cast<uint4 *>(static_cast<bf16 *>(a.out) + e) = u;
  } else if (a.out) {
#pragma unroll
    for (int k = 0; k < W; ++k)
      static_cast<bf16 *>(a.out)[e + k] = __float2bfloat16_rn(s[k]);
  }
  if (qrow) {
    const float q_inv = *a.q_inv;
    int8_t qs[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int q = __float2int_rn(__fmul_rn(s[k], q_inv));
      qs[k] = static_cast<int8_t>(q < -127 ? -127 : (q > 127 ? 127 : q));
    }
    if (W == 8) {
      *reinterpret_cast<uint2 *>(qrow + c0) =
          *reinterpret_cast<const uint2 *>(qs);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) qrow[c0 + k] = qs[k];
    }
  }
}

// V = 8: a thread a group of 8 channels of a pixel (or of its zero
// padding); V = 1: a thread a pixel, its channels one by one, then its
// zero padding
template <int V>
__global__ void __launch_bounds__(THREADS) qfuse_kernel(const Args a) {
  const long long t =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= a.total) return;
  const long long p = V == 8 ? t / a.groups : t;
  const int c0 = V == 8 ? static_cast<int>(t - p * a.groups) * V : 0;
  int8_t *qrow = a.q ? a.q + p * a.q_pitch + a.q_off : nullptr;
  if (V == 8 && c0 >= a.c) {            // the zero padding after the channels
    *reinterpret_cast<uint2 *>(qrow + c0) = make_uint2(0, 0);
    return;
  }
  const int x = static_cast<int>(p % a.w);
  const long long by = p / a.w;
  const int y = static_cast<int>(by % a.h);
  const long long b = by / a.h;
  if (V == 8) {
    float s[8];
    fuse_values<8>(a, b, y, x, c0, s);
    store_values<8>(a, p, c0, s, qrow);
    return;
  }
  for (int c = 0; c < a.c; ++c) {
    float s[1];
    fuse_values<1>(a, b, y, x, c, s);
    store_values<1>(a, p, c, s, qrow);
  }
  for (int c = a.c; c < a.c + a.q_zero; ++c) qrow[c] = 0;
}

template <typename T>
T *ptr(long long v) {
  return reinterpret_cast<T *>(static_cast<uintptr_t>(v));
}

}  // namespace

// f: F_COUNT int64 fields in the order of enum Field (pointers as their
// addresses; an absent operand has kind 0 and comes after the present
// ones; out or q null where that output is not wanted).  Returns the
// launch's cudaError_t; the kernel runs on `stream`.
extern "C" int qfuse_launch(const long long *f, int n_fields, void *stream) {
  if (n_fields != F_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.nops = 0;
  for (int j = 0; j < MAX_OPS; ++j) {
    const long long *g = f + 4 * j;
    const int kind = static_cast<int>(g[2]);
    if (kind == K_NONE) break;
    Op &o = a.op[a.nops++];
    o.p = ptr<const void>(g[0]);
    o.inv = ptr<const float>(g[1]);
    o.kind = kind;
    o.f = static_cast<int>(g[3]);
    if (!o.p || kind > K_INT8 || (kind == K_INT8 && !o.inv) || o.f < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long b = f[F_B];
  a.h = static_cast<int>(f[F_H]);
  a.w = static_cast<int>(f[F_W]);
  a.c = static_cast<int>(f[F_C]);
  a.relu = static_cast<int>(f[F_RELU]);
  a.round_bf16 = static_cast<int>(f[F_BF16]);
  a.out = ptr<void>(f[F_OUT]);
  a.out_f32 = static_cast<int>(f[F_OUT_F32]);
  a.q = ptr<int8_t>(f[F_Q]);
  a.q_inv = ptr<const float>(f[F_Q_INV]);
  a.q_pitch = static_cast<int>(f[F_Q_PITCH]);
  a.q_off = static_cast<int>(f[F_Q_OFF]);
  a.q_zero = a.q ? static_cast<int>(f[F_Q_ZERO]) : 0;
  if (a.nops == 0 || b <= 0 || a.h <= 0 || a.w <= 0 || a.c <= 0 ||
      (!a.out && !a.q) || (a.q && (!a.q_inv || a.q_off < 0 || a.q_zero < 0 ||
                                   a.q_off + a.c + a.q_zero > a.q_pitch)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < a.nops; ++j)
    if (a.h % a.op[j].f || a.w % a.op[j].f)
      return static_cast<int>(cudaErrorInvalidValue);
  // 8 channels a thread where every word stays aligned
  bool vec = a.c % 8 == 0 && a.q_zero % 8 == 0;
  if (a.q) vec = vec && a.q_pitch % 8 == 0 && a.q_off % 8 == 0;
  for (int j = 0; j < a.nops; ++j)
    vec = vec && reinterpret_cast<uintptr_t>(a.op[j].p) % 16 == 0;
  if (a.out) vec = vec && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  if (a.q) vec = vec && reinterpret_cast<uintptr_t>(a.q) % 8 == 0;
  a.groups = vec ? (a.c + a.q_zero) / 8 : 1;
  a.total = b * a.h * a.w * a.groups;
  const unsigned blocks = static_cast<unsigned>((a.total + THREADS - 1) /
                                                THREADS);
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    qfuse_kernel<8><<<blocks, THREADS, 0, st>>>(a);
  else
    qfuse_kernel<1><<<blocks, THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
