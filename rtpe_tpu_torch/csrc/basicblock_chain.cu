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
// Design.  The TPU kernel keeps one image's whole activation in VMEM for
// the chain, grid=(B,).  Here one image at the W48's branch shapes is
// 1.2 MB / 614 KB / 307 KB (80x80x96, 40x40x192, 20x20x384 bf16), far
// above a block's 227 KB of shared memory, and one block per image would
// leave most of the 132 SMs idle at B=1.  So each 3x3 conv is its own
// launch, an implicit GEMM with M = B*H*W pixels (flattened over the
// batch, so ragged H and W cost nothing but a mask), N = C output
// channels and K = 9*C (tap-major, then input channel):
//   - a block computes 128 pixels x BN channels (BN = 64 where C % 64 == 0,
//     else 32) with 4 warps of 32 pixels x BN, on the tensor cores
//     (mma.sync m16n8k16 bf16 -> f32 accumulators);
//   - K steps of 32 input channels of one tap; the A tile (128 shifted
//     pixel rows, zero-filled outside the image) and the B tile (32 x BN
//     of the HWIO weights) go to shared memory by cp.async, two stages
//     deep, rows padded by 16 bytes so that ldmatrix is conflict-free;
//     B is read with ldmatrix.trans, so the HWIO weights need no copy;
//   - the epilogue adds the f32 bias and rounds once (ReLU for conv 1;
//     the bf16 residual add and ReLU for conv 2) and stores bf16 pairs.
// One C entry point launches the chain's 2n convs on the caller's stream,
// so the host makes one call per chain.  The wrapper allocates two
// scratch tensors: conv 1 writes `tmp`; conv 2 reads `tmp` and the
// block's input and writes `out`, in place from the second block on (a
// pixel's residual is read by the thread that then overwrites it).  At
// B=8 each intermediate (<= 9.8 MB) fits in the 50 MB L2.
//
// Bound: operations.  One chain at B=8 on any of the three branch shapes
// is 2n * B*H*W * 9*C*C multiply-adds = 67.9 GFLOP for n=4: 0.0687 ms at
// 989 TFLOP/s (bf16 dense); the bytes (x once, w once, the output once)
// take ~0.01 ms.  Later work: a persistent kernel over the chain with a
// grid-wide barrier, wgmma fed by TMA with a deeper mbarrier pipeline,
// and weight tiles reused across pixel tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int KC = 32;        // input channels per K step
constexpr int THREADS = 128;  // 4 warps x 32 pixels
constexpr int A_LD = KC + 8;  // shared row pitch in bf16 (80 bytes)

__device__ __forceinline__ unsigned smem_addr(const void *p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src-size 0).
__device__ __forceinline__ void cp_async16(void *dst, const void *src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void *p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void *p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ReLU that keeps a NaN, as jnp.maximum(y, 0) and torch.relu do.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// One 3x3 conv, C -> C channels, zero "same" padding, as an implicit GEMM.
// RESIDUAL = false: out = bf16(relu(conv + bias)).
// RESIDUAL = true:  out = bf16(relu(f32(bf16(conv + bias)) + f32(res))).
// `res` may alias `out`; `in` does not alias either.
template <int BN, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const __nv_bfloat16 *__restrict__ in,
               const __nv_bfloat16 *__restrict__ w,
               const float *__restrict__ bias, const __nv_bfloat16 *res,
               __nv_bfloat16 *out, int H, int W, int C, int M) {
  constexpr int B_LD = BN + 8;  // 144 or 80 bytes
  constexpr int A_ELEMS = BM * A_LD;
  constexpr int STAGE = A_ELEMS + KC * B_LD;
  constexpr int NT = BN / 8;                   // n8 tiles per warp
  constexpr int B_VECS = KC * BN / 8;          // 16-byte vectors per B tile
  constexpr int B_PER_THREAD = B_VECS / THREADS;
  static_assert(B_VECS % THREADS == 0, "B tile split");
  __shared__ __align__(16) __nv_bfloat16 smem[2 * STAGE];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int HW = H * W;

  // the A rows this thread loads: r = tid / 4 + 32 i, 8 channels at
  // vector tid % 4 of the K step
  const int a_vec = tid & 3;
  int a_pix[4], a_y[4], a_x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + (tid >> 2) + 32 * i;
    a_pix[i] = p < M ? p : -1;
    const int rem = p < M ? p % HW : 0;
    a_y[i] = rem / W;
    a_x[i] = rem % W;
  }

  const int c_steps = C / KC;
  const int n_iter = 9 * c_steps;

  auto load_stage = [&](int stage, int it) {
    const int tap = it / c_steps;
    const int c0 = (it - tap * c_steps) * KC;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    __nv_bfloat16 *sA = smem + stage * STAGE;
    __nv_bfloat16 *sB = sA + A_ELEMS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const bool ok = a_pix[i] >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const __nv_bfloat16 *src =
          ok ? in + (int64_t)(a_pix[i] + dy * W + dx) * C + c0 + a_vec * 8
             : in;
      cp_async16(sA + ((tid >> 2) + 32 * i) * A_LD + a_vec * 8, src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int v = tid + THREADS * i;
      const int krow = v / (BN / 8);
      const int nv = v - krow * (BN / 8);
      const __nv_bfloat16 *src =
          w + (int64_t)(tap * C + c0 + krow) * C + n0 + nv * 8;
      cp_async16(sB + krow * B_LD + nv * 8, src, true);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  load_stage(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) load_stage((it + 1) & 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's stage has landed
    __syncthreads();
    const __nv_bfloat16 *sA = smem + (it & 1) * STAGE;
    const __nv_bfloat16 *sB = sA + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = warp * 32 + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], sA + row * A_LD + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(b, sB + krow * B_LD + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the load two steps on
  }

  // epilogue: f32 bias, one rounding, (residual,) ReLU, bf16 pairs
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + nt * 8 + (lane & 3) * 2;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + warp * 32 + mt * 16 + (lane >> 2) + half * 8;
        if (p >= M) continue;
        const float v0 = acc[mt][nt][2 * half] + b0;
        const float v1 = acc[mt][nt][2 * half + 1] + b1;
        const int64_t off = (int64_t)p * C + n;
        __nv_bfloat162 o;
        if (RESIDUAL) {
          const __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162 *>(res + off);
          o = __floats2bfloat162_rn(
              relu(__bfloat162float(y.x) + __bfloat162float(r.x)),
              relu(__bfloat162float(y.y) + __bfloat162float(r.y)));
        } else {
          o = __floats2bfloat162_rn(relu(v0), relu(v1));
        }
        *reinterpret_cast<__nv_bfloat162 *>(out + off) = o;
      }
  }
}

template <int BN>
cudaError_t run_chain(const __nv_bfloat16 *x, const __nv_bfloat16 *w,
                      const float *b, __nv_bfloat16 *tmp, __nv_bfloat16 *out,
                      int B, int H, int W, int C, int n_blocks,
                      cudaStream_t stream) {
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, C / BN);
  const int64_t w_conv = 9LL * C * C;
  const __nv_bfloat16 *cur = x;
  for (int i = 0; i < n_blocks; ++i) {
    conv3x3_kernel<BN, false><<<grid, THREADS, 0, stream>>>(
        cur, w + (2 * i) * w_conv, b + (2 * i) * C, nullptr, tmp, H, W, C, M);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    conv3x3_kernel<BN, true><<<grid, THREADS, 0, stream>>>(
        tmp, w + (2 * i + 1) * w_conv, b + (2 * i + 1) * C, cur, out, H, W, C,
        M);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cur = out;
  }
  return cudaSuccess;
}

}  // namespace

// x (B, H, W, C) bf16, w (n, 2, 3, 3, C, C) bf16, b (n, 2, C) f32, all
// contiguous and 16-byte aligned; tmp and out (B, H, W, C) bf16 scratch,
// neither aliasing x.  C must be a multiple of 32.  Returns the first
// launch error (0 on success); the kernels run on `stream`.
extern "C" int basicblock_chain_launch(const void *x, const void *w,
                                       const void *b, void *tmp, void *out,
                                       int B, int H, int W, int C,
                                       int n_blocks, void *stream) {
  if (C <= 0 || C % KC != 0 || n_blocks < 1 || B * H * W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto *xx = static_cast<const __nv_bfloat16 *>(x);
  const auto *ww = static_cast<const __nv_bfloat16 *>(w);
  const auto *bb = static_cast<const float *>(b);
  auto *tt = static_cast<__nv_bfloat16 *>(tmp);
  auto *oo = static_cast<__nv_bfloat16 *>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      C % 64 == 0 ? run_chain<64>(xx, ww, bb, tt, oo, B, H, W, C, n_blocks, s)
                  : run_chain<32>(xx, ww, bb, tt, oo, B, H, W, C, n_blocks, s);
  return static_cast<int>(err);
}
