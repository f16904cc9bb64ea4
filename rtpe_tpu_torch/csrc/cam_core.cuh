// Shared core of the fused ContextAwareModule (CAM) kernels, CUDA C++ for
// sm_90a: cam_f1.cu, cam_f2.cu and cam_f3.cu include it through
// cam_tile.cuh, the 2-D tile kernels of the six ops, which build on it.
//
// The TPU kernels (rtpe_tpu/ops/pallas_cam.py) keep one zero-padded image
// in VMEM and walk it in 16-row bands, grid (B, bands) or (B, phase,
// bands), carrying every reduction in an output block across grid steps.
// One 113 x 113 x 163 bf16 image is 4.2 MB, far above the 227 KB of shared
// memory a block has, and grid steps here run in parallel and in no order.
// So the port tiles the pixels instead (cam_tile.cuh: 8 x 8 pixels of one
// image a block, so a per-tile partial is also a per-image partial, as the
// GAP needs).  Here, what every op shares:
//   - the geometry of a call (Geo): odd channel counts (C = 83 / 163,
//     hc = 20 / 40) are padded to multiples of 16 for K, and N to whole n8
//     tiles, with zeros the wrapper and the kernels stage, never changing
//     the caller's tensors; the output channels of a 1x1 conv go in
//     chunks of NC = 56;
//   - the mma.sync m16n8k16 bf16 -> f32 step and its fragment layout;
//   - every reduction over pixels (batch statistics, the BN parameters'
//     gradients, the gate's gradient) is a per-tile partial written to
//     global memory and summed over tiles in a fixed order by
//     reduce_rows_kernel; the weight gradients (x^T dc over all pixels) are
//     split-K GEMMs over pixel chunks (wgrad_kernel) whose per-split
//     partials are reduced the same way.  No float atomics: a run repeats
//     bitwise;
//   - a backward's phase 0 writes the per-pixel cotangents it needs later
//     (dc of every branch, the residual path's dr, the top conv's dt and
//     the branch activations) to global bf16 scratch; phase 1, the
//     transposed dilated convs that read dc with its halo, is a second
//     launch, since the dependency crosses blocks (cam_tile.cuh).
// Rounding points are the TPU kernels': bf16(conv) before the statistics
// and BN, bf16(a) before the top conv, bf16(t) before the top BN, bf16 of
// dc, dr and dt before the weight-gradient products, dx in bf16.  The
// elementwise BN and cotangent arithmetic uses the _rn intrinsics in the
// JAX order, so the compiler contracts nothing into an FMA.
//
// Later work: wgrad_kernel's pixel rows staged one bf16 per lane, and
// wgmma in place of mma.sync.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cam {

typedef __nv_bfloat16 bf16;

constexpr int TP = 64;            // pixels per tile
constexpr int THREADS = 128;      // 4 warps x 16 pixel rows
constexpr int NWARPS = THREADS / 32;
constexpr int NC = 56;            // output channels per 1x1-conv chunk
constexpr int NTC = NC / 8;       // its n8 tiles
constexpr int NTB = 5;            // n8 tiles of one branch
constexpr int HC_MAX = NTB * 8;   // 40 branch channels at most
constexpr int NB_MAX = 6;         // dilations at most
constexpr int WCH = 64;           // pixels per weight-gradient chunk
constexpr int WP = WCH + 8;       // its shared pitch
constexpr int S_MAX = 64;         // weight-gradient splits at most
constexpr int NRED = 5;           // column sums per chunk at most

// Geometry of one CAM application, from the int[12] the wrapper passes:
// B, H, W, C, nb, hc, then nb dilations.
struct Geo {
  int B, H, W, C, nb, hc;
  int HW, M, NH;
  int kc, knh, khc;   // C, NH, hc padded to 16
  int nhp;            // shared pitch (bf16) of sA: knh + 8
  int dil[NB_MAX];
};

inline int up16(int v) { return (v + 15) / 16 * 16; }

inline bool make_geo(const int *g, Geo *o) {
  Geo r;
  r.B = g[0]; r.H = g[1]; r.W = g[2]; r.C = g[3]; r.nb = g[4]; r.hc = g[5];
  if (r.B <= 0 || r.H <= 0 || r.W <= 0 || r.C <= 0 || r.nb < 1 ||
      r.nb > NB_MAX || r.hc < 1 || r.hc > HC_MAX)
    return false;
  for (int i = 0; i < NB_MAX; ++i) {
    r.dil[i] = i < r.nb ? g[6 + i] : 1;
    if (r.dil[i] < 1) return false;
  }
  r.HW = r.H * r.W;
  r.M = r.B * r.HW;
  r.NH = r.nb * r.hc;
  r.kc = up16(r.C);
  r.knh = up16(r.NH);
  r.khc = up16(r.hc);
  r.nhp = r.knh + 8;
  *o = r;
  return true;
}

// ------------------------------------------------------------ workspace

// Carves 256-byte aligned regions off a workspace pointer; with a null
// base it only counts the bytes.
struct Carve {
  char *base;
  int64_t off = 0;
  explicit Carve(void *b) : base(static_cast<char *>(b)) {}
  template <typename T>
  T *take(int64_t n) {
    T *p = base ? reinterpret_cast<T *>(base + off) : nullptr;
    off += (n * static_cast<int64_t>(sizeof(T)) + 255) / 256 * 256;
    return p;
  }
};

// Pixel chunks of the weight gradients and how they split.
inline int wg_chunks(const Geo &g) { return (g.M + WCH - 1) / WCH; }
inline int wg_splits(const Geo &g) {
  int s = wg_chunks(g) / 16;
  return s < 1 ? 1 : (s > S_MAX ? S_MAX : s);
}

// ------------------------------------------------------------ device helpers

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float bfr(float v) { return bf2f(f2bf(v)); }
__device__ __forceinline__ bf16 bzero() { return __ushort_as_bfloat16(0); }

// max(v, 0) that keeps a NaN, as jnp.maximum(v, 0) and torch.relu do
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// The kernels' BN: ((c - mean) * inv) * scale + bias, no FMA.
__device__ __forceinline__ float bn_apply(float c, float mean, float inv,
                                          float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(c, mean), inv), scale),
                   bias);
}

__device__ __forceinline__ uint32_t ld32(const bf16 *p) {
  return *reinterpret_cast<const uint32_t *>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[j] += A (16 rows from A, K = 16 * ksteps) x B^T, B stored [n][k] with
// n = 8j + 0..7.  Pitches even; fragments per the PTX m16n8k16 layout.
template <int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16 *A,
                                         int lda, const bf16 *Bt, int ldb,
                                         int ksteps, int lane) {
  const int g = lane >> 2, q = (lane & 3) * 2;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 16 + q;
    const uint32_t a0 = ld32(A + g * lda + k);
    const uint32_t a1 = ld32(A + (g + 8) * lda + k);
    const uint32_t a2 = ld32(A + g * lda + k + 8);
    const uint32_t a3 = ld32(A + (g + 8) * lda + k + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16 *b = Bt + (j * 8 + g) * ldb + k;
      mma_bf16(acc[j], a0, a1, a2, a3, ld32(b), ld32(b + 8));
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// Row (0..63) and column (0..8*NT-1) of fragment element (j, e).
__device__ __forceinline__ int frag_row(int warp, int lane, int e) {
  return warp * 16 + (lane >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int lane, int j, int e) {
  return j * 8 + (lane & 3) * 2 + (e & 1);
}

// Flat pixel read for pixel q of image b shifted by (dy, dx); -1 outside
// the image (zero padding) or past its last pixel.
__device__ __forceinline__ int src_row(const Geo &g, int b, int q, int dy,
                                       int dx) {
  if (q >= g.HW) return -1;
  const int y = q / g.W + dy, x = q % g.W + dx;
  if (y < 0 || y >= g.H || x < 0 || x >= g.W) return -1;
  return b * g.HW + y * g.W + x;
}

// After a __syncthreads: the four warps' column sums of slot `slot`, in
// warp order.  red is laid out [warp][SLOTS][NC].
template <int SLOTS = NRED>
__device__ __forceinline__ float block_col(const float *red, int slot,
                                           int c) {
  const int s = SLOTS * NC;
  return ((red[slot * NC + c] + red[s + slot * NC + c]) +
          red[2 * s + slot * NC + c]) +
         red[3 * s + slot * NC + c];
}

// ------------------------------------------------------------ kernels

// out[s * out_ld + c] = sum over r < rows of in[(s rows + r) ld + col0 + c],
// in a fixed order.  grid (ceil(ncols / 32), segments), block (32, 8).
__global__ void reduce_rows_kernel(const float *__restrict__ in, int64_t ld,
                                   int64_t col0, int64_t ncols, int rows,
                                   float *__restrict__ out, int64_t out_ld) {
  __shared__ float sm[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * 32 + tx;
  const int64_t seg = blockIdx.y;
  float acc = 0.0f;
  if (c < ncols)
    for (int r = ty; r < rows; r += 8)
      acc += in[(seg * rows + r) * ld + col0 + c];
  sm[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < ncols) {
    float s = sm[0][tx];
    for (int k = 1; k < 8; ++k) s += sm[k][tx];
    out[seg * out_ld + c] = s;
  }
}

inline cudaError_t reduce_rows(const float *in, int64_t ld, int64_t col0,
                               int64_t ncols, int rows, int segs, float *out,
                               int64_t out_ld, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((ncols + 31) / 32), segs);
  reduce_rows_kernel<<<grid, dim3(32, 8), 0, st>>>(in, ld, col0, ncols, rows,
                                                   out, out_ld);
  return cudaGetLastError();
}

// One weight-gradient product: out[k][n] = sum over pixels p of
// U(p shifted by (dy, dx))[u0 + k] * V(p)[v0 + n], k < K, n < N.
struct WJob {
  const bf16 *u;
  const bf16 *v;
  int64_t out_off;
  int ldu, u0, K, dy, dx, ldv, v0, N;
};
struct WJobs {
  WJob j[NB_MAX * 9];
  int n;
};

// grid (ceil(Kmax / 64), ceil(Nmax / (8 NT)), jobs x splits); each block
// sums its split's pixel chunks for a 64 x 8NT tile of one job and writes
// part[split * part_ld + out_off + k N + n].
template <int NT>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(WJobs jobs, Geo g, int splits, int cps, float *part,
             int64_t part_ld) {
  __shared__ __align__(16) bf16 sU[64 * WP];
  __shared__ __align__(16) bf16 sV[NT * 8 * WP];
  const int job = blockIdx.z / splits, split = blockIdx.z % splits;
  const WJob J = jobs.j[job];
  const int k0 = blockIdx.x * 64, n0 = blockIdx.y * NT * 8;
  if (k0 >= J.K || n0 >= J.N) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = (g.M + WCH - 1) / WCH;
  const int c_begin = split * cps;
  const int c_end = c_begin + cps < n_chunks ? c_begin + cps : n_chunks;
  float acc[NT][4];
  zero_acc(acc);
  for (int ch = c_begin; ch < c_end; ++ch) {
    __syncthreads();
    for (int pp = warp; pp < WCH; pp += NWARPS) {
      const int p = ch * WCH + pp;
      int ru = -1, rv = -1;
      if (p < g.M) {
        const int b = p / g.HW;
        ru = src_row(g, b, p - b * g.HW, J.dy, J.dx);
        rv = p;
      }
      const bf16 *us = J.u + static_cast<int64_t>(ru < 0 ? 0 : ru) * J.ldu +
                       J.u0 + k0;
      const bf16 *vs = J.v + static_cast<int64_t>(rv < 0 ? 0 : rv) * J.ldv +
                       J.v0 + n0;
      for (int k = lane; k < 64; k += 32)
        sU[k * WP + pp] = (ru >= 0 && k0 + k < J.K) ? us[k] : bzero();
      for (int n = lane; n < NT * 8; n += 32)
        sV[n * WP + pp] = (rv >= 0 && n0 + n < J.N) ? vs[n] : bzero();
    }
    __syncthreads();
    warp_mma<NT>(acc, sU + warp * 16 * WP, WP, sV, WP, WCH / 16, lane);
  }
  float *dst = part + split * part_ld + J.out_off;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + frag_row(warp, lane, e);
      const int n = n0 + frag_col(lane, j, e);
      if (k < J.K && n < J.N) dst[static_cast<int64_t>(k) * J.N + n] =
          acc[j][e];
    }
}

// Launch the jobs: part[split * total + job out_off + k N + n].
template <int NT>
cudaError_t wgrad_launch(const WJobs &jobs, const Geo &g, int kmax, int nmax,
                         float *part, int64_t total, cudaStream_t st) {
  const int splits = wg_splits(g);
  const int cps = (wg_chunks(g) + splits - 1) / splits;
  const dim3 grid((kmax + 63) / 64, (nmax + NT * 8 - 1) / (NT * 8),
                  jobs.n * splits);
  wgrad_kernel<NT><<<grid, THREADS, 0, st>>>(jobs, g, splits, cps, part,
                                             total);
  return cudaGetLastError();
}

// Launch the jobs and reduce their split partials into out (the jobs'
// outputs laid end to end, total floats).
template <int NT>
cudaError_t wgrad(const WJobs &jobs, const Geo &g, int kmax, int nmax,
                  float *part, int64_t total, float *out, cudaStream_t st) {
  const cudaError_t err = wgrad_launch<NT>(jobs, g, kmax, nmax, part, total,
                                           st);
  if (err != cudaSuccess) return err;
  return reduce_rows(part, total, 0, total, wg_splits(g), 1, out, total, st);
}

inline int64_t wgrad_part_floats(const Geo &g, int64_t total) {
  return static_cast<int64_t>(wg_splits(g)) * total;
}

inline WJob plain_job(const bf16 *u, int ldu, int K, const bf16 *v, int ldv,
                      int N, int64_t out_off) {
  WJob w;
  w.u = u; w.ldu = ldu; w.u0 = 0; w.K = K; w.dy = 0; w.dx = 0;
  w.v = v; w.ldv = ldv; w.v0 = 0; w.N = N; w.out_off = out_off;
  return w;
}

#define CAM_TRY(expr)                         \
  do {                                        \
    const cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

}  // namespace cam
