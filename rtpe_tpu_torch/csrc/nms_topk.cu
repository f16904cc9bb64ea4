// Fused max-pool NMS + per-plane top-K, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel rtpe_tpu/ops/pallas_decode.py:_nms_topk_kernel
// (nms_topk_pallas).  Per (image, joint) plane of det (B, H, W, J):
//   pooled = separable ksize x ksize same-padded max-pool (-inf border),
//   peak   = det where pooled == det, else 0.0 (not -inf: a plane with
//            fewer than K positive peaks fills its remaining slots with
//            zero-valued pixels in flat-index order),
//   top-K by value, ties to the smallest flat index y * W + x.
//
// Design.  A 320 x 320 f32 plane is 400 KB, more than a block's shared
// memory, so the Pallas "whole plane in VMEM" design does not carry
// over.  Pass 1: one block per (plane, 32 x 64 tile) stages the tile
// plus its halo in shared memory, pools it, and emits the tile's own
// top-K (value, flat index) by K rounds of block-wide argmax.  Pass 2:
// one block per plane merges the tiles' candidates into the plane's
// top-K the same way.  Every element of the plane's top-K is in its
// tile's top-K, so the result is exact.  The order (value desc, flat
// index asc) is total, so both passes break ties as the TPU kernel does.
//
// Bound: memory.  The kernel must read det once (B*J*H*W*4 bytes) and
// reads it once (halo re-reads hit L2); the K argmax rounds are
// latency-bound block reductions, two barriers each.
//
// The C entry point launches both passes on the given stream and
// returns cudaGetLastError().  Strides are in elements, so det may be a
// permuted view (an NCHW model output seen as NHWC reads each plane
// contiguously).

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace {

constexpr int TH = 32;
constexpr int TW = 64;
constexpr int HALF_MAX = 4;  // ksize <= 9
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int PER = TH * TW / NTHREADS;

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ void warp_best(float &v, int &i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide best (value desc, index asc).  sv/si hold two buffers of
// NWARPS + 1 entries; alternating them per round needs two barriers.
__device__ __forceinline__ void block_best(float &v, int &i, float *sv,
                                           int *si, int round) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float *bv = sv + (round & 1) * (NWARPS + 1);
  int *bi = si + (round & 1) * (NWARPS + 1);
  warp_best(v, i);
  if (lane == 0) {
    bv[warp] = v;
    bi[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < NWARPS ? bv[lane] : -CUDART_INF_F;
    i = lane < NWARPS ? bi[lane] : INT_MAX;
    warp_best(v, i);
    if (lane == 0) {
      bv[NWARPS] = v;
      bi[NWARPS] = i;
    }
  }
  __syncthreads();
  v = bv[NWARPS];
  i = bi[NWARPS];
}

__global__ void __launch_bounds__(NTHREADS)
nms_tile_kernel(const float *__restrict__ det, long long sb, long long sy,
                long long sx, long long sj, int J, int H, int W, int half,
                int K, float *__restrict__ cand_v, int *__restrict__ cand_i) {
  __shared__ float tile[TH + 2 * HALF_MAX][TW + 2 * HALF_MAX];
  __shared__ float hmax[TH + 2 * HALF_MAX][TW];
  __shared__ float sv[2 * (NWARPS + 1)];
  __shared__ int si[2 * (NWARPS + 1)];

  const int plane = blockIdx.z;
  const int b = plane / J, j = plane % J;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const float *p = det + b * sb + j * sj;
  const int lh = TH + 2 * half, lw = TW + 2 * half;

  for (int idx = threadIdx.x; idx < lh * lw; idx += NTHREADS) {
    const int ly = idx / lw, lx = idx % lw;
    const int gy = ty0 - half + ly, gx = tx0 - half + lx;
    float v = -CUDART_INF_F;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = p[gy * sy + gx * sx];
    tile[ly][lx] = v;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < lh * TW; idx += NTHREADS) {
    const int ly = idx / TW, lx = idx % TW;
    float m = tile[ly][lx + half];
    for (int d = 1; d <= half; ++d)
      m = fmaxf(m, fmaxf(tile[ly][lx + half - d], tile[ly][lx + half + d]));
    hmax[ly][lx] = m;
  }
  __syncthreads();

  float v[PER];
  int fi[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int idx = threadIdx.x + e * NTHREADS;
    const int ly = idx / TW, lx = idx % TW;
    const int gy = ty0 + ly, gx = tx0 + lx;
    if (gy < H && gx < W) {
      const float d = tile[ly + half][lx + half];
      float m = hmax[ly + half][lx];
      for (int dd = 1; dd <= half; ++dd)
        m = fmaxf(m, fmaxf(hmax[ly + half - dd][lx], hmax[ly + half + dd][lx]));
      v[e] = (m == d) ? d : 0.0f;
      fi[e] = gy * W + gx;
    } else {
      v[e] = -CUDART_INF_F;
      fi[e] = INT_MAX;
    }
  }

  const long long tile_id =
      (long long)plane * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
      blockIdx.x;
  float *ov = cand_v + tile_id * K;
  int *oi = cand_i + tile_id * K;
  for (int r = 0; r < K; ++r) {
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
#pragma unroll
    for (int e = 0; e < PER; ++e)
      if (better(v[e], fi[e], bv, bi)) {
        bv = v[e];
        bi = fi[e];
      }
    block_best(bv, bi, sv, si, r);
#pragma unroll
    for (int e = 0; e < PER; ++e)
      if (fi[e] == bi) {
        v[e] = -CUDART_INF_F;
        fi[e] = INT_MAX;
      }
    if (threadIdx.x == 0) {
      ov[r] = bv;
      oi[r] = bi;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
nms_merge_kernel(float *__restrict__ cand_v, int *__restrict__ cand_i,
                 int n_cand, int W, int K, float *__restrict__ out_v,
                 int *__restrict__ out_x, int *__restrict__ out_y) {
  __shared__ float sv[2 * (NWARPS + 1)];
  __shared__ int si[2 * (NWARPS + 1)];
  const int plane = blockIdx.x;
  float *cv = cand_v + (long long)plane * n_cand;
  int *ci = cand_i + (long long)plane * n_cand;

  // each thread keeps the best of its strided share; only the owner of
  // a round's winner rescans its share (the taken entry is cleared)
  float mv = -CUDART_INF_F;
  int mi = INT_MAX, mpos = -1;
  for (int c = threadIdx.x; c < n_cand; c += NTHREADS)
    if (better(cv[c], ci[c], mv, mi)) {
      mv = cv[c];
      mi = ci[c];
      mpos = c;
    }
  for (int r = 0; r < K; ++r) {
    float bv = mv;
    int bi = mi;
    block_best(bv, bi, sv, si, r);
    if (threadIdx.x == 0) {
      out_v[plane * K + r] = bv;
      out_x[plane * K + r] = bi == INT_MAX ? 0 : bi % W;
      out_y[plane * K + r] = bi == INT_MAX ? 0 : bi / W;
    }
    if (mpos >= 0 && mi == bi) {
      cv[mpos] = -CUDART_INF_F;
      ci[mpos] = INT_MAX;
      mv = -CUDART_INF_F;
      mi = INT_MAX;
      mpos = -1;
      for (int c = threadIdx.x; c < n_cand; c += NTHREADS)
        if (better(cv[c], ci[c], mv, mi)) {
          mv = cv[c];
          mi = ci[c];
          mpos = c;
        }
    }
  }
}

}  // namespace

extern "C" int nms_topk_tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

extern "C" int nms_topk_launch(const float *det, long long sb, long long sy,
                               long long sx, long long sj, int B, int H,
                               int W, int J, int ksize, int K, float *cand_v,
                               int *cand_i, float *out_v, int *out_x,
                               int *out_y, void *stream) {
  const int half = ksize / 2;
  if (half > HALF_MAX || ksize % 2 == 0 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid1((W + TW - 1) / TW, (H + TH - 1) / TH, B * J);
  nms_tile_kernel<<<grid1, NTHREADS, 0, s>>>(det, sb, sy, sx, sj, J, H, W,
                                             half, K, cand_v, cand_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_cand = nms_topk_tiles(H, W) * K;
  nms_merge_kernel<<<B * J, NTHREADS, 0, s>>>(cand_v, cand_i, n_cand, W, K,
                                              out_v, out_x, out_y);
  return (int)cudaGetLastError();
}
