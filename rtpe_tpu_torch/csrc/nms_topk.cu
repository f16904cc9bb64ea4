// Fused max-pool NMS + per-plane top-K, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel rtpe_tpu/ops/pallas_decode.py:_nms_topk_kernel
// (nms_topk_pallas).  Per (image, joint) plane of det (B, H, W, J):
//   pooled = separable ksize x ksize same-padded max-pool (-inf border)
//            that propagates NaN, as jnp.maximum and F.max_pool2d do
//            (PTX max.NaN.f32): a NaN pixel, and every pixel whose window
//            holds one, is no peak,
//   peak   = det where pooled == det, else 0.0 (not -inf: a plane with
//            fewer than K positive peaks fills its remaining slots with
//            zero-valued pixels in flat-index order),
//   top-K by value, ties to the smallest flat index y * W + x.
// No NaN reaches the selection: pooled == det is false for one.
//
// Design.  A 320 x 320 f32 plane is 400 KB, more than a block's shared
// memory, so the Pallas "whole plane in VMEM" design does not carry
// over.  The order used throughout is (key, flat index), where the key
// is a descending uint32 image of the peak value (desc_key: the larger
// value the smaller key, -0 equal to +0; group_core.cuh:order_key
// reversed).
//   Pass 1: one block per (plane, 32 x 64 tile) loads the tile plus its
//   halo into shared memory (every load issued before the first store;
//   the pool's radius a template parameter, so the loops unroll), and
//   each thread pools a column strip of 8 pixels: the rows' horizontal
//   maxima in registers, then the vertical ones.  It then selects the
//   tile's K smallest (key, flat index) without K rounds, by a
//   threshold.  First the keys are split at the zero key (one count; on
//   heatmaps that are mostly zero fill, most tiles end here); else a
//   radix select of 8-bit digits over a shared-memory histogram, on the
//   side of the zero key that holds the K-th key, ending at the first
//   digit whose bin is taken whole.  That gives a threshold key T and the
//   number of keys equal to T to take.  The compaction takes every key
//   below T and the first keys equal to T in flat order: inside a tile,
//   row-major tile order is flat order, so a ballot per element and one
//   block prefix over (strip, element, warp) give each taken element its
//   slot.
//   Pass 2: one block per plane selects the same way over the tiles'
//   candidates.  Across 32 x 64 tiles candidate order is not flat order,
//   so the flat index is carried as a second key: the candidates at the
//   plane's threshold key are narrowed by a radix select on their flat
//   index (unique).  The K winners are ranked by (key, flat index), one thread
//   a winner counting the winners before it, and written.  Every element
//   of the plane's top-K is in its tile's top-K, so the result is exact,
//   and the barriers' count does not grow with K.
//
// Bound: memory.  The kernel must read det once (B*J*H*W*4 bytes) and
// reads it once (halo re-reads hit L2).  What holds it is latency: each
// tile's block spends ~1.5 us loading, ~0.9 pooling, 0.4 (zero split) to
// 1.9 us (radix) selecting and ~1.1 compacting, four blocks an SM, and
// each plane's merge ~9 us (rtpe_tpu_torch/tools/solver_trace.py).
//
// The C entry point launches both passes on the given stream and
// returns cudaGetLastError().  Strides are in elements, so det may be a
// permuted view (an NCHW model output seen as NHWC reads each plane
// contiguously).

#include <cuda_runtime.h>
#include <climits>
#include <type_traits>
#include <math_constants.h>

namespace {

constexpr int TH = 32;
constexpr int TW = 64;
constexpr int HALF_MAX = 4;  // ksize <= 9
constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int PER = TH * TW / NT;          // pixels a thread
constexpr int CW = TW / 32;                 // warps across a tile row
constexpr int SCAN = PER * NW;              // compaction prefix entries
static_assert(NT / TW * PER == TH, "a thread pools one column strip");
static_assert(SCAN % 32 == 0, "the prefix is one warp's");
constexpr int MNT = 256;                    // the merge's threads
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ZERO_KEY = 0x7fffffffu;  // desc_key(+-0)
constexpr unsigned NONE = 0xffffffffu;      // a slot holding no pixel
constexpr unsigned ALL = 0xffffffffu;       // take every key equal to T

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The larger value the smaller key; -0 as +0; -inf's key 0xff800000 is
// below NONE.
__device__ __forceinline__ unsigned desc_key(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? u : (~u & 0x7fffffffu);
}

struct SelectSmem {
  unsigned hist[2][256];
  unsigned lt, eq;                 // keys below / at the zero key
  unsigned digit, before, cnt;
};

// A threshold: every key below t is taken, and the first `need` keys
// equal to t (ALL: every one).
struct Sel {
  unsigned t, need;
};

// The k-th smallest key (counting repeats) among the keys that `each`
// hands the block's NTH threads (each(f) calls f(key) for each of this
// thread's keys; at least k keys in all), by radix digits of 8 bits from bit top_shift down.
// Starts and ends with a barrier.
template <int NTH, typename Each>
__device__ Sel radix_select(Each each, unsigned k, int top_shift,
                            SelectSmem &s) {
  const int tid = threadIdx.x, lane = tid & 31;
  __syncthreads();  // the last reads of s are done
  for (int i = tid; i < 256; i += NTH) s.hist[0][i] = 0u;
  __syncthreads();
  // the bits above the top digit are 0 in every key
  unsigned prefix = 0u, need = k;
  unsigned pmask = top_shift >= 24 ? 0u : ~0u << (top_shift + 8);
  int buf = 0;
  for (int shift = top_shift; shift >= 0; shift -= 8, buf ^= 1) {
    unsigned *h = s.hist[buf];
    for (int i = tid; i < 256; i += NTH) s.hist[buf ^ 1][i] = 0u;
    each([&](unsigned key) {
      if ((key & pmask) == prefix) atomicAdd(&h[(key >> shift) & 255u], 1u);
    });
    __syncthreads();
    if (tid < 32) {  // the digit whose bin holds the need-th key
      unsigned c[8], sum = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = h[8 * lane + i];
        sum += c[i];
      }
      unsigned inc = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(FULL, inc, off);
        if (lane >= off) inc += o;
      }
      unsigned b = inc - sum;
      if (b < need && need <= inc) {
        int d = 8;
        unsigned bd = 0u, cd = 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (d == 8 && b + c[i] >= need) {
            d = i;
            bd = b;
            cd = c[i];
          }
          b += c[i];
        }
        s.digit = 8 * lane + d;
        s.before = bd;
        s.cnt = cd;
      }
    }
    __syncthreads();
    const unsigned d = s.digit, cnt = s.cnt;
    need -= s.before;
    prefix |= d << shift;
    pmask |= 0xffu << shift;
    if (cnt == need) return {prefix | ~pmask, ALL};  // the bin, whole
  }
  return {prefix, need};
}

// The threshold of the k smallest value keys: split at the zero key
// first (counts lt, eq of keys below / at it, made by the caller), then
// a radix select on the side that holds the k-th key.
template <int NTH, typename Each>
__device__ Sel value_select(Each each, unsigned k, SelectSmem &s) {
  const unsigned lt = s.lt, eq = s.eq;
  if (lt < k && k <= lt + eq) return {ZERO_KEY, k - lt};
  if (k <= lt) {
    // a bin taken whole may reach the zero key, which this side leaves
    Sel r = radix_select<NTH>([&](auto f) {
      each([&](unsigned key) { if (key < ZERO_KEY) f(key); });
    }, k, 24, s);
    r.t = min(r.t, ZERO_KEY - 1u);
    return r;
  }
  // every key at or below the zero key is taken
  return radix_select<NTH>([&](auto f) {
    each([&](unsigned key) { if (key > ZERO_KEY) f(key); });
  }, k - lt - eq, 24, s);
}

// Adds this warp's counts of keys below / at the zero key to s.lt / s.eq
// (zeroed before a barrier that precedes this).
__device__ __forceinline__ void count_zero_split(unsigned lt, unsigned eq,
                                                 SelectSmem &s) {
  lt = __reduce_add_sync(FULL, lt);
  eq = __reduce_add_sync(FULL, eq);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s.lt, lt);
    atomicAdd(&s.eq, eq);
  }
}

// Tile pixel (ly, lx) belongs to thread lx + TW (ly / PER), as its element
// ly % PER: a thread pools a column strip of PER rows.  Flat order inside
// the tile is (ly, lx), that is (strip, element, warp of the row, lane).
__device__ __forceinline__ int scan_slot(int warp, int e) {
  return (warp / CW) * PER * CW + e * CW + warp % CW;
}

template <int R>
__global__ void __launch_bounds__(NT)
nms_tile_kernel(const float *__restrict__ det, long long sb, long long sy,
                long long sx, long long sj, int J, int H, int W, int K,
                float *__restrict__ cand_v, int *__restrict__ cand_i) {
  constexpr int LH = TH + 2 * R, LW = TW + 2 * R;
  constexpr int NLOAD = (LH * LW + NT - 1) / NT;
  __shared__ float tile[LH][LW];
  __shared__ SelectSmem ss;
  __shared__ unsigned scan[SCAN];  // (strip, element, warp): lt << 16 | eq

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int plane = blockIdx.z;
  const int b = plane / J, j = plane % J;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const float *p = det + b * sb + j * sj;

  if (tid == 0) {
    ss.lt = 0u;
    ss.eq = 0u;
  }
  // the tile and its halo: every load issued before the first store
  float r[NLOAD];
#pragma unroll
  for (int i = 0; i < NLOAD; ++i) {
    const int idx = tid + i * NT;
    const int gy = ty0 - R + idx / LW, gx = tx0 - R + idx % LW;
    r[i] = (idx < LH * LW && gy >= 0 && gy < H && gx >= 0 && gx < W)
               ? p[gy * sy + gx * sx]
               : -CUDART_INF_F;
  }
#pragma unroll
  for (int i = 0; i < NLOAD; ++i) {
    const int idx = tid + i * NT;
    if (idx < LH * LW) tile[idx / LW][idx % LW] = r[i];
  }
  __syncthreads();

  // the pool of this thread's column strip: the rows' horizontal maxima
  // in registers, then the vertical ones
  const int cx = tid % TW, y0 = (tid / TW) * PER;
  const int gx = tx0 + cx;
  float hm[PER + 2 * R];
#pragma unroll
  for (int rr = 0; rr < PER + 2 * R; ++rr) {
    const float *row = &tile[y0 + rr][cx];
    float m = row[R];
#pragma unroll
    for (int d = 1; d <= R; ++d) m = max_nan(m, max_nan(row[R - d], row[R + d]));
    hm[rr] = m;
  }
  unsigned key[PER], peaks = 0u, n_lt = 0u, n_eq = 0u;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    float m = hm[e + R];
#pragma unroll
    for (int d = 1; d <= R; ++d)
      m = max_nan(m, max_nan(hm[e + R - d], hm[e + R + d]));
    const float c0 = tile[y0 + e + R][cx + R];
    const bool peak = m == c0;
    peaks |= (unsigned)peak << e;
    key[e] = (ty0 + y0 + e < H && gx < W) ? desc_key(peak ? c0 : 0.0f)
                                          : NONE;
    n_lt += key[e] < ZERO_KEY;
    n_eq += key[e] == ZERO_KEY;
  }
  count_zero_split(n_lt, n_eq, ss);
  __syncthreads();

  const unsigned kk = min(K, TH * TW);
  const Sel sel = value_select<NT>([&](auto f) {
#pragma unroll
    for (int e = 0; e < PER; ++e) f(key[e]);
  }, kk, ss);

  // compaction in flat order: slot = (keys below T before this one) +
  // min(keys at T before this one, need)
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const unsigned lt = __popc(__ballot_sync(FULL, key[e] < sel.t));
    const unsigned eq = __popc(__ballot_sync(FULL, key[e] == sel.t));
    if (lane == 0) scan[scan_slot(warp, e)] = (lt << 16) | eq;
  }
  __syncthreads();
  if (tid < 32) {  // exclusive scan of the SCAN entries, SCAN / 32 a lane
    constexpr int PL = SCAN / 32;
    unsigned a[PL], sum = 0u;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      a[i] = scan[PL * lane + i];
      sum += a[i];
    }
    unsigned inc = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += o;
    }
    unsigned exc = inc - sum;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      scan[PL * lane + i] = exc;
      exc += a[i];
    }
  }
  __syncthreads();

  const long long tile_id =
      (long long)plane * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
      blockIdx.x;
  float *ov = cand_v + tile_id * K;
  int *oi = cand_i + tile_id * K;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const unsigned base = scan[scan_slot(warp, e)];
    const unsigned ltp =
        (base >> 16) + __popc(__ballot_sync(FULL, key[e] < sel.t) & below);
    const unsigned eqp = (base & 0xffffu) +
                         __popc(__ballot_sync(FULL, key[e] == sel.t) & below);
    if (key[e] < sel.t || (key[e] == sel.t && eqp < sel.need)) {
      const unsigned slot = ltp + min(eqp, sel.need);
      const int gy = ty0 + y0 + e;
      const bool inside = gy < H && gx < W;
      ov[slot] = !inside ? -CUDART_INF_F
                         : ((peaks >> e) & 1u) ? tile[y0 + e + R][cx + R]
                                               : 0.0f;
      oi[slot] = inside ? gy * W + gx : INT_MAX;
    }
  }
  for (int s = kk + tid; s < K; s += NT) {  // a tile smaller than K
    ov[s] = -CUDART_INF_F;
    oi[s] = INT_MAX;
  }
}

// One block a plane over its tiles' candidates (read from global memory,
// where pass 1 left them, at each pass: they are ~12 KB a plane and sit in
// L2).
__global__ void __launch_bounds__(MNT)
nms_merge_kernel(const float *__restrict__ cand_v,
                 const int *__restrict__ cand_i, int n_cand, int HW, int W,
                 int K, float *__restrict__ out_v, int *__restrict__ out_x,
                 int *__restrict__ out_y) {
  // K winners: (key, flat index) as one 64-bit order, and the value
  extern __shared__ unsigned long long win[];
  __shared__ SelectSmem ss;
  __shared__ unsigned n_win;
  const int tid = threadIdx.x;
  const int plane = blockIdx.x;
  const float *cv = cand_v + (long long)plane * n_cand;
  const int *ci = cand_i + (long long)plane * n_cand;
  float *wv = reinterpret_cast<float *>(win + K);

  auto key_of = [&](int c) {
    return ci[c] == INT_MAX ? NONE : desc_key(cv[c]);
  };
  auto each = [&](auto f) {
    for (int c = tid; c < n_cand; c += MNT) f(key_of(c));
  };
  if (tid == 0) {
    ss.lt = 0u;
    ss.eq = 0u;
    n_win = 0u;
  }
  __syncthreads();
  unsigned n_lt = 0u, n_eq = 0u;
  each([&](unsigned key) {
    n_lt += key < ZERO_KEY;
    n_eq += key == ZERO_KEY;
  });
  count_zero_split(n_lt, n_eq, ss);
  __syncthreads();
  const Sel sv = value_select<MNT>(each, K, ss);
  // the keys at T: the need of them with the smallest flat index (the
  // candidates' flat indices are distinct)
  unsigned t_idx = UINT_MAX;
  if (sv.need != ALL) {
    const int nb = 32 - __clz(max(HW - 1, 1));
    t_idx = radix_select<MNT>([&](auto f) {
      for (int c = tid; c < n_cand; c += MNT)
        if (key_of(c) == sv.t) f((unsigned)ci[c]);
    }, sv.need, ((nb - 1) / 8) * 8, ss).t;
  }
  for (int c = tid; c < n_cand; c += MNT) {
    const unsigned key = key_of(c);
    if (key < sv.t || (key == sv.t && (unsigned)ci[c] <= t_idx)) {
      const unsigned pos = atomicAdd(&n_win, 1u);
      if (pos < (unsigned)K) {
        win[pos] = ((unsigned long long)key << 32) | (unsigned)ci[c];
        wv[pos] = cv[c];
      }
    }
  }
  __syncthreads();
  // rank: the winners before this one in (key, flat index) order
  for (int w = tid; w < K; w += MNT) {
    const unsigned long long mine = win[w];
    int rank = 0;
#pragma unroll 8
    for (int o = 0; o < K; ++o) rank += win[o] < mine;
    const int iw = (int)(mine & 0xffffffffu);
    out_v[plane * K + rank] = wv[w];
    out_x[plane * K + rank] = iw % W;
    out_y[plane * K + rank] = iw / W;
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
  if (half > HALF_MAX || ksize % 2 == 0 || K < 1 || (long long)H * W < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid1((W + TW - 1) / TW, (H + TH - 1) / TH, B * J);
  auto tile = [&](auto r) {
    nms_tile_kernel<decltype(r)::value><<<grid1, NT, 0, s>>>(
        det, sb, sy, sx, sj, J, H, W, K, cand_v, cand_i);
  };
  switch (half) {
    case 0: tile(std::integral_constant<int, 0>{}); break;
    case 1: tile(std::integral_constant<int, 1>{}); break;
    case 2: tile(std::integral_constant<int, 2>{}); break;
    case 3: tile(std::integral_constant<int, 3>{}); break;
    default: tile(std::integral_constant<int, 4>{}); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_cand = nms_topk_tiles(H, W) * K;
  const size_t smem = (size_t)K * 3 * sizeof(unsigned);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_merge_kernel<<<B * J, MNT, smem, s>>>(cand_v, cand_i, n_cand, H * W, W,
                                            K, out_v, out_x, out_y);
  return (int)cudaGetLastError();
}
