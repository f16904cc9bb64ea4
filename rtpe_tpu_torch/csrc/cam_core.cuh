// Shared core of the fused ContextAwareModule (CAM) kernels, CUDA C++ for
// sm_90a: cam_f1.cu, cam_f2.cu and cam_f3.cu include it through
// cam_wg.cuh, the kernels of the six ops, which build on it.
//
// The TPU kernels (rtpe_tpu/ops/pallas_cam.py) keep one zero-padded image
// in VMEM and walk it in 16-row bands, grid (B, bands) or (B, phase,
// bands), carrying every reduction in an output block across grid steps.
// One 113 x 113 x 163 bf16 image is 4.2 MB, far above the 227 KB of shared
// memory a block has, and grid steps here run in parallel and in no order.
// So the port tiles the pixels instead (cam_wg.cuh: 8 x 8 pixels of one
// image a block, so a per-tile partial is also a per-image partial, as the
// GAP needs).  Here, what every op shares:
//   - the geometry of a call (Geo): any C and branch width hc, 1..6
//     dilations; odd channel counts (C = 83 / 163, hc = 20 / 40) are padded
//     to multiples of 16 for K, and N to whole n8 tiles, with zeros the
//     wrapper and the kernels stage, never changing the caller's tensors;
//   - the wgmma helpers (descriptors, fences, mbarriers) and the fragment
//     layout of an m64 accumulator;
//   - every reduction over pixels (batch statistics, the BN parameters'
//     gradients, the gate's gradient) is a per-tile partial written to
//     global memory and summed over tiles in a fixed order by
//     reduce_rows_kernel; the weight gradients are partial rows of the
//     weight-gradient kernels' blocks reduced the same way.  No float
//     atomics: a run repeats bitwise;
//   - a backward's phase 0 writes the per-pixel cotangents it needs later
//     (dc of every branch, the residual path's dr, the top conv's dt and
//     the branch activations a) to global bf16 scratch, every row 16-byte
//     aligned (dr and dt of pitch kc, a of pitch knh, dc of pitch nb khc);
//     phase 1, the transposed dilated convs that read dc with its halo, is
//     a second launch, since the dependency crosses blocks (cam_wg.cuh).
// Rounding points are the TPU kernels': bf16(conv) before the statistics
// and BN, bf16(a) before the top conv, bf16(t) before the top BN, bf16 of
// dc, dr and dt before the weight-gradient products, dx in bf16.  The
// elementwise BN and cotangent arithmetic uses the _rn intrinsics in the
// JAX order, so the compiler contracts nothing into an FMA.
//
// The weight gradients (wgrad_taps_kernel: dkh; wgrad_plain_kernel: dkr,
// dkt) stand for the accumulations inside the three Pallas backwards:
// _f1b_kernel's dkh and dkr (pallas_cam.py:240, 249), _f2b_kernel's dkt
// and dkh (:327, 347) and _f3b_kernel's dkr, dkt and dkh (:451, 468, 488),
// reached through _f1b_call (:580), _f2b_call (:627) and _f3b_call (:675).
// One product is out[k][n] = sum over pixels p of U(p + tap offset, zero
// outside the image)[k] V(p)[n] in float32 from bf16 operands: dkh = x
// against each branch's dc at its 9 taps, dkr = x against dr, dkt = a
// against dt.
//
// Bound, at the train step's CAMs (M = 16 x 113^2 = 204,304 pixels;
// 989 TFLOP/s dense bf16, 3.35 TB/s): dkh at C = 163 (9 x 3 x 163 x 40
// multiply-adds a pixel) 7.19e10 FLOP, 0.073 ms, operations; at C = 83
// (9 x 4 x 83 x 20) 2.44e10 FLOP, 0.025 ms, but reading x (96 channels)
// and dc once takes 0.027 ms, bytes; dkr and dkt at C = 163 are bytes
// bound too (x and dr, a and dt read once: 0.043 and 0.037 ms).  The
// first design (a block per tap, K tile of 64, 64-pixel chunks) took
// 3.6 ms a dkh launch at C = 163 and 2.8 at 83 on an H100 (700 W), this
// one 0.22 and 0.17: the first staged one bf16 of U and V a lane at a
// time, transposed, with three integer divides a pixel row; copies and
// mma.sync products were serialised by two barriers a chunk; and x was
// restaged by each of the 27 taps, dc by each tap and K tile.  What this
// design does about it:
//   - the tap shift is put on dc: out[t] = sum over q of x(q) dc(q -
//     offset t).  A block stages a pixel tile (16 x 8 of one image; 8 x 8
//     where a wide dilation does not fit) of x once, and dc's window
//     around it at the branch's dilation, (16 + 2d) x (8 + 2d) pixels,
//     once; all 9 taps share x's fragments and read their shifted dc out
//     of the one window.  A job's dc columns go in N slices of at most 40
//     (WG_NT_TAPS n8 tiles; hc = 64 is 2 of 32, hc = 128 4 of 32), so a
//     window (308 pixel rows of 80 bytes at d = 3, 40 columns) costs less
//     than x's (128 bytes a row, 64 channels);
//   - TMA copies (one thread issues a tile's boxes, an mbarrier a stage
//     counts their bytes) into a ring of up to 6 stages: tile i + ns - 1
//     loads while tile i multiplies.  TMA's out-of-bounds zero fill is
//     the image edge's zero padding, with no branch in any loop; x lands
//     in the 128-byte swizzle (conflict-free ldmatrix), dc as one plane
//     of 16-byte rows an n8 tile, 128-byte aligned;
//   - no transposing stores: x's pixel-major rows are read as the
//     reduction dimension by ldmatrix .trans, straight into wgmma's A
//     register fragments; dc's planes are wgmma's B in shared memory,
//     MN-major without swizzle (the transpose bit), its descriptor
//     starting at the tap's shift in the window;
//   - wgmma m64 x 8NT x 16 (bf16 -> f32): dkh's 3 warpgroups share the K
//     slice's 64 channels and take 3 taps each (60 accumulators a thread
//     at an N slice of 40 columns); a plain product's take one m64 each
//     against the whole
//     N slice (up to 192 columns, 96 accumulators); k-step ks + 1's A
//     fragments load while ks's wgmmas run;
//   - the walk: 132 blocks, one an SM (384 threads; dkh's ring of 5 takes
//     208 KB of shared memory at C = 163, of 6 210 KB at 83), block k
//     takes combo k % ncombo (combo = job, K slice, N slice) and an even
//     share of its tiles, so every SM is busy at both train shapes and the
//     combos sweep the same pixels together, finding each other's x and
//     dc rows in L2; its sums go to the partial row of its share, the
//     rows (zeroed first) summed by reduce_rows_kernel in a fixed order;
//   - ragged tiles: k-steps past the image's last row are skipped, and
//     pixels outside the image arrive as zeros.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cam {

typedef __nv_bfloat16 bf16;

constexpr int TP = 64;            // pixels per tile
constexpr int NB_MAX = 6;         // dilations at most

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
      r.nb > NB_MAX || r.hc < 1)
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

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t saddr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same, each 8 x 8 matrix transposed on the way: rows stored
// pixel-major are read as the reduction dimension.
__device__ __forceinline__ void ldsm4t(uint32_t a, uint32_t &r0, uint32_t &r1,
                                       uint32_t &r2, uint32_t &r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

// ------------------------------------------------------------ weight grads
//
// out[k][n] = sum over pixels p of U(p + tap offset)[u0 + k] V(p)[v0 + n],
// per job, for all jobs of a launch: wgrad_taps_kernel (the 9 taps of dkh)
// and wgrad_plain_kernel (dkr, dkt: one unshifted product), one body on
// TMA and wgmma; the header note says why they are built so.

constexpr int WG_THREADS = 384;            // 3 warpgroups
constexpr int WG_TX = 8;                   // tile width (pixels)
constexpr int WG_KS = 8;                   // k-steps of a 16-row tile
constexpr int WG_NT_TAPS = 5;              // taps: n8 tiles of an N slice
constexpr int WG_NSW = 24;                 // plain: n8 tiles of an N slice
constexpr int WG_NS_MAX = 6;               // ring stages at most
constexpr int WG_BLOCKS = 132;             // one block an SM
constexpr int WG_SMEM_MAX = 232448;
constexpr int WG_SMEM_EXTRA = 1024 + 64;   // 1024-byte alignment, mbarriers

// One product.  U rows (pitch ldu) from channel u0, K of them; V rows
// (pitch ldv) from channel v0, N of them; with d > 0 the 9 taps of a 3x3
// conv at dilation d (out (3, 3, K, N) at out_off), with d == 0 one
// unshifted product (out (K, N)).
struct WgJob {
  const bf16 *u;
  const bf16 *v;
  int64_t out_off;
  int ldu, u0, K;
  int ldv, v0, N;
  int d;
  int c0, nks, nns;   // its first combo, its K slices and N slices
};

// A launch: its jobs (all with 9 taps, or all with one), the tiling and
// ring, and the walk over combos (job, K slice, N slice) and pixel tiles
// of ty x 8.  A stage holds the tile's U rows, 64 channels (128 bytes,
// TMA's 128-byte swizzle) for each m64 of the K slice, and the V rows, one
// plane of vrows 16-byte rows for each n8 tile (wgmma's layout without
// swizzle): for taps the dc window of the tile at the job's dilation,
// (ty + 2d) x (8 + 2d) pixels, for a plain product the tile.
struct WgPlan {
  WgJob job[NB_MAX];
  int njobs, taps;
  int B, H, W;
  int mt;                  // m16 tiles of a K slice: 4 (taps), 12 (plain)
  int nt;                  // n8 tiles of the wgmma: an N slice's (taps:
                           // the widest job's n8s in even slices of at
                           // most WG_NT_TAPS; plain: rounded up to 8, 16
                           // or 24)
  int nsw;                 // n8 tiles of an N slice: nt (taps), WG_NSW
  int ty;                  // tile rows (16 or 8); tiles are WG_TX wide
  int ns;                  // ring stages
  int tiles_x, tpi, n_tiles;
  int vrows;               // rows of a V plane (a multiple of 8)
  int ustage, vstage;      // bf16 of a stage's U rows and V planes
  int ncombo, blocks, slots;
  int64_t items, total;    // items; floats of one partial row
};

// Block k's share of the walk: combo k % ncombo, tiles [t0, t1) of its
// split s = k / ncombo (the combo's blocks split its tiles evenly), so
// the blocks of all combos sweep the same pixels at the same time and
// find each other's rows of x and of dc in L2; its sums go to partial
// row s.
struct WgRange {
  int combo, s, t0, t1;
};

__host__ __device__ inline WgRange wg_range(const WgPlan &P, int k) {
  WgRange r;
  r.combo = k % P.ncombo;
  r.s = k / P.ncombo;
  const int splits = (P.blocks - r.combo + P.ncombo - 1) / P.ncombo;
  r.t0 = static_cast<int>(static_cast<int64_t>(r.s) * P.n_tiles / splits);
  r.t1 = static_cast<int>(static_cast<int64_t>(r.s + 1) * P.n_tiles /
                          splits);
  return r;
}

inline int64_t wg_smem_bytes(const WgPlan &P) {
  return 2LL * P.ns * (P.ustage + P.vstage) + WG_SMEM_EXTRA;
}

inline int64_t wg_part_floats(const WgPlan &P) {
  return static_cast<int64_t>(P.slots) * P.total;
}

// Fill the tiling, ring and walk of P (jobs' shapes, offsets and pitches
// set; pointers may be null for sizing).  False where a job's rows are not
// 16-byte aligned or nothing fits.  A tap job wider than 40 columns is
// walked in N slices of at most 40 (its combos), each slice the same
// wgmma as a job of that width.
inline bool wg_plan(WgPlan &P, int taps, int B, int H, int W) {
  if (P.njobs < 1 || P.njobs > NB_MAX || (taps != 1 && taps != 9) ||
      B < 1 || H < 1 || W < 1)
    return false;
  P.taps = taps; P.B = B; P.H = H; P.W = W;
  int n8max = 0, dmax = 0;
  for (int i = 0; i < P.njobs; ++i) {
    const WgJob &J = P.job[i];
    const int n8 = (J.N + 7) / 8;
    if (J.K < 1 || J.N < 1 || J.ldu % 8 || J.u0 % 8 || J.ldv % 8 ||
        J.v0 % 8 || J.u0 + (J.K + 7) / 8 * 8 > J.ldu ||
        J.v0 + n8 * 8 > J.ldv || (taps == 9) != (J.d > 0))
      return false;
    const int w8 = taps == 9 || n8 < WG_NSW ? n8 : WG_NSW;
    n8max = w8 > n8max ? w8 : n8max;
    dmax = J.d > dmax ? J.d : dmax;
  }
  // taps: one m64 (the warpgroups take 3 taps each), the widest job's n8
  // tiles in even N slices of at most WG_NT_TAPS (5 stays one slice of 5,
  // 8 two of 4, 16 four of 4); plain: one m64 a warpgroup, the N slice in
  // one wgmma
  P.mt = taps == 9 ? 4 : 12;
  if (taps == 9) {
    const int nsl = (n8max + WG_NT_TAPS - 1) / WG_NT_TAPS;
    P.nt = (n8max + nsl - 1) / nsl;
  } else {
    P.nt = (n8max + 7) / 8 * 8;
  }
  P.nsw = taps == 9 ? P.nt : WG_NSW;
  P.ns = 0;
  // the tallest tile and deepest ring that fit (TMA boxes of <= 256 rows)
  for (int ty = 16; ty >= 8 && !P.ns; ty -= 8)
    for (int ns = WG_NS_MAX; ns >= 1; --ns) {
      const int64_t us = static_cast<int64_t>(P.mt / 4) * ty * WG_TX * 64;
      // a plane's rows, to a multiple of 8: TMA writes 128-byte aligned
      const int64_t vr = (static_cast<int64_t>(ty + 2 * dmax) *
                              (WG_TX + 2 * dmax) + 7) / 8 * 8;
      const int64_t vs = P.nt * vr * 8;
      if (ty + 2 * dmax <= 256 &&
          2LL * ns * (us + vs) + WG_SMEM_EXTRA <= WG_SMEM_MAX) {
        P.ty = ty; P.ns = ns; P.vrows = static_cast<int>(vr);
        P.ustage = static_cast<int>(us);
        P.vstage = static_cast<int>(vs);
        break;
      }
    }
  if (!P.ns) return false;
  P.tiles_x = (W + WG_TX - 1) / WG_TX;
  P.tpi = P.tiles_x * ((H + P.ty - 1) / P.ty);
  P.n_tiles = B * P.tpi;
  int c = 0;
  for (int i = 0; i < P.njobs; ++i) {
    WgJob &J = P.job[i];
    J.c0 = c;
    J.nks = ((J.K + 15) / 16 + P.mt - 1) / P.mt;
    J.nns = ((J.N + 7) / 8 + P.nsw - 1) / P.nsw;
    c += J.nks * J.nns;
  }
  P.ncombo = c;
  P.items = static_cast<int64_t>(c) * P.n_tiles;
  // one SM a block, every combo at least one, no more blocks than items
  P.blocks = c > WG_BLOCKS ? c : WG_BLOCKS;
  if (P.items < P.blocks) P.blocks = static_cast<int>(P.items);
  P.slots = (P.blocks + c - 1) / c;
  return true;
}

// A place in the walk: the combo and the tile's image b and top-left
// pixel (y0, x0).  A block's tiles are consecutive, so the cursor
// advances without a divide.
struct WgCursor {
  int combo, b, y0, x0;
};

__device__ __forceinline__ WgCursor wg_cursor(const WgPlan &P, int combo,
                                              int tile) {
  WgCursor c;
  c.combo = combo;
  c.b = tile / P.tpi;
  const int u = tile - c.b * P.tpi, tyi = u / P.tiles_x;
  c.y0 = tyi * P.ty;
  c.x0 = (u - tyi * P.tiles_x) * WG_TX;
  return c;
}

__device__ __forceinline__ void wg_next(const WgPlan &P, WgCursor &c) {
  c.x0 += WG_TX;
  if (c.x0 < P.W) return;
  c.x0 = 0;
  c.y0 += P.ty;
  if (c.y0 < P.H) return;
  c.y0 = 0;
  ++c.b;
}

// A combo's job, K slice (first channel k0) and N slice (first n8 tile).
struct WgCombo {
  int jj, k0, n8;
};

__device__ __forceinline__ WgCombo wg_combo(const WgPlan &P, int combo) {
  WgCombo q;
  q.jj = 0;
  while (q.jj + 1 < P.njobs && combo >= P.job[q.jj + 1].c0) ++q.jj;
  const int r = combo - P.job[q.jj].c0, nns = P.job[q.jj].nns;
  const int ks = r / nns;
  q.k0 = ks * 16 * P.mt;
  q.n8 = (r - ks * nns) * P.nsw;
  return q;
}

// Order this thread's shared-memory accesses with the async proxy's
// (TMA's writes, wgmma's reads).
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
template <int NT>
__device__ __forceinline__ void fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Keep registers alive to here: the async proxy may still read them.
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[4]) {
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

// A shared-memory matrix descriptor without swizzle: start address,
// leading (K) and stride (N) byte offsets of its 8 x 16-byte core
// matrices.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d += A (64 x 16 bf16, each warp's 16 rows in registers as mma.sync's A
// fragment) . B (16 x 8 NT, N-major in shared memory: descriptor db), f32
// accumulators in mma.sync's C layout per n8 tile (d[j][e]: row 16 warp +
// lane / 4 + 8 (e >> 1), column 8 j + 2 (lane % 4) + (e & 1)).
template <int NT>
struct WgmmaRA;

template <>
struct WgmmaRA<1> {
  __device__ __forceinline__ static void mma(float (&d)[1][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRA<2> {
  __device__ __forceinline__ static void mma(float (&d)[2][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRA<3> {
  __device__ __forceinline__ static void mma(float (&d)[3][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRA<4> {
  __device__ __forceinline__ static void mma(float (&d)[4][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRA<5> {
  __device__ __forceinline__ static void mma(float (&d)[5][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRA<8> {
  __device__ __forceinline__ static void mma(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRA<16> {
  __device__ __forceinline__ static void mma(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRA<24> {
  __device__ __forceinline__ static void mma(float (&d)[24][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// The TMA descriptors of a launch, one pair a job: U (channels, W, H, B)
// in boxes of 64 channels x 8 x ty pixels, 128-byte swizzle; V in boxes of
// 8 channels x (8 + 2d) x (ty + 2d) pixels, no swizzle, so that one box is
// one n8 plane (of the dc window at dilation d for taps, of the tile for
// a plain product).  Pixels outside the image (coordinates below 0 or past
// the edge) and channels past the row arrive as zeros.
struct WgMaps {
  CUtensorMap u[NB_MAX];
  CUtensorMap v[NB_MAX];
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One TMA box of map at 4-D coordinates into shared memory at dst,
// completing on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap *map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Stage the tile at cursor c (one thread): U's boxes of the K slice (one
// an m64) into su, V's planes of the N slice (the dc window at the job's
// dilation, or the tile) into sv; the barrier expects their bytes.
__device__ __forceinline__ void wg_tma(const WgPlan &P, const WgMaps &M,
                                       const WgCursor &c, uint32_t su,
                                       uint32_t sv, uint32_t bar) {
  const WgCombo q = wg_combo(P, c.combo);
  const WgJob &J = P.job[q.jj];
  const int d = J.d, mu = P.mt / 4, box = P.ty * WG_TX * 128;
  int n8 = (J.N + 7) / 8 - q.n8;
  n8 = n8 < P.nsw ? n8 : P.nsw;
  mbar_expect_tx(bar, mu * box +
                          n8 * (P.ty + 2 * d) * (WG_TX + 2 * d) * 16);
  for (int j = 0; j < mu; ++j)
    tma_load(su + j * box, &M.u[q.jj], J.u0 + q.k0 + 64 * j, c.x0, c.y0,
             c.b, bar);
  for (int j = 0; j < n8; ++j)
    tma_load(sv + j * P.vrows * 16, &M.v[q.jj], J.v0 + (q.n8 + j) * 8,
             c.x0 - d, c.y0 - d, c.b, bar);
}

// The walk of block blockIdx.x (wg_range): its tiles of one combo through
// a ring of ns stages filled by TMA (one thread issues a tile's boxes; an
// mbarrier a stage counts their bytes), tile i + ns - 1 loading while
// tile i multiplies.  Per k-step (16 pixels, two tile rows) each warp
// loads its 16 channels' A fragment from the swizzled U rows (ldmatrix
// .trans: pixel-major rows read as the reduction dimension) and its
// warpgroup issues wgmma m64 x 8NT x 16 with B read from the V planes.
// TAPS: the warpgroups share the K slice's m64 and take taps 3 g .. 3 g +
// 2; the shift is put on dc (out[t] = sum over pixels q of x(q) dc(q -
// offset t)), so a tap's B descriptor starts at its shift in the dc window
// and the 9 taps share x's fragments.  Plain: warpgroup g takes the
// slice's m64 number g against the whole N slice.  At the walk's end the
// sums go to partial row s of the combo, zeroed beforehand, so each
// element's rows add up in reduce_rows_kernel's fixed order.
template <bool TAPS, int NT>
__device__ __forceinline__ void wg_body(const WgPlan &P, const WgMaps &M,
                                        float *__restrict__ part) {
  constexpr int GU = TAPS ? 3 : 1;   // wgmmas of a warpgroup a k-step
  extern __shared__ __align__(16) unsigned char wg_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: U stages start there
  const uint32_t su0 = (saddr(wg_smem) + 1023) & ~1023u;
  const uint32_t sv0 = su0 + P.ns * P.ustage * 2;
  const uint32_t bar0 = sv0 + P.ns * P.vstage * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp >> 2, wq = warp & 3;
  const int mi = lane >> 3, ri = lane & 7;
  const bool leader = threadIdx.x == 0;
  const WgRange R = wg_range(P, blockIdx.x);
  const int count = R.t1 - R.t0;
  if (leader) {
    for (int s = 0; s < P.ns; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const WgCombo q = wg_combo(P, R.combo);
  const WgJob &J = P.job[q.jj];
  const int d = J.d, hw = WG_TX + 2 * d;
  // plain: a warpgroup whose m64 lies past K has nothing to add
  const bool idle = !TAPS && q.k0 + 64 * grp >= J.K;
  float acc[GU][NT][4];
#pragma unroll
  for (int i = 0; i < GU; ++i) zero_acc(acc[i]);
  WgCursor cur = wg_cursor(P, R.combo, R.t0), pre = cur;
  for (int s = 0; s + 1 < P.ns && s < count; ++s) {
    if (leader)
      wg_tma(P, M, pre, su0 + s * P.ustage * 2, sv0 + s * P.vstage * 2,
             bar0 + 8 * s);
    wg_next(P, pre);
  }
  // the lane's A row: pixel (row (mi >> 1), column ri) of k-step 0, its
  // 16-byte chunk 2 wq + (mi & 1) of the swizzled row (chunk ^ row % 8),
  // in its warpgroup's m64 (plain) or the one m64 (taps)
  const uint32_t aoff = (TAPS ? 0 : grp * P.ty * WG_TX * 128) +
                        ((mi >> 1) * WG_TX + ri) * 128 +
                        (((2 * wq + (mi & 1)) ^ ri) << 4);
  const uint32_t astep = 2 * WG_TX * 128;
  // B: unit i's plane offset (taps: tap t = 3 g + i reads dc at (y - (t /
  // 3 - 1) d, x - (t % 3 - 1) d), window row (2 - t / 3) d + the pixel's
  // row, column (2 - t % 3) d + its column); K's two 8-pixel halves are a
  // window row (hw) apart, the n8 planes vrows rows
  uint32_t voff[GU];
#pragma unroll
  for (int i = 0; i < GU; ++i) {
    const int t = 3 * grp + i;
    voff[i] = TAPS ? ((2 - t / 3) * d * hw + (2 - t % 3) * d) * 16 : 0;
  }
  const uint32_t lbo = hw * 16, sbo = P.vrows * 16, vstep = 2 * hw * 16;
  int slot = 0, pslot = P.ns - 1;
  for (int n = 0; n < count; ++n) {
    __syncthreads();   // every warp is done with the stage reloaded here
    if (n + P.ns - 1 < count) {
      if (leader) {
        fence_proxy_async();
        wg_tma(P, M, pre, su0 + pslot * P.ustage * 2,
               sv0 + pslot * P.vstage * 2, bar0 + 8 * pslot);
      }
      wg_next(P, pre);
    }
    mbar_wait(bar0 + 8 * slot, (n / P.ns) & 1);
    if (!idle) {
      const int rows = P.H - cur.y0 < P.ty ? P.H - cur.y0 : P.ty;
      const int ksteps = (rows + 1) / 2;
      const uint32_t su = su0 + slot * P.ustage * 2 + aoff;
      const uint32_t sv = sv0 + slot * P.vstage * 2;
      uint32_t a[2][4];
      ldsm4t(su, a[0][0], a[0][1], a[0][2], a[0][3]);
#pragma unroll
      for (int ks = 0; ks < WG_KS; ++ks) {
        if (ks >= ksteps) break;
        const int c = ks & 1;
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < GU; ++i)
          WgmmaRA<NT>::mma(acc[i], a[c],
                           wg_desc(sv + voff[i] + ks * vstep, lbo, sbo));
        wgmma_commit();
        wgmma_wait<1>();   // k-step ks - 1's wgmma done: a[c ^ 1] is free
        keep_regs(a[c ^ 1]);
        if (ks + 1 < ksteps)
          ldsm4t(su + (ks + 1) * astep, a[c ^ 1][0], a[c ^ 1][1],
                 a[c ^ 1][2], a[c ^ 1][3]);
      }
      wgmma_wait<0>();
      keep_regs(a[0]);
      keep_regs(a[1]);
#pragma unroll
      for (int i = 0; i < GU; ++i) fence_acc(acc[i]);
    }
    slot = slot + 1 == P.ns ? 0 : slot + 1;
    pslot = pslot + 1 == P.ns ? 0 : pslot + 1;
    wg_next(P, cur);
  }
  if (idle || count == 0) return;
  // the walk's end: its sums to this block's partial row
  float *dst = part + R.s * P.total + J.out_off;
#pragma unroll
  for (int i = 0; i < GU; ++i) {
    const int64_t base =
        TAPS ? static_cast<int64_t>(3 * grp + i) * J.K * J.N : 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = q.k0 + (TAPS ? 0 : 64 * grp) + wq * 16 +
                      frag_row(0, lane, e);
        const int nn = q.n8 * 8 + frag_col(lane, j, e);
        if (k < J.K && nn < J.N)
          dst[base + static_cast<int64_t>(k) * J.N + nn] = acc[i][j][e];
      }
  }
}

// dkh: the 9 taps of each branch against its dc columns (NT: the n8s of
// an N slice of them).
template <int NT>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_taps_kernel(const WgPlan P, const __grid_constant__ WgMaps M,
                  float *__restrict__ part) {
  wg_body<true, NT>(P, M, part);
}

// dkr, dkt: plain products (NT: an N slice's n8s rounded up to 8, 16, 24).
template <int NT>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_plain_kernel(const WgPlan P, const __grid_constant__ WgMaps M,
                   float *__restrict__ part) {
  wg_body<false, NT>(P, M, part);
}

// Launches of wgrad_taps_kernel ([0]) and wgrad_plain_kernel ([1]) by
// this library since cam_wgrad_counts last reset them; one each launch.
static long long wg_launched[2];

// Zero the partial rows, run the walk, sum the rows into out (the jobs'
// outputs end to end, P.total floats; out null: the caller reduces).
template <typename Kern>
cudaError_t wg_run(Kern kern, const WgPlan &P, const WgMaps &M, float *part,
                   float *out, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(
      part, 0, static_cast<size_t>(wg_part_floats(P)) * sizeof(float), st);
  if (err != cudaSuccess) return err;
  const int64_t smem = wg_smem_bytes(P);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<P.blocks, WG_THREADS, static_cast<size_t>(smem), st>>>(P, M, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++wg_launched[P.taps == 9 ? 0 : 1];
  if (!out) return err;
  return reduce_rows(part, P.total, 0, P.total, P.slots, 1, out, P.total,
                     st);
}

typedef CUresult (*WgEncodeFn)(CUtensorMap *, CUtensorMapDataType, cuuint32_t,
                               void *, const cuuint64_t *, const cuuint64_t *,
                               const cuuint32_t *, const cuuint32_t *,
                               CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion,
                               CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to
// libcuda); null where it is missing.
inline WgEncodeFn wg_encode_fn() {
  static WgEncodeFn fn = nullptr;
  if (!fn) {
    void *p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<WgEncodeFn>(p);
  }
  return fn;
}

// A 4-D bf16 map over pixel rows of pitch ld (channels, W, H, B) with box
// (box0 channels, bw, bh, 1).
inline bool wg_map(CUtensorMap *m, const bf16 *base, int ld, const WgPlan &P,
                   int box0, int bw, int bh, bool swizzle) {
  const WgEncodeFn fn = wg_encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(ld),
                              static_cast<cuuint64_t>(P.W),
                              static_cast<cuuint64_t>(P.H),
                              static_cast<cuuint64_t>(P.B)};
  const cuuint64_t row = static_cast<cuuint64_t>(ld) * 2;
  const cuuint64_t strides[3] = {row, row * P.W, row * P.W * P.H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<bf16 *>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch of plan P: its TMA descriptors, then the kernel of its NT.
inline cudaError_t wgrad(const WgPlan &P, float *part, float *out,
                         cudaStream_t st) {
  WgMaps M;
  for (int i = 0; i < P.njobs; ++i) {
    const WgJob &J = P.job[i];
    if (!wg_map(&M.u[i], J.u, J.ldu, P, 64, WG_TX, P.ty, true) ||
        !wg_map(&M.v[i], J.v, J.ldv, P, 8, WG_TX + 2 * J.d,
                P.ty + 2 * J.d, false))
      return cudaErrorInvalidValue;
  }
  if (P.taps == 9) {
    switch (P.nt) {
      case 1: return wg_run(wgrad_taps_kernel<1>, P, M, part, out, st);
      case 2: return wg_run(wgrad_taps_kernel<2>, P, M, part, out, st);
      case 3: return wg_run(wgrad_taps_kernel<3>, P, M, part, out, st);
      case 4: return wg_run(wgrad_taps_kernel<4>, P, M, part, out, st);
      case 5: return wg_run(wgrad_taps_kernel<5>, P, M, part, out, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (P.nt) {
    case 8: return wg_run(wgrad_plain_kernel<8>, P, M, part, out, st);
    case 16: return wg_run(wgrad_plain_kernel<16>, P, M, part, out, st);
    case 24: return wg_run(wgrad_plain_kernel<24>, P, M, part, out, st);
    default: return cudaErrorInvalidValue;
  }
}

// A plan of plain products (one tap each): jobs' outputs end to end,
// total floats.
inline bool plain_plan(const WgJob *jobs, int n, int64_t total,
                       const Geo &g, WgPlan *P) {
  WgPlan p{};
  p.njobs = n;
  for (int i = 0; i < n; ++i) p.job[i] = jobs[i];
  p.total = total;
  if (!wg_plan(p, 1, g.B, g.H, g.W)) return false;
  *P = p;
  return true;
}

// A job of a plain product (one tap).
inline WgJob plain_job(const bf16 *u, int ldu, int K, const bf16 *v, int ldv,
                       int N, int64_t out_off) {
  WgJob w{};
  w.u = u; w.ldu = ldu; w.u0 = 0; w.K = K;
  w.v = v; w.ldv = ldv; w.v0 = 0; w.N = N;
  w.d = 0; w.out_off = out_off;
  return w;
}

#define CAM_TRY(expr)                         \
  do {                                        \
    const cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

}  // namespace cam

// The weight-gradient launches this library made (out[0] taps, out[1]
// plain) since the last reset; reset != 0 sets them to 0 after reading.
extern "C" int cam_wgrad_counts(long long *out, int reset) {
  for (int i = 0; i < 2; ++i) {
    out[i] = cam::wg_launched[i];
    if (reset) cam::wg_launched[i] = 0;
  }
  return 0;
}
