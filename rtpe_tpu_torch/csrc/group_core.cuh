// Associative-embedding grouping of one image per block, joint after
// joint: the sections shared by group_lockstep.cu (the lockstep greedy
// kernel) and group_mega.cu (the grouping mega-kernel, greedy or exact
// LAP).
//
// What a joint computes (both kernels, see their headers for the
// TPU kernels they replace): against the person state frozen at joint
// entry (keys, tag sums and counts of 128 slots, npv people), each row r
// of the joint's top-k gets a cost to the first p_cur = min(npv, m)
// people; the rows are assigned (greedy: in order, each to the cheapest
// unused person, NaN first and the smallest slot on ties; or the exact
// LAP); then, row by row, a matched row adds its tag to its person, an
// unmatched active row merges onto the first person whose key equals its
// first tag dimension exactly (setdefault) or appends a person at
// min(npv, p_max - 1); the people row of every slot written at the joint
// is the last row that wrote it.
//
// Design.  The parent design ran one warp per image with every latency
// exposed: a clock64 trace of one image (H100) put 60 % of the time in
// the cost build inside the serial row chain, 25 % in the update, 10 % in
// the argmins.  Here one block of NT = 256 threads owns one image:
//   A. all warps: the joint's costs, each (row, slot) element on its own
//      lane (the sequence of __f*_rn operations is the parent's, so the
//      costs are bitwise the same), and each active row's first key match
//      among the slots whose keys cannot change during the joint
//      (s < min(npv, p_max - 1)), 16 slots a warp;
//   B. warp 0: the assignment.  Greedy: one lane per candidate slot group
//      (Q slots a lane, slot = Q * lane + q), each row's argmin is one
//      __reduce_min_sync over an order-preserving uint32 image of the cost
//      (order_key) and one ballot for the smallest slot at that minimum;
//      the row's match test was made in the build.  LAP: lapcore::lap_warp
//      on the 32 x 128 cost, column 0 for the entering row, two columns a
//      lane up to 2m = 63 and four beyond.  Then the
//      update's slot of every row: matched rows take their column, new
//      rows their stable key match, and the rest in one or two warp
//      operations (fresh slots, or the last slot once there are p_max
//      people), walking in order only on the joint that reaches p_max;
//      each slot gets the masks of its rows;
//   C. one thread per slot applies its rows: from the last that reset it
//      (a new person or a key merge), the matched rows' tags added in row
//      order (the parent's order of the sums); it writes its people row
//      and the next joint's mean.
// The next joint's detection rows are copied into shared memory by
// cp.async while this joint runs.  D (tag dimensions) and Q are template
// parameters: no predicated loop over an unused dimension remains.
// Every float operation is an explicit round-to-nearest intrinsic, so
// nvcc contracts no multiply-add; the clamp keeps a NaN.
//
// Bound: latency.  The greedy chain is one dependent (min, ballot) step
// per active row and joint, the update one more; the bytes take well under
// a microsecond.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <type_traits>
#include <math_constants.h>

#include "lap_core.cuh"

namespace groupcore {

constexpr int NT = 256;                  // threads a block (one image)
constexpr int NW = NT / 32;
constexpr int SLOTS = 128;               // person slots of the state
constexpr int ROWS = 32;                 // detection rows a joint
constexpr int LANES = 128;               // the LAP cost's row stride
constexpr int DMAX = 8;
constexpr int HIT_SPAN = SLOTS / NW;     // slots a warp searches for keys
constexpr float COST_CLAMP = 1000.0f;
constexpr float BIG = 2048.0f;
constexpr float HUGE_COST = 4096.0f;
constexpr float MASKED = 1e18f;
constexpr unsigned FULL = 0xffffffffu;

// The three solvers: the lockstep kernel's greedy (its own tie bias), the
// mega-kernel's greedy and its exact LAP.
enum Solver { LOCKSTEP = 0, GREEDY = 1, LAP = 2 };

// An order-preserving uint32 image of a cost for the greedy argmin: a NaN
// below everything (jnp.min and torch.argmin propagate it), -0 equal to
// +0, else the float order.  The smallest non-NaN key, -inf's, is
// 0x007fffff.
__device__ __forceinline__ unsigned order_key(float c) {
  unsigned u = __float_as_uint(c);
  if (c != c) return 0u;
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int D>
struct Rows {                   // one joint's detection rows
  float val[ROWS];
  float xy[2 * ROWS];
  float tag[ROWS * D];
};

// The assignment's scratch: greedy order keys and match tests, or the
// LAP's costs and distances.
template <int S, int Q>
struct Scratch {
  unsigned ckey[ROWS * 32 * Q];        // (row, slot)
  unsigned char okm[ROWS * 32 * Q];    // (row, slot): matches if chosen
};
template <int Q>
struct Scratch<LAP, Q> {
  float cost[ROWS * LANES];            // (row, column l = slot + 1)
  float diff[ROWS * LANES];            // (row, slot) unrounded distance
};

template <int S, int D, int Q>
struct Shared {
  Rows<D> rows[2];                     // this joint's and the next one's
  float mean[D][SLOTS];                // tag means frozen at joint entry
  float key[SLOTS];                    // person keys at joint entry
  int hit[NW][ROWS];                   // first stable key match, by warp
  int col[ROWS];
  int match[ROWS];
  // per slot, bit r: row r writes it; resets it (a new person or a key
  // merge: its tag sum starts again); allocates it (takes the row's key)
  unsigned writes[SLOTS], resets[SLOTS], allocs[SLOTS];
  int npv;
  Scratch<S, Q> s;
};

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies joint j's rows of image b into shared memory, one group.
template <int D>
__device__ __forceinline__ void load_rows(Rows<D> &dst, const float *tag,
                                          const float *loc, const float *val,
                                          long long base, int K, int tid) {
  for (int i = tid; i < K * (3 + D); i += NT) {
    if (i < K)
      cp_async4(dst.val + i, val + base + i);
    else if (i < 3 * K)
      cp_async4(dst.xy + (i - K), loc + 2 * base + (i - K));
    else
      cp_async4(dst.tag + (i - 3 * K), tag + D * base + (i - 3 * K));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// ||t_r - mean_s||^2 as the parent computes it: a sum over d of squared
// differences from 0 (its rounded square root is the distance).
template <int D>
__device__ __forceinline__ float tag_sq(const Rows<D> &rw, int r,
                                        const float (&mean)[D][SLOTS],
                                        int s) {
  float sq = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float dl = __fsub_rn(rw.tag[r * D + d], mean[d][s]);
    sq = __fadd_rn(sq, __fmul_rn(dl, dl));
  }
  return sq;
}

// round_half_even(distance) * 100 - val, or the distance, clamped at
// 1000 in a way that keeps a NaN.
__device__ __forceinline__ float clamped_cost(float diff, float v,
                                              int use_val) {
  const float c =
      use_val ? __fsub_rn(__fmul_rn(rintf(diff), 100.0f), v) : diff;
  return c > COST_CLAMP ? COST_CLAMP : c;
}

// Stores one people row of RW floats in the widest pieces its alignment
// allows (a row starts at a multiple of RW floats): 16 bytes where RW is
// a multiple of 4, 8 where it is even.
template <int RW>
__device__ __forceinline__ void store_row(float *out, const float (&v)[RW]) {
  if constexpr (RW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < RW; i += 4)
      *reinterpret_cast<float4 *>(out + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (RW % 2 == 0) {
#pragma unroll
    for (int i = 0; i < RW; i += 2)
      *reinterpret_cast<float2 *>(out + i) = make_float2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < RW; ++i) out[i] = v[i];
  }
}

// Phase A, greedy: order key and match test of every active row against
// every candidate slot s < p_cur; a lane per slot, a warp's rows
// (r = warp + NW i) taken stage by stage so that their independent
// chains of operations overlap.
template <int S, int D, int Q>
__device__ __forceinline__ void build_greedy(Shared<S, D, Q> &sh,
                                             const Rows<D> &rw, unsigned act,
                                             int K, int m, int p_cur,
                                             float tag_thr, int use_val,
                                             int warp, int lane) {
  constexpr int NC = 32 * Q;
  constexpr int R = ROWS / NW;
  for (int s = lane; s < p_cur; s += 32) {
    float diff[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      diff[i] = tag_sq<D>(rw, min(warp + NW * i, K - 1), sh.mean, s);
#pragma unroll
    for (int i = 0; i < R; ++i) diff[i] = __fsqrt_rn(diff[i]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = warp + NW * i;
      const float cost =
          clamped_cost(diff[i], rw.val[min(r, K - 1)], use_val);
      float crow;
      if (S == LOCKSTEP) {  // pallas_group_lockstep.py: f32(tie * 1e-8) * s
        const float tie_coef = (float)((double)(2 * m - r) * 1e-8);
        crow = __fadd_rn(cost, __fmul_rn(tie_coef, (float)s));
      } else {              // pallas_group.py: ((2m - r) * s) * 1e-8
        crow = __fadd_rn(
            cost, __fmul_rn(__fmul_rn((float)(2 * m - r), (float)s), 1e-8f));
      }
      if (r < K && ((act >> r) & 1u)) {
        sh.s.ckey[r * NC + s] = order_key(crow);
        sh.s.okm[r * NC + s] = crow < BIG && diff[i] < tag_thr;
      }
    }
  }
}

// Phase A, LAP: the parent's 32 x 128 cost (column 0 for the entering
// row; dummy columns p_cur..2m-1 at BIG; a row at or below the detection
// threshold HUGE on real columns and 0 on dummies) and the distances.
template <int D, int Q>
__device__ __forceinline__ void build_lap(Shared<LAP, D, Q> &sh,
                                          const Rows<D> &rw, unsigned valid,
                                          int K, int m, int p_cur,
                                          int use_val, int warp, int lane) {
  constexpr int R = ROWS / NW;
  const int m2 = 2 * m;
  for (int s = lane; s < m2; s += 32) {
    const bool col_real = s < p_cur;
    float diff[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      diff[i] = tag_sq<D>(rw, min(warp + NW * i, K - 1), sh.mean,
                          s < m ? s : 0);
#pragma unroll
    for (int i = 0; i < R; ++i) diff[i] = __fsqrt_rn(diff[i]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = warp + NW * i;
      const float dn =
          s < m ? clamped_cost(diff[i], rw.val[min(r, K - 1)], use_val)
                : 0.0f;
      const float tie =
          __fmul_rn(__fmul_rn((float)(m2 - r), (float)s), 1e-8f);
      const float padded = __fadd_rn(dn, tie);
      const float block = col_real ? padded : BIG;
      if (r < K) {
        if (s < m) sh.s.diff[r * LANES + s] = diff[i];
        sh.s.cost[r * LANES + s + 1] =
            ((valid >> r) & 1u) ? block : (col_real ? HUGE_COST : 0.0f);
      }
    }
  }
}

// Phase A: for each row (a lane), the first slot of this warp's 16 whose
// key equals the row's first tag dimension, among the slots below lo
// (whose keys no allocation of this joint can change); -1 for none.
template <int S, int D, int Q>
__device__ __forceinline__ void stable_hits(Shared<S, D, Q> &sh,
                                            const Rows<D> &rw, int K, int lo,
                                            int warp, int lane) {
  if (lane >= K) return;
  const float key_r = rw.tag[lane * D];
  int h = -1;
#pragma unroll
  for (int i = HIT_SPAN - 1; i >= 0; --i) {
    const int s = warp * HIT_SPAN + i;
    if (s < lo && sh.key[s] == key_r) h = s;
  }
  sh.hit[warp][lane] = h;
}

// Phase B, greedy: the rows of `act` in order, each taking the cheapest
// unused candidate slot (slot = Q * lane + q, candidates s < p_cur): one
// __reduce_min_sync over the order keys, one ballot for the lowest lane
// at the minimum (the lane's own slots were reduced smallest slot first).
// The next row's keys are loaded before this row's reduction, and the
// winning lane only marks the row in a register (no branch, no store in
// the chain); the matched rows' slots are written after it.
template <int Q>
__device__ __forceinline__ void greedy_chain(const unsigned *ckey,
                                             const unsigned char *okm,
                                             unsigned act, int p_cur,
                                             int lane, int *col, int *match) {
  constexpr int NC = 32 * Q;
  const unsigned kmask = order_key(MASKED);
  unsigned cand = 0;  // bit q: slot Q * lane + q is an unused candidate
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (Q * lane + q < p_cur) cand |= 1u << q;
  const unsigned below = (1u << lane) - 1u;
  unsigned won[Q] = {};  // bit r: this lane's slot Q * lane + q took row r
  int r = __ffs(act) - 1;
  unsigned rest = act & (act - 1);
  unsigned k[Q], okb = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    k[q] = ckey[r * NC + Q * lane + q];
    okb |= (unsigned)okm[r * NC + Q * lane + q] << q;
  }
  for (;;) {
    const int rn = rest ? __ffs(rest) - 1 : -1;
    rest &= rest - 1;
    unsigned kn[Q], okn = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      kn[q] = rn >= 0 ? ckey[rn * NC + Q * lane + q] : 0u;
      okn |= (rn >= 0 ? (unsigned)okm[rn * NC + Q * lane + q] : 0u) << q;
    }
    unsigned best = (cand & 1u) ? k[0] : kmask;
    int qb = 0;
#pragma unroll
    for (int q = 1; q < Q; ++q) {
      const unsigned kq = ((cand >> q) & 1u) ? k[q] : kmask;
      if (kq < best) {
        best = kq;
        qb = q;
      }
    }
    const unsigned kmin = __reduce_min_sync(FULL, best);
    const bool low = best == kmin;
    const unsigned bal = __ballot_sync(FULL, low);
    const bool win = low && !(bal & below);
    const unsigned bit = 1u << qb;
    const bool matched = win && (cand & okb & bit);
    cand = matched ? cand & ~bit : cand;
#pragma unroll
    for (int q = 0; q < Q; ++q)
      won[q] |= (unsigned)(matched && qb == q) << r;
    if (rn < 0) break;
    r = rn;
#pragma unroll
    for (int q = 0; q < Q; ++q) k[q] = kn[q];
    okb = okn;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q)
    for (unsigned w = won[q]; w; w &= w - 1) {
      col[__ffs(w) - 1] = Q * lane + q;
      match[__ffs(w) - 1] = 1;
    }
}

// Phase B, LAP: lapcore::lap_warp<QL> (QL columns a lane) on the joint's
// cost (column 0 for the entering row, stride LANES), then col[r] = the
// slot of row r (0 for a row left out).
template <int QL>
__device__ __forceinline__ bool lap_columns(const float *cost, int *col,
                                            int n_rows, int m2, int lane) {
  int p[QL];
  const bool ok = lapcore::lap_warp<QL>(cost, LANES, n_rows, m2, lane, p);
  col[lane] = 0;  // ROWS == 32: one row per lane
  __syncwarp();
#pragma unroll
  for (int q = 0; q < QL; ++q) {
    const int l = QL * lane + q;
    if (l >= 1 && l <= m2 && p[q] >= 1) col[p[q] - 1] = l - 1;
  }
  __syncwarp();
  return ok;
}

// Phase B: the slot each row writes, handed to the slots as row masks,
// and the people count after the joint.  Lane r is row r.  A matched row
// writes its column; a new row its stable key match.  The rest (the
// walkers) need the slots this joint allocates, in row order:
//   - no allocation can saturate (walkers <= p_max - npv): each walker
//     merges onto the first walker with its key (__match_any_sync on the
//     key's bits, -0 as +0, a NaN matching no one), else takes the next
//     fresh slot, npv + its rank among the allocating walkers;
//   - saturated (npv == p_max): every walker lands on slot p_max - 1,
//     whose key is then the previous walker's (the slot's own for the
//     first), and allocates unless its key equals that one;
//   - the joint that saturates: the walkers in order over the slots it
//     allocates (lane i holds slot lo + i; at most 32), one ballot each.
template <int S, int D, int Q>
__device__ __forceinline__ void decide(Shared<S, D, Q> &sh, const Rows<D> &rw,
                                       unsigned act, bool matched, int col,
                                       int K, int npv, int lo, int p_max,
                                       int lane) {
  const bool is_new = ((act >> lane) & 1u) && !matched;
  int h0 = -1;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int h = sh.hit[w][lane];
    if (h0 < 0) h0 = h;
  }
  const float key_r = lane < K ? rw.tag[lane * D] : 0.0f;
  int slot = matched ? min(max(col, 0), p_max - 1) : h0;
  bool alloc = false;
  const unsigned walk = __ballot_sync(FULL, lane < K && is_new && h0 < 0);
  const bool walker = (walk >> lane) & 1u;
  const unsigned below = (1u << lane) - 1u;
  if (walk == 0u) {
  } else if (__popc(walk) <= p_max - npv) {
    const unsigned kb = __float_as_uint(key_r);
    const unsigned long long v =
        walker && key_r == key_r ? (unsigned long long)((kb << 1) ? kb : 0u)
                                 : (1ull << 32) | lane;
    const int leader = __ffs(__match_any_sync(FULL, v)) - 1;
    const unsigned leads = __ballot_sync(FULL, walker && leader == lane);
    if (walker) {
      slot = npv + __popc(leads & ((1u << leader) - 1u));
      alloc = leader == lane;
    }
    npv += __popc(leads);
  } else if (npv == p_max) {
    const unsigned prev = walk & below;
    const float kprev = __shfl_sync(FULL, key_r, prev ? 31 - __clz(prev) : 0);
    const float k0 = sh.key[p_max - 1];
    if (walker) {
      slot = p_max - 1;
      alloc = !((prev ? kprev : k0) == key_r);
    }
  } else {
    float dkey = 0.0f;  // npv < p_max: lo == npv, nothing allocated yet
    for (unsigned w = walk; w; w &= w - 1) {
      const int r = __ffs(w) - 1;
      const float kr = __shfl_sync(FULL, key_r, r);
      const unsigned hitb =
          __ballot_sync(FULL, lane < npv - lo && dkey == kr);
      int s_r;
      if (hitb) {
        s_r = lo + __ffs(hitb) - 1;
      } else {
        s_r = min(npv, p_max - 1);
        if (lane == s_r - lo) dkey = kr;
        npv = min(npv + 1, p_max);
      }
      if (lane == r) {
        slot = s_r;
        alloc = hitb == 0u;
      }
    }
  }
  // each slot's rows, written by the lowest of them (the slots' masks
  // were cleared by their threads)
  const bool writer = lane < K && (matched || is_new);
  const unsigned grp = __match_any_sync(FULL, writer ? slot : -1 - lane);
  const unsigned reset_rows = __ballot_sync(FULL, writer && !matched);
  const unsigned alloc_rows = __ballot_sync(FULL, alloc);
  if (writer && lane == __ffs(grp) - 1) {
    sh.writes[slot] = grp;
    sh.resets[slot] = grp & reset_rows;
    sh.allocs[slot] = grp & alloc_rows;
  }
  if (lane == 0) sh.npv = npv;
}

// The whole grouping of image blockIdx.x (see the header comment).
template <int S, int D, int Q>
__device__ __forceinline__ void group_image(
    const float *__restrict__ tag, const float *__restrict__ loc,
    const float *__restrict__ val, int J, int K, int m, int p_max,
    float det_thr, float tag_thr, int use_val, int ignore_too_much,
    float *__restrict__ people, int *__restrict__ n_people) {
  __shared__ Shared<S, D, Q> sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  constexpr int RW = 3 + D;

  // slot tid's state (tid < SLOTS)
  float tsum[D], tcnt = 0.0f, key = CUDART_INF_F;
#pragma unroll
  for (int d = 0; d < D; ++d) tsum[d] = 0.0f;
  if (tid < SLOTS) {
#pragma unroll
    for (int d = 0; d < D; ++d) sh.mean[d][tid] = 0.0f;
    sh.key[tid] = CUDART_INF_F;
    sh.writes[tid] = sh.resets[tid] = sh.allocs[tid] = 0u;
  }
  if (tid == 0) sh.npv = 0;
  bool ok = true;  // warp 0: every LAP solve found its columns
  load_rows<D>(sh.rows[0], tag, loc, val, (long long)b * J * K, K, tid);
  cp_async_wait_all();
  __syncthreads();

  for (int j = 0; j < J; ++j) {
    const Rows<D> &rw = sh.rows[j & 1];
    if (j + 1 < J)
      load_rows<D>(sh.rows[(j + 1) & 1], tag, loc, val,
                   ((long long)b * J + j + 1) * K, K, tid);
    const int npv = sh.npv;
    const int p_cur = min(npv, m);
    const bool skip_all = ignore_too_much && p_cur == m;
    const int lo = min(npv, p_max - 1);
    const unsigned valid = __ballot_sync(FULL, lane < K && rw.val[lane] > det_thr);
    const unsigned act = skip_all ? 0u : valid;  // rows that take part
    const bool solve = p_cur > 0 && act != 0u;

    // ---- A: costs and stable key matches
    stable_hits<S, D, Q>(sh, rw, K, lo, warp, lane);
    if (solve) {
      if constexpr (S == LAP)
        build_lap<D, Q>(sh, rw, valid, K, m, p_cur, use_val, warp, lane);
      else
        build_greedy<S, D, Q>(sh, rw, act, K, m, p_cur, tag_thr, use_val,
                              warp, lane);
    }
    __syncthreads();

    // ---- B: assignment and slot decisions (warp 0)
    if (warp == 0) {
      int col = 0;
      bool matched = false;
      if constexpr (S == LAP) {
        // rows up to the last valid detection; none when there is no one
        // to match or the joint is skipped
        const int n_rows = solve ? 32 - __clz(valid) : 0;
        ok = (lapcore::lanes_q(2 * m) == 2
                  ? lap_columns<2>(sh.s.cost, sh.col, n_rows, 2 * m, lane)
                  : lap_columns<4>(sh.s.cost, sh.col, n_rows, 2 * m,
                                   lane)) &&
             ok;
        col = sh.col[lane];
        const float d_at = sh.s.diff[lane * LANES + min(max(col, 0), m - 1)];
        matched = ((act >> lane) & 1u) && col < p_cur && d_at < tag_thr;
      } else {
        sh.match[lane] = 0;
        __syncwarp();
        if (solve)
          greedy_chain<Q>(sh.s.ckey, sh.s.okm, act, p_cur, lane, sh.col,
                          sh.match);
        __syncwarp();
        col = sh.col[lane];
        matched = sh.match[lane] != 0;
      }
      decide<S, D, Q>(sh, rw, act, matched, col, K, npv, lo, p_max, lane);
    }
    __syncthreads();

    // ---- C: slot tid applies its rows in order, writes its people row
    // and its mean for the next joint
    if (tid < p_max) {
      unsigned mine = sh.writes[tid];
      const unsigned resets = sh.resets[tid], allocs = sh.allocs[tid];
      sh.writes[tid] = sh.resets[tid] = sh.allocs[tid] = 0u;
      const int win = 31 - __clz(mine);  // the last writer; -1 for none
      if (allocs) key = rw.tag[(31 - __clz(allocs)) * D];
      if (resets) {  // the rows before the last reset leave no trace
        const int r0 = 31 - __clz(resets);
#pragma unroll
        for (int d = 0; d < D; ++d) tsum[d] = rw.tag[r0 * D + d];
        tcnt = 1.0f;
        mine &= ~((2u << r0) - 1u);
      }
      for (; mine; mine &= mine - 1) {  // then matched rows, in order
        const float *t = rw.tag + (__ffs(mine) - 1) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) tsum[d] = __fadd_rn(tsum[d], t[d]);
        tcnt = __fadd_rn(tcnt, 1.0f);
      }
      const bool w = win >= 0;
      const int src = w ? win : 0;
      float row[RW];
      row[0] = w ? rw.xy[2 * src] : 0.0f;
      row[1] = w ? rw.xy[2 * src + 1] : 0.0f;
      row[2] = w ? rw.val[src] : 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) row[3 + d] = w ? rw.tag[src * D + d] : 0.0f;
      store_row<RW>(people + (((long long)b * p_max + tid) * J + j) * RW, row);
      const float cnt = fmaxf(tcnt, 1.0f);
#pragma unroll
      for (int d = 0; d < D; ++d) sh.mean[d][tid] = __fdiv_rn(tsum[d], cnt);
      sh.key[tid] = key;
    }
    cp_async_wait_all();
    __syncthreads();
  }
  // a solve that found no free column (non-finite input) marks the image
  if (tid == 0) n_people[b] = ok ? sh.npv : -1;
}

// The launch arguments of both entry points.
struct Args {
  const float *tag, *loc, *val;
  int B, J, K, D, m, p_max;
  float det_thr, tag_thr;
  int use_val, ignore_too_much;
  float *people;
  int *n_people;
};

// Launches KERNEL<..., D, Q> for the runtime D (1..DMAX) through
// LAUNCH(D, Q); Q from the candidate count min(m, p_max), at most QMAX.
template <int QMAX, typename Launch>
cudaError_t dispatch(const Args &a, Launch launch) {
  const int ncand = min(a.m, a.p_max);
  auto by_d = [&](auto q) {
    switch (a.D) {
      case 1: launch(std::integral_constant<int, 1>{}, q); break;
      case 2: launch(std::integral_constant<int, 2>{}, q); break;
      case 3: launch(std::integral_constant<int, 3>{}, q); break;
      case 4: launch(std::integral_constant<int, 4>{}, q); break;
      case 5: launch(std::integral_constant<int, 5>{}, q); break;
      case 6: launch(std::integral_constant<int, 6>{}, q); break;
      case 7: launch(std::integral_constant<int, 7>{}, q); break;
      default: launch(std::integral_constant<int, 8>{}, q); break;
    }
  };
  if (QMAX == 1 || ncand <= 32) {
    by_d(std::integral_constant<int, 1>{});
  } else if constexpr (QMAX >= 2) {
    if (QMAX == 2 || ncand <= 64)
      by_d(std::integral_constant<int, 2>{});
    else if constexpr (QMAX >= 4)
      by_d(std::integral_constant<int, 4>{});
  }
  return cudaGetLastError();
}

}  // namespace groupcore
