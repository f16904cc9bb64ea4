// Rectangular linear assignment (minimum total cost, every row gets a
// distinct column) for a batch of cost matrices, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel rtpe_tpu/ops/pallas_lap.py:_lap_kernel
// (hungarian_rect_pallas).  The JAX function solves one (n, m) matrix
// and the grouping vmaps it over images; here one launch solves every
// matrix of a (B, n, m) batch: the grouping's one joint for all images.
//
// Design.  One warp per matrix (one block each).  The matrix is staged in
// shared memory with a row stride of m + 1, so that cost column c sits at
// index c + 1 and index 0 is the successive-shortest-path's entering
// column (n <= 32, m <= 127: at most 16 KB).  The solve is
// lapcore::lap_warp<Q> (lap_core.cuh): Q contiguous columns a lane, Q = 2
// up to m = 63 (the decode's 60 columns) and 4 up to 127, chosen at
// launch; each Dijkstra step's argmin is one __reduce_min_sync on an
// order key, one ballot, and shuffles from the owning lane.  The kernel
// then writes the column of each row (rows are all assigned: n <= m).
// Rows of a matrix whose costs are not finite and below 1e18 get column
// -1.
//
// Bound: latency.  Each row insertion is a chain of dependent warp
// reductions (one per visited column, plus the augmenting walk); the
// bytes (the matrix once, n columns back) take well under a microsecond.

#include <cuda_runtime.h>

#include "lap_core.cuh"

namespace {

template <int Q>
__global__ void __launch_bounds__(32)
lap_rect_kernel(const float *__restrict__ cost, int n, int m,
                int *__restrict__ col_of_row) {
  // n rows of stride m + 1, and 32 Q more floats: every lane loads all
  // of its columns of the last row
  extern __shared__ float cost_s[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int stride = m + 1;
  const float *src = cost + (long long)b * n * m;
  for (int r = 0; r < n; ++r)
    for (int c = lane; c < m; c += 32)
      cost_s[r * stride + c + 1] = src[r * m + c];
  __syncwarp();
  int p[Q];
  const bool ok = lapcore::lap_warp<Q>(cost_s, stride, n, m, lane, p);
  int *out = col_of_row + (long long)b * n;
  for (int r = lane; r < n; r += 32) out[r] = ok ? 0 : -1;
  __syncwarp();
  if (!ok) return;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int l = Q * lane + q;
    if (l >= 1 && l <= m && p[q] >= 1) out[p[q] - 1] = l - 1;
  }
}

}  // namespace

extern "C" int lap_rect_launch(const float *cost, int B, int n, int m,
                               int *col_of_row, void *stream) {
  if (B < 1 || n < 1 || n > 32 || m < n || m > 127)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)n * (m + 1) + 128) * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  if (lapcore::lanes_q(m) == 2)
    lap_rect_kernel<2><<<B, 32, smem, s>>>(cost, n, m, col_of_row);
  else
    lap_rect_kernel<4><<<B, 32, smem, s>>>(cost, n, m, col_of_row);
  return (int)cudaGetLastError();
}
