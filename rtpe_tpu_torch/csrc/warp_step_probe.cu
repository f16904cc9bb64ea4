// A measuring probe, not a port of a TPU kernel: one warp runs a chain of
// dependent (__reduce_min_sync, __ballot_sync) steps, the least a greedy
// grouping row's argmin costs on the card, and reports the chain's SM
// cycles and nanoseconds.  chip_smoke.py prices the grouping kernels'
// latency bound with it (group_core.cuh: one such step per greedy row,
// and per row of the update; per Dijkstra step of a LAP).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(32)
warp_step_probe_kernel(int steps, long long *out) {
  const unsigned lane = threadIdx.x;
  unsigned v = 0x9e3779b9u * (lane + 1u);
  __syncwarp();
  const long long c0 = clock64();
  const unsigned long long g0 = global_ns();
#pragma unroll 4
  for (int i = 0; i < steps; ++i) {
    const unsigned kmin = __reduce_min_sync(0xffffffffu, v);
    v ^= __ballot_sync(0xffffffffu, v == kmin);  // the next step waits
  }
  const unsigned long long g1 = global_ns();
  const long long c1 = clock64();
  if (lane == 0) {
    out[0] = c1 - c0;
    out[1] = (long long)(g1 - g0);
    out[2] = v;  // keeps the chain
  }
}

}  // namespace

// out: cycles, nanoseconds and the chain's last value (3 int64).
extern "C" int warp_step_probe_launch(int steps, long long *out,
                                      void *stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  warp_step_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(steps, out);
  return (int)cudaGetLastError();
}
