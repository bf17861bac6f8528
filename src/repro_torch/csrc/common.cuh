// Shared helpers for the port's CUDA kernels: a fixed-order block sum.
//
// Every cross-thread sum in these kernels goes through block_sum, whose
// shuffle tree and warp order depend only on blockDim, so a block's partial
// is the same bits on every run; the wrappers then sum the per-block
// partials in a fixed order.  No float atomics touch a partial.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spade {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over a block of NW warps; the result is valid in thread 0 only.
// `scratch` holds NW floats of shared memory.
template <int NW>
__device__ __forceinline__ float block_sum_of(float v, float* scratch) {
  static_assert(NW <= 32, "one warp sums the warps' partials");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) {
    t = lane < NW ? scratch[lane] : 0.f;
    t = warp_sum(t);
  }
  __syncthreads();  // scratch may be reused by the next call
  return t;
}

// Sum of v over a block of kThreads; valid in thread 0 only.  `scratch`
// holds kWarps floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  return block_sum_of<kWarps>(v, scratch);
}

}  // namespace spade
