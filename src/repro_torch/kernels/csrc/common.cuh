// Shared pieces of the port's CUDA kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kThreads = 256;  // threads per CUDA block in every kernel

// Sum of `v` over the CUDA block (kThreads threads): warp shuffles, then
// one pass of warp 0 over the per-warp partials.  The result is valid in
// thread 0 only.  At most one call per kernel (one static shared array).
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

}  // namespace repro_torch
