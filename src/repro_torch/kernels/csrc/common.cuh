// Shared launch helpers for the SAM reduce kernels (plain C interface,
// loaded from Python with ctypes; see kernels/_build.py).
#pragma once
#include <cuda_runtime.h>

namespace sam {

constexpr int kThreads = 256;

// Grid for a grid-stride loop over n items: enough blocks to cover n, capped
// so very long streams reuse resident blocks instead of queueing millions.
inline int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1LL << 16)) blocks = 1LL << 16;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

__device__ __forceinline__ long long global_tid() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

}  // namespace sam
