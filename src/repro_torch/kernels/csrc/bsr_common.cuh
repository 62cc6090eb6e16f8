// Shared helpers of the block-sparse kernels (spmm_bsr, sddmm_bsr,
// bsr_attention): element conversion for float32 and bfloat16 operands,
// which every kernel accumulates in float32, and short vector loads from
// shared memory.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sam {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as PyTorch's cast
}

// Load N consecutive floats from shared memory; p is aligned to N floats
// for N = 2 and N = 4 (the callers pad their row strides to keep it so).
template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    dst[0] = t.x;
    dst[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = p[i];
  }
}

}  // namespace sam
