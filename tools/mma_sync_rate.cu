// Throughput probe of the warp-level tensor-core products the port's
// block-sparse kernels use (mma.sync m16n8k8 TF32, m16n8k16 bf16): every
// warp runs CHAINS independent accumulators through ITERS products, so the
// rate is the tensor pipe's, not a dependency chain's. Built and driven by
// tools/mma_sync_rate.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../src/repro_torch/kernels/csrc/tensor_core.cuh"

template <bool kTf32, int kChains>
__global__ void probe(float* out, int iters) {
  float acc[kChains][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7 + i;
  for (int i = 0; i < 2; ++i) b[i] = threadIdx.x * 3 + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (kTf32) sam::mma_tf32(acc[c], a, b);
      else sam::mma_bf16(acc[c], a, b);
    }
  }
  float s = 0.f;
  for (int c = 0; c < kChains; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_probe(int tf32, int blocks, int threads, int iters,
                         float* out) {
  if (tf32) probe<true, 16><<<blocks, threads>>>(out, iters);
  else probe<false, 16><<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
