// Dense-workspace scatter-add: the keyed merge of SAM's n>=1 reducer.
//
// Replaces repro/kernels/scatter_workspace.py::scatter_workspace, which on
// the TPU is a one-hot (S, T) x (T, C) MXU product accumulated in a
// VMEM-resident workspace (and so limited to a few thousand slots). Here the
// workspace lives in device memory and each row adds itself into its slot
// with atomicAdd, so any slot count fits.
//
//   out[s, c] = sum over rows i with ids[i] == s of cols[i, c]
//
// mul_pair mode reads cols as [a, b, hit] and accumulates [a*b, 1] where
// hit > 0 and nothing elsewhere: the mask is applied BEFORE the product, so
// inf/nan garbage at masked rows never reaches the sums.
//
// Ids outside [0, num_slots) -- in particular the padding slot num_slots,
// which the reference accumulates and then drops -- are skipped, which also
// spares the atomics that every padding row would aim at one address.
//
// Bound: memory. Each row reads its id and C payload words and issues C
// atomics into a workspace of num_slots * C words; the lower bound is those
// bytes over the card's bandwidth. Atomics on a hot slot serialize in L2.
#include "common.cuh"

namespace {

template <typename T>
__global__ void scatter_workspace_kernel(const int* __restrict__ ids,
                                         const T* __restrict__ cols,
                                         T* __restrict__ ws, long long n,
                                         int c, int num_slots) {
  for (long long i = sam::global_tid(); i < n; i += sam::grid_stride()) {
    const int s = ids[i];
    if (s < 0 || s >= num_slots) continue;
    const T* row = cols + i * c;
    T* dst = ws + static_cast<long long>(s) * c;
    for (int j = 0; j < c; ++j) atomicAdd(dst + j, row[j]);
  }
}

template <typename T>
__global__ void scatter_workspace_mul_pair_kernel(const int* __restrict__ ids,
                                                  const T* __restrict__ cols,
                                                  T* __restrict__ ws,
                                                  long long n, int num_slots) {
  for (long long i = sam::global_tid(); i < n; i += sam::grid_stride()) {
    const int s = ids[i];
    if (s < 0 || s >= num_slots) continue;
    const T* row = cols + i * 3;
    if (!(row[2] > T(0))) continue;  // masked row: adds [0, 0]
    T* dst = ws + 2LL * s;
    atomicAdd(dst, row[0] * row[1]);
    atomicAdd(dst + 1, T(1));
  }
}

template <typename T>
int launch(const int* ids, const T* cols, T* ws, long long n, int c,
           int num_slots, int mul_pair, cudaStream_t stream) {
  if (n > 0) {
    const int grid = sam::grid_for(n);
    if (mul_pair) {
      scatter_workspace_mul_pair_kernel<T><<<grid, sam::kThreads, 0, stream>>>(
          ids, cols, ws, n, num_slots);
    } else {
      scatter_workspace_kernel<T><<<grid, sam::kThreads, 0, stream>>>(
          ids, cols, ws, n, c, num_slots);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sam_scatter_workspace_f32(const int* ids, const float* cols,
                                         float* ws, long long n, int c,
                                         int num_slots, int mul_pair,
                                         void* stream) {
  return launch<float>(ids, cols, ws, n, c, num_slots, mul_pair,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int sam_scatter_workspace_f64(const int* ids, const double* cols,
                                         double* ws, long long n, int c,
                                         int num_slots, int mul_pair,
                                         void* stream) {
  return launch<double>(ids, cols, ws, n, c, num_slots, mul_pair,
                        static_cast<cudaStream_t>(stream));
}
