// Keyed segment sum: the inner sum of SAM's sort-merge reducer.
//
// Replaces repro/kernels/segment_reduce.py::segment_reduce, which on the TPU
// is a one-hot (S, T) x (T, D) MXU product with an (S+1, 128) accumulator
// resident in VMEM. Here the (S, D) output lives in device memory and the
// rows add themselves into their segments with atomicAdd, so any S fits.
//
//   out[s, d] = sum over rows i with ids[i] == s of vals[i, d]
//
// Ids outside [0, S) (the reference's padding id S) are dropped.
//
// Bound: memory. Every element of vals and every id is read once and every
// output word is written; the lower bound is those bytes over the card's
// bandwidth. Atomics on one address serialize in L2, so callers drop their
// padding rows (id S) instead of aiming them at one live segment.
#include "common.cuh"

namespace {

template <typename T>
__global__ void segment_reduce_kernel(const int* __restrict__ ids,
                                      const T* __restrict__ vals,
                                      T* __restrict__ out, long long n, int d,
                                      int num_segments) {
  const long long total = n * d;
  for (long long e = sam::global_tid(); e < total; e += sam::grid_stride()) {
    const long long row = e / d;
    const int s = ids[row];
    if (s < 0 || s >= num_segments) continue;
    atomicAdd(out + static_cast<long long>(s) * d + (e - row * d), vals[e]);
  }
}

template <typename T>
int launch(const int* ids, const T* vals, T* out, long long n, int d,
           int num_segments, cudaStream_t stream) {
  if (n > 0 && d > 0) {
    segment_reduce_kernel<T><<<sam::grid_for(n * d), sam::kThreads, 0,
                               stream>>>(ids, vals, out, n, d, num_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sam_segment_reduce_f32(const int* ids, const float* vals,
                                      float* out, long long n, int d,
                                      int num_segments, void* stream) {
  return launch<float>(ids, vals, out, n, d, num_segments,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int sam_segment_reduce_f64(const int* ids, const double* vals,
                                      double* out, long long n, int d,
                                      int num_segments, void* stream) {
  return launch<double>(ids, vals, out, n, d, num_segments,
                        static_cast<cudaStream_t>(stream));
}
