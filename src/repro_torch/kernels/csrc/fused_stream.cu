// Fused sorted intersection x gather x multiply x workspace reduce: the
// Gustavson inner loop in one pass.
//
// Replaces repro/kernels/fused_stream.py::fused_imr_workspace. The TPU
// kernel has no vector gather, so it probes with a (T, NB) membership matrix
// against the whole b stream held in VMEM. Here one thread per element of a
// binary-searches the sorted b keys in device memory (O(log NB) loads, most
// of them L2 hits for the upper levels of the search), gathers b's value,
// multiplies, and adds [a*b, 1] into the workspace slot out_key with
// atomicAdd. Keys are int64, so no key is narrowed.
//
// Contract (the wrapper establishes it): a rows that are invalid hold
// PAD = INT64_MAX; b keys are sorted ascending with invalid rows PAD at the
// end; out_key lies in [0, num_slots) wherever a matches.
//
// Bound: memory. a's keys, values and out_keys are read once, b's keys and
// values at least once, and the (num_slots, 2) workspace written; the search
// adds log2(NB) dependent loads per element of a, which L2 mostly serves.
#include <climits>

#include "common.cuh"

namespace {

template <typename T>
__global__ void fused_imr_kernel(const long long* __restrict__ a_key,
                                 const T* __restrict__ a_vals,
                                 const long long* __restrict__ out_key,
                                 const long long* __restrict__ b_key,
                                 const T* __restrict__ b_vals,
                                 T* __restrict__ ws, long long na,
                                 long long nb) {
  for (long long i = sam::global_tid(); i < na; i += sam::grid_stride()) {
    const long long k = a_key[i];
    if (k == LLONG_MAX) continue;
    long long lo = 0, hi = nb;
    while (lo < hi) {
      const long long mid = lo + ((hi - lo) >> 1);
      if (b_key[mid] < k) lo = mid + 1; else hi = mid;
    }
    if (lo == nb || b_key[lo] != k) continue;
    T* dst = ws + 2LL * out_key[i];
    atomicAdd(dst, a_vals[i] * b_vals[lo]);
    atomicAdd(dst + 1, T(1));
  }
}

template <typename T>
int launch(const long long* a_key, const T* a_vals, const long long* out_key,
           const long long* b_key, const T* b_vals, T* ws, long long na,
           long long nb, cudaStream_t stream) {
  if (na > 0 && nb > 0) {
    fused_imr_kernel<T><<<sam::grid_for(na), sam::kThreads, 0, stream>>>(
        a_key, a_vals, out_key, b_key, b_vals, ws, na, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sam_fused_imr_f32(const long long* a_key, const float* a_vals,
                                 const long long* out_key,
                                 const long long* b_key, const float* b_vals,
                                 float* ws, long long na, long long nb,
                                 void* stream) {
  return launch<float>(a_key, a_vals, out_key, b_key, b_vals, ws, na, nb,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int sam_fused_imr_f64(const long long* a_key, const double* a_vals,
                                 const long long* out_key,
                                 const long long* b_key, const double* b_vals,
                                 double* ws, long long na, long long nb,
                                 void* stream) {
  return launch<double>(a_key, a_vals, out_key, b_key, b_vals, ws, na, nb,
                        static_cast<cudaStream_t>(stream));
}
