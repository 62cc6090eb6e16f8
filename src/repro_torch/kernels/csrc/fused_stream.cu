// Fused sorted intersection x gather x multiply x workspace reduce: the
// Gustavson inner loop in one pass.
//
// Replaces repro/kernels/fused_stream.py::fused_imr_workspace. The TPU
// kernel has no vector gather, so it probes with a (T, NB) membership matrix
// against the whole b stream held in VMEM. Here the streams are merged tile
// by tile:
//
//   1. each CTA takes a contiguous tile of kTile elements of a, loaded
//      coalesced into shared memory; a block reduction finds the tile's
//      smallest and largest valid key, and a tile without one exits;
//   2. two warps find the window of b that can match the tile, one
//      lower-bound search each, 32 probes a step (four steps for 2^20 keys);
//   3. a window of up to kStage keys is staged in shared memory with
//      cp.async; a longer one (a sparse tile over a dense b) is searched in
//      place in device memory, inside the window only;
//   4. each thread takes a contiguous run of kRun elements of the tile and
//      walks it forward through the window as a merge, galloping from where
//      its previous key landed, so a run costs one short search and b is
//      read about once overall; a run whose keys step backwards (a is not
//      ascending there) searches the window again, so no order is assumed
//      beyond b's;
//   5. each hit reads its a value, output key and b value from device
//      memory and adds [a*b, 1] into workspace slot out_key with atomicAdd.
//
// Keys are int64, so no key is narrowed.
//
// Contract (the wrapper establishes it): a rows that are invalid hold
// PAD = INT64_MAX and may sit anywhere; b keys are sorted ascending with
// invalid rows PAD at the end; out_key lies in [0, num_slots) wherever a
// matches.
//
// Bound: memory. a's keys are read once, coalesced; its values and output
// keys, and b's values, only at hits; b's keys about once; the (num_slots,
// 2) workspace is written by the hits' atomics.
#include <climits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kRun = 8;                     // elements of a a thread
constexpr int kTile = kBlock * kRun;        // elements of a a CTA
constexpr int kStage = 1024;                // b keys staged in shared memory
constexpr unsigned kFull = 0xffffffffu;

// the tile in shared memory with one pad slot every kRun keys, so the
// threads of a warp reading the j-th key of their runs hit distinct banks
__host__ __device__ constexpr int tile_slot(int e) { return e + e / kRun; }

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   sam::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// First position of b[0, n) whose key is >= k, found by one warp: each
// step probes 32 evenly spaced positions and keeps the gap between the
// last probe below k and the first at or above it. Every lane returns it.
__device__ long long warp_lower_bound(const long long* __restrict__ b,
                                      long long n, long long k) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long stride = (hi - lo + 31) / 32;
    const long long p = lo + lane * stride;
    const int below = __popc(__ballot_sync(kFull, p < hi && b[p] < k));
    if (below == 0) break;                       // b[lo] >= k
    const long long next_hi = lo + below * stride;
    lo += (below - 1) * stride + 1;
    hi = min(hi, next_hi);
  }
  return lo;
}

// First position of w[pos, n) whose key is >= k, given that every key
// before pos is below k: steps of 1, 2, 4, ... from pos, then a binary
// search inside the last step.
__device__ __forceinline__ long long gallop(const long long* w, long long pos,
                                            long long n, long long k) {
  long long lo = pos, hi = pos, step = 1;
  while (hi < n && w[hi] < k) {
    lo = hi + 1;
    hi += step;
    step <<= 1;
  }
  if (hi > n) hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (w[mid] < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One thread's run of the tile merged through the window w[0, n), which
// starts at b[w0].
template <typename T>
__device__ __forceinline__ void merge_run(
    const long long* w, long long n, long long w0, const long long* tile,
    long long base, const T* __restrict__ a_vals,
    const long long* __restrict__ out_key, const T* __restrict__ b_vals,
    T* __restrict__ ws) {
  long long pos = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int e = threadIdx.x * kRun + j;
    const long long k = tile[tile_slot(e)];
    if (k == LLONG_MAX) continue;                // padding, or past na
    if (pos > 0 && w[pos - 1] >= k) pos = 0;     // the run stepped back
    pos = gallop(w, pos, n, k);
    if (pos < n && w[pos] == k) {
      const long long i = base + e;
      T* dst = ws + 2 * out_key[i];
      atomicAdd(dst, a_vals[i] * b_vals[w0 + pos]);
      atomicAdd(dst + 1, T(1));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock) fused_imr_kernel(
    const long long* __restrict__ a_key, const T* __restrict__ a_vals,
    const long long* __restrict__ out_key,
    const long long* __restrict__ b_key, const T* __restrict__ b_vals,
    T* __restrict__ ws, long long na, long long nb) {
  __shared__ long long tile[tile_slot(kTile)];
  __shared__ long long stage[kStage];
  __shared__ long long warp_min[kBlock / 32], warp_max[kBlock / 32];
  __shared__ long long window[2];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // 1. the tile, coalesced, and its smallest and largest valid key
  long long kmin = LLONG_MAX, kmax = LLONG_MIN;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int e = threadIdx.x + j * kBlock;
    const long long k = base + e < na ? a_key[base + e] : LLONG_MAX;
    tile[tile_slot(e)] = k;
    if (k != LLONG_MAX) {
      kmin = min(kmin, k);
      kmax = max(kmax, k);
    }
  }
  for (int off = 16; off; off >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(kFull, kmin, off));
    kmax = max(kmax, __shfl_xor_sync(kFull, kmax, off));
  }
  if (lane == 0) {
    warp_min[warp] = kmin;
    warp_max[warp] = kmax;
  }
  __syncthreads();

  // 2. the window [lower_bound(min), lower_bound(max + 1)) of b
  if (warp < 2) {
    kmin = lane < kBlock / 32 ? warp_min[lane] : LLONG_MAX;
    kmax = lane < kBlock / 32 ? warp_max[lane] : LLONG_MIN;
    for (int off = 16; off; off >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(kFull, kmin, off));
      kmax = max(kmax, __shfl_xor_sync(kFull, kmax, off));
    }
    long long bound = 0;                         // no valid key: empty
    if (kmin != LLONG_MAX)
      bound = warp_lower_bound(b_key, nb, warp == 0 ? kmin : kmax + 1);
    if (lane == 0) window[warp] = bound;
  }
  __syncthreads();
  const long long w0 = window[0], n = window[1] - window[0];
  if (n <= 0) return;                            // the whole CTA leaves

  // 3.-5. the window staged, or searched in place when it is too long
  if (n <= kStage) {
    for (int e = threadIdx.x; e < n; e += kBlock)
      cp_async8(&stage[e], b_key + w0 + e);
    sam::cp_async_commit();
    sam::cp_async_wait<0>();
    __syncthreads();
    merge_run(stage, n, w0, tile, base, a_vals, out_key, b_vals, ws);
  } else {
    merge_run(b_key + w0, n, w0, tile, base, a_vals, out_key, b_vals, ws);
  }
}

template <typename T>
int launch(const long long* a_key, const T* a_vals, const long long* out_key,
           const long long* b_key, const T* b_vals, T* ws, long long na,
           long long nb, cudaStream_t stream) {
  if (na > 0 && nb > 0) {
    const long long tiles = (na + kTile - 1) / kTile;
    fused_imr_kernel<T><<<static_cast<unsigned>(tiles), kBlock, 0,
                          stream>>>(a_key, a_vals, out_key, b_key, b_vals, ws,
                                    na, nb);
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
