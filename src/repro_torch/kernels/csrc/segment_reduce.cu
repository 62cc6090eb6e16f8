// Keyed segment sum: the inner sum of SAM's sort-merge reducer, and the
// keyed reduce over a bounded key space.
//
// Replaces repro/kernels/segment_reduce.py::segment_reduce, which on the TPU
// is a one-hot (S, T) x (T, D) MXU product with an (S+1, 128) accumulator
// resident in VMEM. Here the (S, D) output lives in device memory and the
// rows add themselves into their segments with atomics, so any S fits.
//
//   out[s, d] = sum over rows i with ids[i] == s of vals[i, d]
//
// Ids outside [0, S) (the reference's padding id S) are dropped before the
// row's values are read. A second entry, the [a*b, 1] mode, reads the
// engine's int64 keys, two value streams and a validity mask directly and
// accumulates [a[i] * b[i], 1] (or [a[i], 1] without b) for a valid row
// whose key is in range: the product is formed only there, so garbage at
// masked rows never reaches the sums, and the caller stages no (N, 2) input
// and no int32 copy of the keys.
//
// Bound: memory. Every id (or key and mask) is read once, the values of the
// in-range rows once, and the output written once; what costs beyond that
// is the atomics, which L2 serves one address at a time. The design:
//   - a block takes 4096 consecutive rows (1024 for inputs under 4M rows;
//     under 256K rows, a row a thread and no tiles: a short input is
//     latency-bound) and finds the range of their live ids (each thread keeps its ids in
//     registers). Where it fits a 32 KB shared-memory accumulator, the
//     rows add there (shared atomics; a warp whose rows share one id adds
//     its sum once) and the block adds each touched segment to the output
//     once: sorted ids (the
//     sort-merge's inner sum) and blocks of nearby ids (an SpMM tile's
//     j-contiguous keys repeated under each k) issue one global atomic a
//     segment a tile instead of one a row;
//   - where the range is wider, a row a thread, D a template parameter for
//     1 and 2 (a loop over columns for any other D), no 64-bit division,
//     and warp aggregation: where a lane's id equals its neighbour's (a
//     run), the lanes that carry the same id are found with
//     __match_any_sync and summed with shuffles, and one lane issues the
//     atomic. A warp without a run skips the aggregation;
//   - float32 rows of D = 2 are one float2 load and one vector atomic
//     (atomicAdd on float2, red.global.add.v2.f32 on sm_90), half the
//     atomic instructions of two scalar ones; float64 keeps scalar atomics.
// The warp aggregation, the row atomics, the tile's id range and the
// general-width body are shared with scatter_workspace.cu
// (reduce_common.cuh).
#include "reduce_common.cuh"

namespace {

using sam::add_aggregated;
using sam::add_row;
using sam::kFull;
using sam::kSlots;
using sam::mul_rn;
using sam::warp_sum;

// The rows a kernel reads. id(i) is row i's segment, or -1 for a row that
// adds nothing (its values are then never read); load(i, x) reads its D
// values.
template <typename T, int D>
struct GeneralRows {
  const int* __restrict__ ids;
  const T* __restrict__ vals;
  __device__ __forceinline__ int id(long long i, int num_segments) const {
    const int s = ids[i];
    return s >= 0 && s < num_segments ? s : -1;
  }
  __device__ __forceinline__ void load(long long i, T* x) const {
    if constexpr (D == 2 && sizeof(T) == 4) {
      const float2 v = reinterpret_cast<const float2*>(vals)[i];
      x[0] = v.x;
      x[1] = v.y;
    } else {
      for (int c = 0; c < D; ++c) x[c] = vals[i * D + c];
    }
  }
};

// The [a*b, 1] mode: a valid row whose int64 key lies in [0, S) adds
// [a*b, 1] ([a, 1] when b is null).
template <typename T>
struct MulRows {
  const long long* __restrict__ keys;
  const T* __restrict__ a;
  const T* __restrict__ b;
  const unsigned char* __restrict__ valid;
  __device__ __forceinline__ int id(long long i, int num_segments) const {
    // both loads issued together: a key is read whatever its mask says
    const long long k = keys[i];
    const bool ok = valid[i] != 0;
    return ok && k >= 0 && k < num_segments ? static_cast<int>(k) : -1;
  }
  __device__ __forceinline__ void load(long long i, T* x) const {
    x[0] = b ? mul_rn(a[i], b[i]) : a[i];
    x[1] = T(1);
  }
};

// D = 1 or 2. A block walks tiles of kSteps * 256 consecutive rows (a
// thread keeps its kSteps ids in registers between two passes). It first
// finds the range of the tile's live ids; where the range fits kSlots, the
// rows add into shared memory (shared atomics; a warp whose 32 rows share
// one id adds its sum once), and the block then adds each touched segment
// to the output once. Rows sorted by id, or in blocks of nearby ids (a
// tile's products under a few outer coordinates), thus issue one global
// atomic a segment a tile. A tile whose ids spread wider adds a row a
// thread (add_aggregated). Every lane of a warp runs the same iterations
// (the aggregation needs the whole warp).
template <typename T, int D, int kSteps, class Rows>
__global__ void __launch_bounds__(sam::kThreads)
segment_reduce_tiles(Rows rows, T* __restrict__ out, long long n,
                     int num_segments) {
  constexpr int kTileRows = kSteps * sam::kThreads;
  __shared__ T acc[kSlots<T, D> * D];
  __shared__ int warp_lo[sam::kWarps], warp_hi[sam::kWarps];
  const int lane = threadIdx.x & 31;
  for (long long t0 = static_cast<long long>(blockIdx.x) * kTileRows; t0 < n;
       t0 += static_cast<long long>(gridDim.x) * kTileRows) {
    int sid[kSteps];
    int lo = 0x7fffffff, hi = -1;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const long long i = t0 + k * sam::kThreads + threadIdx.x;
      sid[k] = i < n ? rows.id(i, num_segments) : -1;
      if (sid[k] >= 0) {
        lo = min(lo, sid[k]);
        hi = max(hi, sid[k]);
      }
    }
    sam::tile_id_range(lo, hi, warp_lo, warp_hi);
    const int range = hi - lo + 1;      // block-uniform; <= 0: no live row
    if (range > 0 && range <= kSlots<T, D>) {
      for (int k = threadIdx.x; k < range * D; k += sam::kThreads) {
        acc[k] = T(0);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const long long i = t0 + k * sam::kThreads + threadIdx.x;
        const int s = sid[k];
        T x[D];
        if (s >= 0) {
          rows.load(i, x);
        } else {
          for (int c = 0; c < D; ++c) x[c] = T(0);
        }
        if (__all_sync(kFull, s == __shfl_sync(kFull, s, 0))) {
          // one id across the warp (a run): one shared atomic
          for (int c = 0; c < D; ++c) x[c] = warp_sum(x[c]);
          if (lane == 0 && s >= 0) {
            for (int c = 0; c < D; ++c) atomicAdd(acc + (s - lo) * D + c, x[c]);
          }
        } else if (s >= 0) {
          for (int c = 0; c < D; ++c) atomicAdd(acc + (s - lo) * D + c, x[c]);
        }
      }
      __syncthreads();
      // a segment whose sum is exactly 0 in every column adds nothing
      for (int k = threadIdx.x; k < range; k += sam::kThreads) {
        T x[D];
        bool touched = false;
        for (int c = 0; c < D; ++c) {
          x[c] = acc[k * D + c];
          touched |= x[c] != T(0);
        }
        if (touched) add_row<T, D>(out + static_cast<long long>(lo + k) * D, x);
      }
    } else if (range > 0) {
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const long long i = t0 + k * sam::kThreads + threadIdx.x;
        const int s = sid[k];
        T x[D];
        if (s >= 0) {
          rows.load(i, x);
        } else {
          for (int c = 0; c < D; ++c) x[c] = T(0);
        }
        add_aggregated<T, D>(out, s, x);
      }
    }
    __syncthreads();          // before the next tile reuses the shared state
  }
}

// Short inputs, D = 1 or 2: a row a thread over warp-aligned steps
// (add_aggregated). No tile: a short input is latency-bound, and the
// tiles' two passes and barriers would only add to it.
template <typename T, int D, class Rows>
__global__ void segment_reduce_rows(Rows rows, T* __restrict__ out,
                                    long long n, int num_segments) {
  const int lane = threadIdx.x & 31;
  const long long stride = sam::grid_stride();
  for (long long base = sam::global_tid() - lane; base < n; base += stride) {
    const long long i = base + lane;
    const int s = i < n ? rows.id(i, num_segments) : -1;
    T x[D];
    if (s >= 0) {
      rows.load(i, x);
    } else {
      for (int c = 0; c < D; ++c) x[c] = T(0);
    }
    add_aggregated<T, D>(out, s, x);
  }
}

// Any other width: a row a thread, a loop over its columns, equal ids of a
// warp summed before one lane's atomic.
template <typename T>
__global__ void segment_reduce_cols(const int* __restrict__ ids,
                                    const T* __restrict__ vals,
                                    T* __restrict__ out, long long n, int d,
                                    int num_segments) {
  sam::reduce_cols(ids, vals, out, n, d, num_segments);
}

// Long inputs take 4096-row tiles (fewer, fuller flushes), shorter ones
// 1024-row tiles, so that they still spread over the card's SMs, and the
// shortest a row a thread.
constexpr long long kLongRows = 1LL << 22;
constexpr long long kShortRows = 1LL << 18;

template <int kSteps>
int tile_grid(long long n) {
  const long long rows = kSteps * sam::kThreads;
  const long long tiles = (n + rows - 1) / rows;
  return static_cast<int>(tiles < 2048 ? tiles : 2048);
}

template <typename T, int D, class Rows>
void launch_tiles(Rows rows, T* out, long long n, int num_segments,
                  cudaStream_t stream) {
  if (n >= kLongRows) {
    segment_reduce_tiles<T, D, 16><<<tile_grid<16>(n), sam::kThreads, 0,
                                     stream>>>(rows, out, n, num_segments);
  } else if (n < kShortRows) {
    segment_reduce_rows<T, D><<<sam::grid_for(n), sam::kThreads, 0,
                                stream>>>(rows, out, n, num_segments);
  } else {
    segment_reduce_tiles<T, D, 4><<<tile_grid<4>(n), sam::kThreads, 0,
                                    stream>>>(rows, out, n, num_segments);
  }
}

template <typename T>
int launch(const int* ids, const T* vals, T* out, long long n, int d,
           int num_segments, cudaStream_t stream) {
  if (n > 0 && d > 0) {
    if (d == 1) {
      launch_tiles<T, 1>(GeneralRows<T, 1>{ids, vals}, out, n, num_segments,
                         stream);
    } else if (d == 2) {
      launch_tiles<T, 2>(GeneralRows<T, 2>{ids, vals}, out, n, num_segments,
                         stream);
    } else {
      segment_reduce_cols<T><<<sam::grid_for(n), sam::kThreads, 0, stream>>>(
          ids, vals, out, n, d, num_segments);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mul(const long long* keys, const T* a, const T* b,
               const unsigned char* valid, T* out, long long n,
               int num_segments, cudaStream_t stream) {
  if (n > 0) {
    launch_tiles<T, 2>(MulRows<T>{keys, a, b, valid}, out, n, num_segments,
                       stream);
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

extern "C" int sam_segment_reduce_mul_f32(const long long* keys,
                                          const float* a, const float* b,
                                          const unsigned char* valid,
                                          float* out, long long n,
                                          int num_segments, void* stream) {
  return launch_mul<float>(keys, a, b, valid, out, n, num_segments,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int sam_segment_reduce_mul_f64(const long long* keys,
                                          const double* a, const double* b,
                                          const unsigned char* valid,
                                          double* out, long long n,
                                          int num_segments, void* stream) {
  return launch_mul<double>(keys, a, b, valid, out, n, num_segments,
                            static_cast<cudaStream_t>(stream));
}
