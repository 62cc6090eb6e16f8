// Device code shared by the two keyed reduce kernels, segment_reduce.cu and
// scatter_workspace.cu: warp aggregation of equal ids, the rounded product,
// the row atomics (a vector atomic for two float32 columns), a tile's live id
// range, and the body of the row-a-thread kernel for any width.
#pragma once
#include "common.cuh"

namespace sam {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;

// Sum x over the lanes in `peers` (the calling lane's group: equal ids);
// the group's lowest lane gets the total. Every lane of the warp calls it
// (the shuffles need the whole warp); the others' results are partial.
// A tree over each group's lanes in rank order: after round r, a lane
// whose rank is a multiple of 2^(r+1) holds the sum of 2^(r+1) peers.
template <typename T>
__device__ __forceinline__ T reduce_peers(unsigned peers, T x) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);   // peers of higher lanes
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);                 // 0 when none is left
    const T t = __shfl_sync(kFull, x, next ? next - 1 : lane);
    if (next) x += t;
    // lanes of odd rank have handed their sum to the peer below them
    above &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
  return x;
}

// a rounded product that the compiler may not contract into a later add,
// so the kernels round as the plain versions do
__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}

template <typename T>
__device__ __forceinline__ void add_row2(T* dst, T v0, T v1) {
  atomicAdd(dst, v0);
  atomicAdd(dst + 1, v1);
}

// one vector atomic (red.global.add.v2.f32 on sm_90) for two float32 words
template <>
__device__ __forceinline__ void add_row2<float>(float* dst, float v0,
                                                float v1) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v0, v1));
}

template <typename T, int D>
__device__ __forceinline__ void add_row(T* dst, const T* x) {
  if constexpr (D == 2) {
    add_row2<T>(dst, x[0], x[1]);
  } else {
    for (int c = 0; c < D; ++c) atomicAdd(dst + c, x[c]);
  }
}

// Add a row's D values x (s < 0: none) to row s of the output, the warp's
// rows of equal ids summed first where a lane's id equals its neighbour's
// (a run: what repeats within a warp), one atomic a group. Every lane of
// the warp calls it.
template <typename T, int D>
__device__ __forceinline__ void add_aggregated(T* out, int s, T* x) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, s, 1);
  if (__any_sync(kFull, lane > 0 && s >= 0 && s == prev)) {
    const unsigned peers = __match_any_sync(kFull, s);
    for (int c = 0; c < D; ++c) x[c] = reduce_peers(peers, x[c]);
    if (s >= 0 && __ffs(peers) - 1 == lane) {
      add_row<T, D>(out + static_cast<long long>(s) * D, x);
    }
  } else if (s >= 0) {
    add_row<T, D>(out + static_cast<long long>(s) * D, x);
  }
}

// The output rows a block's shared-memory accumulator holds (32 KB of them
// whatever the type and width).
template <typename T, int D>
constexpr int kSlots = 32768 / (D * static_cast<int>(sizeof(T)));

// Sum x over the whole warp; lane 0 gets the total.
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;
}

// The live id range of a block's tile: each thread passes the least and the
// largest of its own live ids (0x7fffffff and -1 where it has none) and gets
// the block's, the same in every thread (hi < lo: no live row). warp_lo and
// warp_hi are kWarps shared ints; the caller may write them again only after
// a barrier that follows this call.
__device__ __forceinline__ void tile_id_range(int& lo, int& hi, int* warp_lo,
                                              int* warp_hi) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
  if ((threadIdx.x & 31) == 0) {
    warp_lo[threadIdx.x >> 5] = lo;
    warp_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  lo = warp_lo[0];
  hi = warp_hi[0];
  for (int w = 1; w < kWarps; ++w) {
    lo = min(lo, warp_lo[w]);
    hi = max(hi, warp_hi[w]);
  }
}

// Any width d: a row a thread over warp-aligned steps, a loop over its
// columns, the equal ids of a warp summed before one lane's atomic. Ids
// outside [0, num_rows) add nothing. The body of a __global__ kernel
// launched with a grid-stride grid.
template <typename T>
__device__ __forceinline__ void reduce_cols(const int* __restrict__ ids,
                                            const T* __restrict__ vals,
                                            T* __restrict__ out, long long n,
                                            int d, int num_rows) {
  const int lane = threadIdx.x & 31;
  const long long stride = grid_stride();
  for (long long base = global_tid() - lane; base < n; base += stride) {
    const long long i = base + lane;
    int s = i < n ? ids[i] : -1;
    if (s >= num_rows) s = -1;
    const bool live = s >= 0;
    const unsigned peers = __match_any_sync(kFull, live ? s : -1);
    const bool leader = live && (__ffs(peers) - 1) == lane;
    for (int c = 0; c < d; ++c) {
      T x = live ? vals[i * d + c] : T(0);
      x = reduce_peers(peers, x);
      if (leader) atomicAdd(out + static_cast<long long>(s) * d + c, x);
    }
  }
}

}  // namespace sam
