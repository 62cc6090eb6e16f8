// COO -> compressed fibertree levels: the program-fusion handoff.
//
// Replaces repro/kernels/coo_levels.py::coo_to_levels_pallas, which on the
// TPU moves each level's stable compaction through the f32 MXU as a one-hot
// scatter (scatter_workspace), exact only below 2**24 and capped at 4096
// slots by VMEM. Here the compaction is an integer prefix count, so any
// extent and capacity is exact. It computes coord_ops.coo_to_levels bit for
// bit. For one level l with stride s = prod(dims[l+1:]):
//
//   pref[i]  = valid[i] ? floor(keys[i] / s) : PAD_KEY
//   first[i] = valid[i] && (i == 0 || pref[i] != pref[i-1])
//   count    = sum(first)                             (int64, on the device)
//   crd[r], par[r] = pref[i] mod dim, parent_rank[i]  for the r-th flagged
//                    row i, kept only where r < cap (overflow drops the rest)
//   seg[p]   = torch.searchsorted(par', p), p in [0, parent_cap], where
//              par'[r] = r < count ? par[r] : parent_cap
//   rank[i]  = (number of flagged rows up to and including i) - 1, the next
//              level's parent_rank
//
// Four launches a level, none of which synchronizes with the host:
//   1. *_flag_count  one CTA of kTile threads per tile of rows counts its
//                    flags (__syncthreads_count);
//   2. *_scan_tiles  one CTA scans the tile counts into tile offsets and
//                    writes the level's count;
//   3. *_compact     each CTA recomputes its flags, ranks them with a
//                    warp-shuffle scan inside the block and scatters crd
//                    to tile offset + local rank; it writes every row's
//                    inclusive rank for the next level, and seg of each
//                    parent at its first child;
//   4. *_seg         fills seg for the parents without children.
// (Each kernel's name starts with coo_to_levels_, the wrapper's name.)
//
// seg without a search: unless the parent level overflowed (its count
// above parent_cap), par' is non-decreasing and holds every parent rank
// below the parent count, so seg[p] = min(r of p's first child, cap) for
// those parents and min(count, cap) for the rest. The first child of p
// is the row that starts p at the parent level (its rank differs from
// the row before). When the parent level did overflow, par' is not
// sorted: compact also scatters par, and *_seg binary-searches it for
// every p step for step as torch.searchsorted does, so the result still
// equals the plain version.
//
// Bound: memory. The function needs keys (8 B) and valid (1 B) read once
// per row for the whole call, and crd (4 B) per slot and seg (4 B) per
// parent written at every level. This kernel reads keys and valid in
// passes 1 and 3 of every level, and pass 3 reads and writes an 8-byte
// rank per row, so it moves several times the bound's bytes. int64
// division is slow on the card but exact; strides are computed on the host.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;   // rows per CTA in passes 1 and 3
constexpr long long kPadKey = 0x7fffffffffffffffLL;

// floor(k / s) for s >= 1 (the wrapper refuses extents whose product
// exceeds int64, so every stride fits)
__device__ __forceinline__ long long floor_div(long long k, long long s) {
  if (s == 1) return k;
  long long q = k / s;
  if ((k % s != 0) && (k < 0)) --q;
  return q;
}

__device__ __forceinline__ int first_flag(const long long* keys,
                                          const unsigned char* valid,
                                          long long i, long long stride,
                                          long long* pref) {
  if (!valid[i]) return 0;
  *pref = floor_div(keys[i], stride);
  if (i == 0) return 1;
  const long long prev = valid[i - 1] ? floor_div(keys[i - 1], stride)
                                      : kPadKey;
  return *pref != prev;
}

// inclusive prefix sum of x over the block (blockDim.x a multiple of 32)
template <typename T>
__device__ T block_inclusive_scan(T x, T* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    T s = lane < n_warps ? warp_sums[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) x += warp_sums[warp - 1];
  return x;
}

__global__ void coo_to_levels_flag_count(
    const long long* __restrict__ keys, const unsigned char* __restrict__ valid,
    long long n, long long stride, int* __restrict__ tile_counts) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  long long pref = 0;
  const int f = i < n ? first_flag(keys, valid, i, stride, &pref) : 0;
  const int c = __syncthreads_count(f);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = c;
}

__global__ void coo_to_levels_scan_tiles(
    const int* __restrict__ tile_counts, long long num_tiles,
    long long* __restrict__ tile_offsets, long long* __restrict__ count_out) {
  __shared__ long long warp_sums[32];
  const long long chunk = (num_tiles + blockDim.x - 1) / blockDim.x;
  const long long lo = threadIdx.x * chunk;
  const long long hi = lo + chunk < num_tiles ? lo + chunk : num_tiles;
  long long s = 0;
  for (long long t = lo; t < hi; ++t) s += tile_counts[t];
  const long long incl = block_inclusive_scan<long long>(s, warp_sums);
  long long run = incl - s;
  for (long long t = lo; t < hi; ++t) {
    tile_offsets[t] = run;
    run += tile_counts[t];
  }
  if (threadIdx.x == blockDim.x - 1) *count_out = incl;
}

// the parent level's live count; the root level has one parent, with
// children when the level has any entry
__device__ __forceinline__ long long parent_count_of(
    const long long* parent_count, const long long* count) {
  return parent_count != nullptr ? *parent_count : (*count > 0 ? 1 : 0);
}

__global__ void coo_to_levels_compact(
    const long long* __restrict__ keys, const unsigned char* __restrict__ valid,
    long long n, long long stride, long long dim,
    const long long* __restrict__ rank_in, long long* __restrict__ rank_out,
    const long long* __restrict__ tile_offsets,
    const long long* __restrict__ count,
    const long long* __restrict__ parent_count, int* __restrict__ crd_out,
    long long* __restrict__ par_out, long long cap, int* __restrict__ seg_out,
    long long parent_cap) {
  __shared__ int warp_sums[32];
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  long long pref = 0;
  const int f = i < n ? first_flag(keys, valid, i, stride, &pref) : 0;
  const int incl = block_inclusive_scan<int>(f, warp_sums);
  if (i >= n) return;
  const long long r = tile_offsets[blockIdx.x] + incl - 1;
  if (rank_out != nullptr) rank_out[i] = r;
  if (!f) return;
  const long long q = rank_in != nullptr ? rank_in[i] : 0;
  if (r < cap) {
    long long m = pref % dim;
    if (m < 0) m += dim;
    crd_out[r] = static_cast<int>(m);
    if (parent_count_of(parent_count, count) > parent_cap) par_out[r] = q;
  }
  // a flagged row whose parent rank differs from the row before is its
  // parent's first child (at the root, the first flagged row)
  const bool first_child = rank_in != nullptr
      ? (i == 0 || rank_in[i - 1] != q) : r == 0;
  if (first_child && q <= parent_cap) {
    seg_out[q] = static_cast<int>(r < cap ? r : cap);
  }
}

__global__ void coo_to_levels_seg(
    const long long* __restrict__ par, long long cap,
    const long long* __restrict__ count,
    const long long* __restrict__ parent_count, long long parent_cap,
    int* __restrict__ seg_out) {
  const long long cnt = *count;
  const long long pc = parent_count_of(parent_count, count);
  const int tail = static_cast<int>(cnt < cap ? cnt : cap);
  for (long long p = sam::global_tid(); p <= parent_cap;
       p += sam::grid_stride()) {
    if (pc <= parent_cap) {          // sorted: compact wrote p < pc
      if (p >= pc) seg_out[p] = tail;
      continue;
    }
    long long start = 0, end = cap;
    while (start < end) {
      const long long mid = start + ((end - start) >> 1);
      const long long v = mid < cnt ? par[mid] : parent_cap;
      if (!(v >= p)) {
        start = mid + 1;
      } else {
        end = mid;
      }
    }
    seg_out[p] = static_cast<int>(start);
  }
}

}  // namespace

// One level of coo_to_levels. rank_in and parent_count (the level above's
// count) are null for the root level (every parent rank 0), rank_out null
// for the last level. tile_counts and tile_offsets hold ceil(n / tile)
// entries, par_scratch cap entries; crd_out must be zeroed by the caller
// (slots at and beyond the count stay 0). count_out is written only when
// n > 0, so the caller zeroes it too.
extern "C" int sam_coo_levels_level(
    const long long* keys, const unsigned char* valid, long long n,
    long long stride, long long dim, const long long* rank_in,
    long long* rank_out, int* crd_out, long long cap, int* seg_out,
    long long parent_cap, long long* count_out,
    const long long* parent_count, int* tile_counts,
    long long* tile_offsets, long long* par_scratch, long long tile,
    void* stream_ptr) {
  if (tile != kTile || dim < 1 || stride < 0 || cap < 0 || parent_cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n > 0) {
    const long long num_tiles = (n + kTile - 1) / kTile;
    const unsigned grid = static_cast<unsigned>(num_tiles);
    coo_to_levels_flag_count<<<grid, kTile, 0, stream>>>(keys, valid, n,
                                                         stride, tile_counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    coo_to_levels_scan_tiles<<<1, kTile, 0, stream>>>(
        tile_counts, num_tiles, tile_offsets, count_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    coo_to_levels_compact<<<grid, kTile, 0, stream>>>(
        keys, valid, n, stride, dim, rank_in, rank_out, tile_offsets,
        count_out, parent_count, crd_out, par_scratch, cap, seg_out,
        parent_cap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  coo_to_levels_seg<<<sam::grid_for(parent_cap + 1), sam::kThreads, 0,
                      stream>>>(par_scratch, cap, count_out, parent_count,
                                parent_cap, seg_out);
  return static_cast<int>(cudaGetLastError());
}
