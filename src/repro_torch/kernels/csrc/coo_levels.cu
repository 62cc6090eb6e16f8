// COO -> compressed fibertree levels: the program-fusion handoff.
//
// Replaces repro/kernels/coo_levels.py::coo_to_levels_pallas, which on the
// TPU moves each level's stable compaction through the f32 MXU as a one-hot
// scatter (scatter_workspace), exact only below 2**24 and capped at 4096
// slots by VMEM. Here the compaction is an integer prefix count, so any
// extent and capacity is exact. It computes coord_ops.coo_to_levels bit for
// bit. For level l with stride s_l = prod(dims[l+1:]):
//
//   pref_l[i]  = valid[i] ? floor(keys[i] / s_l) : PAD_KEY
//   flag_l[i]  = valid[i] && (i == 0 || pref_l[i] != pref_l[i-1])
//   count_l    = sum(flag_l)                           (int64, on the device)
//   crd_l[r], par_l[r] = pref_l[i] mod dims[l], rank_{l-1}[i]  for the r-th
//                flagged row i, kept only where r < cap_l (overflow drops
//                the rest); slots from the count on are 0
//   seg_l[p]   = torch.searchsorted(par'_l, p), p in [0, parent_cap], where
//                par'_l[r] = r < count_l ? par_l[r] : parent_cap
//   rank_l[i]  = (number of rows j <= i with flag_l[j]) - 1
//
// One pass over all levels rests on a fact: flags are nested. pref_l =
// floor(pref_{l+1} / dims[l+1]), so a row whose prefix differs from the row
// before at level l differs at every deeper level too. Each valid row has
// one divergence level d(i), the smallest l with flag_l[i] (L where it
// flags nowhere, as an invalid row), and
//
//   flag_l[i] = d(i) <= l,
//   row i is its parent's first child at level l >= 1 iff d(i) <= l - 1,
//   and then seg_l[rank_{l-1}(i)] = min(rank_l(i), cap_l);
//   at the root the row of rank 0 writes seg_0[0].
//
// seg without a search: unless the parent level overflowed (its count
// above parent_cap), par' is non-decreasing and holds every parent rank
// below the parent count, and every parent has a child (nesting), so
// seg[p] = min(rank of p's first child, cap) for those parents and
// min(count, cap) for the rest. When the parent level did overflow, par'
// is not sorted: the kernel scatters par, and a last launch searches it
// for every p step for step as torch.searchsorted does.
//
// Four launches a call, none of which synchronizes with the host:
//   1. *_divergence  reads keys and valid once (8 consecutive rows a
//                    thread, 16-byte loads): each row's d(i) as one byte
//                    (the key of the row before a thread's first comes from
//                    a warp shuffle, loaded again only by lane 0), and per
//                    (tile, level) the count of flagged rows;
//   2. *_scan        one CTA scans the L x tiles counts into tile offsets
//                    and writes the L level counts;
//   3. *_emit        per tile, reads d and ranks every level's flags with
//                    ballots and a per-level scan across the CTA's warps;
//                    reads the key of rows that flag somewhere, and writes
//                    crd, seg of first children, par where the parent level
//                    overflowed; every CTA also fills seg of childless
//                    parents and zeroes crd past the count;
//   4. *_search      levels whose parent overflowed (read from the device
//                    counts; every CTA returns at once when none did).
// (Each kernel's name starts with coo_to_levels_, the wrapper's name.)
//
// Division: for a non-negative key, floor(k / s) is a shift (s a power of
// two) or a 64-bit multiply-shift, q = umulhi(m, k) >> sh with the round-up
// magic m = floor(2^(63+l) / s) + 1, l = ceil(log2 s) (Granlund and
// Montgomery, Theorem 4.2 for 63-bit numerators), computed by the wrapper
// (coo_levels._divisor). A negative valid key takes an exact int64 floor
// division on a branch. crd_l = pref_l - dims[l] * floor(pref_l / dims[l])
// with floor(pref_l / dims[l]) = floor(k / s_{l-1}), s_{-1} = prod(dims).
//
// Bound: memory. The function needs keys (8 B) and valid (1 B) read once
// per row for the whole call, and crd (4 B) per slot and seg (4 B) per
// parent written at every level. This kernel reads them once in pass 1,
// writes and reads back d (1 B a row), and reads the key again in pass 3
// for rows that flag at some level.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 512;               // passes 1 and 3
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kScanThreads = 1024;          // pass 2
constexpr int kFillThreads = 256;           // pass 4, and fills
constexpr long long kPadKey = 0x7fffffffffffffffLL;
static_assert(kMaxLevels <= kWarps, "pass 3 scans a level a warp");

struct Plan {
  int levels;
  long long n, n_tiles;
  // divisors s_{j-1} = prod(dims[j:]), j = 0..levels (s_{levels-1} = 1)
  unsigned long long magic[kMaxLevels + 1];
  int shift[kMaxLevels + 1];
  long long divisor[kMaxLevels + 1];
  long long dim[kMaxLevels], cap[kMaxLevels];
  int* crd[kMaxLevels];
  int* seg[kMaxLevels];
  long long* par[kMaxLevels];      // null at the root
  long long* counts;               // (levels,)
  int* tile_counts;                // (levels, n_tiles)
  long long* tile_offsets;         // (levels, n_tiles)
  unsigned char* d;                // (n,)
};

__device__ __forceinline__ long long parent_cap_of(const Plan& p, int l) {
  return l ? p.cap[l - 1] : 1;
}

// Kernels take the plan as a __grid_constant__ parameter: read in place
// by reference, indexed by level, never copied to local memory.

// floor(k / s) for s >= 1, as int64 floor division
__device__ __forceinline__ long long floor_div(long long k, long long s) {
  long long q = k / s;
  if ((k % s != 0) && (k < 0)) --q;
  return q;
}

// floor(k / s_{j-1}) (j indexes Plan::divisor)
__device__ __forceinline__ long long quot(const Plan& p, long long k, int j) {
  if (k < 0) return floor_div(k, p.divisor[j]);
  const unsigned long long u = static_cast<unsigned long long>(k);
  const unsigned long long m = p.magic[j];
  return static_cast<long long>((m ? __umul64hi(m, u) : u) >> p.shift[j]);
}

// the parent level's live count; the root level has one parent, with
// children when the level has any entry
__device__ __forceinline__ long long parent_count_of(const Plan& p, int l) {
  return l ? p.counts[l - 1] : (p.counts[0] > 0 ? 1 : 0);
}

// d(i) of row i with key k, given the row before (kp, vp); levels when
// the row flags nowhere
__device__ __forceinline__ int divergence(const Plan& p, long long i, bool v,
                                          long long k, bool vp,
                                          long long kp) {
  if (!v) return p.levels;
  if (i == 0) return 0;
  for (int l = 0; l < p.levels; ++l) {
    const long long q = quot(p, k, l + 1);
    if (q != (vp ? quot(p, kp, l + 1) : kPadKey)) return l;
  }
  return p.levels;
}

// Each thread takes kRowsPerThread consecutive rows of the tile, read with
// 16-byte (keys) and 8-byte (valid) loads; the row before its first comes
// from the lane below by a shuffle (lane 0 loads it again, a cache hit).
__global__ void __launch_bounds__(kThreads)
    coo_to_levels_divergence(const long long* __restrict__ keys,
                             const unsigned char* __restrict__ valid,
                             const __grid_constant__ Plan p) {
  static_assert(kRowsPerThread == 8, "one 8-byte load of valid a thread");
  __shared__ int warp_counts[kMaxLevels][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int levels = p.levels;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile
                       + threadIdx.x * kRowsPerThread;
  long long k[kRowsPerThread];
  bool v[kRowsPerThread];
  if (r0 + kRowsPerThread <= p.n) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; j += 2) {
      const longlong2 x = *reinterpret_cast<const longlong2*>(keys + r0 + j);
      k[j] = x.x;
      k[j + 1] = x.y;
    }
    const uint2 vv = *reinterpret_cast<const uint2*>(valid + r0);
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      v[j] = ((j < 4 ? vv.x >> (8 * j) : vv.y >> (8 * (j - 4))) & 0xff) != 0;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const bool in = r0 + j < p.n;
      k[j] = in ? keys[r0 + j] : 0;
      v[j] = in && valid[r0 + j];
    }
  }
  long long kp = __shfl_up_sync(0xffffffffu, k[kRowsPerThread - 1], 1);
  bool vp = __shfl_up_sync(0xffffffffu,
                           static_cast<int>(v[kRowsPerThread - 1]), 1);
  if (lane == 0) {
    vp = r0 > 0 && r0 <= p.n && valid[r0 - 1];
    kp = vp ? keys[r0 - 1] : 0;
  }
  unsigned char d[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    d[j] = static_cast<unsigned char>(divergence(p, r0 + j, v[j], k[j], vp,
                                                 kp));
    vp = v[j];
    kp = k[j];
  }
  if (r0 + kRowsPerThread <= p.n) {
    uint2 dd;
    dd.x = d[0] | (d[1] << 8) | (d[2] << 16) | (static_cast<unsigned>(d[3])
                                                 << 24);
    dd.y = d[4] | (d[5] << 8) | (d[6] << 16) | (static_cast<unsigned>(d[7])
                                                 << 24);
    *reinterpret_cast<uint2*>(p.d + r0) = dd;
  } else {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (r0 + j < p.n) p.d[r0 + j] = d[j];
    }
  }
  for (int l = 0; l < levels; ++l) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) c += d[j] <= l;
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) warp_counts[l][warp] = c;
  }
  __syncthreads();
  if (threadIdx.x < levels) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += warp_counts[threadIdx.x][w];
    p.tile_counts[threadIdx.x * p.n_tiles + blockIdx.x] = c;
  }
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
  __syncthreads();                 // warp_sums may be reused at once
  return x;
}

__global__ void __launch_bounds__(kScanThreads)
    coo_to_levels_scan(const __grid_constant__ Plan p) {
  __shared__ long long warp_sums[32];
  const long long chunk = (p.n_tiles + blockDim.x - 1) / blockDim.x;
  const long long lo = threadIdx.x * chunk;
  const long long hi = lo + chunk < p.n_tiles ? lo + chunk : p.n_tiles;
  for (int l = 0; l < p.levels; ++l) {
    const int* tc = p.tile_counts + l * p.n_tiles;
    long long* to = p.tile_offsets + l * p.n_tiles;
    long long s = 0;
    for (long long t = lo; t < hi; ++t) s += tc[t];
    const long long incl = block_inclusive_scan<long long>(s, warp_sums);
    long long run = incl - s;
    for (long long t = lo; t < hi; ++t) {
      to[t] = run;
      run += tc[t];
    }
    if (threadIdx.x == blockDim.x - 1) p.counts[l] = incl;
  }
}

__global__ void __launch_bounds__(kThreads)
    coo_to_levels_emit(const long long* __restrict__ keys,
                       const __grid_constant__ Plan p) {
  // per level: the running offset of this tile, and per warp the first
  // rank of the current row group
  __shared__ long long base[kMaxLevels];
  __shared__ long long warp_first[kMaxLevels][kWarps];
  __shared__ int warp_counts[kMaxLevels][kWarps];
  __shared__ bool scatter_par[kMaxLevels];   // the parent level overflowed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int levels = p.levels;
  const unsigned lanes_le = 0xffffffffu >> (31 - lane);

  if (blockIdx.x < p.n_tiles) {
    if (threadIdx.x < levels) {
      const int l = threadIdx.x;
      base[l] = p.tile_offsets[l * p.n_tiles + blockIdx.x];
      scatter_par[l] = l && parent_count_of(p, l) > parent_cap_of(p, l);
    }
    const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
    // every load of the tile issued before any is used: the divergence
    // levels, then the keys of the rows that flag somewhere
    int ds[kRowsPerThread];
    long long ks[kRowsPerThread];
#pragma unroll
    for (int it = 0; it < kRowsPerThread; ++it) {
      const long long i = tile0 + it * kThreads + threadIdx.x;
      ds[it] = i < p.n ? p.d[i] : levels;
    }
#pragma unroll
    for (int it = 0; it < kRowsPerThread; ++it) {
      const long long i = tile0 + it * kThreads + threadIdx.x;
      ks[it] = ds[it] < levels ? keys[i] : 0;
    }
#pragma unroll
    for (int it = 0; it < kRowsPerThread; ++it) {
      const int d = ds[it];
      for (int l = 0; l < levels; ++l) {
        const int c = __popc(__ballot_sync(0xffffffffu, d <= l));
        if (lane == 0) warp_counts[l][warp] = c;
      }
      __syncthreads();               // also: base[], scatter_par[] loaded
      if (warp < levels && lane < kWarps) {   // warp l scans level l
        const int c = warp_counts[warp][lane];
        int x = c;
        for (int o = 1; o < kWarps; o <<= 1) {
          const int y = __shfl_up_sync((1u << kWarps) - 1, x, o);
          if (lane >= o) x += y;
        }
        warp_first[warp][lane] = base[warp] + x - c;
        __syncwarp((1u << kWarps) - 1);
        if (lane == kWarps - 1) base[warp] += x;
      }
      __syncthreads();
      // every lane takes part in the ballots; rows that flag somewhere
      // write the levels from d on
      const long long k = ks[it];
      long long up = d < levels ? quot(p, k, d) : 0;   // pref_{d-1}
      long long rank_up = 0;                       // rank_{l-1}(i)
      for (int l = 0; l < levels; ++l) {
        const unsigned m = __ballot_sync(0xffffffffu, d <= l);
        const long long rank = warp_first[l][warp] + __popc(m & lanes_le) - 1;
        if (d <= l) {
          const long long pref = quot(p, k, l + 1);
          const long long cap = p.cap[l];
          const long long parent_cap = parent_cap_of(p, l);
          if (rank < cap) {
            p.crd[l][rank] = static_cast<int>(pref - p.dim[l] * up);
            if (scatter_par[l]) p.par[l][rank] = rank_up;
          }
          // its parent's first child: it starts the parent too (at the
          // root, the first entry)
          if (l ? d <= l - 1 : rank == 0) {
            const long long q = l ? rank_up : 0;
            if (q <= parent_cap) {
              p.seg[l][q] = static_cast<int>(rank < cap ? rank : cap);
            }
          }
          up = pref;
        }
        rank_up = rank;
      }
    }
  }

  // every CTA: seg of parents without children (unless the parent level
  // overflowed; the search writes all of seg then) and crd past the count
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads
                         + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int l = 0; l < levels; ++l) {
    const long long cnt = p.counts[l], cap = p.cap[l];
    for (long long r = cnt + gtid; r < cap; r += stride) p.crd[l][r] = 0;
    const long long pc = parent_count_of(p, l);
    const long long parent_cap = parent_cap_of(p, l);
    if (pc <= parent_cap) {
      const int tail = static_cast<int>(cnt < cap ? cnt : cap);
      for (long long q = pc + gtid; q <= parent_cap; q += stride) {
        p.seg[l][q] = tail;
      }
    }
  }
}

__global__ void __launch_bounds__(kFillThreads)
    coo_to_levels_search(const __grid_constant__ Plan p) {
  const long long gtid = static_cast<long long>(blockIdx.x) * kFillThreads
                         + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kFillThreads;
  for (int l = 1; l < p.levels; ++l) {
    const long long parent_cap = p.cap[l - 1];
    if (p.counts[l - 1] <= parent_cap) continue;    // sorted: emit wrote it
    const long long cnt = p.counts[l], cap = p.cap[l];
    const long long* par = p.par[l];
    for (long long q = gtid; q <= parent_cap; q += stride) {
      long long start = 0, end = cap;
      while (start < end) {
        const long long mid = start + ((end - start) >> 1);
        const long long v = mid < cnt ? par[mid] : parent_cap;
        if (!(v >= q)) {
          start = mid + 1;
        } else {
          end = mid;
        }
      }
      p.seg[l][q] = static_cast<int>(start);
    }
  }
}

unsigned grid_of(long long items, int threads) {
  long long blocks = (items + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// coo_to_levels for all levels. `plan` is a host array of int64: for each
// divisor j = 0..levels, (magic, shift, divisor) of s_{j-1} =
// prod(dims[j:]); for each level, (dim, cap, crd, seg, par) with crd and
// seg byte offsets into `out` and par into `scratch` (-1 at the root);
// then the byte offsets of counts (into `out`), tile counts, tile offsets
// and d (into `scratch`). The wrapper sizes both buffers (coo_levels.py)
// for rows of `tile`, which must be the kernel's.
extern "C" int sam_coo_levels(const long long* keys,
                              const unsigned char* valid, long long n,
                              int levels, long long tile,
                              const long long* plan, void* out,
                              void* scratch, void* stream_ptr) {
  if (levels < 1 || levels > kMaxLevels || n < 0 || tile != kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  char* ob = static_cast<char*>(out);
  char* sb = static_cast<char*>(scratch);
  Plan p = {};
  p.levels = levels;
  p.n = n;
  p.n_tiles = (n + kTile - 1) / kTile;
  const long long* at = plan;
  for (int j = 0; j <= levels; ++j, at += 3) {
    p.magic[j] = static_cast<unsigned long long>(at[0]);
    p.shift[j] = static_cast<int>(at[1]);
    p.divisor[j] = at[2];
    if (p.divisor[j] < 1 || p.shift[j] < 0 || p.shift[j] > 63) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  long long widest = 2;
  for (int l = 0; l < levels; ++l, at += 5) {
    p.dim[l] = at[0];
    p.cap[l] = at[1];
    p.crd[l] = reinterpret_cast<int*>(ob + at[2]);
    p.seg[l] = reinterpret_cast<int*>(ob + at[3]);
    p.par[l] = at[4] < 0 ? nullptr : reinterpret_cast<long long*>(sb + at[4]);
    if (p.dim[l] < 1 || p.cap[l] < 0 || (l && p.par[l] == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long parent = l ? p.cap[l - 1] + 1 : 2;
    widest = p.cap[l] > widest ? p.cap[l] : widest;
    widest = parent > widest ? parent : widest;
  }
  p.counts = reinterpret_cast<long long*>(ob + at[0]);
  p.tile_counts = reinterpret_cast<int*>(sb + at[1]);
  p.tile_offsets = reinterpret_cast<long long*>(sb + at[2]);
  p.d = reinterpret_cast<unsigned char*>(sb + at[3]);

  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (p.n_tiles > 0) {
    coo_to_levels_divergence<<<static_cast<unsigned>(p.n_tiles), kThreads, 0,
                               stream>>>(keys, valid, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  coo_to_levels_scan<<<1, kScanThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned fill = grid_of(widest, kThreads);
  const unsigned emit_grid =
      p.n_tiles > fill ? static_cast<unsigned>(p.n_tiles) : fill;
  coo_to_levels_emit<<<emit_grid, kThreads, 0, stream>>>(keys, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (levels > 1) {
    coo_to_levels_search<<<grid_of(widest, kFillThreads), kFillThreads, 0,
                           stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
