// Dense-workspace scatter-add: the keyed merge of SAM's n>=1 reducer.
//
// Replaces repro/kernels/scatter_workspace.py::scatter_workspace, which on
// the TPU is a one-hot (S, T) x (T, C) MXU product accumulated in a
// VMEM-resident workspace (and so limited to a few thousand slots). Here the
// workspace lives in device memory, so any slot count fits.
//
//   out[s, c] = sum over rows i with ids[i] == s of cols[i, c]
//
// mul_pair mode reads cols as [a, b, hit] and accumulates [a*b, 1] where
// hit > 0 and nothing elsewhere: the mask is applied BEFORE the product, so
// inf/nan garbage at masked rows never reaches the sums. The product is
// rounded (mul_rn) before any add, as the plain version rounds it.
//
// Ids outside [0, num_slots) -- in particular the padding slot num_slots,
// which the reference accumulates and then drops -- are skipped before the
// row's values are read.
//
// Bound: memory. Every id is read once, the values of the in-range rows
// once, and the workspace written once. What costs beyond that is the
// atomics: L2 serves the atomics on one address one at a time, and the
// engine's streams aim many rows at each slot (a model block's down stage
// sends 369M rows into 2^18 slots, j-contiguous runs repeated under an
// outer loop). The design (the device code it shares with segment_reduce.cu
// is in reduce_common.cuh):
//   - long inputs (above 2^18 rows, C_out of 1 to 3): a block takes a
//     contiguous run of tiles of 1024 rows, about kTargetBlocks runs in
//     all, and keeps a window of kSlots<T, C_out> slots in 32 KB of shared
//     memory. For each tile it reads the ids into registers and finds
//     their live range; where the range fits the window, the rows add
//     there with shared atomics (a warp whose 32 rows share one id adds
//     its sum once), and the window moves, flushing each touched slot to
//     the output with one global atomic, only when a tile's range leaves
//     it. A run inside one bucket of keys (the down stage's (e, c): 2.9M
//     rows into 2048 slots) thus issues one global atomic a slot, not one
//     a row;
//   - a tile whose range is wider than the window adds a row a thread,
//     the lanes of a warp that carry one id summed with __match_any_sync
//     and shuffles before one lane's atomic;
//   - short inputs (up to 2^18 rows) are latency-bound: a row a thread
//     with the same warp aggregation, no tiles;
//   - C_out a template parameter for 1, 2 and 3; any other C a row a thread
//     with a loop over the columns;
//   - two float32 output columns (mul_pair's [a*b, 1], the keyed merge's
//     [value, hit]) go out as one vector atomic (red.global.add.v2.f32), and
//     C = 2 rows come in as one float2 load; float64 keeps scalar atomics.
#include "reduce_common.cuh"

namespace {

using sam::add_aggregated;
using sam::add_row;
using sam::kFull;
using sam::kSlots;
using sam::kThreads;
using sam::warp_sum;

// The rows a kernel reads. id(i) is row i's slot, or -1 for an id outside
// [0, num_slots) (its values are then never read); load(i, x) reads its
// D output values and returns false for a row that adds nothing.
template <typename T, int D>
struct PlainRows {
  const int* __restrict__ ids;
  const T* __restrict__ cols;
  __device__ __forceinline__ int id(long long i, int num_slots) const {
    const int s = ids[i];
    return s >= 0 && s < num_slots ? s : -1;
  }
  __device__ __forceinline__ bool load(long long i, T* x) const {
    if constexpr (D == 2 && sizeof(T) == 4) {
      const float2 v = reinterpret_cast<const float2*>(cols)[i];
      x[0] = v.x;
      x[1] = v.y;
    } else {
      for (int c = 0; c < D; ++c) x[c] = cols[i * D + c];
    }
    return true;
  }
};

// mul_pair: [a, b, hit] rows add [a*b, 1] where hit > 0. The three words
// are read together; the product is formed only for a hit.
template <typename T>
struct MulPairRows {
  const int* __restrict__ ids;
  const T* __restrict__ cols;
  __device__ __forceinline__ int id(long long i, int num_slots) const {
    const int s = ids[i];
    return s >= 0 && s < num_slots ? s : -1;
  }
  __device__ __forceinline__ bool load(long long i, T* x) const {
    const T* row = cols + i * 3;
    const T a = row[0], b = row[1], hit = row[2];
    if (!(hit > T(0))) return false;   // masked row: adds [0, 0]
    x[0] = sam::mul_rn(a, b);
    x[1] = T(1);
    return true;
  }
};

// Add the window's touched slots [0, top] to the output, one atomic a slot
// (a slot whose sum is exactly 0 in every column adds nothing), and zero
// them for the next window. Every thread of the block calls it.
template <typename T, int D>
__device__ __forceinline__ void flush(T* acc, T* __restrict__ out, int base,
                                      int top) {
  for (int k = threadIdx.x; k <= top; k += kThreads) {
    T x[D];
    bool touched = false;
    for (int c = 0; c < D; ++c) {
      x[c] = acc[k * D + c];
      acc[k * D + c] = T(0);
      touched |= x[c] != T(0);
    }
    if (touched) add_row<T, D>(out + static_cast<long long>(base + k) * D, x);
  }
}

// Add a row's D values x (s < 0: none) to its slot s of the window
// [base, base + kSlots): one shared atomic a column, or, where the warp's
// 32 rows share one id (a run), the warp's sum once. Every lane of the
// warp calls it.
template <typename T, int D>
__device__ __forceinline__ void add_shared(T* acc, int base, int s, T* x) {
  if (__all_sync(kFull, s == __shfl_sync(kFull, s, 0))) {
    if (s < 0) return;
    for (int c = 0; c < D; ++c) x[c] = warp_sum(x[c]);
    if ((threadIdx.x & 31) != 0) return;
  } else if (s < 0) {
    return;
  }
  for (int c = 0; c < D; ++c) atomicAdd(acc + (s - base) * D + c, x[c]);
}

// D = 1, 2 or 3. Block b takes rows [b * run, (b + 1) * run) in tiles of
// kSteps * 256; the window [base, base + kSlots) lives in shared memory
// across the tiles (see the header). A tile whose range does not fit adds
// its rows to the output directly (add_aggregated). Every lane of a warp
// runs the same iterations (the aggregation needs the whole warp).
template <typename T, int D, int kSteps, class Rows>
__global__ void __launch_bounds__(kThreads)
scatter_workspace_tiles(Rows rows, T* __restrict__ out, long long n,
                        int num_slots, long long run) {
  constexpr int kTileRows = kSteps * kThreads;
  constexpr int kWin = kSlots<T, D>;
  __shared__ T acc[kWin * D];
  __shared__ int warp_lo[sam::kWarps], warp_hi[sam::kWarps];
  const long long begin = static_cast<long long>(blockIdx.x) * run;
  const long long end = begin + run < n ? begin + run : n;
  for (int k = threadIdx.x; k < kWin * D; k += kThreads) acc[k] = T(0);
  int base = 0, top = -1;   // the window's first slot; its largest touched
                            // slot less base (-1: none). Block-uniform.
  for (long long t0 = begin; t0 < end; t0 += kTileRows) {
    int sid[kSteps];
    int lo = 0x7fffffff, hi = -1;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const long long i = t0 + k * kThreads + threadIdx.x;
      sid[k] = i < end ? rows.id(i, num_slots) : -1;
      if (sid[k] >= 0) {
        lo = min(lo, sid[k]);
        hi = max(hi, sid[k]);
      }
    }
    sam::tile_id_range(lo, hi, warp_lo, warp_hi);
    if (hi >= lo) {                        // block-uniform, as is `fits`
      const bool fits = hi - lo < kWin;
      if (fits && (lo < base || hi >= base + kWin)) {
        // the tile leaves the window
        flush<T, D>(acc, out, base, top);
        __syncthreads();
        base = lo;
        top = -1;
      }
      if (fits) top = max(top, hi - base);
      // all the thread's rows are read (their loads in flight together)
      // before any of their atomics
      T x[kSteps][D];
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const long long i = t0 + k * kThreads + threadIdx.x;
        if (sid[k] >= 0 && !rows.load(i, x[k])) sid[k] = -1;
        if (sid[k] < 0) {
          for (int c = 0; c < D; ++c) x[k][c] = T(0);
        }
      }
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        if (fits) {
          add_shared<T, D>(acc, base, sid[k], x[k]);
        } else {
          add_aggregated<T, D>(out, sid[k], x[k]);
        }
      }
    }
    __syncthreads();          // before the next tile reuses the shared state
  }
  flush<T, D>(acc, out, base, top);
}

// Short inputs, D = 1, 2 or 3: a row a thread over warp-aligned steps
// (add_aggregated). No tile: a short input is latency-bound, and the tiles'
// two passes and barriers would only add to it.
template <typename T, int D, class Rows>
__global__ void scatter_workspace_rows(Rows rows, T* __restrict__ out,
                                       long long n, int num_slots) {
  const int lane = threadIdx.x & 31;
  const long long stride = sam::grid_stride();
  for (long long base = sam::global_tid() - lane; base < n; base += stride) {
    const long long i = base + lane;
    int s = i < n ? rows.id(i, num_slots) : -1;
    T x[D];
    if (s >= 0 && !rows.load(i, x)) s = -1;
    if (s < 0) {
      for (int c = 0; c < D; ++c) x[c] = T(0);
    }
    add_aggregated<T, D>(out, s, x);
  }
}

// Any other width: a row a thread, a loop over its columns, equal ids of a
// warp summed before one lane's atomic.
template <typename T>
__global__ void scatter_workspace_cols(const int* __restrict__ ids,
                                       const T* __restrict__ cols,
                                       T* __restrict__ out, long long n, int c,
                                       int num_slots) {
  sam::reduce_cols(ids, cols, out, n, c, num_slots);
}

// Up to kShortRows rows a row a thread (at (d2)'s 2^18 rows, whose spans
// never fit a window, a third faster than tiles); above, tiles of 1024
// rows (as fast as 2048 or 4096 at the model blocks' shapes, and less
// for a block to wait on at its barriers). Each block takes a run of
// whole tiles, about kTargetBlocks runs in all: several waves of the
// card's resident blocks (so that blocks whose rows are dropped padding,
// which finish early, leave no SM idle), each run long enough that its
// window's flushes cost little beside its rows (at 2^29 rows, 128 tiles a
// run; 2048 runs were slower at (s), 16384 no faster).
constexpr long long kShortRows = 1LL << 18;
constexpr long long kTargetBlocks = 4096;
constexpr int kTileSteps = 4;

template <typename T, int D, class Rows>
void launch_rows(Rows rows, T* out, long long n, int num_slots,
                 cudaStream_t stream) {
  if (n <= kShortRows) {
    scatter_workspace_rows<T, D><<<sam::grid_for(n), kThreads, 0, stream>>>(
        rows, out, n, num_slots);
    return;
  }
  const long long tile = kTileSteps * kThreads;
  const long long tiles = (n + tile - 1) / tile;
  const long long run = (tiles + kTargetBlocks - 1) / kTargetBlocks * tile;
  const int grid = static_cast<int>((n + run - 1) / run);
  scatter_workspace_tiles<T, D, kTileSteps><<<grid, kThreads, 0, stream>>>(
      rows, out, n, num_slots, run);
}

template <typename T>
int launch(const int* ids, const T* cols, T* ws, long long n, int c,
           int num_slots, int mul_pair, cudaStream_t stream) {
  if (n > 0 && c > 0) {
    if (mul_pair) {
      launch_rows<T, 2>(MulPairRows<T>{ids, cols}, ws, n, num_slots, stream);
    } else if (c == 1) {
      launch_rows<T, 1>(PlainRows<T, 1>{ids, cols}, ws, n, num_slots, stream);
    } else if (c == 2) {
      launch_rows<T, 2>(PlainRows<T, 2>{ids, cols}, ws, n, num_slots, stream);
    } else if (c == 3) {
      launch_rows<T, 3>(PlainRows<T, 3>{ids, cols}, ws, n, num_slots, stream);
    } else {
      scatter_workspace_cols<T><<<sam::grid_for(n), kThreads, 0, stream>>>(
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
