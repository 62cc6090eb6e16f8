// Block-sparse (BCSR) times dense: out = BCSR(blocks) @ C.
//
// Replaces repro/kernels/spmm_bsr.py::spmm_bsr, which on the TPU walks the
// grid (block row, N tile, slot) in order and keeps the output tile in a
// VMEM scratch while the row's blocks stream through the MXU. Here one CTA
// owns one output tile of a block row and loops over the row's slots
// itself, accumulating in registers: every CTA runs independently, so
// nothing is carried between grid steps.
//
//   out[i*bs + r, n] = sum over slots s of row i (blk_map[i,s] < nnzb) of
//                      sum_k blocks[blk_map[i,s], r, k] * C[col_idx[i,s]*bs + k, n]
//
// Pad slots (blk_map == nnzb, the reference's appended zero block) are
// SKIPPED rather than multiplied: the two differ only where C's rows hold
// inf or NaN (0 * inf = NaN), which the reference would spread into the
// row and this kernel does not. Rows of C outside [0, K) read as zero, and
// the ragged last column tile is masked, so any K and N work.
//
// Bound: operations (2 * live blocks * bs^2 * N FLOPs against the blocks,
// C and the output read or written once; in three TF32 passes for float32
// data). Two routes, chosen by the wrapper from the shape alone:
//
// * Tensor cores (bs >= 16, rows of C 16-byte aligned: N a multiple of 4
//   for float32, of 8 for bfloat16). One CTA owns 128 columns of N and
//   min(bs, 128) rows of a block row (the grid's z walks the 128-row parts
//   of a larger block); at 128 rows, 8 warps in 2 x 4, each a 64 x 32 tile
//   of m16n8 accumulators. K streams as (live slot, 32-wide k chunk) steps
//   through a 3-stage cp.async ring with one block barrier a step: the
//   block's BM x 32 chunk (k contiguous, the A operand) and 32 rows of C
//   from col_idx * bs + k (n contiguous, the B operand). The row's slots
//   are counted once and pad slots skipped before any copy is issued.
//   float32 runs 3xTF32 (tensor_core.cuh), split in registers as fragments
//   load, so integers up to 2^11 stay exact and each product is within
//   3 * 2^-22 of exact; bfloat16 runs one bf16 pass with B through
//   ldmatrix.trans. Sums in float32. A rows are padded by 16 bytes and B
//   rows by 8 elements, so every fragment read is conflict-free. The
//   epilogue stages the tile in the ring's shared memory and writes it
//   with 16-byte streaming stores, masking the ragged last N tile. At 128
//   rows, float32, a CTA takes 107,520 bytes and at most 128 registers a
//   thread: two CTAs share an SM.
// * CUDA cores, the first version (any block size, any N): float32 FMA,
//   both operand tiles staged in shared memory, one CTA per BM rows of a
//   block x 64 columns, a 4x4 register tile a thread at bs >= 64.
#include <type_traits>

#include "bsr_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kBN = 64;            // output columns per CTA
constexpr int kTN = 4;             // contiguous columns per thread
constexpr int kNTX = kBN / kTN;    // threads across the columns

template <typename T, int BM, int BK, int TM>
__global__ void __launch_bounds__((BM / TM) * kNTX)
    spmm_bsr_kernel(const int* __restrict__ blk_map,
                    const int* __restrict__ col_idx,
                    const T* __restrict__ blocks, const T* __restrict__ c,
                    T* __restrict__ out, int max_nnz, int nnzb, int bs,
                    long long k_dim, int n) {
  constexpr int kThreads = (BM / TM) * kNTX;
  __shared__ __align__(16) float a_s[BK][BM + 4];   // block tile, k-major
  __shared__ __align__(16) float c_s[BK][kBN];      // C tile
  const int tid = threadIdx.x;
  const int tx = tid % kNTX, ty = tid / kNTX;
  const long long brow = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int m0 = blockIdx.z * BM;

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int* bm_row = blk_map + brow * max_nnz;
  const int* ci_row = col_idx + brow * max_nnz;
  for (int s = 0; s < max_nnz; ++s) {
    const int b = bm_row[s];
    if (b < 0 || b >= nnzb) continue;           // pad slot (uniform per CTA)
    const T* blk = blocks + static_cast<long long>(b) * bs * bs +
                   static_cast<long long>(m0) * bs;
    const long long r0 = static_cast<long long>(ci_row[s]) * bs;
    for (int k0 = 0; k0 < bs; k0 += BK) {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int m = e / BK, k = e % BK;
        a_s[k][m] = sam::to_f32(blk[static_cast<long long>(m) * bs + k0 + k]);
      }
      for (int e = tid; e < BK * kBN; e += kThreads) {
        const int k = e / kBN, j = e % kBN;
        const long long r = r0 + k0 + k;
        const int col = n0 + j;
        c_s[k][j] = (r >= 0 && r < k_dim && col < n)
                        ? sam::to_f32(c[r * n + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], x[kTN];
        sam::load_vec<TM>(a, &a_s[k][ty * TM]);
        sam::load_vec<kTN>(x, &c_s[k][tx * kTN]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = brow * bs + m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < n) out[row * n + col] = sam::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BK, int TM>
void launch_tile(const int* blk_map, const int* col_idx, const T* blocks,
                 const T* c, T* out, int n_brow, int max_nnz, int nnzb,
                 int bs, long long k_dim, int n, cudaStream_t stream) {
  const dim3 grid(n_brow, (n + kBN - 1) / kBN, bs / BM);
  spmm_bsr_kernel<T, BM, BK, TM><<<grid, (BM / TM) * kNTX, 0, stream>>>(
      blk_map, col_idx, blocks, c, out, max_nnz, nnzb, bs, k_dim, n);
}

template <typename T>
int launch(const int* blk_map, const int* col_idx, const T* blocks,
           const T* c, T* out, int n_brow, int max_nnz, int nnzb, int bs,
           long long k_dim, int n, cudaStream_t stream) {
  if (n_brow <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  // bs is a power of two (the wrapper checks); one tile shape per size
  switch (bs) {
    case 1: launch_tile<T, 1, 1, 1>(blk_map, col_idx, blocks, c, out, n_brow,
                                    max_nnz, nnzb, bs, k_dim, n, stream); break;
    case 2: launch_tile<T, 2, 2, 1>(blk_map, col_idx, blocks, c, out, n_brow,
                                    max_nnz, nnzb, bs, k_dim, n, stream); break;
    case 4: launch_tile<T, 4, 4, 1>(blk_map, col_idx, blocks, c, out, n_brow,
                                    max_nnz, nnzb, bs, k_dim, n, stream); break;
    case 8: launch_tile<T, 8, 8, 1>(blk_map, col_idx, blocks, c, out, n_brow,
                                    max_nnz, nnzb, bs, k_dim, n, stream); break;
    case 16: launch_tile<T, 16, 16, 1>(blk_map, col_idx, blocks, c, out,
                                       n_brow, max_nnz, nnzb, bs, k_dim, n,
                                       stream); break;
    case 32: launch_tile<T, 32, 16, 2>(blk_map, col_idx, blocks, c, out,
                                       n_brow, max_nnz, nnzb, bs, k_dim, n,
                                       stream); break;
    default: launch_tile<T, 64, 16, 4>(blk_map, col_idx, blocks, c, out,
                                       n_brow, max_nnz, nnzb, bs, k_dim, n,
                                       stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}


// -- the tensor-core route ---------------------------------------------------

constexpr int kTcBN = 128;   // output columns per CTA

template <typename T, int BM, int BK, int WM, int WN>
struct TcTile {
  static constexpr int kStages = 3;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kEpp = 16 / sizeof(T);      // elements per 16 bytes
  static constexpr int kWarpM = BM / WM, kWarpN = kTcBN / WN;
  static constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;
  // A rows (k contiguous) padded by 16 bytes; B rows (n contiguous) by 8
  // elements: 8 words mod 32 for float32, an odd count of 16-byte units
  // for bfloat16, so every fragment read and ldmatrix is conflict-free
  static constexpr int kLdA = BK + kEpp, kLdB = kTcBN + 8;
  static constexpr int kA = BM * kLdA, kB = BK * kLdB;
  static constexpr int kStage = kA + kB;               // elements
  static constexpr int kAPieces = BM * BK / kEpp;
  static constexpr int kBPieces = BK * kTcBN / kEpp;
  static constexpr int kOutLd = kTcBN + 8;             // epilogue row stride
  static constexpr size_t kRing = sizeof(T) * kStages * kStage;
  static constexpr size_t kOut = sizeof(T) * BM * kOutLd;
  static constexpr size_t kBytes = kRing > kOut ? kRing : kOut;
  static_assert(kMT >= 1 && kNT >= 2 && kNT % 2 == 0, "warp tile");
  static_assert(BK % 16 == 0, "chunk below one bf16 k step");
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    *reinterpret_cast<uint32_t*>(p) = sam::pack_bf16(x, y);
  }
}

template <typename T, int BM, int BK, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 2)
    spmm_bsr_tc_kernel(const int* __restrict__ blk_map,
                       const int* __restrict__ col_idx,
                       const T* __restrict__ blocks,
                       const T* __restrict__ c, T* __restrict__ out,
                       int max_nnz, int nnzb, int bs, long long k_dim,
                       int n) {
  using Ti = TcTile<T, BM, BK, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const long long brow = blockIdx.x;
  const int n0 = blockIdx.y * kTcBN;
  const int m0 = blockIdx.z * BM;
  const int* bm_row = blk_map + brow * max_nnz;
  const int* ci_row = col_idx + brow * max_nnz;
  const int chunks = bs / BK;

  // the row's live slots, counted once; pad slots issue no copy
  auto live = [&](int s) {
    const int b = bm_row[s];
    return b >= 0 && b < nnzb;
  };
  int n_live = 0;
  for (int s0 = 0; s0 < max_nnz; s0 += Ti::kThreads) {
    const int s = s0 + tid;
    n_live += __syncthreads_count(s < max_nnz && live(s));
  }
  const int steps = n_live * chunks;
  auto next_live = [&](int s) {
    while (s < max_nnz && !live(s)) ++s;
    return s;
  };
  int ps = next_live(0), pkc = 0;     // the producer's (slot, k chunk)

  // copy step (ps, pkc) into ring stage `stage`: BM x BK of the block
  // (the A operand) and BK rows of C from col_idx * bs + k (the B
  // operand); rows of C at or past K and columns past N copy as zeros
  auto load_stage = [&](int stage) {
    T* as = ring + stage * Ti::kStage;
    T* bsm = as + Ti::kA;
    const T* blk = blocks + static_cast<long long>(bm_row[ps]) * bs * bs
                   + static_cast<long long>(m0) * bs + pkc * BK;
    const long long r0 = static_cast<long long>(ci_row[ps]) * bs + pkc * BK;
    constexpr int kAP = BK / Ti::kEpp, kBP = kTcBN / Ti::kEpp;
#pragma unroll
    for (int i = 0; i < (Ti::kAPieces + Ti::kThreads - 1) / Ti::kThreads;
         ++i) {
      const int e = tid + i * Ti::kThreads;
      if (Ti::kAPieces % Ti::kThreads == 0 || e < Ti::kAPieces) {
        const int r = e / kAP, p = e % kAP;
        sam::cp_async16(as + r * Ti::kLdA + p * Ti::kEpp,
                        blk + static_cast<long long>(r) * bs + p * Ti::kEpp,
                        true);
      }
    }
#pragma unroll
    for (int i = 0; i < (Ti::kBPieces + Ti::kThreads - 1) / Ti::kThreads;
         ++i) {
      const int e = tid + i * Ti::kThreads;
      if (Ti::kBPieces % Ti::kThreads == 0 || e < Ti::kBPieces) {
        const int r = e / kBP, p = e % kBP;
        const long long kr = r0 + r;
        const int col = n0 + p * Ti::kEpp;
        const bool ok = kr >= 0 && kr < k_dim && col < n;
        sam::cp_async16(bsm + r * Ti::kLdB + p * Ti::kEpp,
                        ok ? c + kr * n + col : c, ok);
      }
    }
    if (++pkc == chunks) {
      pkc = 0;
      ps = next_live(ps + 1);
    }
  };

  float acc[Ti::kMT][Ti::kNT][4];
#pragma unroll
  for (int i = 0; i < Ti::kMT; ++i)
#pragma unroll
    for (int j = 0; j < Ti::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < Ti::kStages - 1; ++s) {
    if (s < steps) load_stage(s);
    sam::cp_async_commit();          // empty groups keep the count uniform
  }
  for (int step = 0; step < steps; ++step) {
    sam::cp_async_wait<Ti::kStages - 2>();   // this thread's copies landed
    __syncthreads();                 // everyone's; stage (step - 1) is free
    const int nstep = step + Ti::kStages - 1;
    if (nstep < steps) load_stage(nstep % Ti::kStages);
    sam::cp_async_commit();

    T* stage = ring + (step % Ti::kStages) * Ti::kStage;
    const T* as = stage + wm * Ti::kWarpM * Ti::kLdA;
    const T* bsm = stage + Ti::kA + wn * Ti::kWarpN;
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        uint32_t bh[Ti::kNT][2], bl[Ti::kNT][2];
#pragma unroll
        for (int nt = 0; nt < Ti::kNT; ++nt) {
          const float* p = bsm + (ks * 8 + t) * Ti::kLdB + nt * 8 + g;
          const float x[2] = {p[0], p[4 * Ti::kLdB]};
          sam::split_tf32(x, bh[nt], bl[nt]);
        }
#pragma unroll
        for (int mt = 0; mt < Ti::kMT; ++mt) {
          const float* p = as + (mt * 16 + g) * Ti::kLdA + ks * 8 + t;
          const float x[4] = {p[0], p[8 * Ti::kLdA], p[4],
                              p[8 * Ti::kLdA + 4]};
          uint32_t ah[4], al[4];
          sam::split_tf32(x, ah, al);
#pragma unroll
          for (int nt = 0; nt < Ti::kNT; ++nt)
            sam::mma_3xtf32(acc[mt][nt], ah, al, bh[nt], bl[nt]);
        }
      }
    } else {
      // B fragments through ldmatrix.trans from the (k, n) tile: lanes
      // 8i..8i+7 address matrix i = (k 0-7 | k 8-15) x (n 0-7 | n 8-15)
      const T* brow_p = bsm + ((lane & 7) + ((lane >> 3) & 1) * 8) * Ti::kLdB
                        + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t bf[Ti::kNT][2];
#pragma unroll
        for (int np = 0; np < Ti::kNT / 2; ++np) {
          uint32_t r[4];
          sam::ldmatrix_x4_trans(r, brow_p + ks * 16 * Ti::kLdB + np * 16);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < Ti::kMT; ++mt) {
          const T* p = as + (mt * 16 + g) * Ti::kLdA + ks * 16 + 2 * t;
          const uint32_t af[4] = {sam::ld32(p), sam::ld32(p + 8 * Ti::kLdA),
                                  sam::ld32(p + 8),
                                  sam::ld32(p + 8 * Ti::kLdA + 8)};
#pragma unroll
          for (int nt = 0; nt < Ti::kNT; ++nt)
            sam::mma_bf16(acc[mt][nt], af, bf[nt]);
        }
      }
    }
  }
  sam::cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the epilogue

  T* ep = ring;
#pragma unroll
  for (int mt = 0; mt < Ti::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Ti::kNT; ++nt) {
      const int r = wm * Ti::kWarpM + mt * 16 + g;
      const int col = wn * Ti::kWarpN + nt * 8 + 2 * t;
      store2(ep + r * Ti::kOutLd + col, acc[mt][nt][0], acc[mt][nt][1]);
      store2(ep + (r + 8) * Ti::kOutLd + col, acc[mt][nt][2],
             acc[mt][nt][3]);
    }
  __syncthreads();
  // 16-byte stores along the rows; N is a multiple of 16 bytes' worth of
  // elements, so a piece lies wholly inside or wholly past the last column
  constexpr int kRowPieces = kTcBN / Ti::kEpp;
  T* o = out + (brow * bs + m0) * static_cast<long long>(n);
#pragma unroll
  for (int i = 0; i < BM * kRowPieces / Ti::kThreads; ++i) {
    const int e = tid + i * Ti::kThreads;
    const int r = e / kRowPieces, p = e % kRowPieces;
    const int col = n0 + p * Ti::kEpp;
    if (col < n) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          ep + r * Ti::kOutLd + p * Ti::kEpp);
      __stcs(reinterpret_cast<uint4*>(o + static_cast<long long>(r) * n
                                      + col), val);
    }
  }
}

template <typename T, int BM, int BK, int WM, int WN>
int launch_tc_tile(const int* blk_map, const int* col_idx, const T* blocks,
                   const T* c, T* out, int n_brow, int max_nnz, int nnzb,
                   int bs, long long k_dim, int n, cudaStream_t stream) {
  using Ti = TcTile<T, BM, BK, WM, WN>;
  auto kernel = spmm_bsr_tc_kernel<T, BM, BK, WM, WN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Ti::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_brow, (n + kTcBN - 1) / kTcBN, bs / BM);
  kernel<<<grid, Ti::kThreads, Ti::kBytes, stream>>>(
      blk_map, col_idx, blocks, c, out, max_nnz, nnzb, bs, k_dim, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc(const int* blk_map, const int* col_idx, const T* blocks,
              const T* c, T* out, int n_brow, int max_nnz, int nnzb, int bs,
              long long k_dim, int n, cudaStream_t stream) {
  if (n_brow <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  // the wrapper admits power-of-two bs >= 16 and 16-byte-aligned rows only
  switch (bs) {
    case 16: return launch_tc_tile<T, 16, 16, 1, 8>(
        blk_map, col_idx, blocks, c, out, n_brow, max_nnz, nnzb, bs, k_dim,
        n, stream);
    case 32: return launch_tc_tile<T, 32, 32, 2, 4>(
        blk_map, col_idx, blocks, c, out, n_brow, max_nnz, nnzb, bs, k_dim,
        n, stream);
    case 64: return launch_tc_tile<T, 64, 32, 2, 4>(
        blk_map, col_idx, blocks, c, out, n_brow, max_nnz, nnzb, bs, k_dim,
        n, stream);
    default:
      if (bs < 128) return static_cast<int>(cudaErrorInvalidValue);
      return launch_tc_tile<T, 128, 32, 2, 4>(
          blk_map, col_idx, blocks, c, out, n_brow, max_nnz, nnzb, bs, k_dim,
          n, stream);
  }
}

}  // namespace

extern "C" int sam_spmm_bsr_f32(const int* blk_map, const int* col_idx,
                                const float* blocks, const float* c,
                                float* out, int n_brow, int max_nnz, int nnzb,
                                int bs, long long k_dim, int n, void* stream) {
  return launch<float>(blk_map, col_idx, blocks, c, out, n_brow, max_nnz,
                       nnzb, bs, k_dim, n, static_cast<cudaStream_t>(stream));
}

extern "C" int sam_spmm_bsr_bf16(const int* blk_map, const int* col_idx,
                                 const __nv_bfloat16* blocks,
                                 const __nv_bfloat16* c, __nv_bfloat16* out,
                                 int n_brow, int max_nnz, int nnzb, int bs,
                                 long long k_dim, int n, void* stream) {
  return launch<__nv_bfloat16>(blk_map, col_idx, blocks, c, out, n_brow,
                               max_nnz, nnzb, bs, k_dim, n,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int sam_spmm_bsr_tc_f32(const int* blk_map, const int* col_idx,
                                   const float* blocks, const float* c,
                                   float* out, int n_brow, int max_nnz,
                                   int nnzb, int bs, long long k_dim, int n,
                                   void* stream) {
  return launch_tc<float>(blk_map, col_idx, blocks, c, out, n_brow, max_nnz,
                          nnzb, bs, k_dim, n,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int sam_spmm_bsr_tc_bf16(const int* blk_map, const int* col_idx,
                                    const __nv_bfloat16* blocks,
                                    const __nv_bfloat16* c,
                                    __nv_bfloat16* out, int n_brow,
                                    int max_nnz, int nnzb, int bs,
                                    long long k_dim, int n, void* stream) {
  return launch_tc<__nv_bfloat16>(blk_map, col_idx, blocks, c, out, n_brow,
                                  max_nnz, nnzb, bs, k_dim, n,
                                  static_cast<cudaStream_t>(stream));
}
