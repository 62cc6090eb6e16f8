// Block-sparse (BCSR) times dense: out = BCSR(blocks) @ C.
//
// Replaces repro/kernels/spmm_bsr.py::spmm_bsr, which on the TPU walks the
// grid (block row, N tile, slot) in order and keeps the output tile in a
// VMEM scratch while the row's blocks stream through the MXU. Here one CTA
// owns one output tile of a block row (BM rows of the block x 64 columns)
// and loops over the row's slots itself, accumulating in registers: every
// CTA runs independently, so nothing is carried between grid steps.
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
// Bound: operations (2 * nnzb * bs^2 * N FLOPs against the blocks, C and the
// output read or written once). First version: float32 FMA on the CUDA
// cores, both operand tiles staged in shared memory, a 4x4 register tile per
// thread at bs >= 64; no tensor cores, TMA or pipelining yet.
#include "bsr_common.cuh"

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
