// Block-sampled dense-dense product (SDDMM at block granularity).
//
// Replaces repro/kernels/sddmm_bsr.py::sddmm_bsr, which on the TPU runs the
// grid (sampled block, K tile) in order with a (bs, bs) VMEM accumulator.
// Here one CTA owns one BT x BT tile of one sampled block (BT = min(bs, 64),
// so a 128-block is four CTAs) and walks K itself in chunks of 16, staging
// the A and B rows of the chunk in shared memory:
//
//   out[b, r, c] = sum_k A[rows[b]*bs + r, k] * B[cols[b]*bs + c, k]
//
// Rows of A or B outside their extent read as zero, and the ragged last K
// chunk is masked, so any K works.
//
// Bound: operations (2 * nnzb * bs^2 * K FLOPs; A and B are read once and
// the sampled blocks written once). First version: float32 FMA on the CUDA
// cores with a 4x4 register tile per thread at bs >= 64; no tensor cores.
#include "bsr_common.cuh"

namespace {

constexpr int kBK = 16;   // K chunk staged per step

template <typename T, int BT, int TM>
__global__ void __launch_bounds__((BT / TM) * (BT / TM))
    sddmm_bsr_kernel(const int* __restrict__ rows,
                     const int* __restrict__ cols, const T* __restrict__ a,
                     const T* __restrict__ b, T* __restrict__ out, int bs,
                     int k_dim, long long m_rows, long long n_rows) {
  constexpr int kNTX = BT / TM;
  constexpr int kThreads = kNTX * kNTX;
  __shared__ __align__(16) float a_s[kBK][BT + 4];
  __shared__ __align__(16) float b_s[kBK][BT + 4];
  const int tid = threadIdx.x;
  const int tx = tid % kNTX, ty = tid / kNTX;
  const long long blk = blockIdx.x;
  const int tiles = bs / BT;
  const int tm0 = (blockIdx.y / tiles) * BT;
  const int tn0 = (blockIdx.y % tiles) * BT;
  const long long ar0 = static_cast<long long>(rows[blk]) * bs + tm0;
  const long long br0 = static_cast<long long>(cols[blk]) * bs + tn0;

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_dim; k0 += kBK) {
    for (int e = tid; e < BT * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int kk = k0 + k;
      const long long ra = ar0 + r, rb = br0 + r;
      a_s[k][r] = (ra >= 0 && ra < m_rows && kk < k_dim)
                      ? sam::to_f32(a[ra * k_dim + kk]) : 0.f;
      b_s[k][r] = (rb >= 0 && rb < n_rows && kk < k_dim)
                      ? sam::to_f32(b[rb * k_dim + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float x[TM], y[TM];
      sam::load_vec<TM>(x, &a_s[k][ty * TM]);
      sam::load_vec<TM>(y, &b_s[k][tx * TM]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* o = out + blk * bs * bs;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j)
      o[static_cast<long long>(tm0 + ty * TM + i) * bs + tn0 + tx * TM + j] =
          sam::from_f32<T>(acc[i][j]);
}

template <typename T, int BT, int TM>
void launch_tile(const int* rows, const int* cols, const T* a, const T* b,
                 T* out, int nnzb, int bs, int k_dim, long long m_rows,
                 long long n_rows, cudaStream_t stream) {
  const int tiles = bs / BT;
  const dim3 grid(nnzb, tiles * tiles);
  sddmm_bsr_kernel<T, BT, TM><<<grid, (BT / TM) * (BT / TM), 0, stream>>>(
      rows, cols, a, b, out, bs, k_dim, m_rows, n_rows);
}

template <typename T>
int launch(const int* rows, const int* cols, const T* a, const T* b, T* out,
           int nnzb, int bs, int k_dim, long long m_rows, long long n_rows,
           cudaStream_t stream) {
  if (nnzb <= 0) return static_cast<int>(cudaGetLastError());
  // bs is a power of two (the wrapper checks); one tile shape per size
  switch (bs) {
    case 1: launch_tile<T, 1, 1>(rows, cols, a, b, out, nnzb, bs, k_dim,
                                 m_rows, n_rows, stream); break;
    case 2: launch_tile<T, 2, 1>(rows, cols, a, b, out, nnzb, bs, k_dim,
                                 m_rows, n_rows, stream); break;
    case 4: launch_tile<T, 4, 1>(rows, cols, a, b, out, nnzb, bs, k_dim,
                                 m_rows, n_rows, stream); break;
    case 8: launch_tile<T, 8, 1>(rows, cols, a, b, out, nnzb, bs, k_dim,
                                 m_rows, n_rows, stream); break;
    case 16: launch_tile<T, 16, 1>(rows, cols, a, b, out, nnzb, bs, k_dim,
                                   m_rows, n_rows, stream); break;
    case 32: launch_tile<T, 32, 2>(rows, cols, a, b, out, nnzb, bs, k_dim,
                                   m_rows, n_rows, stream); break;
    default: launch_tile<T, 64, 4>(rows, cols, a, b, out, nnzb, bs, k_dim,
                                   m_rows, n_rows, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sam_sddmm_bsr_f32(const int* rows, const int* cols,
                                 const float* a, const float* b, float* out,
                                 int nnzb, int bs, int k_dim, long long m_rows,
                                 long long n_rows, void* stream) {
  return launch<float>(rows, cols, a, b, out, nnzb, bs, k_dim, m_rows, n_rows,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int sam_sddmm_bsr_bf16(const int* rows, const int* cols,
                                  const __nv_bfloat16* a,
                                  const __nv_bfloat16* b, __nv_bfloat16* out,
                                  int nnzb, int bs, int k_dim,
                                  long long m_rows, long long n_rows,
                                  void* stream) {
  return launch<__nv_bfloat16>(rows, cols, a, b, out, nnzb, bs, k_dim, m_rows,
                               n_rows, static_cast<cudaStream_t>(stream));
}
