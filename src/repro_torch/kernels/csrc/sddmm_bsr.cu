// Block-sampled dense-dense product (SDDMM at block granularity).
//
// Replaces repro/kernels/sddmm_bsr.py::sddmm_bsr, which on the TPU runs the
// grid (sampled block, K tile) in order with a (bs, bs) VMEM accumulator:
//
//   out[b, r, c] = sum_k A[rows[b]*bs + r, k] * B[cols[b]*bs + c, k]
//
// Rows of A or B outside their extent read as zero, and the ragged last K
// chunk is masked, so any K works.
//
// Bound: at the bridge's shapes (bs = 128, K = 128) the operations and the
// output write weigh about the same on this card: 2 * nnzb * bs^2 * K
// FLOPs in three TF32 passes, and nnzb * bs^2 outputs written once (A and
// B are small and read once).
//
// Two routes, chosen by the wrapper from the shape alone:
//
// * Tensor cores (16 <= bs <= 128, rows of A and B 16-byte aligned: K a
//   multiple of 4 for float32, of 8 for bfloat16). One CTA owns a whole
//   sampled block (at bs = 128, 8 warps in 2 x 4, each a 64 x 32 tile of
//   m16n8 accumulators), so A's and B's rows are read once per block. K
//   streams in chunks of 32 through a 2-stage cp.async ring in shared
//   memory with one block barrier per chunk, the next chunk's copy in
//   flight while the current one is multiplied (a third stage measured no
//   faster at K = 128, which is four chunks). float32 runs 3xTF32
//   (tensor_core.cuh), bfloat16 one bf16 pass; sums in float32. Shared
//   rows are padded by 16 bytes, which makes every fragment read
//   conflict-free. The epilogue stages the tile in shared memory (the
//   ring's space) and writes the block, one contiguous bs*bs region of
//   `out`, with coalesced 16-byte streaming stores. At bs = 128 float32
//   the CTA takes 73,728 bytes and 128 registers a thread: two CTAs share
//   an SM, so one's epilogue overlaps the other's products.
// * CUDA cores, the first version (any block size, any K): one CTA owns
//   one BT x BT tile of a block (BT = min(bs, 64)) and walks K in chunks of
//   16 staged in shared memory, float32 FMA with a 4x4 register tile.
#include <type_traits>

#include "bsr_common.cuh"
#include "tensor_core.cuh"

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

// -- the tensor-core route ---------------------------------------------------

constexpr int kTcBK = 32;        // K elements per ring stage
constexpr int kTcStages = 2;

template <typename T>
struct TcShape {
  static constexpr int kEpp = 16 / sizeof(T);   // elements per 16-byte copy
  static constexpr int kPpr = kTcBK / kEpp;     // copies per staged row
  static constexpr int kLd = kTcBK + kEpp;      // padded staged row
};

template <typename T, int BT, int WM, int WN>
struct TcTile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kWarpM = BT / WM, kWarpN = BT / WN;
  static constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;
  static constexpr int kLd = TcShape<T>::kLd;
  static constexpr int kStage = 2 * BT * kLd;          // A and B, elements
  static constexpr int kOutLd = BT + 8;                // epilogue row stride
  static constexpr size_t kRing = sizeof(T) * kTcStages * kStage;
  static constexpr size_t kOut = sizeof(T) * BT * kOutLd;
  static constexpr size_t kBytes = kRing > kOut ? kRing : kOut;
  static_assert(kMT >= 1 && kNT >= 1, "warp tile below m16n8");
  static_assert(BT * TcShape<T>::kPpr % kThreads == 0, "ragged stage copy");
  static_assert(BT * BT / TcShape<T>::kEpp % kThreads == 0,
                "ragged epilogue copy");
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    *reinterpret_cast<uint32_t*>(p) = sam::pack_bf16(x, y);
  }
}

template <typename T, int BT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 2)
    sddmm_bsr_tc_kernel(const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const T* __restrict__ a, const T* __restrict__ b,
                        T* __restrict__ out, int k_dim, long long m_rows,
                        long long n_rows) {
  using Sh = TcShape<T>;
  using Ti = TcTile<T, BT, WM, WN>;
  constexpr int kLd = Sh::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const long long blk = blockIdx.x;
  const long long ar0 = static_cast<long long>(rows[blk]) * BT;
  const long long br0 = static_cast<long long>(cols[blk]) * BT;
  const int n_k = (k_dim + kTcBK - 1) / kTcBK;

  // copy K chunk kc of the block's A and B rows into ring stage `stage`;
  // rows past their extent and columns past K are zero-filled
  auto load_stage = [&](int stage, int kc) {
    T* as = ring + stage * Ti::kStage;
    T* bsm = as + BT * kLd;
    const int k0 = kc * kTcBK;
#pragma unroll
    for (int i = 0; i < BT * Sh::kPpr / Ti::kThreads; ++i) {
      const int e = tid + i * Ti::kThreads;
      const int r = e / Sh::kPpr, p = e % Sh::kPpr;
      const int kk = k0 + p * Sh::kEpp;
      const long long ra = ar0 + r, rb = br0 + r;
      const bool va = ra >= 0 && ra < m_rows && kk < k_dim;
      const bool vb = rb >= 0 && rb < n_rows && kk < k_dim;
      sam::cp_async16(as + r * kLd + p * Sh::kEpp,
                      va ? a + ra * k_dim + kk : a, va);
      sam::cp_async16(bsm + r * kLd + p * Sh::kEpp,
                      vb ? b + rb * k_dim + kk : b, vb);
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
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    sam::cp_async_commit();          // empty groups keep the count uniform
  }
  for (int kc = 0; kc < n_k; ++kc) {
    sam::cp_async_wait<kTcStages - 2>();   // this thread's chunk kc landed
    __syncthreads();                 // everyone's; stage (kc - 1) is free
    const int nk = kc + kTcStages - 1;
    if (nk < n_k) load_stage(nk % kTcStages, nk);
    sam::cp_async_commit();

    const T* as = ring + (kc % kTcStages) * Ti::kStage
                  + wm * Ti::kWarpM * kLd;
    const T* bsm = ring + (kc % kTcStages) * Ti::kStage + BT * kLd
                   + wn * Ti::kWarpN * kLd;
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int ks = 0; ks < kTcBK / 8; ++ks) {
        uint32_t bh[Ti::kNT][2], bl[Ti::kNT][2];
#pragma unroll
        for (int nt = 0; nt < Ti::kNT; ++nt) {
          const float* p = bsm + (nt * 8 + g) * kLd + ks * 8 + t;
          const float x[2] = {p[0], p[4]};
          sam::split_tf32(x, bh[nt], bl[nt]);
        }
#pragma unroll
        for (int mt = 0; mt < Ti::kMT; ++mt) {
          const float* p = as + (mt * 16 + g) * kLd + ks * 8 + t;
          const float x[4] = {p[0], p[8 * kLd], p[4], p[8 * kLd + 4]};
          uint32_t ah[4], al[4];
          sam::split_tf32(x, ah, al);
#pragma unroll
          for (int nt = 0; nt < Ti::kNT; ++nt)
            sam::mma_3xtf32(acc[mt][nt], ah, al, bh[nt], bl[nt]);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kTcBK / 16; ++ks) {
        uint32_t bf[Ti::kNT][2];
#pragma unroll
        for (int nt = 0; nt < Ti::kNT; ++nt) {
          const T* p = bsm + (nt * 8 + g) * kLd + ks * 16 + 2 * t;
          bf[nt][0] = sam::ld32(p);
          bf[nt][1] = sam::ld32(p + 8);
        }
#pragma unroll
        for (int mt = 0; mt < Ti::kMT; ++mt) {
          const T* p = as + (mt * 16 + g) * kLd + ks * 16 + 2 * t;
          const uint32_t af[4] = {sam::ld32(p), sam::ld32(p + 8 * kLd),
                                  sam::ld32(p + 8),
                                  sam::ld32(p + 8 * kLd + 8)};
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
      const int c = wn * Ti::kWarpN + nt * 8 + 2 * t;
      store2(ep + r * Ti::kOutLd + c, acc[mt][nt][0], acc[mt][nt][1]);
      store2(ep + (r + 8) * Ti::kOutLd + c, acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  constexpr int kRowPieces = BT / Sh::kEpp;
  T* o = out + blk * BT * BT;
#pragma unroll
  for (int i = 0; i < BT * kRowPieces / Ti::kThreads; ++i) {
    const int e = tid + i * Ti::kThreads;
    const int r = e / kRowPieces, p = e % kRowPieces;
    const uint4 val = *reinterpret_cast<const uint4*>(
        ep + r * Ti::kOutLd + p * Sh::kEpp);
    __stcs(reinterpret_cast<uint4*>(o + r * BT + p * Sh::kEpp), val);
  }
}

template <typename T, int BT, int WM, int WN>
int launch_tc_tile(const int* rows, const int* cols, const T* a, const T* b,
                   T* out, int nnzb, int k_dim, long long m_rows,
                   long long n_rows, cudaStream_t stream) {
  using Ti = TcTile<T, BT, WM, WN>;
  auto kernel = sddmm_bsr_tc_kernel<T, BT, WM, WN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Ti::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nnzb, Ti::kThreads, Ti::kBytes, stream>>>(
      rows, cols, a, b, out, k_dim, m_rows, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc(const int* rows, const int* cols, const T* a, const T* b,
              T* out, int nnzb, int bs, int k_dim, long long m_rows,
              long long n_rows, cudaStream_t stream) {
  if (nnzb <= 0) return static_cast<int>(cudaGetLastError());
  // the wrapper admits bs in {16, 32, 64, 128} and aligned rows only
  switch (bs) {
    case 16: return launch_tc_tile<T, 16, 1, 1>(rows, cols, a, b, out, nnzb,
                                                k_dim, m_rows, n_rows, stream);
    case 32: return launch_tc_tile<T, 32, 2, 2>(rows, cols, a, b, out, nnzb,
                                                k_dim, m_rows, n_rows, stream);
    case 64: return launch_tc_tile<T, 64, 2, 4>(rows, cols, a, b, out, nnzb,
                                                k_dim, m_rows, n_rows, stream);
    case 128: return launch_tc_tile<T, 128, 2, 4>(rows, cols, a, b, out,
                                                  nnzb, k_dim, m_rows, n_rows,
                                                  stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

extern "C" int sam_sddmm_bsr_tc_f32(const int* rows, const int* cols,
                                    const float* a, const float* b,
                                    float* out, int nnzb, int bs, int k_dim,
                                    long long m_rows, long long n_rows,
                                    void* stream) {
  return launch_tc<float>(rows, cols, a, b, out, nnzb, bs, k_dim, m_rows,
                          n_rows, static_cast<cudaStream_t>(stream));
}

extern "C" int sam_sddmm_bsr_tc_bf16(const int* rows, const int* cols,
                                     const __nv_bfloat16* a,
                                     const __nv_bfloat16* b,
                                     __nv_bfloat16* out, int nnzb, int bs,
                                     int k_dim, long long m_rows,
                                     long long n_rows, void* stream) {
  return launch_tc<__nv_bfloat16>(rows, cols, a, b, out, nnzb, bs, k_dim,
                                  m_rows, n_rows,
                                  static_cast<cudaStream_t>(stream));
}
