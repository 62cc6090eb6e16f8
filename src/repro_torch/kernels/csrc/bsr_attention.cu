// Block-sparse flash attention: fused SDDMM -> softmax -> SpMM.
//
// Replaces repro/kernels/bsr_attention.py::bsr_flash_attention, which on the
// TPU walks the grid (batch*head, q block, kv slot) in order with the
// accumulator, running max and running sum in VMEM scratch. Here one CTA
// owns up to 64 query rows of one q block of one batch*head and walks the
// q block's kv slots itself: it flattens the slots into kv positions
// (slot * bkv + offset) and streams them in chunks (32 positions on the
// tensor cores, 64 on the CUDA cores), so any kv block size fills whole
// chunks. Per chunk it computes the scores in registers, updates the
// online softmax (running max, sum and accumulator in float32, exact up to
// rounding for any chunking) and accumulates P @ V.
//
//   out[bh, q, :] = sum_kv softmax_kv(scale * q . k  over the allowed kv) v
//
// A kv slot holding a value outside [0, n_kvblk) (the sentinel n_kvblk) is
// masked; `causal` also masks q_pos < k_pos. A query row with no allowed
// position writes ZEROS: masked scores are -inf and never enter the sums,
// so such a row keeps l == 0. (The TPU kernel gives masked scores the same
// -1e30 its running max starts at, so there exp(0) = 1 and such a row
// returns the mean of V's last kv block instead.) Chunks with no allowed
// position (sentinel slots, or wholly above the diagonal under `causal`)
// are skipped.
//
// Bound: operations (4 * D FLOPs per allowed (q, kv) pair, in three TF32
// passes for float32) for the shapes of the model's heads; q, k, v are
// read once and out written once.
//
// Two routes, chosen by the wrapper from the shape alone:
//
// * Tensor cores (bq, bkv >= 16; D a multiple of 8 and at most 128), the
//   shape of FlashAttention-2 on mma.sync. Four warps own 16 query rows
//   each (64 a CTA). A warp holds its 16 x 32 scores S and 16 x D output O
//   as accumulators. Its Q rows are A fragments: held in registers for
//   bfloat16, read from shared memory each chunk for float32 (held, the
//   64 raw floats pushed the thread past 255 registers into spills). P
//   goes from S's accumulators straight into the A fragments of P V: for
//   float32 the k order of each m16n8k8 step is permuted (k t -> kv 2t,
//   k t+4 -> kv 2t+1) so that no shuffle is needed, and V's B fragment
//   reads the matching rows; for bfloat16 two score tiles pack into one
//   m16n8k16 A fragment and ldmatrix.trans reads V. K and V chunks come in
//   by cp.async into two tiles, four threads a row with one position lookup
//   each: V of chunk c loads while its scores are computed, K of the next
//   live chunk while P V runs, with one block barrier per tile. float32
//   runs 3xTF32 (tensor_core.cuh), bfloat16 one bf16 pass; the softmax
//   runs in float32 in log2 units (one FFMA and one MUFU.EX2 a score), and
//   a chunk open to every row skips the per-score mask. Rows are padded by
//   16 bytes, so every fragment read is free of bank conflicts. Columns
//   past D are zero in shared memory, so the products run over 64 or 128
//   columns without a test. At D = 128 float32: Q, K and V tiles take
//   2 x 32 x 132 + 64 x 132 floats + 256 bytes = 67,840 bytes, about 200
//   registers a thread, two CTAs (8 warps) an SM. Chunks of 32 measured
//   faster than 64 (fewer live registers) and than 16 (barriers).
//   Why mma.sync and not wgmma for float32: TF32 wgmma needs B K-major, and
//   V (kv x D, D contiguous) would have to be transposed in shared memory
//   every chunk; and wgmma reads its operands from shared memory, so the
//   3xTF32 hi and lo tiles of Q, K and V plus a raw copy ring would need
//   about 256 KB at a 64-position chunk (above the 227 KB a CTA may use)
//   and about 192 KB at 32 positions, one CTA an SM. mma.sync takes its
//   fragments from registers in any layout and splits them there. The
//   price: mma.sync runs below wgmma's TF32 rate (tools/mma_sync_rate.py
//   measures it), and the split costs five integer and float instructions
//   an operand element, paid by every warp for every K and V element it
//   reads.
// * CUDA cores, the first version (block sizes below 16, head dims that
//   are not a multiple of 8 or above 128, up to 256): float32 FMA, per
//   chunk four block barriers and no overlap of loads with compute.
//   Shared memory for head dim D <= DMAX (64, 128 or 256):
//     q_s [DMAX][64 + 4]   Q tile, d-major        (read as float4 over rows)
//     kv_s                 K chunk as [DMAX][64 + 1] (d-major, conflict-free
//                          column reads), then V chunk as [64][DMAX]
//     p_s [64][64 + 4]     probabilities, kv-major (read as float4 over rows)
//     pos_s[64]            kv position of each chunk row, -1 when masked
//   DMAX = 128 takes 85,760 bytes: two CTAs fit on one SM.
#include <math.h>

#include <type_traits>

#include "bsr_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kQT = 64;        // query rows per CTA
constexpr int kKC = 64;        // kv positions per chunk
constexpr int kThreads = 256;
constexpr int kNTX = 16;       // threads across kv (scores) and d (P @ V)
constexpr int kQStride = kQT + 4;
constexpr int kKStride = kKC + 1;
constexpr int kPStride = kQT + 4;

template <int DMAX>
struct Layout {
  static constexpr int q_floats = DMAX * kQStride;
  static constexpr int k_floats = DMAX * kKStride;
  static constexpr int v_floats = kKC * DMAX;
  static constexpr int kv_floats = k_floats > v_floats ? k_floats : v_floats;
  static constexpr int p_floats = kKC * kPStride;
  static constexpr size_t bytes =
      sizeof(float) * (q_floats + kv_floats + p_floats) + sizeof(int) * kKC;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    bsr_attention_kernel(const int* __restrict__ kv_idx,
                         const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         int s_q, int s_kv, int d, int max_kv, int bq,
                         int bkv, float scale, int causal) {
  using L = Layout<DMAX>;
  constexpr int kDC = DMAX / 64;            // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* kv_s = q_s + L::q_floats;
  float* p_s = kv_s + L::kv_floats;
  int* pos_s = reinterpret_cast<int*>(p_s + L::p_floats);

  const int tid = threadIdx.x;
  const int tx = tid % kNTX, ty = tid / kNTX;
  const int subs = (bq + kQT - 1) / kQT;
  const int qi = blockIdx.x / subs;
  const int q0 = qi * bq + (blockIdx.x % subs) * kQT;
  const int nq = min(kQT, qi * bq + bq - q0);
  const int q_last = q0 + nq - 1;
  const long long bh = blockIdx.y;
  const T* qb = q + bh * s_q * d;
  const T* kb = k + bh * s_kv * d;
  const T* vb = v + bh * s_kv * d;
  T* ob = out + bh * s_q * d;
  const int n_kvblk = s_kv / bkv;
  const int* idx_row = kv_idx + static_cast<long long>(qi) * max_kv;

  for (int e = tid; e < kQT * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    q_s[c * kQStride + r] =
        (r < nq && c < d)
            ? sam::to_f32(qb[static_cast<long long>(q0 + r) * d + c]) : 0.f;
  }

  float acc[4][4 * kDC];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kDC; ++c) acc[i][c] = 0.f;
  }

  const long long total = static_cast<long long>(max_kv) * bkv;
  for (long long c0 = 0; c0 < total; c0 += kKC) {
    int any = 0;
    if (tid < kKC) {
      const long long p = c0 + tid;
      int pos = -1;
      if (p < total) {
        const int blk = idx_row[p / bkv];
        if (blk >= 0 && blk < n_kvblk) {
          pos = blk * bkv + static_cast<int>(p % bkv);
          if (causal && pos > q_last) pos = -1;   // above every row here
        }
      }
      pos_s[tid] = pos;
      any = pos >= 0;
    }
    if (!__syncthreads_or(any)) continue;

    // K chunk, d-major
    for (int e = tid; e < kKC * DMAX; e += kThreads) {
      const int r = e / DMAX, c = e % DMAX;
      const int pos = pos_s[r];
      kv_s[c * kKStride + r] =
          (pos >= 0 && c < d)
              ? sam::to_f32(kb[static_cast<long long>(pos) * d + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DMAX; ++c) {
      float qv[4], kx[4];
      sam::load_vec<4>(qv, &q_s[c * kQStride + ty * 4]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kx[j] = kv_s[c * kKStride + tx + kNTX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kx[j], sc[i][j]);
    }

    int kpos[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kpos[j] = pos_s[tx + kNTX * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = kpos[j] >= 0 && !(causal && qpos < kpos[j]);
        sc[i][j] = ok ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 threads of one row are lanes of one half-warp
#pragma unroll
      for (int o = kNTX / 2; o > 0; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      float alpha = 1.f, rowsum = 0.f, p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = 0.f;
      if (m_new != -INFINITY) {               // some position allowed so far
        alpha = expf(m_run[i] - m_new);       // 0 when m_run is still -inf
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
          rowsum += p[j];
        }
      }
#pragma unroll
      for (int o = kNTX / 2; o > 0; o /= 2)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, o);
      l_run[i] = l_run[i] * alpha + rowsum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kDC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(tx + kNTX * j) * kPStride + ty * 4 + i] = p[j];
    }
    __syncthreads();                          // K reads done, P written

    // V chunk, kv-major, in K's buffer
    for (int e = tid; e < kKC * DMAX; e += kThreads) {
      const int r = e / DMAX, c = e % DMAX;
      const int pos = pos_s[r];
      kv_s[r * DMAX + c] =
          (pos >= 0 && c < d)
              ? sam::to_f32(vb[static_cast<long long>(pos) * d + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kKC; ++r) {
      float pv[4];
      sam::load_vec<4>(pv, &p_s[r * kPStride + ty * 4]);
#pragma unroll
      for (int cc = 0; cc < kDC; ++cc) {
        float vv[4];
        sam::load_vec<4>(vv, &kv_s[r * DMAX + 64 * cc + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][4 * cc + jj] = fmaf(pv[i], vv[jj], acc[i][4 * cc + jj]);
      }
    }
    __syncthreads();                          // before the next chunk's loads
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const bool live = l_run[i] > 0.f;
#pragma unroll
    for (int cc = 0; cc < kDC; ++cc)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = 64 * cc + 4 * tx + jj;
        if (col < d)
          ob[static_cast<long long>(q0 + r) * d + col] = sam::from_f32<T>(
              live ? acc[i][4 * cc + jj] / l_run[i] : 0.f);
      }
  }
}

template <typename T, int DMAX>
int launch_dmax(const int* kv_idx, const T* q, const T* k, const T* v, T* out,
                int bh, int s_q, int s_kv, int d, int n_qblk, int max_kv,
                int bq, int bkv, float scale, int causal,
                cudaStream_t stream) {
  const size_t smem = Layout<DMAX>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bsr_attention_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int subs = (bq + kQT - 1) / kQT;
  const dim3 grid(n_qblk * subs, bh);
  bsr_attention_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      kv_idx, q, k, v, out, s_q, s_kv, d, max_kv, bq, bkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const int* kv_idx, const T* q, const T* k, const T* v, T* out,
           int bh, int s_q, int s_kv, int d, int n_qblk, int max_kv, int bq,
           int bkv, float scale, int causal, cudaStream_t stream) {
  if (bh <= 0 || n_qblk <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  if (d <= 64)
    return launch_dmax<T, 64>(kv_idx, q, k, v, out, bh, s_q, s_kv, d, n_qblk,
                              max_kv, bq, bkv, scale, causal, stream);
  if (d <= 128)
    return launch_dmax<T, 128>(kv_idx, q, k, v, out, bh, s_q, s_kv, d, n_qblk,
                               max_kv, bq, bkv, scale, causal, stream);
  return launch_dmax<T, 256>(kv_idx, q, k, v, out, bh, s_q, s_kv, d, n_qblk,
                             max_kv, bq, bkv, scale, causal, stream);
}

// -- the tensor-core route ---------------------------------------------------

constexpr int kTcRows = 64;      // query rows per CTA: 4 warps x 16
constexpr int kTcChunk = 32;     // kv positions per chunk
constexpr int kTcThreads = 128;

// K and V tiles, and for float32 the CTA's Q rows (bf16 Q fragments fit
// in registers), then two chunks' kv positions
template <typename T, int DMAX>
struct TcLayout {
  static constexpr bool kQInSmem = std::is_same<T, float>::value;
  static constexpr int kEpp = 16 / sizeof(T);    // elements per 16 bytes
  static constexpr int kLd = DMAX + kEpp;        // padded row of Q, K or V
  static constexpr int kTile = kTcChunk * kLd;   // elements of K or V
  static constexpr int kElems = 2 * kTile + (kQInSmem ? kTcRows * kLd : 0);
  static constexpr size_t bytes =
      sizeof(T) * kElems + sizeof(int) * 2 * kTcChunk;
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    *reinterpret_cast<uint32_t*>(p) = sam::pack_bf16(x, y);
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kTcThreads, 2)
    bsr_attention_tc_kernel(const int* __restrict__ kv_idx,
                            const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            int s_q, int s_kv, int d, int max_kv, int bq,
                            int bkv, float scale, int causal) {
  using L = TcLayout<T, DMAX>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kQK = DMAX / (kF32 ? 8 : 16);   // mma steps over the head dim
  constexpr int kNT = DMAX / 8;                 // n8 tiles of the output
  constexpr int kST = kTcChunk / 8;             // n8 tiles of the scores
  constexpr int kPpr = DMAX / L::kEpp;          // 16-byte copies a row
  constexpr int kLd = L::kLd;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + L::kTile;
  T* q_s = v_s + L::kTile;                                // float32 only
  int* pos_s = reinterpret_cast<int*>(k_s + L::kElems);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int subs = (bq + kTcRows - 1) / kTcRows;
  const int qi = blockIdx.x / subs;
  const int q0 = qi * bq + (blockIdx.x % subs) * kTcRows;
  const int nq = min(kTcRows, qi * bq + bq - q0);
  const int q_last = q0 + nq - 1;
  const bool warp_live = warp * 16 < nq;        // warp-uniform
  const int r0 = warp * 16 + g;                 // this thread's rows r0, r0+8
  const long long bh = blockIdx.y;
  const T* qb = q + bh * s_q * d;
  const T* kb = k + bh * s_kv * d;
  const T* vb = v + bh * s_kv * d;
  T* ob = out + bh * s_q * d;
  const int n_kvblk = s_kv / bkv;
  const int bkv_shift = __ffs(bkv) - 1;         // bkv is a power of two
  const int* idx_row = kv_idx + static_cast<long long>(qi) * max_kv;
  const long long total = static_cast<long long>(max_kv) * bkv;
  const long long n_chunks = (total + kTcChunk - 1) / kTcChunk;

  // a chunk is live when one of its positions is allowed for some row of
  // this CTA (every thread computes the same answer)
  auto chunk_live = [&](long long c) {
    const long long p0 = c * kTcChunk;
    const long long p1 = min(p0 + kTcChunk, total);
    for (long long s = p0 >> bkv_shift; (s << bkv_shift) < p1; ++s) {
      const int blk = idx_row[s];
      if (blk < 0 || blk >= n_kvblk) continue;
      const long long first = (static_cast<long long>(blk) << bkv_shift)
                              + max(p0 - (s << bkv_shift), 0LL);
      if (!causal || first <= q_last) return true;
    }
    return false;
  };
  auto next_live = [&](long long c) {
    while (c < n_chunks && !chunk_live(c)) ++c;
    return c;
  };
  // kv position of row r of chunk c, -1 where masked for every row here
  auto chunk_pos = [&](long long c, int r) {
    const long long p = c * kTcChunk + r;
    if (p >= total) return -1;
    const int blk = idx_row[p >> bkv_shift];
    if (blk < 0 || blk >= n_kvblk) return -1;
    const int pos = (blk << bkv_shift) + static_cast<int>(p & (bkv - 1));
    return (causal && pos > q_last) ? -1 : pos;
  };
  // a position every row of this CTA may attend to
  auto open_for_all = [&](int p) { return p >= 0 && !(causal && p > q0); };
  // one K or V chunk into shared memory, kTpr threads a row (one position
  // lookup each; their copies interleave, so each copy instruction of a
  // warp reads whole 32-byte sectors); masked rows are zero-filled
  constexpr int kTpr = kTcThreads / kTcChunk;
  static_assert(kTpr * kTcChunk == kTcThreads && kPpr % kTpr == 0,
                "whole rows a thread group");
  auto load_tile = [&](T* dst, const T* src, const int* pos) {
    const int r = tid / kTpr, h = tid % kTpr;
    const int p = pos[r];
    T* drow = dst + r * kLd + h * L::kEpp;
    const T* srow =
        p >= 0 ? src + static_cast<long long>(p) * d + h * L::kEpp : src;
#pragma unroll
    for (int i = 0; i < kPpr / kTpr; ++i)
      if ((kTpr * i + h) * L::kEpp < d)
        sam::cp_async16(drow + kTpr * i * L::kEpp,
                        p >= 0 ? srow + kTpr * i * L::kEpp : src, p >= 0);
  };

  // Columns past d are zero and stay so (no copy writes them), and so are
  // Q's rows past nq: the products run over all DMAX columns without a
  // test, and output columns past d are not written.
  for (int e = tid;
       e < static_cast<int>(L::kElems * sizeof(T) / 16);
       e += kTcThreads)
    reinterpret_cast<uint4*>(k_s)[e] = make_uint4(0, 0, 0, 0);

  // bfloat16: this warp's 16 query rows as A fragments, held in registers
  // for the whole run (float32 Q fragments would cost 64 registers more
  // than the thread has: they are read from q_s and split per k step)
  uint32_t qf[kF32 ? 1 : kQK][4];
  if constexpr (!kF32) {
    const bool ok0 = r0 < nq, ok1 = r0 + 8 < nq;
    const T* q_r0 = qb + static_cast<long long>(q0 + r0) * d;
    const T* q_r1 = q_r0 + 8LL * d;
#pragma unroll
    for (int ks = 0; ks < kQK; ++ks) {
      const int c = ks * 16 + 2 * t;
      const bool lo = ks * 16 < d, hi = ks * 16 + 8 < d;
      qf[ks][0] = lo && ok0 ? sam::ld32(q_r0 + c) : 0u;
      qf[ks][1] = lo && ok1 ? sam::ld32(q_r1 + c) : 0u;
      qf[ks][2] = hi && ok0 ? sam::ld32(q_r0 + c + 8) : 0u;
      qf[ks][3] = hi && ok1 ? sam::ld32(q_r1 + c + 8) : 0u;
    }
  }
  const int qr[2] = {q0 + r0, q0 + r0 + 8};
  // scores in log2 units: exp2(s * scale * log2 e - max) is the softmax's
  // exp(s * scale - max) at one FFMA and one MUFU.EX2
  const float scale_log2 = scale * 1.4426950408889634f;

  float o[kNT][4];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  // Two tiles, K and V, each loading while the other is multiplied: V of
  // chunk c during the scores of c, K of the next live chunk during P V.
  // `full` says that no score of the chunk needs a mask (every position
  // open to every row), which skips the per-score tests.
  long long c = next_live(0);
  int pos = -1;
  if (c < n_chunks && tid < kTcChunk) pos_s[tid] = pos = chunk_pos(c, tid);
  // zeros and positions before any copy
  bool full = __syncthreads_and(tid >= kTcChunk || open_for_all(pos));
  if constexpr (kF32) {
    if (c < n_chunks) {
#pragma unroll
      for (int i = 0; i < kTcRows * kPpr / kTcThreads; ++i) {
        const int e = tid + i * kTcThreads;
        const int r = e / kPpr, pc = e % kPpr;
        if (pc * L::kEpp < d && r < nq)
          sam::cp_async16(q_s + r * kLd + pc * L::kEpp,
                          qb + static_cast<long long>(q0 + r) * d
                              + pc * L::kEpp, true);
      }
    }
  }
  if (c < n_chunks) load_tile(k_s, kb, pos_s);
  sam::cp_async_commit();            // Q (float32) with the first K
  int buf = 0;
  while (c < n_chunks) {
    const long long cn = next_live(c + 1);
    const int* pos_cur = pos_s + buf * kTcChunk;
    int* pos_nxt = pos_s + (buf ^ 1) * kTcChunk;
    sam::cp_async_wait<0>();
    __syncthreads();                 // K of c landed; V's tile is free
    load_tile(v_s, vb, pos_cur);
    sam::cp_async_commit();
    if (cn < n_chunks && tid < kTcChunk)
      pos_nxt[tid] = pos = chunk_pos(cn, tid);

    float s[kST][4];
    if (warp_live) {
#pragma unroll
      for (int st = 0; st < kST; ++st)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[st][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kQK; ++ks) {
        if constexpr (kF32) {
          const float* qp = q_s + r0 * kLd + ks * 8 + t;
          const float qx[4] = {qp[0], qp[8 * kLd], qp[4], qp[8 * kLd + 4]};
          uint32_t ah[4], al[4];
          sam::split_tf32(qx, ah, al);
#pragma unroll
          for (int st = 0; st < kST; ++st) {
            const float* p = k_s + (st * 8 + g) * kLd + ks * 8 + t;
            const float x[2] = {p[0], p[4]};
            uint32_t bh[2], bl[2];
            sam::split_tf32(x, bh, bl);
            sam::mma_3xtf32(s[st], ah, al, bh, bl);
          }
        } else {
#pragma unroll
          for (int st = 0; st < kST; ++st) {
            const T* p = k_s + (st * 8 + g) * kLd + ks * 16 + 2 * t;
            const uint32_t b2[2] = {sam::ld32(p), sam::ld32(p + 8)};
            sam::mma_bf16(s[st], qf[ks], b2);
          }
        }
      }
      // mask, then the online softmax of rows r0 (h = 0) and r0 + 8 (h = 1);
      // the four lanes of a quad hold one row's 64 scores between them
      float mx[2] = {-INFINITY, -INFINITY};
      if (full) {
#pragma unroll
        for (int st = 0; st < kST; ++st)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[st][e] *= scale_log2;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[st][e]);
          }
      } else {
#pragma unroll
        for (int st = 0; st < kST; ++st)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kp = pos_cur[st * 8 + 2 * t + j];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const bool ok = kp >= 0 && !(causal && qr[h] < kp);
              float& x = s[st][2 * h + j];
              x = ok ? x * scale_log2 : -INFINITY;
              mx[h] = fmaxf(mx[h], x);
            }
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        // no allowed position yet: every p is exp2(-inf) = 0, l stays 0
        const float m_ref = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = sam::exp2_approx(m_run[h] - m_ref);  // 0 from -inf
        m_run[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int st = 0; st < kST; ++st)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = sam::exp2_approx(s[st][2 * h + j] - m_ref);
            s[st][2 * h + j] = p;
            sum += p;
          }
        l_run[h] = l_run[h] * alpha + sum;     // this lane's share of the row
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          o[nt][2 * h] *= alpha;
          o[nt][2 * h + 1] *= alpha;
        }
      }
    }
    sam::cp_async_wait<0>();
    // V of c landed; K's tile is free; the next chunk's positions are in
    const bool full_next =
        __syncthreads_and(tid >= kTcChunk || open_for_all(pos));
    if (cn < n_chunks) {
      load_tile(k_s, kb, pos_nxt);
      sam::cp_async_commit();
    }

    if (warp_live) {
      if constexpr (kF32) {
        // P stays in registers: the scores' C fragment of kv 8j..8j+7 is
        // this lane's (g, 2t), (g, 2t+1), (g+8, ..) - the A fragment of
        // an mma whose k order maps k t -> kv 8j+2t and k t+4 -> kv
        // 8j+2t+1, so V's B fragment reads rows 8j+2t and 8j+2t+1
#pragma unroll
        for (int j = 0; j < kST; ++j) {
          const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
          uint32_t ah[4], al[4];
          sam::split_tf32(pa, ah, al);
          const float* vp = v_s + (j * 8 + 2 * t) * kLd + g;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const float x[2] = {vp[nt * 8], vp[kLd + nt * 8]};
            uint32_t bh[2], bl[2];
            sam::split_tf32(x, bh, bl);
            sam::mma_3xtf32(o[nt], ah, al, bh, bl);
          }
        }
      } else {
        // bf16: two score tiles make one k16 A fragment; V's B fragments
        // come transposed from shared memory by ldmatrix, two n8 tiles a
        // call
        const T* vrow = v_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd
                        + (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < kST / 2; ++j) {
          const uint32_t pa[4] = {
              sam::pack_bf16(s[2 * j][0], s[2 * j][1]),
              sam::pack_bf16(s[2 * j][2], s[2 * j][3]),
              sam::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
              sam::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            uint32_t r[4];
            sam::ldmatrix_x4_trans(r, vrow + j * 16 * kLd + np * 16);
            const uint32_t b0[2] = {r[0], r[1]};
            const uint32_t b1[2] = {r[2], r[3]};
            sam::mma_bf16(o[2 * np], pa, b0);
            sam::mma_bf16(o[2 * np + 1], pa, b1);
          }
        }
      }
    }
    c = cn;
    buf ^= 1;
    full = full_next;
  }
  sam::cp_async_wait<0>();           // Q's copy, when no chunk was live

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r0 + 8 * h;
    if (r >= nq) continue;
    T* orow = ob + static_cast<long long>(q0 + r) * d;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt * 8 >= d) continue;
      store2(orow + nt * 8 + 2 * t, l > 0.f ? o[nt][2 * h] / l : 0.f,
             l > 0.f ? o[nt][2 * h + 1] / l : 0.f);
    }
  }
}

template <typename T, int DMAX>
int launch_tc_dmax(const int* kv_idx, const T* q, const T* k, const T* v,
                   T* out, int bh, int s_q, int s_kv, int d, int n_qblk,
                   int max_kv, int bq, int bkv, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = TcLayout<T, DMAX>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bsr_attention_tc_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int subs = (bq + kTcRows - 1) / kTcRows;
  const dim3 grid(n_qblk * subs, bh);
  bsr_attention_tc_kernel<T, DMAX><<<grid, kTcThreads, smem, stream>>>(
      kv_idx, q, k, v, out, s_q, s_kv, d, max_kv, bq, bkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc(const int* kv_idx, const T* q, const T* k, const T* v, T* out,
              int bh, int s_q, int s_kv, int d, int n_qblk, int max_kv,
              int bq, int bkv, float scale, int causal, cudaStream_t stream) {
  // the wrapper admits d % 8 == 0, d <= 128 and bq, bkv >= 16 only
  if (bh <= 0 || n_qblk <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  if (d <= 64)
    return launch_tc_dmax<T, 64>(kv_idx, q, k, v, out, bh, s_q, s_kv, d,
                                 n_qblk, max_kv, bq, bkv, scale, causal,
                                 stream);
  return launch_tc_dmax<T, 128>(kv_idx, q, k, v, out, bh, s_q, s_kv, d,
                                n_qblk, max_kv, bq, bkv, scale, causal,
                                stream);
}

}  // namespace

extern "C" int sam_bsr_attention_f32(const int* kv_idx, const float* q,
                                     const float* k, const float* v,
                                     float* out, int bh, int s_q, int s_kv,
                                     int d, int n_qblk, int max_kv, int bq,
                                     int bkv, float scale, int causal,
                                     void* stream) {
  return launch<float>(kv_idx, q, k, v, out, bh, s_q, s_kv, d, n_qblk, max_kv,
                       bq, bkv, scale, causal,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int sam_bsr_attention_bf16(const int* kv_idx,
                                      const __nv_bfloat16* q,
                                      const __nv_bfloat16* k,
                                      const __nv_bfloat16* v,
                                      __nv_bfloat16* out, int bh, int s_q,
                                      int s_kv, int d, int n_qblk, int max_kv,
                                      int bq, int bkv, float scale, int causal,
                                      void* stream) {
  return launch<__nv_bfloat16>(kv_idx, q, k, v, out, bh, s_q, s_kv, d, n_qblk,
                               max_kv, bq, bkv, scale, causal,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int sam_bsr_attention_tc_f32(const int* kv_idx, const float* q,
                                        const float* k, const float* v,
                                        float* out, int bh, int s_q, int s_kv,
                                        int d, int n_qblk, int max_kv, int bq,
                                        int bkv, float scale, int causal,
                                        void* stream) {
  return launch_tc<float>(kv_idx, q, k, v, out, bh, s_q, s_kv, d, n_qblk,
                          max_kv, bq, bkv, scale, causal,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int sam_bsr_attention_tc_bf16(const int* kv_idx,
                                         const __nv_bfloat16* q,
                                         const __nv_bfloat16* k,
                                         const __nv_bfloat16* v,
                                         __nv_bfloat16* out, int bh, int s_q,
                                         int s_kv, int d, int n_qblk,
                                         int max_kv, int bq, int bkv,
                                         float scale, int causal,
                                         void* stream) {
  return launch_tc<__nv_bfloat16>(kv_idx, q, k, v, out, bh, s_q, s_kv, d,
                                  n_qblk, max_kv, bq, bkv, scale, causal,
                                  static_cast<cudaStream_t>(stream));
}
