// Block-sparse flash attention: fused SDDMM -> softmax -> SpMM.
//
// Replaces repro/kernels/bsr_attention.py::bsr_flash_attention, which on the
// TPU walks the grid (batch*head, q block, kv slot) in order with the
// accumulator, running max and running sum in VMEM scratch. Here one CTA
// owns up to 64 query rows of one q block of one batch*head and walks the
// q block's kv slots itself: it flattens the slots into kv positions
// (slot * bkv + offset) and streams them in chunks of 64, so any kv block
// size fills whole chunks. Per chunk it stages K, computes the 64 x 64
// scores in registers, updates the online softmax (running max, sum and
// accumulator in float32, exact up to rounding for any chunking), then
// stages V in the same buffer and accumulates P @ V.
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
// Bound: operations (4 * D FLOPs per allowed (q, kv) pair) for the shapes
// of the model's heads; q, k, v are read once and out written once. First
// version: float32 FMA on the CUDA cores; per chunk four block barriers and
// no overlap of loads with compute; no tensor cores or TMA.
//
// Shared memory for head dim D <= DMAX (64, 128 or 256):
//   q_s [DMAX][64 + 4]   Q tile, d-major        (read as float4 over rows)
//   kv_s                 K chunk as [DMAX][64 + 1] (d-major, conflict-free
//                        column reads), then V chunk as [64][DMAX]
//   p_s [64][64 + 4]     probabilities, kv-major (read as float4 over rows)
//   pos_s[64]            kv position of each chunk row, -1 when masked
// DMAX = 128 takes 85,760 bytes: two CTAs fit on one SM.
#include <math.h>

#include "bsr_common.cuh"

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
