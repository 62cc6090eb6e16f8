// Tensor-core building blocks of the block-sparse kernels (sddmm_bsr,
// bsr_attention): warp-level mma.sync products, asynchronous copies into
// shared memory, and the float32 precision contract.
//
// float32 operands run in 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each
// operand x splits into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and
// the product accumulates lo*hi + hi*lo + hi*hi in float32 on the tensor
// cores (m16n8k8). The dropped lo*lo term and the two residual roundings
// leave at most 3 * 2^-22 * |a*b| per product, near float32; integers up to
// 2^11 split with lo = 0 and multiply exactly. The split happens in
// registers as fragments are loaded, so no hi or lo copy is ever stored.
// bfloat16 operands take one native bf16 pass (m16n8k16), float32 sums.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 / mma.m16n8k16 .bf16), with
// g = lane / 4 and t = lane % 4:
//   A 16 x 8 tf32 : a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B 8 x 8 tf32  : b0 (k t, n g), b1 (k t+4, n g)
//   A 16 x 16 bf16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                   a3 (g+8, 2t+8..), the lower k in the lower half
//   B 16 x 8 bf16 : b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16 x 8 f32  : c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sam {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared through L2 only; a copy that is not
// `valid` reads nothing and writes 16 zero bytes (src must still be a
// mapped address: callers pass the operand's base)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// float32 -> TF32 rounded half away from zero, as cvt.rna.tf32.f32 (which
// the compiler expands into a longer sequence with NaN checks): half a
// unit of the 13 dropped bits added to the sign-magnitude pattern, then
// those bits cleared. Finite inputs only, as the kernels' data.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo (+ at most 2^-22 |x|), both TF32
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32, the small cross terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x in one MUFU.EX2 (relative error about 2^-22; results below 2^-126
// flush to zero, which a softmax term next to its row's maximum of 1 never
// misses)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as one bf16x2 register, `lo` in the lower half (round to
// nearest even, as PyTorch's cast)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the row addresses of matrix i, and r[i] holds that matrix's
// (2t, g) and (2t+1, g) elements: a B fragment read from a row-major
// (k, n) tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

}  // namespace sam
