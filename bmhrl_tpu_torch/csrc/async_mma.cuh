// Asynchronous copies and tensor-core primitives (sm_80+ PTX, run on sm_90a)
// shared by the hand-written kernels of bmhrl_tpu_torch.
//
//   cp_async16 / cp_async4  global -> shared copies that bypass registers,
//                           with a zero-fill of the bytes past `bytes`
//                           (rows past a tensor's edge arrive as zeros);
//   ldmatrix_x4[_trans]     four 8x8 b16 tiles from shared memory into the
//                           register fragments of mma.sync;
//   mma_bf16                D += A B on the tensor cores, m16n8k16, bf16
//                           inputs, f32 accumulators;
//   split_tf32 / mma_tf32   the 3xTF32 product: x = hi + lo, two tf32 terms
//                           rounded to nearest, and D += A B on m16n8k8
//                           tf32 with f32 accumulators.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bmhrl {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes; copies `bytes` (0 or 16) from src, zero-fills the rest. src and
// dst must be 16-byte aligned (src is not read when bytes == 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// 8 bytes; copies `bytes` (0 or 8) from src, zero-fills the rest. src and
// dst must be 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes; copies `bytes` (0 or 4) from src, zero-fills the rest.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// lanes 8i..8i+7 give the row addresses of tile i; r[i] is tile i's fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// four 8x4 f32 tiles (8 rows of 16 bytes each) as one tf32 A fragment or
// two B fragments: lane 4r + c of tile i gets row r, word c. Lanes 8i..8i+7
// give the row addresses of tile i.
__device__ __forceinline__ void ldmatrix_f32_x4(float (&r)[4], uint32_t addr) {
  uint32_t u[4];
  ldmatrix_x4(u, addr);
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __uint_as_float(u[i]);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major).
// Fragments, with g = lane / 4 and t = lane % 4:
//   a[0] = A[g][2t..2t+1]   a[1] = A[g+8][2t..]   a[2] = A[g][2t+8..]
//   a[3] = A[g+8][2t+8..]   b0 = B[2t..2t+1][g]   b1 = B[2t+8..][g]
//   d[0..1] = D[g][2t..2t+1]                      d[2..3] = D[g+8][2t..]
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero: the result of cvt.rna.tf32.f32 for every finite x, in two integer
// instructions (ptxas expands the cvt into a longer sequence)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo (+ about 2^-22 |x|): hi = tf32(x), lo = tf32(x - hi)

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d (16x8 f32) += a (16x8 tf32, row-major) * b (8x8 tf32, col-major).
// Fragments, with g = lane / 4 and t = lane % 4:
//   a[0] = A[g][t]   a[1] = A[g+8][t]   a[2] = A[g][t+4]   a[3] = A[g+8][t+4]
//   b0 = B[t][g]     b1 = B[t+4][g]
//   d[0..1] = D[g][2t..2t+1]            d[2..3] = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as tf32 terms: split when SPLIT, else x itself (a bf16 value, exact in
// tf32: its lo term is zero and never used)
template <bool SPLIT, int N>
__device__ __forceinline__ void split_n(const float (&x)[N], uint32_t (&hi)[N],
                                        uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (SPLIT) {
      split_tf32(x[i], hi[i], lo[i]);
    } else {
      hi[i] = __float_as_uint(x[i]);
      lo[i] = 0u;
    }
  }
}

// d += A B as 3xTF32 on the tensor cores: lo(A) hi(B) + hi(A) lo(B) +
// hi(A) hi(B), the small terms first; the terms of an operand that is
// exact in tf32 (SA or SB false) are left out
template <bool SA, bool SB>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  if (SA) mma_tf32(d, al, bh[0], bh[1]);
  if (SB) mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// two floats rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace bmhrl
