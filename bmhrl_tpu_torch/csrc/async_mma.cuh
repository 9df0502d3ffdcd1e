// Asynchronous copies and tensor-core primitives (sm_80+ PTX, run on sm_90a)
// shared by the hand-written kernels of bmhrl_tpu_torch.
//
//   cp_async16 / cp_async4  global -> shared copies that bypass registers,
//                           with a zero-fill of the bytes past `bytes`
//                           (rows past a tensor's edge arrive as zeros);
//   ldmatrix_x4[_trans]     four 8x8 b16 tiles from shared memory into the
//                           register fragments of mma.sync;
//   mma_bf16                D += A B on the tensor cores, m16n8k16, bf16
//                           inputs, f32 accumulators.
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

// two floats rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace bmhrl
