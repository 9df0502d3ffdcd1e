// Helpers shared by the hand-written Hopper kernels of bmhrl_tpu_torch.
//
// Each .cu file is compiled on its own by nvcc into a shared library with a
// plain C interface (bmhrl_tpu_torch/ops/_cuda.py) and loaded with ctypes.
// Every exported launcher returns a cudaError_t as an int; the Python
// wrapper raises when it is not cudaSuccess.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bmhrl {

// additive mask fill of the reference (-1e9, not -inf: a fully-masked row
// softmaxes to a uniform distribution instead of NaN)
constexpr float kMaskFill = -1e9f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, kept as a float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// dtype codes passed by the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// the largest dynamic shared memory one block may use on Hopper
constexpr size_t kMaxSmem = 232448;

}  // namespace bmhrl

extern "C" const char* bmhrl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
