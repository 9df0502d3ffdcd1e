// Flash attention on un-headed (B, S, H*d) projections, for sm_90a.
//
// Replaces two TPU kernels of the JAX package:
//   _flash_bsd_kernel    bmhrl_tpu/ops/attention.py:89  (one pass, all keys
//                        resident in VMEM)
//   _flash_stream_kernel bmhrl_tpu/ops/attention.py:269 (online softmax over
//                        key blocks, chosen when no one-pass tile fits VMEM)
// Both compute the same function. On Hopper a block's shared memory is
// 227 KB, so this kernel always streams the keys: one block per (batch row,
// head, tile of BQ queries) loops over tiles of 32 keys with a running max m,
// normaliser l and an f32 accumulator, which covers both TPU kernels at every
// source length.
//
// Semantics kept from the TPU kernels:
//   - s = (q . k) * 1/sqrt(d) in f32; -1e9 where the key mask is 0 or, with
//     `causal`, where the key lies after the query;
//   - keys past Sk are skipped (p = 0, left out of the max), never filled,
//     so a fully-masked row gives mean(V) over the actual Sk keys whatever
//     the tile size;
//   - p is rounded to the input type before the PV product, l sums the
//     unrounded p, and the output is normalised after PV.
//
// Bound: at the flagship's encoder sites (d = 256, Sq, Sk = 128..800) the
// work is 4*Sq*Sk*d operations per (row, head) against 2*(Sq+Sk)*d elements
// moved, far above the card's operations-per-byte balance, so it is bound by
// operations. This first version runs the products on the CUDA cores in f32
// (float4 reads from padded shared memory, no bank conflicts); moving QK^T
// and PV onto the tensor cores (wgmma) is later work.
#include "common.cuh"

namespace {

using bmhrl::kMaskFill;
using bmhrl::round_to;
using bmhrl::to_f;
using bmhrl::from_f;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // keys per tile: one key per lane

template <int D>
struct Cfg {
  static constexpr int BQ = D <= 256 ? 32 : 16;    // queries per block
  static constexpr int RPW = BQ / 8;               // score rows per warp
  static constexpr int TPC = D < 256 ? D : 256;    // PV threads per row
  static constexpr int NRG = kThreads / TPC;       // PV row groups
  static constexpr int RPT = BQ / NRG;             // PV rows per thread
  static constexpr int NCOL = (D + TPC - 1) / TPC; // PV columns per thread
  static constexpr int QS = D + 4;  // Q/K row stride: float4 reads by 8
                                    // lanes of different rows hit distinct
                                    // bank groups
  static constexpr size_t smem =
      sizeof(float) * (BQ * QS + kBK * QS + kBK * D + BQ * kBK + 2 * BQ) +
      sizeof(int) * kBK;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 T* __restrict__ out, int Sq, int Sk, int H, int64_t q_bs,
                 int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                 int64_t v_rs, float scale, int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // BQ x QS
  float* Ks = Qs + C::BQ * C::QS;     // kBK x QS
  float* Vs = Ks + kBK * C::QS;       // kBK x D
  float* Ps = Vs + kBK * D;           // BQ x kBK
  float* corr_s = Ps + C::BQ * kBK;   // BQ
  float* l_s = corr_s + C::BQ;        // BQ
  int* mask_s = reinterpret_cast<int*>(l_s + C::BQ);  // kBK

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * q_bs + h * D;
  const T* kb = k + b * k_bs + h * D;
  const T* vb = v + b * v_bs + h * D;
  const int* mb = mask + static_cast<int64_t>(b) * Sk;

  for (int idx = tid; idx < C::BQ * D; idx += kThreads) {
    const int i = idx / D, c = idx % D;
    Qs[i * C::QS + c] = q0 + i < Sq ? to_f(qb[(q0 + i) * q_rs + c]) : 0.f;
  }

  float m_run[C::RPW], l_run[C::RPW];
#pragma unroll
  for (int r = 0; r < C::RPW; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float acc[C::NCOL][C::RPT];
#pragma unroll
  for (int n = 0; n < C::NCOL; ++n)
#pragma unroll
    for (int r = 0; r < C::RPT; ++r) acc[n][r] = 0.f;
  const int col = tid % C::TPC, rg = tid / C::TPC;

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed; Qs is written
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      float kx = 0.f, vx = 0.f;  // zero rows past Sk keep 0 * v finite
      if (k0 + j < Sk) {
        kx = to_f(kb[(k0 + j) * k_rs + c]);
        vx = to_f(vb[(k0 + j) * v_rs + c]);
      }
      Ks[j * C::QS + c] = kx;
      Vs[j * D + c] = vx;
    }
    if (tid < kBK) mask_s[tid] = k0 + tid < Sk ? mb[k0 + tid] : 0;
    __syncthreads();

    // scores and the online softmax: warp w owns rows w + 8r, lane = key
    const int kj = k0 + lane;
    const bool key_in = kj < Sk;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * C::QS);
#pragma unroll
    for (int r = 0; r < C::RPW; ++r) {
      const int i = warp + 8 * r;
      const float4* qrow = reinterpret_cast<const float4*>(Qs + i * C::QS);
      float dot = 0.f;
#pragma unroll 8
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 a = qrow[d4], bb = krow[d4];
        dot = fmaf(a.x, bb.x, dot);
        dot = fmaf(a.y, bb.y, dot);
        dot = fmaf(a.z, bb.z, dot);
        dot = fmaf(a.w, bb.w, dot);
      }
      float s = dot * scale;
      if (!key_in) {
        s = -INFINITY;
      } else if (mask_s[lane] <= 0 || (causal && kj > q0 + i)) {
        s = kMaskFill;
      }
      const float m_new = fmaxf(m_run[r], bmhrl::warp_max(s));
      const float corr = m_run[r] == -INFINITY ? 0.f : expf(m_run[r] - m_new);
      const float p = key_in ? expf(s - m_new) : 0.f;
      l_run[r] = l_run[r] * corr + bmhrl::warp_sum(p);
      m_run[r] = m_new;
      Ps[i * kBK + lane] = round_to<T>(p);
      if (lane == 0) corr_s[i] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V, thread owns columns col + n*TPC of RPT rows
#pragma unroll
    for (int n = 0; n < C::NCOL; ++n) {
      const int c = col + n * C::TPC;
      if (c < D) {
#pragma unroll
        for (int r = 0; r < C::RPT; ++r) acc[n][r] *= corr_s[rg * C::RPT + r];
        for (int j = 0; j < kBK; j += 4) {
          const float v0 = Vs[j * D + c], v1 = Vs[(j + 1) * D + c];
          const float v2 = Vs[(j + 2) * D + c], v3 = Vs[(j + 3) * D + c];
#pragma unroll
          for (int r = 0; r < C::RPT; ++r) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                Ps + (rg * C::RPT + r) * kBK + j);
            float a = acc[n][r];
            a = fmaf(p4.x, v0, a);
            a = fmaf(p4.y, v1, a);
            a = fmaf(p4.z, v2, a);
            a = fmaf(p4.w, v3, a);
            acc[n][r] = a;
          }
        }
      }
    }
  }

  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < C::RPW; ++r) l_s[warp + 8 * r] = l_run[r];
  }
  __syncthreads();
  const int64_t HD = static_cast<int64_t>(H) * D;
#pragma unroll
  for (int n = 0; n < C::NCOL; ++n) {
    const int c = col + n * C::TPC;
    if (c >= D) continue;
#pragma unroll
    for (int r = 0; r < C::RPT; ++r) {
      const int i = rg * C::RPT + r;
      if (q0 + i < Sq) {
        const float o = acc[n][r] / fmaxf(l_s[i], 1e-30f);
        out[(static_cast<int64_t>(b) * Sq + q0 + i) * HD + h * D + c] =
            from_f<T>(o);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* mask,
           void* out, int B, int Sq, int Sk, int H, int64_t q_bs, int64_t q_rs,
           int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
           float scale, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  kern<<<grid, kThreads, C::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), Sq, Sk, H, q_bs,
      q_rs, k_bs, k_rs, v_bs, v_rs, scale, causal);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* mask, void* out, int B, int Sq, int Sk, int H,
               int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
               int64_t v_bs, int64_t v_rs, float scale, int causal,
               cudaStream_t st) {
  switch (D) {
    case 128:
      return launch<T, 128>(q, k, v, mask, out, B, Sq, Sk, H, q_bs, q_rs,
                            k_bs, k_rs, v_bs, v_rs, scale, causal, st);
    case 256:
      return launch<T, 256>(q, k, v, mask, out, B, Sq, Sk, H, q_bs, q_rs,
                            k_bs, k_rs, v_bs, v_rs, scale, causal, st);
    case 384:
      return launch<T, 384>(q, k, v, mask, out, B, Sq, Sk, H, q_bs, q_rs,
                            k_bs, k_rs, v_bs, v_rs, scale, causal, st);
    case 512:
      return launch<T, 512>(q, k, v, mask, out, B, Sq, Sk, H, q_bs, q_rs,
                            k_bs, k_rs, v_bs, v_rs, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (B, S, H*D) with unit stride along the last axis and the given
// batch/row strides (elements); mask: (B, Sk) int32, contiguous; out:
// (B, Sq, H*D) contiguous, same type as q. dtype: 0 = f32, 1 = bf16.
extern "C" int bmhrl_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, const int* mask, void* out,
                                     int B, int Sq, int Sk, int H, int D,
                                     int64_t q_bs, int64_t q_rs, int64_t k_bs,
                                     int64_t k_rs, int64_t v_bs, int64_t v_rs,
                                     float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == bmhrl::kF32)
    return dispatch_d<float>(D, q, k, v, mask, out, B, Sq, Sk, H, q_bs, q_rs,
                             k_bs, k_rs, v_bs, v_rs, scale, causal, st);
  if (dtype == bmhrl::kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, mask, out, B, Sq, Sk, H,
                                     q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale,
                                     causal, st);
  return cudaErrorInvalidValue;
}
