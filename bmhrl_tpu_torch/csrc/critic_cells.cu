// One LSTM or GRU cell step of the frozen SegmentCritic, for sm_90a.
//
// Replaces the TPU kernels of bmhrl_tpu/ops/critic_kernels.py:
//   _lstm_kernel :64  gates = x W_ih^T + h W_hh^T + (b_ih + b_hh), gate
//                     order i, f, g, o; c' = f c + i g; h' = o tanh(c')
//   _gru_kernel  :87  torch semantics: r, z = sigmoid(x W + b_i + h W + b_h),
//                     n = tanh(x W_n + b_in + r (h W_hn + b_hn)),
//                     h' = (1 - z) n + z h
// The gate product over [x, h] and the state update are fused: a block
// computes all four gate columns of 32 hidden units for 32 batch rows, so
// each thread holds i, f, g, o (LSTM) or r, z, x_n, h_n (GRU) of its units in
// registers and writes h' (and c') directly; the gates never reach memory.
// The TPU kernels padded the hidden width 600 to 640 for the 128-lane
// vector unit; here H = 600 runs unpadded, with ragged edges masked.
//
// Exact f32 on the CUDA cores (no TF32), as the TPU kernels were.
//
// Bound: at the flagship (B = 256, H = 600, K = 300 or 600) a cell is
// 2*B*4H*(K+H) operations on about (4H*(K+H) + B*(K+3H)) * 4 bytes, about
// 60 operations per byte, above the f32 balance of the card, so it is
// bound by operations.
#include "common.cuh"

namespace {

using bmhrl::sigmoidf;

constexpr int BM = 32;   // batch rows per block
constexpr int BN = 32;   // hidden units per block
constexpr int BK = 16;   // contraction step
constexpr int kThreads = 256;

// column `gk` of gate row `gate` (of 4) for hidden unit n, over the
// concatenated contraction axis [x (K), h (H)]
template <bool LSTM>
__device__ __forceinline__ float gate_weight(const float* __restrict__ w_ih,
                                             const float* __restrict__ w_hh,
                                             int gate, int n, int gk, int K,
                                             int H) {
  if (LSTM || gate < 2) {
    return gk < K ? w_ih[(static_cast<int64_t>(gate) * H + n) * K + gk]
                  : w_hh[(static_cast<int64_t>(gate) * H + n) * H + gk - K];
  }
  // GRU: gate 2 is the x-part of n, gate 3 its h-part (kept apart because
  // r multiplies only the h-part)
  if (gate == 2)
    return gk < K ? w_ih[(2 * static_cast<int64_t>(H) + n) * K + gk] : 0.f;
  return gk < K ? 0.f : w_hh[(2 * static_cast<int64_t>(H) + n) * H + gk - K];
}

template <bool LSTM>
__global__ void __launch_bounds__(kThreads)
    cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ c, const float* __restrict__ w_ih,
                const float* __restrict__ w_hh,
                const float* __restrict__ b_ih,
                const float* __restrict__ b_hh, float* __restrict__ h_out,
                float* __restrict__ c_out, int B, int K, int H) {
  __shared__ float As[BK][BM + 1];       // [k][row], padded against conflicts
  __shared__ float Ws[BK][4 * BN + 1];   // [k][gate * BN + unit]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const int u = tid % 16, rg = tid / 16;  // units u, u+16; rows rg, rg+16
  const int KT = K + H;

  float acc[2][2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[a][j][g] = 0.f;

  for (int k0 = 0; k0 < KT; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int row = idx / BK, kk = idx % BK;
      const int gr = r0 + row, gk = k0 + kk;
      float a = 0.f;
      if (gr < B && gk < KT)
        a = gk < K ? x[static_cast<int64_t>(gr) * K + gk]
                   : h[static_cast<int64_t>(gr) * H + gk - K];
      As[kk][row] = a;
    }
    for (int idx = tid; idx < 4 * BN * BK; idx += kThreads) {
      const int wr = idx / BK, kk = idx % BK;
      const int gate = wr / BN, unit = wr % BN;
      const int n = n0 + unit, gk = k0 + kk;
      Ws[kk][gate * BN + unit] =
          (n < H && gk < KT) ? gate_weight<LSTM>(w_ih, w_hh, gate, n, gk, K, H)
                             : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = As[kk][rg], a1 = As[kk][rg + 16];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float w = Ws[kk][g * BN + u + 16 * j];
          acc[0][j][g] = fmaf(a0, w, acc[0][j][g]);
          acc[1][j][g] = fmaf(a1, w, acc[1][j][g]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = r0 + rg + 16 * a;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + u + 16 * j;
      if (n >= H) continue;
      const int64_t o = static_cast<int64_t>(row) * H + n;
      const float* g = acc[a][j];
      if (LSTM) {
        // b_ih holds b_ih + b_hh for the LSTM
        const float gi = sigmoidf(g[0] + b_ih[n]);
        const float gf = sigmoidf(g[1] + b_ih[H + n]);
        const float gg = tanhf(g[2] + b_ih[2 * H + n]);
        const float go = sigmoidf(g[3] + b_ih[3 * H + n]);
        const float cn = gf * c[o] + gi * gg;
        c_out[o] = cn;
        h_out[o] = go * tanhf(cn);
      } else {
        const float r = sigmoidf(g[0] + b_ih[n] + b_hh[n]);
        const float z = sigmoidf(g[1] + b_ih[H + n] + b_hh[H + n]);
        const float nn =
            tanhf(g[2] + b_ih[2 * H + n] + r * (g[3] + b_hh[2 * H + n]));
        h_out[o] = (1.f - z) * nn + z * h[o];
      }
    }
  }
}

}  // namespace

// lstm != 0: x (B, K), h, c (B, H), w_ih (4H, K), w_hh (4H, H),
// b_ih = b_ih + b_hh (4H); writes h_out, c_out (B, H). b_hh is unused.
// lstm == 0: x (B, K), h (B, H), w_ih (3H, K), w_hh (3H, H), b_ih, b_hh
// (3H); writes h_out (B, H). c and c_out are unused. All f32, contiguous.
extern "C" int bmhrl_rnn_cell(int lstm, const float* x, const float* h,
                              const float* c, const float* w_ih,
                              const float* w_hh, const float* b_ih,
                              const float* b_hh, float* h_out, float* c_out,
                              int B, int K, int H, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0) return cudaErrorInvalidValue;
  dim3 grid((H + BN - 1) / BN, (B + BM - 1) / BM);
  auto st = static_cast<cudaStream_t>(stream);
  if (lstm)
    cell_kernel<true><<<grid, kThreads, 0, st>>>(x, h, c, w_ih, w_hh, b_ih,
                                                 b_hh, h_out, c_out, B, K, H);
  else
    cell_kernel<false><<<grid, kThreads, 0, st>>>(x, h, c, w_ih, w_hh, b_ih,
                                                  b_hh, h_out, c_out, B, K, H);
  return cudaGetLastError();
}
