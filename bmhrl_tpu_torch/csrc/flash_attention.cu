// Flash attention on un-headed (B, S, H*d) projections, for sm_90a.
//
// Replaces two TPU kernels of the JAX package:
//   _flash_bsd_kernel    bmhrl_tpu/ops/attention.py:89  (one pass, all keys
//                        resident in VMEM)
//   _flash_stream_kernel bmhrl_tpu/ops/attention.py:269 (online softmax over
//                        key blocks, chosen when no one-pass tile fits VMEM)
// Both compute the same function. On Hopper a block's shared memory is
// 227 KB, so both kernels here stream the keys with a running max m,
// normaliser l and an f32 accumulator, which covers both TPU kernels at
// every source length. Two routes (ops/attention.py, flash_route):
//   flash_tc_kernel    bf16 at d in {128, 256}: the serving and training
//                      paths, on the tensor cores (training's gradient is
//                      the recompute in ops/attention.py, no kernel);
//   flash_simt_kernel  f32 at d in {128..512}, bf16 at d in {384, 512}: on
//                      the CUDA cores in f32.
//
// Semantics kept from the TPU kernels, by both routes:
//   - s = (q . k) * 1/sqrt(d) in f32; -1e9 where the key mask is 0 or, with
//     `causal`, where the key lies after the query;
//   - keys past Sk are skipped (p = 0, left out of the max), never filled,
//     so a fully-masked row gives mean(V) over the actual Sk keys whatever
//     the tile size;
//   - p is rounded to the input type before the PV product, l sums the
//     unrounded p, and the output is normalised after PV.
//
// Bound: per (row, head) the work is 4*Sq*Sk*d operations on 2*(Sq+Sk)*d
// elements moved, Sq*Sk/(Sq+Sk) operations per bf16 byte: 64 at 128x128,
// 85 at 128x256, 128 at 256x256, below the card's ~295 bf16 operations per
// byte, so the flagship's encoder sites are bound by BYTES. Only the
// long-source 800x800 site (400 per byte) is bound by operations.
//
// flash_tc_kernel: one block of 8 warps per (batch row, head, 128 queries),
// so at Sq <= 128 each head's K/V is read from device memory once. Q is
// staged once in shared memory; K/V tiles of 64 keys arrive by 16-byte
// cp.async in a 2-stage ring (the next tile loads while this one is
// consumed). Shared rows are padded by 16 bytes, so the 8 row addresses of
// every ldmatrix fall in distinct bank groups. Each warp owns 16 queries:
// S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, f32
// accumulators), the online softmax runs on the S fragment in registers, and
// P, rounded to bf16 in registers, is the A operand of PV as it stands (the
// S accumulator layout of two adjacent 8-key tiles is the A fragment of one
// 16-key step). The output leaves through the warp's own Q rows in shared
// memory as 16-byte stores.
#include "async_mma.cuh"
#include "common.cuh"

namespace {

using bmhrl::from_f;
using bmhrl::kMaskFill;
using bmhrl::round_to;
using bmhrl::to_f;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// tensor-core route
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 16 * kWarps;  // queries per block, 16 per warp
constexpr int BKV = 64;          // keys per tile

template <int D>
struct Cfg {
  static constexpr int RS = D + 8;   // shared row stride (bf16): +16 bytes
  static constexpr int CH = D / 8;   // 16-byte chunks per row
  static constexpr int q_elems = BQ * RS;
  static constexpr int kv_elems = BKV * RS;
  static constexpr size_t smem =
      sizeof(bf16) * (q_elems + 4 * kv_elems) + sizeof(int) * 2 * BKV;
};

// rows x D from src (row stride rs elements) into dst (row stride RS);
// rows >= valid arrive as zeros
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t rs, int rows, int valid,
                                          int tid) {
  using C = Cfg<D>;
  for (int idx = tid; idx < rows * C::CH; idx += kThreads) {
    const int r = idx / C::CH, c = idx % C::CH;
    const bool ok = r < valid;
    bmhrl::cp_async16(dst + r * C::RS + c * 8,
                      ok ? src + r * rs + c * 8 : src, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ mask,
                    bf16* __restrict__ out, int Sq, int Sk, int H,
                    int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                    int64_t v_bs, int64_t v_rs, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int NT = D / 8;      // 8-column tiles of O
  constexpr int ST = BKV / 8;    // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + C::q_elems;        // 2 stages
  bf16* Vs = Ks + 2 * C::kv_elems;   // 2 stages
  int* Ms = reinterpret_cast<int*>(Vs + 2 * C::kv_elems);  // 2 x BKV

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* kb = k + b * k_bs + h * D;
  const bf16* vb = v + b * v_bs + h * D;
  const int* mb = mask + static_cast<int64_t>(b) * Sk;
  const int n_tiles = (Sk + BKV - 1) / BKV;

  auto load_kv = [&](int t, int s) {
    const int k0 = t * BKV, valid = min(BKV, Sk - k0);
    load_rows<D>(Ks + s * C::kv_elems, kb + k0 * k_rs, k_rs, BKV, valid, tid);
    load_rows<D>(Vs + s * C::kv_elems, vb + k0 * v_rs, v_rs, BKV, valid, tid);
    if (tid < BKV) {
      const bool ok = tid < valid;
      bmhrl::cp_async4(Ms + s * BKV + tid, mb + k0 + (ok ? tid : 0),
                       ok ? 4 : 0);
    }
  };
  load_rows<D>(Qs, q + b * q_bs + q0 * q_rs + h * D, q_rs, BQ, Sq - q0, tid);
  load_kv(0, 0);
  bmhrl::cp_async_commit();

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int qrow = q0 + 16 * warp + g;  // query of d[0..1]; +8 for d[2..3]
  // ldmatrix row addresses: Q (A operand), K (B of QK^T), V (B of PV, trans)
  const uint32_t q_addr = bmhrl::smem_u32(
      Qs + (16 * warp + (lane & 15)) * C::RS + (lane >> 4) * 8);
  const int k_off = (lane & 7) * C::RS + (lane >> 3) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * C::RS +
                    (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) & 1);  // its stage was consumed at t - 1
      bmhrl::cp_async_commit();
      bmhrl::cp_async_wait<1>();
    } else {
      bmhrl::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + (t & 1) * C::kv_elems;
    const bf16* Vt = Vs + (t & 1) * C::kv_elems;
    const int* Mt = Ms + (t & 1) * BKV;
    const int k0 = t * BKV;

    // S = Q K^T: 16 queries x 64 keys per warp
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 32) {
      uint32_t a0[4], a1[4];
      bmhrl::ldmatrix_x4(a0, q_addr + kk * 2);
      bmhrl::ldmatrix_x4(a1, q_addr + (kk + 16) * 2);
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        uint32_t bk[4];
        bmhrl::ldmatrix_x4(bk,
                           bmhrl::smem_u32(Kt + 8 * j * C::RS + kk + k_off));
        bmhrl::mma_bf16(s[j], a0, bk[0], bk[1]);
        bmhrl::mma_bf16(s[j], a1, bk[2], bk[3]);
      }
    }

    // online softmax on the fragment: d[e] is row qrow + 8*(e/2), key
    // k0 + 8j + 2*t4 + e%2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * scale;
        if (k0 + kj >= Sk) {
          x = -INFINITY;
        } else if (Mt[kj] <= 0 || (causal && k0 + kj > qrow + 8 * (e >> 1))) {
          x = kMaskFill;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: key k0 < Sk
      corr[r] = m_run[r] == -INFINITY ? 0.f : __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == -INFINITY ? 0.f : __expf(x - m_run[e >> 1]);
        psum[e >> 1] += p;
        s[j][e] = p;
      }
    }
    // per-thread partial l (its own columns); the quad sums at the end
    l_run[0] = l_run[0] * corr[0] + psum[0];
    l_run[1] = l_run[1] * corr[1] + psum[1];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P (bf16) straight from the S fragment as the A operand
#pragma unroll
    for (int jj = 0; jj < BKV / 16; ++jj) {
      const uint32_t pa[4] = {
          bmhrl::pack_bf16x2(s[2 * jj][0], s[2 * jj][1]),
          bmhrl::pack_bf16x2(s[2 * jj][2], s[2 * jj][3]),
          bmhrl::pack_bf16x2(s[2 * jj + 1][0], s[2 * jj + 1][1]),
          bmhrl::pack_bf16x2(s[2 * jj + 1][2], s[2 * jj + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bv[4];
        bmhrl::ldmatrix_x4_trans(
            bv, bmhrl::smem_u32(Vt + 16 * jj * C::RS + 8 * n + v_off));
        bmhrl::mma_bf16(o[n], pa, bv[0], bv[1]);
        bmhrl::mma_bf16(o[n + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is free for the load at t + 1
  }

  // normalise, stage the warp's 16 rows in its own Q rows, store 16 bytes
  // per lane
  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_tot[r] = fmaxf(l, 1e-30f);
  }
  bf16* Ow = Qs + 16 * warp * C::RS;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t4;
    *reinterpret_cast<uint32_t*>(Ow + g * C::RS + c) =
        bmhrl::pack_bf16x2(o[n][0] / l_tot[0], o[n][1] / l_tot[0]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * C::RS + c) =
        bmhrl::pack_bf16x2(o[n][2] / l_tot[1], o[n][3] / l_tot[1]);
  }
  __syncwarp();
  const int64_t HD = static_cast<int64_t>(H) * D;
  for (int idx = lane; idx < 16 * C::CH; idx += 32) {
    const int r = idx / C::CH, c = idx % C::CH;
    const int qi = q0 + 16 * warp + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(b) * Sq + qi) *
                                          HD + h * D + c * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * C::RS + c * 8);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask,
           void* out, int B, int Sq, int Sk, int H, int64_t q_bs,
           int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
           int64_t v_rs, float scale, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  static_assert(C::smem <= bmhrl::kMaxSmem, "tile exceeds shared memory");
  auto kern = flash_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, C::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), Sq, Sk, H,
      q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, causal);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA-core route (f32, and bf16 at d = 384, 512): the first version of
// this kernel. Tiles of 32 keys in f32 shared memory, one key per lane for
// the scores, float4 reads from rows padded to d + 4 floats.
namespace simt {

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
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ mask,
                      T* __restrict__ out, int Sq, int Sk, int H,
                      int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                      int64_t v_bs, int64_t v_rs, float scale, int causal) {
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
  auto kern = flash_simt_kernel<T, D>;
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

}  // namespace simt

bool bad_dims(int B, int Sq, int Sk, int H) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || H > 65535 || B > 65535;
}

}  // namespace

// Both entry points: q, k, v (B, S, H*D) with unit stride along the last
// axis and the given batch/row strides (elements); mask (B, Sk) int32,
// contiguous; out (B, Sq, H*D) contiguous, same type as q. dtype: 0 = f32,
// 1 = bf16.

// bf16 at D in {128, 256}; q, k, v 16-byte aligned with strides that are
// multiples of 8 elements.
extern "C" int bmhrl_flash_attention_tc(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const int* mask, void* out, int B,
                                        int Sq, int Sk, int H, int D,
                                        int64_t q_bs, int64_t q_rs,
                                        int64_t k_bs, int64_t k_rs,
                                        int64_t v_bs, int64_t v_rs,
                                        float scale, int causal,
                                        void* stream) {
  if (bad_dims(B, Sq, Sk, H) || dtype != bmhrl::kBF16)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return tc::launch<128>(q, k, v, mask, out, B, Sq, Sk, H, q_bs, q_rs, k_bs,
                           k_rs, v_bs, v_rs, scale, causal, st);
  if (D == 256)
    return tc::launch<256>(q, k, v, mask, out, B, Sq, Sk, H, q_bs, q_rs, k_bs,
                           k_rs, v_bs, v_rs, scale, causal, st);
  return cudaErrorInvalidValue;
}

// f32 or bf16 at D in {128, 256, 384, 512}
extern "C" int bmhrl_flash_attention_simt(int dtype, const void* q,
                                          const void* k, const void* v,
                                          const int* mask, void* out, int B,
                                          int Sq, int Sk, int H, int D,
                                          int64_t q_bs, int64_t q_rs,
                                          int64_t k_bs, int64_t k_rs,
                                          int64_t v_bs, int64_t v_rs,
                                          float scale, int causal,
                                          void* stream) {
  if (bad_dims(B, Sq, Sk, H)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == bmhrl::kF32)
    return simt::dispatch_d<float>(D, q, k, v, mask, out, B, Sq, Sk, H, q_bs,
                                   q_rs, k_bs, k_rs, v_bs, v_rs, scale,
                                   causal, st);
  if (dtype == bmhrl::kBF16)
    return simt::dispatch_d<__nv_bfloat16>(D, q, k, v, mask, out, B, Sq, Sk,
                                           H, q_bs, q_rs, k_bs, k_rs, v_bs,
                                           v_rs, scale, causal, st);
  return cudaErrorInvalidValue;
}
