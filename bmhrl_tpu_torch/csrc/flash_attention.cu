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
//                      the tensor cores as 3xTF32 (f32 accuracy); the route
//                      keeps its name and launch counter, "simt".
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
// long-source 800x800 site (400 per byte) is bound by operations. In f32
// each product is three tf32 products: the operations bound is 3 * 4 Sq Sk
// d / 495 TFLOP/s, about 103 operations per f32 byte, so at B=256, 4 heads
// of d=256, V<-V (128x128, 537 MB, 17.2 GFLOP) is bound by bytes (0.160
// ms) and A<-A (256x256, 0.416 ms), 300x800 and 800x800 by operations. On
// the CUDA cores (67 TFLOP/s) V<-V alone would take 0.257 ms.
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
//
// flash_simt_kernel (3xTF32): one block of 8 warps (4 at f32 d = 512, where
// 8 do not fit, and 4 at d <= 256 where 8-warp blocks would leave over half
// the SMs idle; ops/attention.py flash_simt_warps) per (batch row, head,
// query tile). Each warp owns 16 queries; at d >= 384 two warps share
// them, each owning half of O's columns, so O stays at 96 or 128 registers
// a thread, and each computes their 16 x 16 S tile itself (no exchange
// through shared memory: those widths are no model's main path, and the
// second S adds half again the products there). Q is staged once;
// K/V tiles of 16 keys arrive by 16-byte cp.async in a 2-stage ring
// (the next tile loads while this one is used), rows padded by 16 bytes so
// every fragment load is free of bank conflicts: f32 Q and K by ldmatrix as
// 8x4 tiles of 32-bit words, V as rows (2t, 2t + 1) of column g. Each f32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), rounded to
// nearest with ties away from zero (cvt.rna.tf32's result, in two integer
// instructions), and each product is lo hi + hi lo + hi hi on mma.sync
// m16n8k8 tf32 with f32 accumulators: about 22 bits of mantissa, none of it
// single-pass TF32. A bf16 operand is exact in tf32: its lo terms drop out.
// S accumulates in two mma chains (even and odd 8-column steps); the online
// softmax runs on the S fragment in registers in f32 (expf), P enters PV as
// the fragment holds it, its k axis (t, t + 4) read as keys (2t, 2t + 1)
// and V's rows taken in the same order.
//   ptxas -v (sm_90a), no spill at any width: f32 d 128 / 256 / 384 / 512:
//   138 / 208 / 178 / 209 registers; bf16 d 384 / 512: 164 / 197.
//   Shared memory a block: f32 d 128 101,504 bytes (8 warps) or 67,712
//   (4), d 256 199,808 or 133,248, d 384 198,784, d 512 198,272 (4
//   warps); bf16 d 384 100,480, d 512 133,248.
#include "async_mma.cuh"
#include "common.cuh"

namespace {

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
// 3xTF32 route (f32, and bf16 at d = 384, 512), on the tensor cores
namespace simt {

constexpr int BKV = 16;  // keys per tile

template <typename T, int D>
struct Cfg {
  static constexpr int WPQ = D <= 256 ? 1 : 2;  // warps sharing 16 queries
  static constexpr int DW = D / WPQ;            // O columns per warp
  static constexpr int NT = DW / 8;             // 8-column tiles of O
  static constexpr int EPC = 16 / sizeof(T);    // elements per 16 bytes
  static constexpr int RS = D + EPC;  // shared row stride: +16 bytes
  static constexpr int CH = D / EPC;  // 16-byte chunks per row
  // f32 operands are split into two tf32 terms; bf16 ones are exact
  static constexpr bool kSplit = sizeof(T) == 4;
};

// shared memory of a block of `warps` warps: Q (16 * warps / WPQ rows),
// two stages of K and V (BKV rows each) and of the mask
template <typename T, int D>
size_t smem_bytes(int warps) {
  using C = Cfg<T, D>;
  return sizeof(T) * C::RS * (16 * warps / C::WPQ + 4 * BKV) +
         sizeof(int) * 2 * BKV;
}

// rows x D from src (row stride rs elements) into dst (row stride RS);
// rows >= valid arrive as zeros
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t rs,
                                          int rows, int valid, int tid,
                                          int nthreads) {
  using C = Cfg<T, D>;
  for (int idx = tid; idx < rows * C::CH; idx += nthreads) {
    const int r = idx / C::CH, c = idx % C::CH;
    const bool ok = r < valid;
    bmhrl::cp_async16(dst + r * C::RS + c * C::EPC,
                      ok ? src + r * rs + c * C::EPC : src, ok ? 16 : 0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256, 1)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ mask,
                      T* __restrict__ out, int Sq, int Sk, int H,
                      int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                      int64_t v_bs, int64_t v_rs, float scale, int causal) {
  using C = Cfg<T, D>;
  constexpr int RS = C::RS;
  constexpr bool SP = C::kSplit;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthreads = blockDim.x, warps = nthreads >> 5;
  const int BQ = 16 * warps / C::WPQ;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * RS;         // 2 stages
  T* Vs = Ks + 2 * BKV * RS;    // 2 stages
  int* Ms = reinterpret_cast<int*>(Vs + 2 * BKV * RS);  // 2 x BKV

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // warp = 16-query group qg, column part c0
  const int qg = warp / C::WPQ, c0 = warp % C::WPQ * C::DW;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* kb = k + b * k_bs + h * D;
  const T* vb = v + b * v_bs + h * D;
  const int* mb = mask + static_cast<int64_t>(b) * Sk;
  const int n_tiles = (Sk + BKV - 1) / BKV;

  auto load_kv = [&](int t) {
    const int k0 = t * BKV, valid = min(BKV, Sk - k0), st = t & 1;
    load_rows<T, D>(Ks + st * BKV * RS, kb + k0 * k_rs, k_rs, BKV, valid,
                    tid, nthreads);
    load_rows<T, D>(Vs + st * BKV * RS, vb + k0 * v_rs, v_rs, BKV, valid,
                    tid, nthreads);
    if (tid < BKV) {
      const bool ok = tid < valid;
      bmhrl::cp_async4(Ms + st * BKV + tid, mb + k0 + (ok ? tid : 0),
                       ok ? 4 : 0);
    }
  };
  load_rows<T, D>(Qs, q + b * q_bs + q0 * q_rs + h * D, q_rs, BQ, Sq - q0,
                  tid, nthreads);
  load_kv(0);
  bmhrl::cp_async_commit();

  float o[C::NT][4];
#pragma unroll
  for (int n = 0; n < C::NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int qrow = q0 + 16 * qg + g;  // query of s[.][0..1]; +8 for [2..3]
  const T* Qw = Qs + (16 * qg + g) * RS + t4;
  // ldmatrix row addresses (f32): Q rows 16 qg + (lane & 7) + 8 (lane >> 3
  // & 1) at column 4 (lane >> 4); key rows (lane & 7) + 8 (lane >> 4) at
  // column 4 (lane >> 3 & 1)
  const uint32_t q_addr = bmhrl::smem_u32(
      Qs + (16 * qg + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
      4 * (lane >> 4));
  const uint32_t k_addr = bmhrl::smem_u32(
      Ks + ((lane & 7) + 8 * (lane >> 4)) * RS + 4 * ((lane >> 3) & 1));
  const uint32_t k_stage = sizeof(T) * BKV * RS;

  for (int t = 0; t < n_tiles; ++t) {
    bmhrl::cp_async_wait<0>();
    __syncthreads();  // tile t has landed; tile t - 1 is consumed
    if (t + 1 < n_tiles) load_kv(t + 1);
    bmhrl::cp_async_commit();
    const int k0 = t * BKV;
    const T* Kt = Ks + ((t & 1) * BKV + g) * RS + t4;
    const T* Vt = Vs + ((t & 1) * BKV + 2 * t4) * RS + c0 + g;
    const int* Mt = Ms + (t & 1) * BKV;

    // S = Q K^T, 16 queries x 16 keys: s[j][e] is row qrow + 8(e/2), key
    // k0 + 8j + 2 t4 + e%2. Even and odd 8-column steps accumulate apart
    // (two independent mma chains per key tile), summed after.
    float s[2][4], s2[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float af[4], bf[2][2];
        if constexpr (SP) {
          // f32 rows of 16 bytes: one ldmatrix each for Q's A fragment and
          // the two key tiles' B fragments
          float kf[4];
          bmhrl::ldmatrix_f32_x4(af, q_addr + 4 * (kk + 8 * h));
          bmhrl::ldmatrix_f32_x4(kf, k_addr + (t & 1) * k_stage +
                                         4 * (kk + 8 * h));
          bf[0][0] = kf[0];
          bf[0][1] = kf[1];
          bf[1][0] = kf[2];
          bf[1][1] = kf[3];
        } else {
          const int c = kk + 8 * h;
          af[0] = to_f(Qw[c]);
          af[1] = to_f(Qw[8 * RS + c]);
          af[2] = to_f(Qw[c + 4]);
          af[3] = to_f(Qw[8 * RS + c + 4]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            bf[j][0] = to_f(Kt[8 * j * RS + c]);
            bf[j][1] = to_f(Kt[8 * j * RS + c + 4]);
          }
        }
        uint32_t ah[4], al[4];
        bmhrl::split_n<SP>(af, ah, al);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bh[2], bl[2];
          bmhrl::split_n<SP>(bf[j], bh, bl);
          bmhrl::mma_3xtf32<SP, SP>(h ? s2[j] : s[j], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];

    // online softmax on the fragment
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
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
      corr[r] = m_run[r] == -INFINITY ? 0.f : expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == -INFINITY ? 0.f : expf(x - m_run[e >> 1]);
        psum[e >> 1] += p;      // l sums the unrounded p
        s[j][e] = round_to<T>(p);  // P enters PV in the input type
      }
    }
    // per-thread partial l (its own keys); the quad sums at the end
    l_run[0] = l_run[0] * corr[0] + psum[0];
    l_run[1] = l_run[1] * corr[1] + psum[1];
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V over the warp's columns. P is the A operand as the S
    // fragment holds it, its k axis read as keys (2 t4, 2 t4 + 1) for
    // (t4, t4 + 4); V's rows are taken in the same order.
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float pf[4] = {s[jj][0], s[jj][2], s[jj][1], s[jj][3]};
      uint32_t ph[4], pl[4];
      bmhrl::split_n<SP>(pf, ph, pl);
      const T* Vj = Vt + 8 * jj * RS;
#pragma unroll
      for (int n = 0; n < C::NT; ++n) {
        const float bf[2] = {to_f(Vj[8 * n]), to_f(Vj[RS + 8 * n])};
        uint32_t bh[2], bl[2];
        bmhrl::split_n<SP>(bf, bh, bl);
        bmhrl::mma_3xtf32<SP, SP>(o[n], ph, pl, bh, bl);
      }
    }
  }

  // the rows' l (the quad's partial sums)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // normalise; each quad writes 8 adjacent columns of its two rows
  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_tot[r] = 1.f / fmaxf(l_run[r], 1e-30f);
  const int64_t HD = static_cast<int64_t>(H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= Sq) continue;
    T* orow = out + (static_cast<int64_t>(b) * Sq + row) * HD + h * D + c0 +
              2 * t4;
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      const float x0 = o[n][2 * r] * l_tot[r], x1 = o[n][2 * r + 1] * l_tot[r];
      if constexpr (SP) {
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            bmhrl::pack_bf16x2(x0, x1);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* mask,
           void* out, int B, int Sq, int Sk, int H, int64_t q_bs, int64_t q_rs,
           int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
           float scale, int causal, int warps, cudaStream_t stream) {
  using C = Cfg<T, D>;
  if (warps != 4 && warps != 8) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, D>(warps);
  if (smem > bmhrl::kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_simt_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int BQ = 16 * warps / C::WPQ;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), Sq, Sk, H, q_bs,
      q_rs, k_bs, k_rs, v_bs, v_rs, scale, causal);
  return cudaGetLastError();
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

// f32 at D in {128, 256, 384, 512}, bf16 at D in {384, 512}; q, k, v
// 16-byte aligned with strides that are multiples of 16 bytes. warps (4 or
// 8): the block's warps (ops/attention.py: flash_simt_warps).
extern "C" int bmhrl_flash_attention_simt(int dtype, const void* q,
                                          const void* k, const void* v,
                                          const int* mask, void* out, int B,
                                          int Sq, int Sk, int H, int D,
                                          int64_t q_bs, int64_t q_rs,
                                          int64_t k_bs, int64_t k_rs,
                                          int64_t v_bs, int64_t v_rs,
                                          float scale, int causal, int warps,
                                          void* stream) {
  const int64_t epc = dtype == bmhrl::kF32 ? 4 : 8;  // elements in 16 bytes
  if (bad_dims(B, Sq, Sk, H) || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 || q_bs % epc || q_rs % epc ||
      k_bs % epc || k_rs % epc || v_bs % epc || v_rs % epc)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define BMHRL_FLASH_SIMT(T, DD)                                              \
  if (D == DD)                                                               \
    return simt::launch<T, DD>(q, k, v, mask, out, B, Sq, Sk, H, q_bs, q_rs, \
                               k_bs, k_rs, v_bs, v_rs, scale, causal, warps, \
                               st);
  if (dtype == bmhrl::kF32) {
    BMHRL_FLASH_SIMT(float, 128)
    BMHRL_FLASH_SIMT(float, 256)
    BMHRL_FLASH_SIMT(float, 384)
    BMHRL_FLASH_SIMT(float, 512)
  } else if (dtype == bmhrl::kBF16) {
    BMHRL_FLASH_SIMT(__nv_bfloat16, 384)
    BMHRL_FLASH_SIMT(__nv_bfloat16, 512)
  }
#undef BMHRL_FLASH_SIMT
  return cudaErrorInvalidValue;
}
