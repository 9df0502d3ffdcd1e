// One LSTM or GRU cell step of the frozen SegmentCritic, over weights packed
// once per decode, for sm_90a.
//
// Replaces the TPU kernels of bmhrl_tpu/ops/critic_kernels.py:
//   _lstm_kernel :64  gates = x W_ih^T + h W_hh^T + (b_ih + b_hh), gate
//                     order i, f, g, o; c' = f c + i g; h' = o tanh(c')
//   _gru_kernel  :87  torch semantics: r, z = sigmoid(x W + b_i + h W + b_h),
//                     n = tanh(x W_n + b_in + r (h W_hn + b_hn)),
//                     h' = (1 - z) n + z h
// Exact f32 on the CUDA cores (no TF32), as the TPU kernels were.
//
// Packed weights (ops/critic_kernels.py, pack_lstm / pack_gru; BN and BK
// below are UNITS and KTILE there, and the entry points refuse a buffer
// whose shape is not this layout's). The contraction axis is [x (K), h (H)],
// each half zero-padded to a multiple of BK rows. For the tile t of BN
// hidden units, w[t] is one contiguous (Kp + Hp, BN * G) block whose k-row
// holds, unit by unit, that unit's G gate weights: LSTM (i, f, g, o); GRU
// (r, z, n_x) in the x-half rows and (r, z, n_h) in the h-half rows. So a
// block's k-tile of weights is one run of memory, loaded with 16-byte
// cp.async, and no weight is gathered per call. The biases are (T*BN, 4):
// LSTM b_ih + b_hh; GRU (b_ir + b_hr, b_iz + b_hz, b_in, b_hn).
//
// A block computes every gate of BN = 8 units for BM = 128 batch rows:
// grid (ceil(H/8), ceil(B/128)), 150 blocks at B = 256, H = 600 (75 at
// B = 32, where 32 of each block's 128 rows are live). Its 256 threads are
// two k-groups of 128 that split the contraction (even and odd k-tiles) and
// add their partial sums through shared memory at the end: a block has 8
// warps in flight while each thread keeps 32 accumulators. Thread (tm, tn) =
// (tid / 8, tid % 8) of a k-group owns rows tm + 16i (i < 8) of unit tn:
// 8 rows x 4 gate sums = 32 f32 accumulators (LSTM i, f, g, o; GRU r, z,
// n_x, n_h), so the nonlinearity and the state update run in registers and
// the gates never reach memory. The GRU runs its x-half with (r, z, n_x)
// and its h-half with (r, z, n_h): no multiply-adds on zeros. Per 4 k the
// thread reads 8 float4 of activations and 4 float4 (LSTM) or 12 floats
// (GRU) of weights for 128 (96) multiply-adds; k-tiles of 32 arrive by
// cp.async in a 2-stage ring, so the next pair of tiles loads under this
// pair's math. Each block streams its units' weights once per ceil(B/128)
// row blocks.
//
// Bound: at the flagship (B = 256, H = 600, K = 300 or 600) a cell is
// 2*B*G*H*(K+H) operations on about (G*H*(K+H) + B*(K+3H)) * 4 bytes, about
// 60 operations per byte, above the card's f32 balance (~20), so it is
// bound by operations.
#include "async_mma.cuh"
#include "common.cuh"

namespace {

using bmhrl::sigmoidf;

constexpr int BM = 128;  // batch rows per block
constexpr int BN = 8;    // hidden units per block (UNITS)
constexpr int BK = 32;   // contraction tile (KTILE)
constexpr int KG = 2;    // k-groups: warps 0-3 take the even k-tiles, 4-7
                         // the odd ones
constexpr int kGroup = 128;  // threads of one k-group
constexpr int NSTAGE = 2;    // depth of the cp.async ring
constexpr int kThreads = KG * kGroup;
constexpr int RPT = BM / 16;  // rows per thread
constexpr int AS = BK + 4;    // activation row stride (floats): float4
                              // reads of 8 consecutive rows hit distinct
                              // bank groups

template <int G>
struct Smem {  // the ring; each stage holds one k-tile per k-group
  float a[NSTAGE][KG][BM][AS];
  float w[NSTAGE][KG][BK][BN * G];
};

// k-tile kt of the [x, h] rows r0.. into a (BM x BK); zeros past B and past
// the end of each half
template <bool VEC4>
__device__ __forceinline__ void load_a(float (*a)[AS], const float* x,
                                       const float* h, int r0, int B, int K,
                                       int H, int nkx, int kt, int tid) {
  const bool xh = kt < nkx;
  const float* src = xh ? x : h;
  const int width = xh ? K : H;
  const int k0 = (xh ? kt : kt - nkx) * BK;
  if (VEC4) {  // width % 4 == 0: a 4-float chunk is all in or all out
    for (int idx = tid; idx < BM * BK / 4; idx += kGroup) {
      const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
      const int row = r0 + r, col = k0 + c;
      const bool ok = row < B && col < width;
      bmhrl::cp_async16(&a[r][c],
                        ok ? src + static_cast<int64_t>(row) * width + col
                           : src,
                        ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < BM * BK; idx += kGroup) {
      const int r = idx / BK, c = idx % BK;
      const int row = r0 + r, col = k0 + c;
      const bool ok = row < B && col < width;
      bmhrl::cp_async4(&a[r][c],
                       ok ? src + static_cast<int64_t>(row) * width + col
                          : src,
                       ok ? 4 : 0);
    }
  }
}

// acc += a w over one k-tile. G = 4: gates (i, f, g, o) into acc[.][0..3];
// G = 3: (r, z, n) into acc[.][0], [1] and [2] (x-half) or [3] (h-half)
template <int G, bool XHALF>
__device__ __forceinline__ void mac(float (&acc)[RPT][4],
                                    const float (*a)[AS],
                                    const float (*w)[BN * G], int tm,
                                    int tn) {
  constexpr int NSLOT = (G == 4 || XHALF) ? 2 : 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 4) {
    float av[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(&a[tm + 16 * i][kk]);
      av[i][0] = t.x;
      av[i][1] = t.y;
      av[i][2] = t.z;
      av[i][3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float wg[4];
      if (G == 4) {
        const float4 t =
            *reinterpret_cast<const float4*>(&w[kk + j][tn * 4]);
        wg[0] = t.x;
        wg[1] = t.y;
        wg[2] = t.z;
        wg[3] = t.w;
      } else {
        wg[0] = w[kk + j][tn * 3];
        wg[1] = w[kk + j][tn * 3 + 1];
        wg[2] = w[kk + j][tn * 3 + 2];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float ai = av[i][j];
        acc[i][0] = fmaf(ai, wg[0], acc[i][0]);
        acc[i][1] = fmaf(ai, wg[1], acc[i][1]);
        if (G == 4) {
          acc[i][2] = fmaf(ai, wg[2], acc[i][2]);
          acc[i][3] = fmaf(ai, wg[3], acc[i][3]);
        } else {
          acc[i][NSLOT] = fmaf(ai, wg[2], acc[i][NSLOT]);
        }
      }
    }
  }
}

template <bool LSTM, bool VEC4>
__device__ __forceinline__ void cell_body(
    const float* __restrict__ x, const float* __restrict__ h,
    const float* __restrict__ c, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ h_out,
    float* __restrict__ c_out, int B, int K, int H) {
  constexpr int G = LSTM ? 4 : 3;
  constexpr int WT = BK * BN * G;  // floats of one weight k-tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<G>& sm = *reinterpret_cast<Smem<G>*>(smem_raw);

  const int grp = threadIdx.x / kGroup, tid = threadIdx.x % kGroup;
  // a warp covers 4 row groups x 8 units: its activation reads broadcast
  // (4 distinct addresses) and its weight reads are one 128-byte line
  const int tn = tid % BN, tm = tid / BN;
  const int tile = blockIdx.x, r0 = blockIdx.y * BM;
  const int nkx = (K + BK - 1) / BK, nk = nkx + (H + BK - 1) / BK;
  const int n_pairs = (nk + KG - 1) / KG;
  const float* wb = w + static_cast<int64_t>(tile) * nk * WT;

  // k-group grp loads and multiplies k-tile KG * p + grp of pair p
  auto load = [&](int p) {
    const int kt = KG * p + grp, s = p % NSTAGE;
    if (kt >= nk) return;
    load_a<VEC4>(sm.a[s][grp], x, h, r0, B, K, H, nkx, kt, tid);
    const float* src = wb + static_cast<int64_t>(kt) * WT;
    float* dst = &sm.w[s][grp][0][0];
    for (int idx = tid; idx < WT / 4; idx += kGroup)
      bmhrl::cp_async16(dst + 4 * idx, src + 4 * idx, 16);
  };

  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int p = 0; p < NSTAGE - 1; ++p) {
    load(p);
    bmhrl::cp_async_commit();  // possibly empty: keeps the group count
  }
  for (int p = 0; p < n_pairs; ++p) {
    bmhrl::cp_async_wait<NSTAGE - 2>();  // pair p has landed
    __syncthreads();  // ... for every thread, and pair p - 1 is consumed
    load(p + NSTAGE - 1);  // into the stage of pair p - 1
    bmhrl::cp_async_commit();
    const int s = p % NSTAGE, kt = KG * p + grp;
    if (kt < nk) {
      if (!LSTM && kt < nkx)  // the GRU's x-half: n_x, not n_h
        mac<G, true>(acc, sm.a[s][grp], sm.w[s][grp], tm, tn);
      else
        mac<G, false>(acc, sm.a[s][grp], sm.w[s][grp], tm, tn);
    }
  }
  bmhrl::cp_async_wait<0>();
  __syncthreads();

  // k-group 1 hands its partial sums to k-group 0, which finishes the cell
  static_assert(KG == 2, "the hand-over below is written for two k-groups");
  float* red = &sm.a[0][0][0][0];  // 32 x kGroup floats, free now
  if (grp == 1) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * i + e) * kGroup + tid] = acc[i][e];
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += red[(4 * i + e) * kGroup + tid];

  const int n = tile * BN + tn;
  if (n >= H) return;  // the ragged last tile
  const float4 bv = reinterpret_cast<const float4*>(bias)[n];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = r0 + tm + 16 * i;
    if (row >= B) break;
    const int64_t o = static_cast<int64_t>(row) * H + n;
    const float* g = acc[i];
    if (LSTM) {
      const float gi = sigmoidf(g[0] + bv.x);
      const float gf = sigmoidf(g[1] + bv.y);
      const float gg = tanhf(g[2] + bv.z);
      const float go = sigmoidf(g[3] + bv.w);
      const float cn = gf * c[o] + gi * gg;
      c_out[o] = cn;
      h_out[o] = go * tanhf(cn);
    } else {
      const float r = sigmoidf(g[0] + bv.x);
      const float z = sigmoidf(g[1] + bv.y);
      const float nn = tanhf(g[2] + bv.z + r * (g[3] + bv.w));
      h_out[o] = (1.f - z) * nn + z * h[o];
    }
  }
}

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_kernel(const float* x, const float* h, const float* c,
                     const float* w, const float* bias, float* h_out,
                     float* c_out, int B, int K, int H) {
  cell_body<true, VEC4>(x, h, c, w, bias, h_out, c_out, B, K, H);
}

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
    gru_cell_kernel(const float* x, const float* h, const float* w,
                    const float* bias, float* h_out, int B, int K, int H) {
  cell_body<false, VEC4>(x, h, nullptr, w, bias, h_out, nullptr, B, K, H);
}

dim3 grid_of(int B, int H) {
  return dim3((H + BN - 1) / BN, (B + BM - 1) / BM);
}

// launch one instance with its dynamic shared memory (above the 48 KB of
// static shared memory)
template <typename Kern, typename... Args>
int launch(Kern kern, size_t smem, int B, int H, cudaStream_t st,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid_of(B, H), kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

bool bad_dims(int B, int K, int H) {
  return B <= 0 || K <= 0 || H <= 0 || (B + BM - 1) / BM > 65535;
}

// The packer (ops/critic_kernels.py) lays the buffers out with its own
// UNITS and KTILE; the caller passes the shapes it packed, w (wt, wr, wc)
// and b (br, 4), and a layout that is not this kernel's BN and BK is refused
// instead of read at the wrong offsets.
bool bad_layout(int G, int K, int H, int wt, int wr, int wc, int br) {
  const int T = (H + BN - 1) / BN;
  const int rows = (K + BK - 1) / BK * BK + (H + BK - 1) / BK * BK;
  return wt != T || wr != rows || wc != BN * G || br != T * BN;
}

}  // namespace

// x (B, K), h, c (B, H), w packed (ceil(H/8), Kp + Hp, 32) with its shape
// (wt, wr, wc), b (br = ceil(H/8)*8, 4); writes h_out, c_out (B, H). All f32,
// contiguous. vec4: K and H are multiples of 4 and x, h are 16-byte aligned
// (16-byte activation copies).
extern "C" int bmhrl_lstm_cell(const float* x, const float* h, const float* c,
                               const float* w, const float* b, float* h_out,
                               float* c_out, int B, int K, int H, int wt,
                               int wr, int wc, int br, int vec4,
                               void* stream) {
  if (bad_dims(B, K, H) || bad_layout(4, K, H, wt, wr, wc, br))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return launch(vec4 ? lstm_cell_kernel<true> : lstm_cell_kernel<false>,
                sizeof(Smem<4>), B, H, st, x, h, c, w, b, h_out, c_out, B, K,
                H);
}

// x (B, K), h (B, H), w packed (ceil(H/8), Kp + Hp, 24) with its shape
// (wt, wr, wc), b (br = ceil(H/8)*8, 4); writes h_out (B, H). All f32,
// contiguous. vec4 as above.
extern "C" int bmhrl_gru_cell(const float* x, const float* h, const float* w,
                              const float* b, float* h_out, int B, int K,
                              int H, int wt, int wr, int wc, int br, int vec4,
                              void* stream) {
  if (bad_dims(B, K, H) || bad_layout(3, K, H, wt, wr, wc, br))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return launch(vec4 ? gru_cell_kernel<true> : gru_cell_kernel<false>,
                sizeof(Smem<3>), B, H, st, x, h, w, b, h_out, B, K, H);
}
