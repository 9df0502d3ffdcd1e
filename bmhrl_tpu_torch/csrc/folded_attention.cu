// Decode-side folded attention against the raw encoder memory, for sm_90a.
//
// Replaces the TPU kernel _folded_kernel (bmhrl_tpu/ops/attention.py:568,
// launched by folded_attend :666). For one clip b it computes
//   out[b, g] = softmax_s(scale q[b, g] . mem[b, s]) mem[b, s]      (f32)
// for all G query groups (2 fusion stacks x H heads) from ONE read of
// mem[b]: each tile of keys serves the score product, the online softmax
// and the context product.
//
// The TPU kernel batched 8 clips per program as one block-diagonal product
// (a Mosaic tiling artefact). That layout also gives a fully-masked row the
// mean over every column of its batch tile, other clips and padding
// included. Here a fully-masked row gets -1e9 on its own S keys only, so it
// returns mean(mem[b]) over those keys, as the XLA path of the same JAX
// function and the flash kernel do. Keys past S are never read.
//
// Bound: per call the memory (B*S*draw elements, bf16 on the serving path)
// is read once for 4*G*S*draw operations, G = 8: about 16 operations per
// byte, far below the card's ~295 per bf16 byte, so the kernel is bound by
// the BYTES it moves: B*S*draw*2 of memory, 8*B*G*draw of q and out, 4*B*S
// of mask (B=256, G=8: 84.0 MB for the video call (S 128, draw 1024) and
// 19.1 MB for the audio call (S 256, draw 128), 0.031 ms together at
// 3.35 TB/s).
//
// Two routes (ops/attention.py, folded_route):
//
// folded_tc_kernel, bf16 memory at draw = 128..1024 step 128 (the serving
// path):
//   - loads: 16-byte cp.async of bf16 key rows, never widened, into a ring
//     of 3 stages of BK keys (BK = 16384 / draw clamped to 16..64, so a
//     stage is 17-33 KB): tiles t+1 and t+2 are in flight while t is used.
//     Each key row is read from HBM once and serves both products. Rows past
//     the block's last key, up to the 16-row mma tile, arrive as zeros, so
//     0 * mem stays finite. Rows are padded by 16 bytes: every ldmatrix is
//     conflict-free without a swizzle;
//   - tensor cores: the bf16 memory is an exact mma.sync m16n8k16 operand.
//     The f32 operands (q, then p) go in as two bf16 terms, hi = bf16(x) and
//     lo = bf16(x - hi), two mma's into f32 accumulators: about 16 bits of
//     mantissa. A block serves 8 queries, one mma's n (any G in chunks of 8
//     blocks along y; a padded query is zero and never stored; each chunk
//     reads the memory again, from L2 when the chunks run together).
//     Scores: S^T (keys x 8) = mem tile . q^T; context: out^T (draw x 8) =
//     mem tile^T . p^T (ldmatrix .trans). Warp w owns draw columns
//     [w*draw/8, (w+1)*draw/8) for both products: its q fragments (scaled as
//     they are loaded, the plain version's f32 multiply) and its context
//     accumulators stay in registers. The 8 warps' partial scores meet in
//     shared memory (8 warps x 8 queries x BK f32), where warp i runs the
//     online softmax of query i in f32 on unrounded scores (l sums the
//     unrounded p) and leaves p as its two bf16 terms;
//   - parallelism: a clip's keys are split, in 16-key tiles, across a
//     thread-block cluster of c in {1, 2, 4, 8} blocks (folded_split: a
//     block for every SM where the keys allow, each block with at least two
//     16-key tiles; B=256 takes 1, B=32 4 or 8). Each block keeps its
//     partial (m, l, acc) in shared memory; after cluster.sync() block r
//     combines draw columns [r*draw/c, (r+1)*draw/c) of all c partials over
//     distributed shared memory and writes them; a second cluster.sync()
//     keeps every block's shared memory alive until all have read it. A
//     block whose share of keys is empty contributes m = -inf, l = 0. One
//     launch per call, no scratch tensor, no atomics;
//   - no wgmma: the tensor-core rate is not this kernel's limit;
//   - ptxas -v (sm_90a): 128 registers a thread at draw 1024 and 80 at
//     draw 128, no spill at any width; shared memory 105,248 bytes a block
//     at draw 1024 (2 blocks per SM) and 72,800 at draw 128 (3 per SM).
//
// folded_kernel, f32 memory and any other width: the first version of this
// kernel (f32 tiles in shared memory, CUDA cores), q pre-scaled by the
// wrapper. A block serves one chunk of at most GC queries of one clip (grid
// (B, ceil(G / GC))), so its shared memory does not grow with G: GC is the
// largest power of two up to 64 whose block fits kMaxSmem at the memory's
// width (simt_chunk; ops/attention.py folded_simt_chunk, 16 at draw 1024,
// 64 at draw 128). Each chunk reads the clip's memory again, from L2 when
// the chunks run together. G <= GC (every call of the f32 greedy decode)
// is one chunk, as before.
#include <cooperative_groups.h>

#include "async_mma.cuh"
#include "common.cuh"

namespace {

using bmhrl::kMaskFill;
using bmhrl::to_f;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// keys per tile: the staged f32 tile stays at or under 64 KB
int simt_tile(int draw) {
  const int BS = 16384 / draw;
  return BS > 64 ? 64 : (BS < 1 ? 1 : BS);
}

// shared memory of a block serving G queries
size_t smem_bytes(int G, int draw, int BS) {
  return sizeof(float) * (2 * static_cast<size_t>(G) * draw +
                          static_cast<size_t>(BS) * draw + G * BS + 3 * G) +
         sizeof(int) * BS;
}

// queries per block: the largest of 64, 32, ..., 1 whose block fits; 0
// when none does
int simt_chunk(int draw) {
  for (int gc = 64; gc >= 1; gc /= 2)
    if (smem_bytes(gc, draw, simt_tile(draw)) <= bmhrl::kMaxSmem) return gc;
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    folded_kernel(const float* __restrict__ q, const T* __restrict__ mem,
                  const int* __restrict__ mask, float* __restrict__ out,
                  int G_all, int GC, int S, int draw, int BS) {
  extern __shared__ __align__(16) float smem[];
  const int g0 = blockIdx.y * GC;
  const int G = min(GC, G_all - g0);      // queries of this block
  float* qs = smem;                       // G x draw
  float* acc = qs + G * draw;             // G x draw
  float* tile = acc + G * draw;           // BS x draw
  float* ps = tile + BS * draw;           // G x BS
  float* m_s = ps + G * BS;               // G
  float* l_s = m_s + G;                   // G
  float* corr_s = l_s + G;                // G
  int* mask_s = reinterpret_cast<int*>(corr_s + G);  // BS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const float* qb = q + (b * G_all + g0) * draw;
  const T* memb = mem + b * S * draw;
  const int* mb = mask + b * S;

  for (int i = tid; i < G * draw; i += kThreads) {
    qs[i] = qb[i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += BS) {
    const int ns = min(BS, S - s0);
    __syncthreads();  // previous tile consumed; q/acc/m/l initialised
    for (int i = tid; i < ns * draw; i += kThreads)
      tile[i] = to_f(memb[static_cast<int64_t>(s0) * draw + i]);
    for (int s = tid; s < ns; s += kThreads) mask_s[s] = mb[s0 + s];
    __syncthreads();

    // scores: one warp per (group, key) pair, lanes split the draw axis
    for (int p = warp; p < G * ns; p += kWarps) {
      const int g = p / ns, s = p % ns;
      const float* qr = qs + g * draw;
      const float* mr = tile + s * draw;
      float dot = 0.f;
      for (int c = lane; c < draw; c += 32) dot = fmaf(qr[c], mr[c], dot);
      dot = bmhrl::warp_sum(dot);
      if (lane == 0) ps[g * BS + s] = mask_s[s] > 0 ? dot : kMaskFill;
    }
    __syncthreads();

    // online softmax, one warp per group
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int s = lane; s < ns; s += 32) mx = fmaxf(mx, ps[g * BS + s]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, bmhrl::warp_max(mx));
      float sum = 0.f;
      for (int s = lane; s < ns; s += 32) {
        const float e = expf(ps[g * BS + s] - m_new);
        ps[g * BS + s] = e;
        sum += e;
      }
      sum = bmhrl::warp_sum(sum);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // context: thread owns columns c, all groups
    for (int c = tid; c < draw; c += kThreads) {
      for (int g = 0; g < G; ++g) {
        float a = acc[g * draw + c] * corr_s[g];
        const float* pg = ps + g * BS;
        for (int s = 0; s < ns; ++s) a = fmaf(pg[s], tile[s * draw + c], a);
        acc[g * draw + c] = a;
      }
    }
  }
  __syncthreads();
  float* ob = out + (b * G_all + g0) * draw;
  for (int i = tid; i < G * draw; i += kThreads)
    ob[i] = acc[i] / fmaxf(l_s[i / draw], 1e-30f);
}

// ---------------------------------------------------------------------------
// tensor-core route
namespace tc {

namespace cg = cooperative_groups;

constexpr int kQ = 8;       // queries per block: one mma n
constexpr int kStages = 3;  // ring depth

// Shared memory of one block, in this order: the ring (kStages x BK rows of
// draw + 8 bf16; after the loop it holds the block's partial context, 8 rows
// of draw + 4 f32), the warps' partial scores (kWarps x kQ x (BK + 4) f32),
// p as two bf16 terms (2 x kQ x (BK + 8)), the mask ring (kStages x BK int),
// corr, m and l (kQ f32 each). Every part is a multiple of 16 bytes.
size_t smem_bytes(int draw, int BK) {
  return sizeof(bf16) * kStages * BK * (draw + 8) +
         sizeof(float) * kWarps * kQ * (BK + 4) +
         sizeof(bf16) * 2 * kQ * (BK + 8) + sizeof(int) * kStages * BK +
         sizeof(float) * 3 * kQ;
}

// (x0, x1) as packed bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = bmhrl::pack_bf16x2(x0 - hf.x, x1 - hf.y);
}

// two blocks per SM (at most 128 registers a thread), except at draw 896,
// where that limit spills
template <int NK>
constexpr int kMinBlocks = NK == 7 ? 1 : 2;

// NK: 16-column steps per warp, draw = 128 * NK
template <int NK>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NK>)
    folded_tc_kernel(const float* __restrict__ q, const bf16* __restrict__ mem,
                     const int* __restrict__ mask, float* __restrict__ out,
                     int G, int S, int BK, int64_t q_bs, int64_t q_gs,
                     int64_t q_cs, int64_t m_bs, int64_t m_rs, float scale) {
  constexpr int draw = 128 * NK;
  constexpr int CW = draw / kWarps;  // columns per warp
  constexpr int CH = draw / 8;       // 16-byte chunks per row
  constexpr int RS = draw + 8;       // ring row stride (bf16)
  constexpr int AS = draw + 4;       // partial-context row stride (f32)
  const int PK = BK + 4, PS = BK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* part = reinterpret_cast<float*>(ring + kStages * BK * RS);
  bf16* Ph = reinterpret_cast<bf16*>(part + kWarps * kQ * PK);
  bf16* Pl = Ph + kQ * PS;
  int* Ms = reinterpret_cast<int*>(Pl + kQ * PS);
  float* corr_s = reinterpret_cast<float*>(Ms + kStages * BK);
  float* m_s = corr_s + kQ;
  float* l_s = m_s + kQ;
  float* accs = reinterpret_cast<float*>(smem_raw);  // after the loop

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int g0 = blockIdx.y * kQ;
  const int64_t b = blockIdx.z;
  // this block's keys: the clip's 16-key tiles split evenly over the cluster
  const int per = ((S + 15) / 16 + c - 1) / c * 16;
  const int k_begin = min(S, rank * per), k_end = min(S, k_begin + per);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const bf16* mb = mem + b * m_bs;
  const int* mk = mask == nullptr ? nullptr : mask + b * S;

  // rows of tile t up to the next multiple of 16; rows past k_end are zeros
  auto load_tile = [&](int t) {
    const int k0 = k_begin + t * BK, valid = min(BK, k_end - k0);
    const int rows = (valid + 15) & ~15;
    const int st = t % kStages;
    bf16* dst = ring + st * BK * RS;
    const bf16* src = mb + k0 * m_rs;
    for (int idx = tid; idx < rows * CH; idx += kThreads) {
      const int r = idx / CH, ch = idx % CH;
      const bool ok = r < valid;
      bmhrl::cp_async16(dst + r * RS + ch * 8,
                        ok ? src + r * m_rs + ch * 8 : src, ok ? 16 : 0);
    }
    if (mk != nullptr && tid < rows) {
      const bool ok = tid < valid;
      bmhrl::cp_async4(Ms + st * BK + tid, mk + k0 + (ok ? tid : 0),
                       ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    bmhrl::cp_async_commit();
  }

  // q^T fragments (B operand of the scores) of the warp's columns, scaled
  // in f32 as they are loaded, split into hi and lo bf16 terms
  uint32_t qh[NK][2], ql[NK][2];
  {
    const int gq = g0 + g;
#pragma unroll
    for (int s = 0; s < NK; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = warp * CW + 16 * s + 8 * h + 2 * t4;
        float x0 = 0.f, x1 = 0.f;
        if (gq < G) {
          const float* qg = q + b * q_bs + gq * q_gs;
          x0 = qg[col * q_cs] * scale;
          x1 = qg[(col + 1) * q_cs] * scale;
        }
        split_bf16x2(x0, x1, qh[s][h], ql[s][h]);
      }
    }
  }

  float acc[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // query `warp` of the chunk
  // ldmatrix lane offsets: mem tile as the A operand of the scores (rows =
  // keys) and, transposed, of the context (rows = columns)
  const int a_off = (lane & 15) * RS + warp * CW + (lane >> 4) * 8;
  const int v_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * RS + warp * CW +
                    ((lane >> 3) & 1) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    bmhrl::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed; tile t - 1 is consumed
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    bmhrl::cp_async_commit();
    const bf16* tile = ring + (t % kStages) * BK * RS;
    const int* mt = Ms + (t % kStages) * BK;
    const int k0 = k_begin + t * BK, valid = min(BK, k_end - k0);
    const int n_m = (valid + 15) >> 4;

    // partial scores over the warp's columns: d[e] is key 16i + g + 8(e/2),
    // query 2 t4 + e%2
    float* pw = part + warp * kQ * PK;
    for (int i = 0; i < n_m; ++i) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const uint32_t base = bmhrl::smem_u32(tile + 16 * i * RS + a_off);
#pragma unroll
      for (int s = 0; s < NK; ++s) {
        uint32_t a[4];
        bmhrl::ldmatrix_x4(a, base + 32 * s);
        bmhrl::mma_bf16(d, a, qh[s][0], qh[s][1]);
        bmhrl::mma_bf16(d, a, ql[s][0], ql[s][1]);
      }
      const int key = 16 * i + g;
      pw[2 * t4 * PK + key] = d[0];
      pw[(2 * t4 + 1) * PK + key] = d[1];
      pw[2 * t4 * PK + key + 8] = d[2];
      pw[(2 * t4 + 1) * PK + key + 8] = d[3];
    }
    __syncthreads();

    // online softmax of query `warp`, lanes over keys; the summed scores go
    // to warp 0's row of this query, which only this warp reads
    {
      float* sq = part + warp * PK;
      float mx = -INFINITY;
      for (int key = lane; key < valid; key += 32) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[(w * kQ + warp) * PK + key];
        if (mk != nullptr && mt[key] <= 0) s = kMaskFill;
        sq[key] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m_run, bmhrl::warp_max(mx));  // valid >= 1
      const float corr = m_run == -INFINITY ? 0.f : expf(m_run - m_new);
      float psum = 0.f;
      for (int key = lane; key < 16 * n_m; key += 32) {
        const float p = key < valid ? expf(sq[key] - m_new) : 0.f;
        psum += p;
        const bf16 hi = __float2bfloat16_rn(p);
        Ph[warp * PS + key] = hi;
        Pl[warp * PS + key] = __float2bfloat16_rn(p - __bfloat162float(hi));
      }
      l_run = l_run * corr + bmhrl::warp_sum(psum);
      m_run = m_new;
      if (lane == 0) corr_s[warp] = corr;
    }
    __syncthreads();

    // context: acc[j][e] is column warp*CW + 16j + g + 8(e/2), query
    // 2 t4 + e%2
    const float c0 = corr_s[2 * t4], c1 = corr_s[2 * t4 + 1];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c1;
      acc[j][2] *= c0;
      acc[j][3] *= c1;
    }
    for (int i = 0; i < n_m; ++i) {
      const uint32_t* ph =
          reinterpret_cast<const uint32_t*>(Ph + g * PS + 16 * i + 2 * t4);
      const uint32_t* pl =
          reinterpret_cast<const uint32_t*>(Pl + g * PS + 16 * i + 2 * t4);
      const uint32_t bh0 = ph[0], bh1 = ph[4], bl0 = pl[0], bl1 = pl[4];
      const uint32_t base = bmhrl::smem_u32(tile + 16 * i * RS + v_off);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t a[4];
        bmhrl::ldmatrix_x4_trans(a, base + 32 * j);
        bmhrl::mma_bf16(acc[j], a, bh0, bh1);
        bmhrl::mma_bf16(acc[j], a, bl0, bl1);
      }
    }
  }

  // the block's partial (m, l, acc) into shared memory
  bmhrl::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const int col = warp * CW + 16 * j + g;
    accs[2 * t4 * AS + col] = acc[j][0];
    accs[(2 * t4 + 1) * AS + col] = acc[j][1];
    accs[2 * t4 * AS + col + 8] = acc[j][2];
    accs[(2 * t4 + 1) * AS + col + 8] = acc[j][3];
  }
  if (lane == 0) {
    m_s[warp] = m_run;
    l_s[warp] = l_run;
  }
  cluster.sync();

  // block `rank` combines its 1/c of the columns from all c partials
  const int cpr = draw / c, v4 = cpr / 4;
  for (int idx = tid; idx < kQ * v4; idx += kThreads) {
    const int qi = idx / v4, col = rank * cpr + (idx % v4) * 4;
    if (g0 + qi >= G) continue;
    float M = -INFINITY;
    for (int r = 0; r < c; ++r)
      M = fmaxf(M, cluster.map_shared_rank(m_s, r)[qi]);
    float L = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < c; ++r) {
      const float mr = cluster.map_shared_rank(m_s, r)[qi];
      const float w = mr == -INFINITY ? 0.f : expf(mr - M);
      L += w * cluster.map_shared_rank(l_s, r)[qi];
      const float4 a = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(accs, r) + qi * AS + col);
      o.x += w * a.x;
      o.y += w * a.y;
      o.z += w * a.z;
      o.w += w * a.w;
    }
    L = fmaxf(L, 1e-30f);
    *reinterpret_cast<float4*>(out + (b * G + g0 + qi) * draw + col) =
        make_float4(o.x / L, o.y / L, o.z / L, o.w / L);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int NK>
int launch(const float* q, const void* mem, const int* mask, float* out,
           int B, int G, int S, int split, int BK, int64_t q_bs, int64_t q_gs,
           int64_t q_cs, int64_t m_bs, int64_t m_rs, float scale,
           cudaStream_t stream) {
  auto kern = folded_tc_kernel<NK>;
  const size_t smem = smem_bytes(128 * NK, BK);
  if (smem > bmhrl::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (G + kQ - 1) / kQ, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, q, static_cast<const bf16*>(mem), mask,
                           out, G, S, BK, q_bs, q_gs, q_cs, m_bs, m_rs, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q: (B, G, draw) f32 pre-scaled; mem: (B, S, draw) f32 or bf16; mask:
// (B, S) int32; out: (B, G, draw) f32. All contiguous. chunk: queries per
// block, which must be simt_chunk(draw) (ops/attention.py:
// folded_simt_chunk).
extern "C" int bmhrl_folded_attend(int dtype, const float* q, const void* mem,
                                   const int* mask, float* out, int B, int G,
                                   int S, int draw, int chunk, void* stream) {
  if (B <= 0 || G <= 0 || S <= 0 || draw <= 0 || chunk <= 0 ||
      chunk != simt_chunk(draw))
    return cudaErrorInvalidValue;
  const int chunks = (G + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const int BS = simt_tile(draw);
  const size_t smem = smem_bytes(G < chunk ? G : chunk, draw, BS);
  const dim3 grid(B, chunks);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == bmhrl::kF32) {
    err = cudaFuncSetAttribute(folded_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    folded_kernel<float><<<grid, kThreads, smem, st>>>(
        q, static_cast<const float*>(mem), mask, out, G, chunk, S, draw, BS);
  } else if (dtype == bmhrl::kBF16) {
    err = cudaFuncSetAttribute(folded_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    folded_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        q, static_cast<const __nv_bfloat16*>(mem), mask, out, G, chunk, S,
        draw, BS);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Tensor-core route. q: (B, G, draw) f32, NOT scaled, with element strides
// (q_bs, q_gs, q_cs); mem: (B, S, draw) bf16 with unit stride along draw,
// batch and row strides (m_bs, m_rs) multiples of 8 elements, 16-byte
// aligned; mask: (B, S) int32 contiguous, or null (every key attends); out:
// (B, G, draw) f32 contiguous. draw in 128..1024 step 128; split (the
// cluster's blocks) in {1, 2, 4, 8}; BK (keys per ring stage) in 16..64
// step 16 (ops/attention.py: folded_split, folded_tile).
extern "C" int bmhrl_folded_attend_tc(const float* q, const void* mem,
                                      const int* mask, float* out, int B,
                                      int G, int S, int draw, int split,
                                      int BK, int64_t q_bs, int64_t q_gs,
                                      int64_t q_cs, int64_t m_bs,
                                      int64_t m_rs, float scale,
                                      void* stream) {
  const int chunks = (G + tc::kQ - 1) / tc::kQ;
  if (B <= 0 || G <= 0 || S <= 0 || B > 65535 || chunks > 65535 ||
      draw % 128 || draw < 128 || draw > 1024 ||
      (split != 1 && split != 2 && split != 4 && split != 8) || BK % 16 ||
      BK < 16 || BK > 64 || m_bs % 8 || m_rs % 8 ||
      reinterpret_cast<uintptr_t>(mem) % 16)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (draw / 128) {
#define BMHRL_FOLDED_TC(NK)                                                  \
  case NK:                                                                   \
    return tc::launch<NK>(q, mem, mask, out, B, G, S, split, BK, q_bs, q_gs, \
                          q_cs, m_bs, m_rs, scale, st);
    BMHRL_FOLDED_TC(1)
    BMHRL_FOLDED_TC(2)
    BMHRL_FOLDED_TC(3)
    BMHRL_FOLDED_TC(4)
    BMHRL_FOLDED_TC(5)
    BMHRL_FOLDED_TC(6)
    BMHRL_FOLDED_TC(7)
    BMHRL_FOLDED_TC(8)
#undef BMHRL_FOLDED_TC
    default:
      return cudaErrorInvalidValue;
  }
}
