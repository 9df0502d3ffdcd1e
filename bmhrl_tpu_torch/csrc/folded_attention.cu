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
// 3.35 TB/s). An f32 memory doubles the memory's bytes, and 3xTF32 triples
// the operations (3 * 4*G*S*draw at 495 TFLOP/s): still bound by bytes, at
// the f32 beam's video call (64 clips, G=32) 50.4 MB (0.0150 ms) against
// 0.0065 ms of operations (0.0160 ms on the CUDA cores at 67 TFLOP/s).
//
// Two routes (ops/attention.py, folded_route), both on the tensor cores:
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
// folded_kernel ("simt": f32 memory at any width, bf16 at the widths the
// route above does not take): the same skeleton on the tensor cores as
// 3xTF32.
//   - loads: the memory's rows as they are (f32 or bf16, never widened) in
//     16-key tiles through a 2-stage cp.async ring, each copy as wide as the
//     rows' alignment allows (16, 8 or 4 bytes; a bf16 row of odd width or
//     2-byte alignment is copied element by element). Rows past the block's
//     keys arrive as zeros, columns up to the warps' 128 nm are zeros; rows
//     are padded by 16 bytes, so the score fragments (ldmatrix of 8x4 f32
//     tiles) and the context fragments (rows 2t, 2t + 1 of column g) load
//     free of bank conflicts;
//   - 3xTF32: each f32 operand x is split into hi = tf32(x) and lo =
//     tf32(x - hi), rounded to nearest with ties away from zero (cvt.rna's
//     result in two integer instructions), each product lo hi + hi lo +
//     hi hi on mma.sync m16n8k8 tf32 into f32 accumulators (about 22 bits;
//     none of it single-pass TF32). A bf16 memory is exact in tf32: its lo
//     terms drop out. The memory tile is the A operand of both products,
//     S^T = mem q^T and out^T = mem^T p^T (the k axis (t, t + 4) of an
//     8-key step read as keys (2t, 2t + 1) in both operands, so p's pair is
//     one float2). Warp w owns columns [w 16 nm, (w + 1) 16 nm) (nm =
//     ceil(draw / 128)) for both products; q is scaled in f32 as it is
//     loaded (the plain version's multiply) and stays in registers. The 8
//     warps' partial scores meet in shared memory, where 16 lanes a query
//     run the online softmax in f32 on unrounded scores (l sums the
//     unrounded p, expf); a fully-masked row gives mean(mem) over its keys;
//   - queries: a block serves QB = 16 of a clip's G queries (8 at nm > 8),
//     in 8-query n-tiles, skipping n-tiles past G: the q fragments and the
//     context accumulators (nm QB registers a thread) stay in registers.
//     The register budget forces the query split: at draw 1024 32 queries
//     would take 256 registers for them alone, so the f32 beam (G = 32)
//     runs two blocks a clip (each reads the memory, the second from L2);
//   - keys: split over a cluster of 1, 2, 4 or 8 blocks where the grid is
//     small (ops/attention.py folded_simt_split), combined as in the
//     tensor-core route over distributed shared memory, each query's
//     weights exp(m_r - M) / L computed once;
//   - columns: above draw 1664 (nm 13, the widest ring of f32 rows that
//     fits a block) the columns are cut into ceil(nm / 13) slabs of equal
//     width (7..13 m-tiles a warp), each served by its own blocks (8
//     queries a block). A block streams every slab of a key tile through
//     the ring for the scores, adding their partial scores in shared
//     memory, its own slab last; it keeps only its own slab's context, so
//     the memory is read once a slab (from L2 after the first). Any width
//     runs, as in the JAX function's XLA path;
//   - ptxas -v (sm_90a), no spill at any class: one slab, f32 nm 1 / 2 /
//     4 / 8 / 13: 79 / 110 / 153 / 252 / 211 registers, bf16 82 / 116 /
//     153 / 251 / 212; several slabs (8 queries a block), nm class 8 / 13:
//     f32 128 / 168, bf16 130 / 170. Shared memory a block (f32): draw 128
//     28,992 bytes, 1024 143,680, 1664 219,616, 2048 (2 slabs of 1024)
//     137,696.
#include <cooperative_groups.h>

#include "async_mma.cuh"
#include "common.cuh"

namespace {

using bmhrl::kMaskFill;
using bmhrl::to_f;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// 3xTF32 route (f32 memory, and bf16 at the widths the bf16 route does not
// take)
namespace simt {

namespace cg = cooperative_groups;

constexpr int kBK = 16;       // keys per tile: the m of one score mma
constexpr int kPS = kBK + 4;  // row stride of the partial scores (f32)
constexpr int kPK = kBK + 8;  // row stride of p (f32)

// The block's geometry at a memory `draw` wide. The columns are cut into
// `slabs` slabs of 128 nm columns, each served by blocks of its own: one
// slab up to draw 1664 (nm 13, the widest ring of f32 rows that fits
// kMaxSmem), else ceil(ceil(draw / 128) / 13) slabs of equal nm (the last
// one ragged). Each of the 8 warps owns nm 16-column m-tiles of its slab.
// The kernel is built for classes of nm (NM, the largest nm of the class:
// 1, 2, 4, 8, 13) with QB queries a block, so that the q fragments and the
// context accumulators (NM QB registers a thread) stay in registers: QB 16
// up to nm 8 (draw 1024), 8 above and wherever there are several slabs
// (their nm is 7..13). False for draw <= 0.
bool geometry(int draw, int& NM, int& QB, int& nm, int& slabs) {
  if (draw <= 0) return false;
  const int nt = (draw + 127) / 128;
  slabs = (nt + 12) / 13;
  nm = (nt + slabs - 1) / slabs;
  NM = nm <= 2 ? nm : nm <= 4 ? 4 : nm <= 8 ? 8 : 13;
  QB = nt <= 8 ? 16 : 8;
  return true;
}

// Shared memory of a block, in this order: the ring (2 stages x kBK rows of
// 128 nm + 16 bytes; after the loop it holds the block's partial context,
// QB rows of 128 nm + 4 f32, and is as large as the larger of the two), the
// warps' partial scores (kWarps x QB x kPS f32), p (QB x kPK f32), the mask
// ring (2 x kBK int), corr, m and l (QB f32 each).
size_t ring_bytes(int esz, int nm, int QB) {
  const size_t DP = 128 * nm;
  const size_t ring = 2 * kBK * (DP + 16 / esz) * esz;
  const size_t accs = sizeof(float) * QB * (DP + 4);
  return ring > accs ? ring : accs;
}

size_t smem_bytes(int esz, int nm, int QB) {
  return ring_bytes(esz, nm, QB) +
         sizeof(float) * (kWarps * QB * kPS + QB * kPK + 2 * kBK + 3 * QB);
}

template <typename T, int NM, int NQ, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
    folded_kernel(const float* __restrict__ q, const T* __restrict__ mem,
                  const int* __restrict__ mask, float* __restrict__ out,
                  int G, int S, int draw, int slab_nm, int64_t q_bs,
                  int64_t q_gs, int64_t q_cs, int64_t m_bs, int64_t m_rs,
                  float scale, int vec) {
  constexpr bool SP = sizeof(T) == 4;  // f32 memory: two tf32 terms
  constexpr int QB = 8 * NQ;
  constexpr int R = NQ > 2 ? NQ / 2 : 1;  // (query, key) pairs a thread
  const int nm = WIDE ? slab_nm : (draw + 127) >> 7;
  const int DP = 128 * nm, CW = 16 * nm;
  const int RS = DP + 16 / static_cast<int>(sizeof(T)), AS = DP + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  // the ring's bytes (ring_bytes), in 32-bit arithmetic: the compiler
  // recomputes these addresses rather than hold them in registers
  const int ring_b = max(2 * kBK * RS * static_cast<int>(sizeof(T)),
                         static_cast<int>(sizeof(float)) * QB * AS);
  float* part = reinterpret_cast<float*>(smem_raw + ring_b);
  float* Ps = part + kWarps * QB * kPS;
  int* Ms = reinterpret_cast<int*>(Ps + QB * kPK);
  float* corr_s = reinterpret_cast<float*>(Ms + 2 * kBK);
  float* m_s = corr_s + QB;
  float* l_s = m_s + QB;
  float* accs = reinterpret_cast<float*>(smem_raw);  // after the loop

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int g0 = blockIdx.y * QB;
  const int nq = min(NQ, (G - g0 + 7) >> 3);  // n-tiles holding a query
  const int64_t b = blockIdx.z;
  // this block's keys: the clip's 16-key tiles split evenly over the cluster
  const int per = ((S + 15) / 16 + c - 1) / c * 16;
  const int k_begin = min(S, rank * per), k_end = min(S, k_begin + per);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;
  const T* mb = mem + b * m_bs;
  const int* mk = mask == nullptr ? nullptr : mask + b * S;
  // WIDE: the columns in slabs of DP, blocks x = slab * c + rank; this
  // block computes the context of slab `own`
  const int slabs = WIDE ? (draw + DP - 1) / DP : 1;
  const int own = WIDE ? static_cast<int>(blockIdx.x) / c : 0;

  // one slab: the pad columns [draw, DP) of both stages are zeros (loads
  // never write them), so 0 * q stays out of the scores
  if (!WIDE && draw < DP) {
    const int pad = DP - draw;
    for (int idx = tid; idx < 2 * kBK * pad; idx += kThreads)
      ring[(idx / pad) * RS + draw + idx % pad] = T(0.f);
  }
  // Unit u of the loop is tile u of the block's keys; WIDE: tile u / slabs,
  // slab (own + 1 + u % slabs) % slabs, so that a tile's slabs each add
  // their columns' partial scores and the own slab comes last, its rows
  // still in the ring for the context product. The 16 rows of a unit are
  // copied in `vec`-byte pieces (vec 16, 8, 4: cp.async; 2, a bf16 row of
  // odd width or alignment: plain copies); rows past k_end and (WIDE)
  // columns past the slab's width arrive as zeros, so 0 * mem stays
  // finite. A row in `vec`-byte pieces:
  const int pieces = (WIDE ? DP : draw) * static_cast<int>(sizeof(T)) / vec;
  const int step_r = kThreads / pieces, step_c = kThreads % pieces;
  auto load_tile = [&](int u) {
    const int t = WIDE ? u / slabs : u, js = WIDE ? u - t * slabs : 0;
    const int k0 = k_begin + t * kBK, valid = min(kBK, k_end - k0);
    const int st = u & 1;
    const int s0 = WIDE ? (own + 1 + js) % slabs * DP : 0;
    // pieces that hold columns of the slab
    const int held =
        WIDE ? min(DP, draw - s0) * static_cast<int>(sizeof(T)) / vec : 0;
    unsigned char* dst = reinterpret_cast<unsigned char*>(ring + st * kBK * RS);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        mb + k0 * m_rs + s0);
    const int64_t srs = m_rs * static_cast<int64_t>(sizeof(T));
    const int drs = RS * static_cast<int>(sizeof(T));
    // piece idx = tid + kThreads i is (row r, piece c of the row), stepped
    // without a division
    int r = tid / pieces, c = tid % pieces;
    for (; r < kBK; r += step_r, c += step_c) {
      if (c >= pieces) {
        c -= pieces;
        ++r;
        if (r >= kBK) break;
      }
      const int off = c * vec;
      const bool ok = r < valid && (!WIDE || c < held);
      unsigned char* d = dst + r * drs + off;
      const unsigned char* sp = ok ? src + r * srs + off : src;
      if (vec == 16) {
        bmhrl::cp_async16(d, sp, ok ? 16 : 0);
      } else if (vec == 8) {
        bmhrl::cp_async8(d, sp, ok ? 8 : 0);
      } else if (vec == 4) {
        bmhrl::cp_async4(d, sp, ok ? 4 : 0);
      } else {
        *reinterpret_cast<T*>(d) =
            ok ? *reinterpret_cast<const T*>(sp) : T(0.f);
      }
    }
    if (js == 0 && mk != nullptr && tid < kBK) {
      const bool ok = tid < valid;
      bmhrl::cp_async4(Ms + (t & 1) * kBK + tid, mk + k0 + (ok ? tid : 0),
                       ok ? 4 : 0);
    }
  };
  const int n_units = n_tiles * slabs;
  if (n_units > 0) load_tile(0);
  bmhrl::cp_async_commit();

  // q^T fragments (B operand of the scores) of the warp's columns, scaled
  // in f32 as they are loaded: qf[ks][n] = columns (t4, t4 + 4) of k-step
  // ks, query 8n + g. WIDE: loaded again for each unit's slab
  float qf[2 * NM][NQ][2];
#pragma unroll
  for (int ks = 0; ks < 2 * NM; ++ks) {
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = warp * CW + 8 * ks + t4 + 4 * e, gq = g0 + 8 * n + g;
        qf[ks][n][e] = ks < 2 * nm && gq < G && col < draw
                           ? q[b * q_bs + gq * q_gs + col * q_cs] * scale
                           : 0.f;
      }
    }
  }

  // context accumulators: acc[j][n][e] is column warp*CW + 16j + g + 8(e/2),
  // query 8n + 2 t4 + e%2
  float acc[NM][NQ][4];
#pragma unroll
  for (int j = 0; j < NM; ++j)
#pragma unroll
    for (int n = 0; n < NQ; ++n)
      acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
  // the online softmax state of pair r of this thread: query
  // (tid + kThreads r) / 16, held by all 16 lanes of its keys
  float m_run[R], l_run[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  for (int u = 0; u < n_units; ++u) {
    const int t = WIDE ? u / slabs : u, js = WIDE ? u - t * slabs : 0;
    bmhrl::cp_async_wait<0>();
    __syncthreads();  // unit u has landed; unit u - 1 is consumed
    if (u + 1 < n_units) load_tile(u + 1);
    bmhrl::cp_async_commit();
    const T* tile = ring + (u & 1) * kBK * RS;
    const int* mt = Ms + (t & 1) * kBK;
    const int valid = min(kBK, k_end - k_begin - t * kBK);
    if constexpr (WIDE) {
      const int s0 = (own + 1 + js) % slabs * DP;
#pragma unroll
      for (int ks = 0; ks < 2 * NM; ++ks) {
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = s0 + warp * CW + 8 * ks + t4 + 4 * e;
            const int gq = g0 + 8 * n + g;
            qf[ks][n][e] = ks < 2 * nm && gq < G && col < draw
                               ? q[b * q_bs + gq * q_gs + col * q_cs] * scale
                               : 0.f;
          }
        }
      }
    }

    // partial scores S^T (16 keys x QB queries) over the warp's columns:
    // d[n][e] is key g + 8(e/2), query 8n + 2 t4 + e%2
    {
      float d[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
      const T* a = tile + g * RS + warp * CW + t4;
      // f32: ldmatrix, lane l giving key row (l & 7) + 8 (l >> 3 & 1) at
      // column 4 (l >> 4)
      const uint32_t a_addr = bmhrl::smem_u32(
          tile + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS + warp * CW +
          4 * (lane >> 4));
#pragma unroll
      for (int ks = 0; ks < 2 * NM; ++ks) {
        if (ks < 2 * nm) {
          float af[4];
          if constexpr (SP) {
            bmhrl::ldmatrix_f32_x4(af, a_addr + 32 * ks);
          } else {
            af[0] = to_f(a[8 * ks]);
            af[1] = to_f(a[8 * RS + 8 * ks]);
            af[2] = to_f(a[8 * ks + 4]);
            af[3] = to_f(a[8 * RS + 8 * ks + 4]);
          }
          uint32_t ah[4], al[4];
          bmhrl::split_n<SP>(af, ah, al);
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            if (n < nq) {
              uint32_t bh[2], bl[2];
              bmhrl::split_n<true>(qf[ks][n], bh, bl);
              bmhrl::mma_3xtf32<SP, true>(d[n], ah, al, bh, bl);
            }
          }
        }
      }
      float* pw = part + warp * QB * kPS;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        if (n >= nq) continue;
        const int qi = 8 * n + 2 * t4;
        if (WIDE && js > 0) {  // each thread adds into its own entries
          pw[qi * kPS + g] += d[n][0];
          pw[(qi + 1) * kPS + g] += d[n][1];
          pw[qi * kPS + g + 8] += d[n][2];
          pw[(qi + 1) * kPS + g + 8] += d[n][3];
        } else {
          pw[qi * kPS + g] = d[n][0];
          pw[(qi + 1) * kPS + g] = d[n][1];
          pw[qi * kPS + g + 8] = d[n][2];
          pw[(qi + 1) * kPS + g + 8] = d[n][3];
        }
      }
    }
    if (WIDE && js + 1 < slabs) continue;  // the tile's other slabs first
    __syncthreads();

    // online softmax in f32 on the unrounded scores: pair (query i, key kj),
    // the 16 keys of a query in 16 adjacent lanes; l sums the unrounded p
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = (tid + kThreads * r) >> 4, kj = tid & 15;
      if (i >= 8 * nq) continue;  // whole warps: 8 queries are 128 lanes
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x += part[(w * QB + i) * kPS + kj];
      const bool in = kj < valid;
      if (in && mk != nullptr && mt[kj] <= 0) x = kMaskFill;
      float mx = in ? x : -INFINITY;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[r], mx);  // finite: valid >= 1
      const float corr = m_run[r] == -INFINITY ? 0.f : expf(m_run[r] - m_new);
      const float p = in ? expf(x - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run[r] = l_run[r] * corr + sum;
      m_run[r] = m_new;
      Ps[i * kPK + kj] = p;
      if (kj == 0) corr_s[i] = corr;
    }
    __syncthreads();

    // context: out^T (the warp's columns x QB) = mem tile^T p^T, after the
    // rescale. The k axis (t4, t4 + 4) of an 8-key step is read as keys
    // (2 t4, 2 t4 + 1) in both operands: p's two keys are one float2.
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      if (n >= nq) continue;
      const float c0 = corr_s[8 * n + 2 * t4], c1 = corr_s[8 * n + 2 * t4 + 1];
#pragma unroll
      for (int j = 0; j < NM; ++j) {
        acc[j][n][0] *= c0;
        acc[j][n][1] *= c1;
        acc[j][n][2] *= c0;
        acc[j][n][3] *= c1;
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t ph[NQ][2], pl[NQ][2];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        if (n >= nq) continue;
        const float2 pv = *reinterpret_cast<const float2*>(
            Ps + (8 * n + g) * kPK + 8 * ks + 2 * t4);
        bmhrl::split_tf32(pv.x, ph[n][0], pl[n][0]);
        bmhrl::split_tf32(pv.y, ph[n][1], pl[n][1]);
      }
      const T* a = tile + (8 * ks + 2 * t4) * RS + warp * CW + g;
#pragma unroll
      for (int j = 0; j < NM; ++j) {
        if (j < nm) {
          const float af[4] = {to_f(a[16 * j]), to_f(a[16 * j + 8]),
                               to_f(a[RS + 16 * j]),
                               to_f(a[RS + 16 * j + 8])};
          uint32_t ah[4], al[4];
          bmhrl::split_n<SP>(af, ah, al);
#pragma unroll
          for (int n = 0; n < NQ; ++n)
            if (n < nq)
              bmhrl::mma_3xtf32<SP, true>(acc[j][n], ah, al, ph[n], pl[n]);
        }
      }
    }
  }

  // the block's partial (m, l, acc) into shared memory
  bmhrl::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    if (j < nm) {
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int col = warp * CW + 16 * j + g, qi = 8 * n + 2 * t4;
        accs[qi * AS + col] = acc[j][n][0];
        accs[(qi + 1) * AS + col] = acc[j][n][1];
        accs[qi * AS + col + 8] = acc[j][n][2];
        accs[(qi + 1) * AS + col + 8] = acc[j][n][3];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = (tid + kThreads * r) >> 4;
    if (i < QB && (tid & 15) == 0) {
      m_s[i] = m_run[r];
      l_s[i] = l_run[r];
    }
  }
  cluster.sync();

  // block `rank` combines its 1/c of the own slab's columns from all c
  // partials. The weight of partial r for query qi, exp(m_r - M) / L, is
  // computed once per query into `part` (free after the loop); a block with
  // no keys has m = -inf, l = 0 and weighs nothing.
  const int nqb = min(QB, G - g0);  // queries of this block
  float* wt = part;                 // c x QB weights
  for (int qi = tid; qi < nqb; qi += kThreads) {
    float M = -INFINITY;
    for (int r = 0; r < c; ++r)
      M = fmaxf(M, cluster.map_shared_rank(m_s, r)[qi]);
    float L = 0.f;
    for (int r = 0; r < c; ++r) {
      const float mr = cluster.map_shared_rank(m_s, r)[qi];
      const float w = mr == -INFINITY ? 0.f : expf(mr - M);
      wt[r * QB + qi] = w;
      L += w * cluster.map_shared_rank(l_s, r)[qi];
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int r = 0; r < c; ++r) wt[r * QB + qi] *= inv;
  }
  __syncthreads();
  // the own slab's columns [c_own, c_own + w_own)
  const int c_own = own * DP, w_own = WIDE ? min(DP, draw - c_own) : draw;
  const int cpr = (w_own + c - 1) / c, col0 = rank * cpr;
  const int ncol = min(cpr, w_own - col0);
  for (int idx = tid; idx < nqb * ncol; idx += kThreads) {
    const int qi = idx / ncol, col = col0 + idx % ncol;
    float o = 0.f;
    for (int r = 0; r < c; ++r)
      o += wt[r * QB + qi] * cluster.map_shared_rank(accs, r)[qi * AS + col];
    out[(b * G + g0 + qi) * draw + c_own + col] = o;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T, int NM, int NQ, bool WIDE>
int launch(const float* q, const void* mem, const int* mask, float* out,
           int B, int G, int S, int draw, int nm, int slabs, int split,
           int64_t q_bs, int64_t q_gs, int64_t q_cs, int64_t m_bs,
           int64_t m_rs, float scale, int vec, cudaStream_t stream) {
  auto kern = folded_kernel<T, NM, NQ, WIDE>;
  const size_t smem = smem_bytes(sizeof(T), nm, 8 * NQ);
  if (smem > bmhrl::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * slabs, (G + 8 * NQ - 1) / (8 * NQ), B);
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
  err = cudaLaunchKernelEx(&cfg, kern, q, static_cast<const T*>(mem), mask,
                           out, G, S, draw, nm, q_bs, q_gs, q_cs, m_bs, m_rs,
                           scale, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int dispatch(int NM, int nm, int slabs, const float* q, const void* mem,
             const int* mask, float* out, int B, int G, int S, int draw,
             int split, int64_t q_bs, int64_t q_gs, int64_t q_cs,
             int64_t m_bs, int64_t m_rs, float scale, int vec,
             cudaStream_t st) {
#define BMHRL_FOLDED_SIMT(NMC, NQ, WIDE)                                     \
  if (NM == NMC && (slabs > 1) == WIDE)                                      \
    return launch<T, NMC, NQ, WIDE>(q, mem, mask, out, B, G, S, draw, nm,    \
                                    slabs, split, q_bs, q_gs, q_cs, m_bs,    \
                                    m_rs, scale, vec, st);
  BMHRL_FOLDED_SIMT(1, 2, false)
  BMHRL_FOLDED_SIMT(2, 2, false)
  BMHRL_FOLDED_SIMT(4, 2, false)
  BMHRL_FOLDED_SIMT(8, 2, false)
  BMHRL_FOLDED_SIMT(13, 1, false)
  // several slabs: nm 7..13, 8 queries a block
  BMHRL_FOLDED_SIMT(8, 1, true)
  BMHRL_FOLDED_SIMT(13, 1, true)
#undef BMHRL_FOLDED_SIMT
  return cudaErrorInvalidValue;
}

}  // namespace simt

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

// 3xTF32 route. q: (B, G, draw) f32, NOT scaled, with element strides
// (q_bs, q_gs, q_cs); mem: (B, S, draw) f32 or bf16 with unit stride along
// draw and batch and row strides (m_bs, m_rs); mask: (B, S) int32
// contiguous, or null (every key attends); out: (B, G, draw) f32
// contiguous. Any draw > 0 (in column slabs above 1664); chunk (queries
// per block) must be the geometry's QB and split (the cluster's blocks,
// over keys) in {1, 2, 4, 8} (ops/attention.py: folded_simt_chunk,
// folded_simt_slabs, folded_simt_split).
extern "C" int bmhrl_folded_attend(int dtype, const float* q, const void* mem,
                                   const int* mask, float* out, int B, int G,
                                   int S, int draw, int chunk, int split,
                                   int64_t q_bs, int64_t q_gs, int64_t q_cs,
                                   int64_t m_bs, int64_t m_rs, float scale,
                                   void* stream) {
  int NM = 0, QB = 0, nm = 0, slabs = 0;
  if (B <= 0 || G <= 0 || S <= 0 || B > 65535 ||
      !simt::geometry(draw, NM, QB, nm, slabs) || chunk != QB ||
      (G + QB - 1) / QB > 65535 ||
      (split != 1 && split != 2 && split != 4 && split != 8) ||
      static_cast<int64_t>(split) * slabs > 0x7fffffff ||
      (dtype != bmhrl::kF32 && dtype != bmhrl::kBF16))
    return cudaErrorInvalidValue;
  // the widest copy that every row start allows
  const int esz = dtype == bmhrl::kF32 ? 4 : 2;
  int vec = 16;
  while (vec > esz &&
         ((static_cast<int64_t>(draw) * esz) % vec || (m_rs * esz) % vec ||
          (m_bs * esz) % vec || reinterpret_cast<uintptr_t>(mem) % vec))
    vec /= 2;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == bmhrl::kF32)
    return simt::dispatch<float>(NM, nm, slabs, q, mem, mask, out, B, G, S,
                                 draw, split, q_bs, q_gs, q_cs, m_bs, m_rs,
                                 scale, vec, st);
  return simt::dispatch<bf16>(NM, nm, slabs, q, mem, mask, out, B, G, S,
                              draw, split, q_bs, q_gs, q_cs, m_bs, m_rs,
                              scale, vec, st);
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
