// Decode-side folded attention against the raw encoder memory, for sm_90a.
//
// Replaces the TPU kernel _folded_kernel (bmhrl_tpu/ops/attention.py:568,
// launched by folded_attend :604). For one clip b it computes
//   out[b, g] = softmax_s(q[b, g] . mem[b, s]) mem[b, s]      (f32)
// for all G query groups (2 fusion stacks x H heads) from ONE read of
// mem[b]: each tile of keys is staged in shared memory once and serves the
// score product, the online softmax and the context product.
//
// The TPU kernel batched 8 clips per program as one block-diagonal product
// (a Mosaic tiling artefact). That layout also gives a fully-masked row the
// mean over every column of its batch tile, other clips and padding
// included. Here one block serves one clip, and a fully-masked row gets
// -1e9 on its own S keys only, so it returns mean(mem[b]) over those keys,
// as the XLA path of the same JAX function and the flash kernel do.
//
// q arrives pre-scaled (q * 1/sqrt(d_k), as the TPU kernel takes it).
//
// Bound: per step the memory (B*S*draw elements, bf16 at the flagship) is
// read once for 4*G*S*draw operations, G = 8: about 16 operations per byte,
// far below the card's balance, so the kernel is bound by the bytes it
// reads. Keys past S are skipped, never read.
#include "common.cuh"

namespace {

using bmhrl::kMaskFill;
using bmhrl::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

size_t smem_bytes(int G, int draw, int BS) {
  return sizeof(float) * (2 * static_cast<size_t>(G) * draw +
                          static_cast<size_t>(BS) * draw + G * BS + 3 * G) +
         sizeof(int) * BS;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    folded_kernel(const float* __restrict__ q, const T* __restrict__ mem,
                  const int* __restrict__ mask, float* __restrict__ out,
                  int G, int S, int draw, int BS) {
  extern __shared__ __align__(16) float smem[];
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
  const float* qb = q + b * G * draw;
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
  float* ob = out + b * G * draw;
  for (int i = tid; i < G * draw; i += kThreads)
    ob[i] = acc[i] / fmaxf(l_s[i / draw], 1e-30f);
}

}  // namespace

// q: (B, G, draw) f32 pre-scaled; mem: (B, S, draw) f32 or bf16; mask:
// (B, S) int32; out: (B, G, draw) f32. All contiguous.
extern "C" int bmhrl_folded_attend(int dtype, const float* q, const void* mem,
                                   const int* mask, float* out, int B, int G,
                                   int S, int draw, void* stream) {
  if (B <= 0 || G <= 0 || S <= 0 || draw <= 0) return cudaErrorInvalidValue;
  // keys per tile: the staged tile stays at or under 64 KB
  int BS = 16384 / draw;
  BS = BS > 64 ? 64 : (BS < 1 ? 1 : BS);
  const size_t smem = smem_bytes(G, draw, BS);
  if (smem > bmhrl::kMaxSmem) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == bmhrl::kF32) {
    err = cudaFuncSetAttribute(folded_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    folded_kernel<float><<<B, kThreads, smem, st>>>(
        q, static_cast<const float*>(mem), mask, out, G, S, draw, BS);
  } else if (dtype == bmhrl::kBF16) {
    err = cudaFuncSetAttribute(folded_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    folded_kernel<__nv_bfloat16><<<B, kThreads, smem, st>>>(
        q, static_cast<const __nv_bfloat16*>(mem), mask, out, G, S, draw, BS);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
