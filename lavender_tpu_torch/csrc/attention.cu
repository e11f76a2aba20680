// Attention core for one window (Swin) or one sequence (BERT) and one head:
//   o = softmax(q k^T * scale + bias[h] + mask[w], keys with keep == 0 dropped) v
//
// Replaces the per-(window, head) score / softmax / pv part of
// lavender_tpu/ops/swin_block_attn.py _block_kernel_wm and the per-head part
// of lavender_tpu/ops/encoder_attention.py _attn_block_kernel_kmask.  Input is
// the packed qkv slab [nSeq * N, 3C] that the qkv GEMM writes (columns
// s*C + h*hd + d, the JAX qkv layout), output [nSeq * N, C].  It is also
// the forward of the Swin window-attention core K8a
// (lavender_tpu/ops/swin_core_attn.py _core_fwd_kernel): there it also
// writes each query row's log-sum-exp of its scores (f32 [nSeq, nH, N]),
// which the backward (attention_bwd.cu) uses instead of recomputing the
// row sums.
//
// Differences from the TPU kernels, on purpose: natural-unit exponent with
// a running max (the TPU kernels skip the max subtraction and clamp exp2 at
// 115.4, which only holds for trained-scale logits), and masked keys are
// skipped outright (the TPU kmask kernel zeroes their k/v rows and subtracts
// their exp2(0) = 1 count from the denominator, exact only without a max).
// Bias and mask stay additive and finite (-100 pad keys / shift mask), as in
// the reference.
//
// It is also the forward of the BERT train attention K10a
// (lavender_tpu/ops/encoder_attention.py _enc_attn_train_lanes_kernel): a
// per-sequence [B, N, N] mask (nW = B, clamped at -1e4 by the caller) and
// dropout on the probabilities with its bits drawn from the counter hash of
// dropout.cuh (stream seq * nH + h, index i * N + j), so the backward
// regenerates them.  As in the TPU kernel, the mask multiplies p only in the
// P.V sum: the row sum l and the log-sum-exp are those of the undropped
// softmax, o = ((m * p) v) / l.
//
// Bound on the card: the score and pv FLOPs (4 * N^2 * hd per block).  This
// first version runs them on the f32 pipes, one query row per thread (rows
// split over several blocks where the (sequence, head) grid is too small
// for the card), with
// K and V of the (window, head) in shared memory (2 * N * hd * 2 bytes: 31 KB
// for a Swin window, 71 KB for a 276-token BERT sequence) read as
// warp-broadcast 16-byte vectors, and keys taken in chunks of 16 so the
// running-max rescale of the accumulator is paid once per chunk.  Scores
// never leave registers.  Tensor-core (mma) tiles are the next step.
#include <math.h>

#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;

template <int HD>
__device__ __forceinline__ float dot_k(const float* q, const bf16* k) {
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int d = 0; d < HD; d += 8) {
    float f[8];
    lvt::unpack8(*reinterpret_cast<const uint4*>(k + d), f);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      s0 = fmaf(q[d + e], f[e], s0);
      s1 = fmaf(q[d + e + 1], f[e + 1], s1);
    }
  }
  return s0 + s1;
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     const bf16* __restrict__ bias, const bf16* __restrict__ mask,
                     const uint8_t* __restrict__ keep, float* __restrict__ lse, int N, int nH,
                     int nW, float scale, int rows_per_block, const int64_t* __restrict__ seed,
                     uint32_t thresh, float drop_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)N * HD;
  uint8_t* kp = reinterpret_cast<uint8_t*>(vs + (size_t)N * HD);

  const int seq = blockIdx.x, h = blockIdx.y;
  const int C = nH * HD;
  const size_t ld = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)seq * N * ld;

  constexpr int V8 = HD / 8;
  for (int c = threadIdx.x; c < N * V8; c += blockDim.x) {
    const int r = c / V8, k8 = (c % V8) * 8;
    const bf16* src = base + r * ld + h * HD + k8;
    *reinterpret_cast<uint4*>(ks + r * HD + k8) = *reinterpret_cast<const uint4*>(src + C);
    *reinterpret_cast<uint4*>(vs + r * HD + k8) = *reinterpret_cast<const uint4*>(src + 2 * C);
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    kp[j] = keep == nullptr ? 1 : (keep[(size_t)seq * N + j] != 0);
  __syncthreads();

  const bf16* bias_h = bias == nullptr ? nullptr : bias + (size_t)h * N * N;
  const bf16* mask_w = mask == nullptr ? nullptr : mask + (size_t)(seq % nW) * N * N;
  const uint32_t key = DROP ? lvt::dropout_key((uint32_t)*seed, (uint32_t)(seq * nH + h)) : 0u;

  const int row_end = min(N, (blockIdx.z + 1) * rows_per_block);
  for (int i = blockIdx.z * rows_per_block + threadIdx.x; i < row_end; i += blockDim.x) {
    float q[HD], acc[HD];
    const bf16* qrow = base + (size_t)i * ld + h * HD;
#pragma unroll
    for (int d = 0; d < HD; d += 8) lvt::unpack8(*reinterpret_cast<const uint4*>(qrow + d), q + d);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      q[d] *= scale;
      acc[d] = 0.0f;
    }
    float m = -INFINITY, l = 0.0f;
    for (int j0 = 0; j0 < N; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int j = j0 + t;
        float sv = -INFINITY;
        if (j < N && kp[j]) {  // uniform across the block: no divergence
          sv = dot_k<HD>(q, ks + j * HD);
          if (bias_h != nullptr) sv += __bfloat162float(bias_h[(size_t)i * N + j]);
          if (mask_w != nullptr) sv += __bfloat162float(mask_w[(size_t)i * N + j]);
        }
        s[t] = sv;
        cmax = fmaxf(cmax, sv);
      }
      if (cmax == -INFINITY) continue;  // every key of the chunk dropped
      const float mn = fmaxf(m, cmax);
      const float corr = __expf(m - mn);  // 0 on the first live chunk
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (s[t] == -INFINITY) continue;
        const float p = __expf(s[t] - mn);
        l += p;
        // a dropped probability counts in l but not in the P.V sum
        if (DROP && lvt::dropout_bits(key, (uint32_t)(i * N + j0 + t)) < thresh) continue;
        const bf16* vr = vs + (j0 + t) * HD;
#pragma unroll
        for (int d = 0; d < HD; d += 8) {
          float f[8];
          lvt::unpack8(*reinterpret_cast<const uint4*>(vr + d), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[d + e] = fmaf(p, f[e], acc[d + e]);
        }
      }
      m = mn;
    }
    // all keys dropped -> 0; dropout scales the kept by 1 / (1 - rate)
    const float inv = l > 0.0f ? (DROP ? drop_scale : 1.0f) / l : 0.0f;
    if (lse != nullptr) lse[((size_t)seq * nH + h) * N + i] = l > 0.0f ? m + logf(l) : INFINITY;
    bf16* orow = out + ((size_t)seq * N + i) * C + h * HD;
#pragma unroll
    for (int d = 0; d < HD; d += 8) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = acc[d + e] * inv;
      *reinterpret_cast<uint4*>(orow + d) = lvt::pack8(f);
    }
  }
}

template <int HD, bool DROP>
int launch(const void* qkv, void* out, const void* bias, const void* mask, const void* keep,
           void* lse, int nSeq, int N, int nH, int nW, float scale, const void* seed,
           uint32_t thresh, float drop_scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)N * HD * sizeof(bf16) + (size_t)((N + 15) / 16) * 16;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_kernel<HD, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // The query rows are split over blockIdx.z into tiles of at most kThreads
  // rows, so that each thread runs one row (N = 276 would otherwise run a
  // second round of 20 rows on one warp).  A (sequence, head) grid smaller
  // than the card (the BERT serving grid of B x 12 blocks leaves most of the
  // 132 SMs idle) splits further, into as many tiles as minimise the rows
  // the busiest SM runs.  Each extra tile reloads K/V of its window from L2.
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long blocks = (long)nSeq * nH;
  int tiles = (N + kThreads - 1) / kThreads;
  int rows = ((N + tiles - 1) / tiles + 31) / 32 * 32;
  long best = (blocks * tiles + n_sm - 1) / n_sm * rows;
  for (int t = tiles + 1; blocks < n_sm && t <= (N + 31) / 32; ++t) {
    const int r = ((N + t - 1) / t + 31) / 32 * 32;
    const long per_sm = (blocks * t + n_sm - 1) / n_sm * r;
    if (per_sm < best) best = per_sm, tiles = t, rows = r;
  }
  tiles = (N + rows - 1) / rows;
  const int threads = rows < kThreads ? rows : kThreads;
  dim3 grid(nSeq, nH, tiles);
  attention_kernel<HD, DROP><<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(mask), static_cast<const uint8_t*>(keep), static_cast<float*>(lse),
      N, nH, nW, scale, rows, static_cast<const int64_t*>(seed), thresh, drop_scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const void* qkv, void* out, const void* bias, const void* mask, const void* keep,
              void* lse, int nSeq, int N, int nH, int nW, float scale, const void* seed,
              uint32_t thresh, float drop_scale, cudaStream_t s) {
  if (seed != nullptr)
    return launch<HD, true>(qkv, out, bias, mask, keep, lse, nSeq, N, nH, nW, scale, seed, thresh,
                            drop_scale, s);
  return launch<HD, false>(qkv, out, bias, mask, keep, lse, nSeq, N, nH, nW, scale, seed, thresh,
                           drop_scale, s);
}

}  // namespace

// qkv [nSeq * N, 3 * nH * hd] -> out [nSeq * N, nH * hd].  Optional (null):
// bias [nH, N, N] per head, mask [nW, N, N] for sequence s's window s % nW,
// keep [nSeq, N] uint8 (0 = key dropped), lse [nSeq, nH, N] f32 (written
// when given; +inf for a row whose keys are all dropped), seed (int64 on the
// device: dropout of the probabilities, element (i, j) kept iff its bits >=
// thresh, kept ones scaled by drop_scale).  hd in {16, 32, 64}.
LVT_EXPORT int lvt_attention_bf16(const void* qkv, void* out, const void* bias, const void* mask,
                                  const void* keep, void* lse, int nSeq, int N, int nH, int hd,
                                  int nW, float scale, const void* seed, uint32_t thresh,
                                  float drop_scale, void* stream) {
  if (nSeq <= 0 || N <= 0 || nH <= 0 || nW <= 0 || nH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<16>(qkv, out, bias, mask, keep, lse, nSeq, N, nH, nW, scale, seed, thresh,
                           drop_scale, s);
    case 32:
      return launch_hd<32>(qkv, out, bias, mask, keep, lse, nSeq, N, nH, nW, scale, seed, thresh,
                           drop_scale, s);
    case 64:
      return launch_hd<64>(qkv, out, bias, mask, keep, lse, nSeq, N, nH, nW, scale, seed, thresh,
                           drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
