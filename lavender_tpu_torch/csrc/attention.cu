// Attention core for one window (Swin) or one sequence (BERT) and one head:
//   o = softmax(q k^T * scale + bias[h] + mask[w], keys with keep == 0 dropped) v
//
// Replaces the per-(window, head) part of lavender_tpu/ops/
// swin_block_attn.py _block_kernel (K14) and _block_kernel_wm_shift
// (K16); _block_kernel_wm (K1), lavender_tpu/ops/encoder_attention.py
// _attn_block_kernel_kmask (K4) and _attn_block_kernel (K6, a
// per-sequence [B, N, N] mask) ran here until they moved to the
// tensor-core forward, and the key-keep vector stays.  Input
// is the packed qkv slab [nSeq * N, 3C] that the qkv GEMM writes (columns
// s*C + h*hd + d, the JAX qkv layout), output [nSeq * N, C]; the bias and
// the mask are bf16.
//
// Differences from the TPU kernels, on purpose: natural-unit exponent with
// a running max (the TPU kernels skip the max subtraction and clamp exp2 at
// 115.4, which only holds for trained-scale logits), and masked keys are
// skipped outright (the TPU kmask kernel zeroes their k/v rows and subtracts
// their exp2(0) = 1 count from the denominator, exact only without a max).
// Bias and mask stay additive and finite (-100 pad keys / shift mask), as in
// the reference.
//
// Every other attention call runs on the tensor cores
// (attention_fwd_tc.cu), which the C entries below hand it to: the calls
// that write each row's log-sum-exp for a backward (K10a,
// _enc_attn_train_lanes_kernel, and K13a, _enc_attn_train_kernel, with
// dropout; the Swin window core K8a, lavender_tpu/ops/swin_core_attn.py
// _core_fwd_kernel, with its per-head bias), the heads-layout calls
// without lse: K7 (lavender_tpu/ops/encoder_attention.py _enc_attn_kernel,
// q, k, v [B, nH, N, hd] by their strides under an f32 [B, N, N] mask) and
// K15 (lavender_tpu/ops/window_attention.py _attn_kernel, q, k, v
// [W, nH, N, hd] under a per-head bias and a per-window mask, bf16 or f32),
// and the packed calls whose wrapper selects the tensor cores: K1
// (_block_kernel_wm, bias + shift mask) and K4 (_attn_block_kernel_kmask,
// the key-keep vector).  The selection is an argument, never inferred:
// K14 and K16 pass the same bias and mask as K1.  This core takes no
// dropout and writes no lse: it serves the packed slab of K14 and K16,
// until they move too (K6 calls the tensor-core forward from blocks.cu).
// The ragged N is masked in the loops, not padded as on the TPU.
//
// Bound on the card: the score and pv FLOPs (4 * N^2 * hd per block).  This
// core runs them on the f32 pipes, one query row per thread (rows
// split over several blocks where the (sequence, head) grid is too small
// for the card), with
// K and V of the (window, head) in shared memory (2 * N * hd * 2 bytes: 31 KB
// for a Swin window, 71 KB for a 276-token BERT sequence) read as
// warp-broadcast 16-byte vectors, and keys taken in chunks of 16 so the
// running-max rescale of the accumulator is paid once per chunk.  Scores
// never leave registers.  Moving K14's and K16's calls onto the
// tensor-core tiles of attention_fwd_tc.cu, as K1's, K4's and K6's moved,
// is queued; the core goes when its last caller does.
#include <math.h>

#include "attention_tc.cuh"
#include "common.cuh"

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

template <int HD>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     const bf16* __restrict__ bias, const bf16* __restrict__ mask,
                     const uint8_t* __restrict__ keep, int N, int nH, int nW, float scale,
                     int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)N * HD;
  uint8_t* kp = reinterpret_cast<uint8_t*>(vs + (size_t)N * HD);

  const int seq = blockIdx.x, h = blockIdx.y;
  // row r of q, k, v of this (sequence, head) at qb/kb/vb + r * ld, of o
  // at ob + r * C
  const int C = nH * HD;
  const size_t ld = 3 * (size_t)C;
  const bf16* qb = qkv + (size_t)seq * N * ld + h * HD;
  const bf16* kb = qb + C;
  const bf16* vb = qb + 2 * C;
  bf16* ob = out + (size_t)seq * N * C + h * HD;

  constexpr int V8 = HD / 8;
  for (int c = threadIdx.x; c < N * V8; c += blockDim.x) {
    const int r = c / V8, k8 = (c % V8) * 8;
    *reinterpret_cast<uint4*>(ks + r * HD + k8) =
        *reinterpret_cast<const uint4*>(kb + r * ld + k8);
    *reinterpret_cast<uint4*>(vs + r * HD + k8) =
        *reinterpret_cast<const uint4*>(vb + r * ld + k8);
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    kp[j] = keep == nullptr ? 1 : (keep[(size_t)seq * N + j] != 0);
  __syncthreads();

  const bf16* bias_h = bias == nullptr ? nullptr : bias + (size_t)h * N * N;
  const bf16* mask_w = mask == nullptr ? nullptr : mask + (size_t)(seq % nW) * N * N;

  const int row_end = min(N, (blockIdx.z + 1) * rows_per_block);
  for (int i = blockIdx.z * rows_per_block + threadIdx.x; i < row_end; i += blockDim.x) {
    float q[HD], acc[HD];
    const bf16* qrow = qb + (size_t)i * ld;
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
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;  // all keys dropped -> 0
    bf16* orow = ob + (size_t)i * C;
#pragma unroll
    for (int d = 0; d < HD; d += 8) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = acc[d + e] * inv;
      *reinterpret_cast<uint4*>(orow + d) = lvt::pack8(f);
    }
  }
}

template <int HD>
int launch(const void* qkv, void* out, const void* bias, const void* mask, const void* keep,
           int nSeq, int N, int nH, int nW, float scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)N * HD * sizeof(bf16) + (size_t)((N + 15) / 16) * 16;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_kernel<HD>,
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
  attention_kernel<HD><<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(mask), static_cast<const uint8_t*>(keep), N, nH, nW, scale, rows);
  return (int)cudaGetLastError();
}

// The heads layout (K7, K13a, K15) on the tensor cores: q, k, v and out by
// the element strides st[12] (host memory) of (sequence, head, row) in
// turn.
int heads_tc(const void* q, const void* k, const void* v, void* out, const long long* st,
             const void* bias, int bias_ld, const void* mask, int mask_ld, bool mask_f32,
             void* lse, int nSeq, int N, int nH, int hd, int nW, float scale, const void* seed,
             uint32_t thresh, float drop_scale, cudaStream_t s) {
  lvt::TcFwd a{{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v)},
               static_cast<bf16*>(out), {}, static_cast<float*>(lse), mask,
               static_cast<const bf16*>(bias), static_cast<const int64_t*>(seed), thresh,
               drop_scale, scale, nSeq, N, nH, nW, mask_ld, bias_ld};
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i) a.st[t][i] = st[3 * t + i];
  return lvt::attention_fwd_tc(a, hd, mask_f32, s);
}

}  // namespace

// qkv [nSeq * N, 3 * nH * hd] -> out [nSeq * N, nH * hd].  Optional (null):
// bias [nH, N, N] per head, mask [nW, N, N] for sequence s's window s % nW,
// keep [nSeq, N] uint8 (0 = key dropped; 4-byte aligned), lse [nSeq, nH,
// N] f32 (each row's log-sum-exp of its scores), seed (int64 on the
// device: dropout of the probabilities, element (i, j) kept iff its bits
// >= thresh, kept ones scaled by drop_scale).  hd in {16, 32, 64}.  A call
// with lse or tensor_cores != 0 runs on the tensor cores
// (attention_fwd_tc.cu; nW must divide nSeq; no bias with dropout; keep
// only without lse, dropout and bias): K10a with dropout, K8a with a bias,
// K1 (tensor_cores) with a bias, K4 (tensor_cores) with keep; any other on
// the f32 pipes, which take neither lse nor dropout (K14, K16).
LVT_EXPORT int lvt_attention_bf16(const void* qkv, void* out, const void* bias, const void* mask,
                                  const void* keep, void* lse, int nSeq, int N, int nH, int hd,
                                  int nW, float scale, const void* seed, uint32_t thresh,
                                  float drop_scale, int tensor_cores, void* stream) {
  if (nSeq <= 0 || N <= 0 || nH <= 0 || nW <= 0 || nH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr || tensor_cores) {  // K10a, K8a, K1, K4: the tensor cores
    if (keep != nullptr && (lse != nullptr || seed != nullptr || bias != nullptr))
      return (int)cudaErrorInvalidValue;
    const long long C = (long long)nH * hd, ld = 3 * C;
    const bf16* x = static_cast<const bf16*>(qkv);
    lvt::TcFwd a{{x, x + C, x + 2 * C}, static_cast<bf16*>(out),
                 {{N * ld, hd, ld}, {N * ld, hd, ld}, {N * ld, hd, ld}, {N * C, hd, C}},
                 static_cast<float*>(lse), mask, static_cast<const bf16*>(bias),
                 static_cast<const int64_t*>(seed), thresh, drop_scale, scale, nSeq, N, nH, nW};
    a.keep = static_cast<const uint8_t*>(keep);
    return lvt::attention_fwd_tc(a, hd, false, s);
  }
  if (seed != nullptr) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<16>(qkv, out, bias, mask, keep, nSeq, N, nH, nW, scale, s);
    case 32: return launch<32>(qkv, out, bias, mask, keep, nSeq, N, nH, nW, scale, s);
    case 64: return launch<64>(qkv, out, bias, mask, keep, nSeq, N, nH, nW, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The heads layout on the tensor cores: q, k, v -> out, each [B, nH, N, hd]
// addressed by the element strides st[12] (host memory): (sequence, head,
// row) of q, k, v and out in turn, the head dim contiguous, every stride a
// multiple of 8 and every pointer 16-byte aligned; mask [B, N, N] f32, its
// rows mask_ld elements apart (null: none).  lse [B, nH, N] f32 (null: not
// written), seed, thresh and drop_scale as in lvt_attention_bf16 (null
// seed: no dropout; K7 passes neither, the train attention K13a both).  No
// bias or key-keep.  hd in {16, 32, 64}.
LVT_EXPORT int lvt_attention_heads_bf16(const void* q, const void* k, const void* v, void* out,
                                        const long long* st, const void* mask, int mask_ld,
                                        void* lse, int B, int N, int nH, int hd, float scale,
                                        const void* seed, uint32_t thresh, float drop_scale,
                                        void* stream) {
  if (B <= 0 || N <= 0 || nH <= 0 || nH > 65535) return (int)cudaErrorInvalidValue;
  return heads_tc(q, k, v, out, st, nullptr, 0, mask, mask_ld, true, lse, B, N, nH, hd, B, scale,
                  seed, thresh, drop_scale, static_cast<cudaStream_t>(stream));
}

// Per-window attention (K15) on the tensor cores: q, k, v -> out, each
// [W, nH, N, hd] addressed as in lvt_attention_heads_bf16 by the element
// strides st[12]; bias [nH, N, N] bf16 (null: none), mask [nW, N, N] for
// window w's w % nW, f32 where mask_f32 and bf16 otherwise (null: none),
// the rows of each bias_ld and mask_ld elements apart.  hd in {16, 32,
// 64}.
LVT_EXPORT int lvt_window_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         const long long* st, const void* bias, int bias_ld,
                                         const void* mask, int mask_ld, int mask_f32, int W,
                                         int N, int nH, int hd, int nW, float scale,
                                         void* stream) {
  if (W <= 0 || N <= 0 || nH <= 0 || nW <= 0 || W % nW != 0 || nH > 65535)
    return (int)cudaErrorInvalidValue;
  return heads_tc(q, k, v, out, st, bias, bias_ld, mask, mask_ld, mask_f32 != 0, nullptr, W, N,
                  nH, hd, nW, scale, nullptr, 0, 1.0f, static_cast<cudaStream_t>(stream));
}
