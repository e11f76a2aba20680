// Backward of the Swin window-attention core (K8b):
//   s = q k^T * scale + bias[h] + mask[w],  p = softmax(s),  o = p v
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - rowsum(p * dp)),
//   dq = ds k * scale,  dk = ds^T q * scale,  dbias[h] = sum over sequences of ds.
//
// Replaces lavender_tpu/ops/swin_core_attn.py _core_bwd_kernel.  Input is the
// packed qkv slab [nSeq * N, 3C] (sequence s = b * nW + w uses window w of the
// mask), the cotangent do [nSeq * N, C] and the forward's per-row log-sum-exp
// (attention.cu), so p = exp(s - lse) needs no second pass for the row sums.
// Output is dqkv [nSeq * N, 3C] bf16 and dbias [nH, N, N] f32; the mask gets
// no gradient (it is geometry, never a parameter).
//
// The TPU kernel summed dbias over its grid, which runs in order.  Blocks here
// run in no order, and an atomic add per (sequence, element) would serialise
// (stage 1 at B = 8: 512 sequences onto each of 4 heads' 248 x 248 entries).
// So each block takes one head and a contiguous chunk of sequences, keeps its
// chunk's running sum in its own f32 slice of a scratch buffer (each entry
// touched only by the thread that owns its key column: no atomics, coalesced
// rows), and a second kernel adds the slices.  The sum is the same on every run.
//
// Bound on the card: the recompute and the four products, on the f32 pipes in
// this first version (the forward's design: one row per thread, Q, K, V and do
// of the (sequence, head) in shared memory, read as warp-broadcast 16-byte
// vectors).  Pass 1 runs one query row per thread and forms dq; it also forms
// rowsum(p * dp) exactly in f32 as dq's companion sums (dq = scale * (sum p dp k
// - D sum p k)), which avoids the rounding of D = do . o from the bf16 output.
// Pass 2 runs one key row per thread and forms dk, dv and the dbias column.
// Both passes recompute s and p; tensor-core tiles are the next step.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int HD>
__device__ __forceinline__ void load_row(const bf16* src, float* dst) {
#pragma unroll
  for (int d = 0; d < HD; d += 8) lvt::unpack8(*reinterpret_cast<const uint4*>(src + d), dst + d);
}

// sum_d a[d] * (row[d] * rscale), row in shared memory, in the order of
// attention.cu's dot_k (even terms into s0, odd into s1), so a recomputed
// score equals the forward's bit for bit.
template <int HD>
__device__ __forceinline__ float dot_row(const float* a, const bf16* row, float rscale = 1.0f) {
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int d = 0; d < HD; d += 8) {
    float f[8];
    lvt::unpack8(*reinterpret_cast<const uint4*>(row + d), f);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      s0 = fmaf(f[e] * rscale, a[d + e], s0);
      s1 = fmaf(f[e + 1] * rscale, a[d + e + 1], s1);
    }
  }
  return s0 + s1;
}

// acc[d] += c * row[d], row in shared memory.
template <int HD>
__device__ __forceinline__ void axpy_row(float c, const bf16* row, float* acc) {
#pragma unroll
  for (int d = 0; d < HD; d += 8) {
    float f[8];
    lvt::unpack8(*reinterpret_cast<const uint4*>(row + d), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[d + e] = fmaf(c, f[e], acc[d + e]);
  }
}

template <int HD>
__device__ __forceinline__ void store_row(bf16* dst, const float* v, float scale) {
#pragma unroll
  for (int d = 0; d < HD; d += 8) {
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = v[d + e] * scale;
    *reinterpret_cast<uint4*>(dst + d) = lvt::pack8(f);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const bf16* __restrict__ bias,
                         const bf16* __restrict__ mask, bf16* __restrict__ dqkv,
                         float* __restrict__ part, int nSeq, int N, int nH, int nW, int nChunks,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + (size_t)N * HD;
  bf16* vs = ks + (size_t)N * HD;
  bf16* dos = vs + (size_t)N * HD;
  float* lse_s = reinterpret_cast<float*>(dos + (size_t)N * HD);
  float* dd = lse_s + N;

  const int chunk = blockIdx.x, h = blockIdx.y;
  const int C = nH * HD;
  const size_t ld = 3 * (size_t)C;
  const int s_begin = (int)((long)chunk * nSeq / nChunks);
  const int s_end = (int)((long)(chunk + 1) * nSeq / nChunks);
  float* part_c = part + ((size_t)chunk * nH + h) * N * N;
  const bf16* bias_h = bias + (size_t)h * N * N;
  constexpr int V8 = HD / 8;

  for (int seq = s_begin; seq < s_end; ++seq) {
    const bf16* base = qkv + (size_t)seq * N * ld + h * HD;
    const bf16* dbase = dout + (size_t)seq * N * C + h * HD;
    for (int c = threadIdx.x; c < N * V8; c += blockDim.x) {
      const int r = c / V8, k8 = (c % V8) * 8;
      const bf16* src = base + r * ld + k8;
      *reinterpret_cast<uint4*>(qs + r * HD + k8) = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(ks + r * HD + k8) = *reinterpret_cast<const uint4*>(src + C);
      *reinterpret_cast<uint4*>(vs + r * HD + k8) = *reinterpret_cast<const uint4*>(src + 2 * C);
      *reinterpret_cast<uint4*>(dos + r * HD + k8) =
          *reinterpret_cast<const uint4*>(dbase + (size_t)r * C + k8);
    }
    for (int j = threadIdx.x; j < N; j += blockDim.x) lse_s[j] = lse[((size_t)seq * nH + h) * N + j];
    __syncthreads();
    const bf16* mask_w = mask == nullptr ? nullptr : mask + (size_t)(seq % nW) * N * N;
    bf16* dbase_out = dqkv + (size_t)seq * N * ld + h * HD;

    // Pass 1: one query row per thread -> dq and D = rowsum(p * dp).
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float q[HD], dov[HD], a[HD], bsum[HD];
      load_row<HD>(qs + i * HD, q);
      load_row<HD>(dos + i * HD, dov);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        q[d] *= scale;
        a[d] = 0.0f;
        bsum[d] = 0.0f;
      }
      const float li = lse_s[i];
      float D = 0.0f;
      for (int j = 0; j < N; ++j) {
        float s = dot_row<HD>(q, ks + j * HD) + __bfloat162float(bias_h[(size_t)i * N + j]);
        if (mask_w != nullptr) s += __bfloat162float(mask_w[(size_t)i * N + j]);
        const float p = __expf(s - li);
        const float pdp = p * dot_row<HD>(dov, vs + j * HD);
        D += pdp;
        axpy_row<HD>(pdp, ks + j * HD, a);
        axpy_row<HD>(p, ks + j * HD, bsum);
      }
      dd[i] = D;
#pragma unroll
      for (int d = 0; d < HD; ++d) a[d] -= D * bsum[d];
      store_row<HD>(dbase_out + (size_t)i * ld, a, scale);
    }
    __syncthreads();

    // Pass 2: one key row per thread -> dk, dv and its column of dbias.
    const bool first = seq == s_begin;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      float k[HD], v[HD], dk[HD], dv[HD];
      load_row<HD>(ks + j * HD, k);
      load_row<HD>(vs + j * HD, v);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dk[d] = 0.0f;
        dv[d] = 0.0f;
      }
      for (int i = 0; i < N; ++i) {
        float s = dot_row<HD>(k, qs + i * HD, scale) + __bfloat162float(bias_h[(size_t)i * N + j]);
        if (mask_w != nullptr) s += __bfloat162float(mask_w[(size_t)i * N + j]);
        const float p = __expf(s - lse_s[i]);
        const float ds = p * (dot_row<HD>(v, dos + i * HD) - dd[i]);
        axpy_row<HD>(p, dos + i * HD, dv);
        axpy_row<HD>(ds, qs + i * HD, dk);
        float* pe = part_c + (size_t)i * N + j;
        *pe = first ? ds : *pe + ds;
      }
      bf16* orow = dbase_out + (size_t)j * ld;
      store_row<HD>(orow + C, dk, scale);
      store_row<HD>(orow + 2 * C, dv, 1.0f);
    }
    __syncthreads();  // the next sequence overwrites the tiles
  }
}

// dbias[e] = sum over chunks of part[chunk][e], e over nH * N * N.
__global__ void sum_chunks_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                                  int nChunks, size_t n) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < nChunks; ++c) s += part[(size_t)c * n + e];
    dbias[e] = s;
  }
}

template <int HD>
int launch(const void* qkv, const void* dout, const void* lse, const void* bias, const void* mask,
           void* dqkv, void* dbias, void* part, int nSeq, int N, int nH, int nW, int nChunks,
           float scale, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)N * HD * sizeof(bf16) + 2 * (size_t)N * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = (N + 31) / 32 * 32;
  const int threads = rows < kThreads ? rows : kThreads;
  attention_bwd_kernel<HD><<<dim3(nChunks, nH), threads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(mask), static_cast<bf16*>(dqkv),
      static_cast<float*>(part), nSeq, N, nH, nW, nChunks, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)nH * N * N;
  const int blocks = (int)((n + 255) / 256 < 132 * 8 ? (n + 255) / 256 : 132 * 8);
  sum_chunks_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float*>(part),
                                                static_cast<float*>(dbias), nChunks, n);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv [nSeq * N, 3C], dout [nSeq * N, C], lse [nSeq, nH, N] f32, bias [nH, N, N],
// mask [nW, N, N] or null -> dqkv [nSeq * N, 3C], dbias [nH, N, N] f32, using
// part [nChunks, nH, N, N] f32 as scratch.  1 <= nChunks <= nSeq; hd in {16, 32, 64}.
LVT_EXPORT int lvt_attention_bwd_bf16(const void* qkv, const void* dout, const void* lse,
                                      const void* bias, const void* mask, void* dqkv, void* dbias,
                                      void* part, int nSeq, int N, int nH, int hd, int nW,
                                      int nChunks, float scale, void* stream) {
  if (nSeq <= 0 || N <= 0 || nH <= 0 || nW <= 0 || nH > 65535 || nChunks < 1 ||
      nChunks > nSeq || nSeq % nW != 0 || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(qkv, dout, lse, bias, mask, dqkv, dbias, part, nSeq, N, nH, nW, nChunks,
                        scale, s);
    case 32:
      return launch<32>(qkv, dout, lse, bias, mask, dqkv, dbias, part, nSeq, N, nH, nW, nChunks,
                        scale, s);
    case 64:
      return launch<64>(qkv, dout, lse, bias, mask, dqkv, dbias, part, nSeq, N, nH, nW, nChunks,
                        scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
