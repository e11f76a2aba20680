// The C entries of the attention backwards, and the f32-pipe kernel that
// forms the mask's gradient dmask of the heads-layout train attention:
//   s = q k^T * scale + mask[b],  p = softmax(s),  o = (m * p) v
//   dv = (m * p)^T do,  dp = m * (do v^T),  ds = p * (dp - rowsum(p * dp)),
//   dq = ds k * scale,  dk = ds^T q * scale,  dmask[b] = sum over heads of ds,
// m the dropout factor of each probability.
//
// Every call on a model path runs on the wgmma + TMA kernels of
// attention_bwd_wgmma.cu: lvt_attention_bwd_bf16 on the packed qkv slab
// without a bias (K10b, lavender_tpu/ops/encoder_attention.py
// _enc_attn_train_lanes_bwd_kernel) and with one (K8b,
// lavender_tpu/ops/swin_core_attn.py _core_bwd_kernel, with its dbias), and
// lvt_attention_heads_bwd_bf16 without dmask (K13b,
// _enc_attn_train_bwd_kernel).  The kernel below is K13b's dmask option
// (the TPU kernel's; on no model path: the caller zeroes it where the mask
// is <= -1e4): q, k, v, do, dq, dk and dv [B, nH, N, hd], each by its own
// (sequence, head, row) strides, the f32 [B, N, N] mask the forward read,
// dropout whose bits are regenerated from the forward's seed by the counter
// hash of dropout.cuh, and the lse of the tensor-core forward
// (attention_fwd_tc.cu), so p = exp(s - lse) needs no second pass for the
// row sums.
//
// Blocks run in no order, and an atomic add per (head, element) would
// serialise.  So each block takes one sequence and a contiguous chunk of
// heads, keeps its chunk's running sum in its own f32 slice of a scratch
// buffer (each entry touched only by the thread that owns its key column:
// no atomics, coalesced rows), and sum_chunks adds the slices.  The sum is
// the same on every run.
//
// Bound on the card: the recompute and the four products, on the f32 pipes
// (one row per thread, Q, K, V and do of the (sequence, head) in shared
// memory, read as warp-broadcast 16-byte vectors).  Pass 1 runs one query
// row per thread and forms dq; it also forms rowsum(p * dp) exactly in f32
// as dq's companion sums (dq = scale * (sum p dp k - D sum p k)), which
// avoids the rounding of D = do . o from the bf16 output.  Pass 2 runs one
// key row per thread and forms dk, dv and the [N, N] sum's column.  Both
// passes recompute s and p.  At hd = 64 four rows of 64 floats per thread
// would spill, so each pass sweeps twice: D then dq, and dk then dv (three
// rows of registers each).
#include <math.h>

#include "attention_tc.cuh"
#include "common.cuh"
#include "dropout.cuh"

namespace {

template <int HD>
__device__ __forceinline__ void load_row(const bf16* src, float* dst) {
#pragma unroll
  for (int d = 0; d < HD; d += 8) lvt::unpack8(*reinterpret_cast<const uint4*>(src + d), dst + d);
}

// sum_d a[d] * (row[d] * rscale), row in shared memory (even terms into
// s0, odd into s1; the tensor-core forward sums in another order: equal up
// to rounding).
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

// The heads layout's operands: k, v, dk and dv (q, do and dq are the
// kernel's q, dout and dq arguments) and the element strides (sequence,
// head, row) of q, k, v, do, dq, dk and dv, the head dim contiguous.
struct BwdHeads {
  const bf16* k;
  const bf16* v;
  bf16* dk;
  bf16* dv;
  long long st[7][3];
  int head0, heads_total;  // the dropout stream (dropout.cuh attention_stream)
};

// The dropout factor m of probability (i, j): 1 without dropout, else 0 or
// 1 / (1 - rate), the forward's bits regenerated from the seed (index
// i * N + j of the stream's key).
template <bool DROP>
__device__ __forceinline__ float mfac_of(uint32_t key, uint32_t index, uint32_t thresh,
                                         float drop_scale) {
  if constexpr (!DROP) return 1.0f;
  return lvt::dropout_bits(key, index) >= thresh ? drop_scale : 0.0f;
}

// One query row (pass 1) or key row (pass 2) per thread, 256 threads: at
// most 8 warps keep the whole register file of 255 a thread (9 to 12 warps
// share an SM sub-partition three to one and get 168, which spills the
// hd = 64 rows).
constexpr int kThreads = 256;

// Each block accumulates ds into its slice of ``part``: the grid is (chunk,
// sequence), and the block walks its chunk of the sequence's heads.
template <int HD, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_kernel(const bf16* __restrict__ q_ptr, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ mask,
                         bf16* __restrict__ dq_ptr, float* __restrict__ part, int N, int nH,
                         int nChunks, float scale, const int64_t* __restrict__ seed,
                         uint32_t thresh, float drop_scale, BwdHeads hb) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + (size_t)N * HD;
  bf16* vs = ks + (size_t)N * HD;
  bf16* dos = vs + (size_t)N * HD;
  float* lse_s = reinterpret_cast<float*>(dos + (size_t)N * HD);
  float* dd = lse_s + N;

  const int chunk = blockIdx.x, seq = blockIdx.y;
  const int it_begin = (int)((long)chunk * nH / nChunks);
  const int it_end = (int)((long)(chunk + 1) * nH / nChunks);
  float* part_c = part + ((size_t)chunk * gridDim.y + seq) * N * N;
  const uint32_t seed32 = DROP ? (uint32_t)*seed : 0u;
  constexpr int V8 = HD / 8;

  for (int h = it_begin; h < it_end; ++h) {
    // row r of q, k, v, do, dq, dk, dv of this (sequence, head) at base + r * ld
    const bf16* qb = q_ptr + seq * hb.st[0][0] + h * hb.st[0][1];
    const bf16* kb = hb.k + seq * hb.st[1][0] + h * hb.st[1][1];
    const bf16* vb = hb.v + seq * hb.st[2][0] + h * hb.st[2][1];
    const bf16* gb = dout + seq * hb.st[3][0] + h * hb.st[3][1];
    bf16* dqb = dq_ptr + seq * hb.st[4][0] + h * hb.st[4][1];
    bf16* dkb = hb.dk + seq * hb.st[5][0] + h * hb.st[5][1];
    bf16* dvb = hb.dv + seq * hb.st[6][0] + h * hb.st[6][1];
    const size_t q_ld = hb.st[0][2], k_ld = hb.st[1][2], v_ld = hb.st[2][2], g_ld = hb.st[3][2];
    const size_t dq_ld = hb.st[4][2], dk_ld = hb.st[5][2], dv_ld = hb.st[6][2];
    for (int c = threadIdx.x; c < N * V8; c += blockDim.x) {
      const int r = c / V8, k8 = (c % V8) * 8;
      *reinterpret_cast<uint4*>(qs + r * HD + k8) =
          *reinterpret_cast<const uint4*>(qb + r * q_ld + k8);
      *reinterpret_cast<uint4*>(ks + r * HD + k8) =
          *reinterpret_cast<const uint4*>(kb + r * k_ld + k8);
      *reinterpret_cast<uint4*>(vs + r * HD + k8) =
          *reinterpret_cast<const uint4*>(vb + r * v_ld + k8);
      *reinterpret_cast<uint4*>(dos + r * HD + k8) =
          *reinterpret_cast<const uint4*>(gb + r * g_ld + k8);
    }
    for (int j = threadIdx.x; j < N; j += blockDim.x) lse_s[j] = lse[((size_t)seq * nH + h) * N + j];
    __syncthreads();
    const float* mask_b = mask == nullptr ? nullptr : mask + (size_t)seq * N * N;
    const uint32_t key =
        DROP ? lvt::dropout_key(seed32, lvt::attention_stream(seq, h, hb.head0, hb.heads_total))
             : 0u;
#define LVT_SCORE(qk, i, j) \
  ((qk) + (mask_b != nullptr ? mask_b[(size_t)(i) * N + (j)] : 0.0f))
#define LVT_MFAC(i, j) mfac_of<DROP>(key, (uint32_t)((i) * N + (j)), thresh, drop_scale)

    // Pass 1: one query row per thread -> dq and D = rowsum(p * m * dp).
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float q[HD], dov[HD];
      load_row<HD>(qs + i * HD, q);
      load_row<HD>(dos + i * HD, dov);
#pragma unroll
      for (int d = 0; d < HD; ++d) q[d] *= scale;
      const float li = lse_s[i];
      float D = 0.0f;
      bf16* orow = dqb + (size_t)i * dq_ld;
      if constexpr (HD <= 32) {
        // one sweep: dq = scale * (sum p dp k - D sum p k)
        float a[HD], bsum[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) a[d] = bsum[d] = 0.0f;
        for (int j = 0; j < N; ++j) {
          const float p = __expf(LVT_SCORE(dot_row<HD>(q, ks + j * HD), i, j) - li);
          const float pdp = p * LVT_MFAC(i, j) * dot_row<HD>(dov, vs + j * HD);
          D += pdp;
          axpy_row<HD>(pdp, ks + j * HD, a);
          axpy_row<HD>(p, ks + j * HD, bsum);
        }
#pragma unroll
        for (int d = 0; d < HD; ++d) a[d] -= D * bsum[d];
        store_row<HD>(orow, a, scale);
      } else {
        // two sweeps (D first, then dq = scale * sum p (m dp - D) k): at
        // most three rows of registers live at once instead of four
        for (int j = 0; j < N; ++j) {
          const float p = __expf(LVT_SCORE(dot_row<HD>(q, ks + j * HD), i, j) - li);
          D += p * LVT_MFAC(i, j) * dot_row<HD>(dov, vs + j * HD);
        }
        float a[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) a[d] = 0.0f;
        for (int j = 0; j < N; ++j) {
          const float p = __expf(LVT_SCORE(dot_row<HD>(q, ks + j * HD), i, j) - li);
          const float dp = LVT_MFAC(i, j) * dot_row<HD>(dov, vs + j * HD);
          axpy_row<HD>(p * (dp - D), ks + j * HD, a);
        }
        store_row<HD>(orow, a, scale);
      }
      dd[i] = D;
    }
    __syncthreads();

    // Pass 2: one key row per thread -> dk, dv and its column of the sum.
    const bool first = h == it_begin;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      float k[HD], v[HD], dk[HD];
      load_row<HD>(ks + j * HD, k);
      load_row<HD>(vs + j * HD, v);
#pragma unroll
      for (int d = 0; d < HD; ++d) dk[d] = 0.0f;
      bf16* dk_row = dkb + (size_t)j * dk_ld;
      bf16* dv_row = dvb + (size_t)j * dv_ld;
      if constexpr (HD <= 32) {
        float dv[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) dv[d] = 0.0f;
        for (int i = 0; i < N; ++i) {
          const float p = __expf(LVT_SCORE(dot_row<HD>(k, qs + i * HD, scale), i, j) - lse_s[i]);
          const float m = LVT_MFAC(i, j);
          const float ds = p * (m * dot_row<HD>(v, dos + i * HD) - dd[i]);
          axpy_row<HD>(p * m, dos + i * HD, dv);
          axpy_row<HD>(ds, qs + i * HD, dk);
          float* pe = part_c + (size_t)i * N + j;
          *pe = first ? ds : *pe + ds;
        }
        store_row<HD>(dv_row, dv, 1.0f);
        store_row<HD>(dk_row, dk, scale);
      } else {
        // dk (and the sum) first, stored before the sweep for dv = sum_i m p
        // do_i, so that at most three rows of registers are live at once
        for (int i = 0; i < N; ++i) {
          const float p = __expf(LVT_SCORE(dot_row<HD>(k, qs + i * HD, scale), i, j) - lse_s[i]);
          const float ds = p * (LVT_MFAC(i, j) * dot_row<HD>(v, dos + i * HD) - dd[i]);
          axpy_row<HD>(ds, qs + i * HD, dk);
          float* pe = part_c + (size_t)i * N + j;
          *pe = first ? ds : *pe + ds;
        }
        store_row<HD>(dk_row, dk, scale);
        float dv[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) dv[d] = 0.0f;
        for (int i = 0; i < N; ++i) {
          const float p = __expf(LVT_SCORE(dot_row<HD>(k, qs + i * HD, scale), i, j) - lse_s[i]);
          axpy_row<HD>(p * LVT_MFAC(i, j), dos + i * HD, dv);
        }
        store_row<HD>(dv_row, dv, 1.0f);
      }
    }
#undef LVT_SCORE
#undef LVT_MFAC
    __syncthreads();  // the next (sequence, head) overwrites the tiles
  }
}

// grid (nChunks, B); the chunks' slices of ``part`` are added into dmask.
template <int HD, bool DROP>
int launch(const void* q, const void* dout, const void* lse, const void* mask, void* dq,
           void* dmask, void* part, int B, int N, int nH, int nChunks, float scale,
           const void* seed, uint32_t thresh, float drop_scale, cudaStream_t stream,
           const BwdHeads& hb) {
  const size_t smem = 4 * (size_t)N * HD * sizeof(bf16) + 2 * (size_t)N * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel<HD, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = (N + 31) / 32 * 32;
  const int threads = rows < kThreads ? rows : kThreads;
  attention_bwd_kernel<HD, DROP><<<dim3(nChunks, B), threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(mask), static_cast<bf16*>(dq), static_cast<float*>(part), N, nH,
      nChunks, scale, static_cast<const int64_t*>(seed), thresh, drop_scale, hb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return lvt::sum_chunks(static_cast<const float*>(part), static_cast<float*>(dmask), nChunks,
                         (size_t)B * N * N, stream);
}

template <int HD>
int launch_drop(const void* q, const void* dout, const void* lse, const void* mask, void* dq,
                void* dmask, void* part, int B, int N, int nH, int nChunks, float scale,
                const void* seed, uint32_t thresh, float drop_scale, cudaStream_t s,
                const BwdHeads& hb) {
#define LVT_LAUNCH(DROP)                                                                    \
  launch<HD, DROP>(q, dout, lse, mask, dq, dmask, part, B, N, nH, nChunks, scale, seed, thresh, \
                   drop_scale, s, hb)
  return seed != nullptr ? LVT_LAUNCH(true) : LVT_LAUNCH(false);
#undef LVT_LAUNCH
}

}  // namespace

// qkv [nSeq * N, 3C], dout [nSeq * N, C], lse [nSeq, nH, N] f32, dd the
// tensor-core kernels' D [nSeq, nH, N] f32 as lvt_attention_row_dot_bf16
// wrote it, bias [nH, N, N] bf16 or null, mask [nW, N, N] bf16 or null ->
// dqkv [nSeq * N, 3C] and, with a bias (K8b), dbias [nH, N, N] f32 (null
// exactly when the bias is), summed in nChunks partial sums of sequences
// (1 <= nChunks <= nSeq) into part [nChunks, nH, N, N] f32 scratch (both
// unused without a bias: K10b).  seed (int64 on the device) or null: the
// forward's dropout (bits >= thresh kept, scaled by drop_scale), never with
// a bias; head0 and heads_total its stream, as lvt_attention_bf16's.  hd in
// {16, 32, 64}.  The wgmma kernels (attention_bwd_wgmma.cu) run, with acc
// and sem their scratch (f32 [nSeq * nH * T * 64 * hd] and int32 [nSeq *
// nH * T] at 0, T = ceil(N / 64)); with a bias (K8b) also the dbias kernel
// over nChunks chunks of sequences and the chunks' sum.
LVT_EXPORT int lvt_attention_bwd_bf16(const void* qkv, const void* dout, const void* lse,
                                      const void* dd, const void* bias, const void* mask,
                                      void* dqkv, void* dbias, void* part, int nSeq, int N,
                                      int nH, int hd, int nW, int nChunks, float scale,
                                      const void* seed, uint32_t thresh, float drop_scale,
                                      int head0, int heads_total, void* acc, void* sem,
                                      void* stream) {
  if (nSeq <= 0 || N <= 0 || nH <= 0 || nW <= 0 || nH > 65535 || nSeq % nW != 0 ||
      (bias == nullptr) != (dbias == nullptr) || dd == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)nH * hd, ld = 3 * C;
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* dx = static_cast<bf16*>(dqkv);
  lvt::TcBwd a{{x, x + C, x + 2 * C, static_cast<const bf16*>(dout)},
               {dx, dx + C, dx + 2 * C},
               {{N * ld, hd, ld}, {N * ld, hd, ld}, {N * ld, hd, ld}, {N * C, hd, C},
                {N * ld, hd, ld}, {N * ld, hd, ld}, {N * ld, hd, ld}},
               static_cast<const float*>(lse), mask, static_cast<const float*>(dd),
               static_cast<const int64_t*>(seed), thresh, drop_scale, scale, nSeq, N, nH, nW,
               static_cast<const bf16*>(bias), static_cast<float*>(dbias),
               static_cast<float*>(part), nChunks};
  a.head0 = head0;
  a.heads_total = heads_total;
  return lvt::attention_bwd_wgmma(a, static_cast<float*>(acc), static_cast<int*>(sem), hd, false,
                                  static_cast<cudaStream_t>(stream));
}

// The heads layout (K13b): q, k, v, dout -> dq, dk, dv, each [B, nH, N, hd]
// addressed by the element strides st[21] (host memory): (sequence, head,
// row) of q, k, v, dout, dq, dk and dv in turn, the head dim contiguous,
// every stride a multiple of 8 and every pointer 16-byte aligned; lse
// [B, nH, N] f32 (the forward's), mask [B, N, N] f32 (the forward's) or
// null.  dmask [B, N, N] f32 = the sum over heads of ds, or null: not
// formed, and the call runs on the wgmma kernel (attention_bwd_wgmma.cu,
// acc and sem its scratch as in lvt_attention_bwd_bf16).  part is f32:
// with dmask scratch [nChunks, B, N, N] (each block takes one sequence and
// a chunk of its heads, 1 <= nChunks <= nH), without it the tensor-core
// kernels' D [B, nH, N] as lvt_attention_row_dot_bf16 wrote it (nChunks =
// nH).  seed, thresh, drop_scale, head0, heads_total as in
// lvt_attention_bwd_bf16.  hd in {16, 32, 64}.
LVT_EXPORT int lvt_attention_heads_bwd_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* mask,
                                            void* dq, void* dk, void* dv, void* dmask, void* part,
                                            const long long* st, int B, int N, int nH, int hd,
                                            int nChunks, float scale, const void* seed,
                                            uint32_t thresh, float drop_scale, int head0,
                                            int heads_total, void* acc, void* sem,
                                            void* stream) {
  if (heads_total <= 0) heads_total = nH;
  if (B <= 0 || N <= 0 || nH <= 0 || B > 65535 || nChunks < 1 || nChunks > nH ||
      part == nullptr || (dmask == nullptr && nChunks != nH) || head0 < 0 ||
      head0 + nH > heads_total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dmask == nullptr) {  // K13b on the model path: the wgmma kernel
    lvt::TcBwd a{{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout)},
                 {static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv)},
                 {},
                 static_cast<const float*>(lse), mask, static_cast<const float*>(part),
                 static_cast<const int64_t*>(seed), thresh, drop_scale, scale, B, N, nH, B};
    a.head0 = head0;
    a.heads_total = heads_total;
    for (int t = 0; t < 7; ++t)
      for (int i = 0; i < 3; ++i) a.st[t][i] = st[3 * t + i];
    return lvt::attention_bwd_wgmma(a, static_cast<float*>(acc), static_cast<int*>(sem), hd, true,
                                    s);
  }
  BwdHeads hb{static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(dk),
              static_cast<bf16*>(dv), {}, head0, heads_total};
  for (int t = 0; t < 7; ++t)
    for (int a = 0; a < 3; ++a) hb.st[t][a] = st[3 * t + a];
#define LVT_HEADS(HD) \
  launch_drop<HD>(q, dout, lse, mask, dq, dmask, part, B, N, nH, nChunks, scale, seed, thresh, \
                  drop_scale, s, hb)
  switch (hd) {
    case 16: return LVT_HEADS(16);
    case 32: return LVT_HEADS(32);
    case 64: return LVT_HEADS(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LVT_HEADS
}

// The tensor-core backward's D = rowsum(o * g) in f32 per (sequence, head,
// row), the pass before lvt_attention_bwd_bf16 (its dd) and
// lvt_attention_heads_bwd_bf16 without dmask (its part):
// o the forward's output and g its cotangent [nSeq, nH, N, hd] by the
// element strides st[6] (host memory): (sequence, head, row) of o, then
// of g, the head dim contiguous, every stride a multiple of 8 and every
// pointer 16-byte aligned (the packed slab's columns: (N * C, hd, C)).
// dd [nSeq, nH, N] f32.  hd in {16, 32, 64}.
LVT_EXPORT int lvt_attention_row_dot_bf16(const void* o, const void* g, const long long* st,
                                          void* dd, int nSeq, int N, int nH, int hd,
                                          void* stream) {
  lvt::RowDot a{static_cast<const bf16*>(o), static_cast<const bf16*>(g), {},
                static_cast<float*>(dd), nSeq, N, nH};
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 3; ++i) a.st[t][i] = st[3 * t + i];
  return lvt::attention_row_dot(a, hd, static_cast<cudaStream_t>(stream));
}
