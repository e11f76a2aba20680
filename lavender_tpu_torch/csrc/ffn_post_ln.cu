// The BERT FFN sub-block (K5):  out = LN(x + fc2(GELU(fc1 x + b1)) + b2).
//
// Replaces lavender_tpu/ops/fused_mlp.py _ffn_post_ln_kernel (:283), the
// serving FFN of every fusion-encoder layer: x [M, C] bf16, w1 [HD, C] and
// w2 [C, HD] (torch Linear layout), f32 accumulation, the GELU's erf form
// (erff here; gemm_tc.cu's erf to 1.5e-7 at long M), the
// hidden h = GELU(fc1 x + b1) rounded to bf16, LN in f32 over the whole
// C-wide row with the caller's eps.
//
// Bound on the card: at the KV decoder's step (M = 8 rows) the 9.4 MB of
// weights (2.8 us at 3.35 TB/s); at serving's M = 1104 and the prefill's
// 1000 the products' 10.4 / 9.4 GFLOP (10.5 / 9.5 us at 989 TFLOP/s).
// Three launches, in one of two regimes that the wrapper's planning
// function (lavender_tpu_torch/ops/fused_mlp.py ffn_plan) picks by M:
//
// - short M (<= 64): the weights take the mma's 16-row A side and the
//   token rows its n = 8 side, so no tensor-core work goes to padding
//   rows.  A block of 4 warps owns 16 output features; its warps take
//   every fourth 32-wide chunk of the block's K range, each lane loads its
//   two weight rows straight from device memory as 16-byte vectors, 8
//   chunks in flight before the first mma (K is permuted inside each
//   32-wide chunk, the same way on both operands, so one vector feeds two
//   k-steps of 16), and the four partial sums meet in shared memory in a
//   fixed order.
//   fc1 (+ bias, GELU) runs HD / 16 = 192 blocks; fc2 C / 16 = 48 column
//   tiles x S K-slices (>= 132 blocks: S = 3), writing f32 partials.
// - long M: the tile GEMM of gemm_tc.cu (128 x 128 tiles of 2 warpgroups
//   on wgmma, fed by the Tensor Memory Accelerator), which K1 and K4 share:
//   fc1 with the bias + GELU epilogue, fc2 split-K by S so that >= 132
//   blocks run, writing f32 partials.  wgmma rather than mma.sync: the
//   same tiles on mma.sync from ldmatrix fragments were slower than one
//   PyTorch call for the whole sub-block.
// - both: gemm_tc.cu's row kernel, one block a row, sums the S partials in
//   the order s = 0..S-1, adds bias and residual, and applies LN in f32
//   (two-pass variance).
//
// Every sum is taken in a fixed order and nothing is atomic, so two calls
// give the same bits.  The wrapper passes h [M, HD] bf16 and the partials
// [S, M, C] f32 as scratch.
#include "gemm_tc.cuh"

namespace {

namespace tc = lvt::tc;

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// ---- short M -------------------------------------------------------------

constexpr int kSkinnyWarps = 4;
constexpr int kChunk = 32;  // K elements of one 16-byte vector per lane, 4 lanes a row
constexpr int kAhead = 8;   // chunks a warp keeps in flight

// out^T[f0 .. f0 + 16, tokens] over K range [blockIdx.y * k_block, + k_block)
// of W [N, K] . X [M, K]^T; NT = ceil(M / 8) token tiles.  Warp w takes
// the range's 32-wide chunks w, w + 4, ...  GELU: + bias, GELU, into
// H [M, N] bf16; else the f32 partial of slice blockIdx.y into P [S, M, N].
template <int NT, bool GELU>
__global__ void __launch_bounds__(kSkinnyWarps * 32)
    skinny_kernel(const bf16* __restrict__ X, const bf16* __restrict__ W,
                  const bf16* __restrict__ bias, bf16* __restrict__ H, float* __restrict__ P,
                  int M, int N, int K, int k_block) {
  __shared__ float red[kSkinnyWarps][NT * 8][17];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.x * 16;
  const int kb = blockIdx.y * k_block + 8 * t;
  const int n_chunks = k_block / kChunk;
  // lane (g, t) reads elements 8t .. 8t + 7 of each chunk of weight rows g
  // and g + 8 and of token row g: words 0, 1 feed the first mma (logical
  // columns 2t, 2t + 1 and 2t + 8, 2t + 9), words 2, 3 the second
  const bf16* w_lo = W + (size_t)(f0 + g) * K + kb;
  const bf16* w_hi = w_lo + (size_t)8 * K;
  float acc[NT][4] = {};
  for (int c0 = warp; c0 < n_chunks; c0 += kAhead * kSkinnyWarps) {
    uint4 a[kAhead][2];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u * kSkinnyWarps;
      if (c < n_chunks) {
        a[u][0] = __ldg(reinterpret_cast<const uint4*>(w_lo + c * kChunk));
        a[u][1] = __ldg(reinterpret_cast<const uint4*>(w_hi + c * kChunk));
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u * kSkinnyWarps;
      if (c >= n_chunks) break;
      const uint32_t a0[4] = {a[u][0].x, a[u][1].x, a[u][0].y, a[u][1].y};
      const uint32_t a1[4] = {a[u][0].z, a[u][1].z, a[u][0].w, a[u][1].w};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int tok = nt * 8 + g;
        uint4 b = make_uint4(0u, 0u, 0u, 0u);
        if (tok < M) b = *reinterpret_cast<const uint4*>(X + (size_t)tok * K + kb + c * kChunk);
        tc::mma(acc[nt], a0, b.x, b.y);
        tc::mma(acc[nt], a1, b.z, b.w);
      }
    }
  }
  // accumulator element e of tile nt: feature g + 8 (e / 2), token nt * 8 + 2t + e % 2
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][nt * 8 + 2 * t + (e & 1)][g + 8 * (e >> 1)] = acc[nt][e];
  __syncthreads();
  for (int i = threadIdx.x; i < M * 16; i += kSkinnyWarps * 32) {
    const int tok = i >> 4, f = i & 15;
    const float v = ((red[0][tok][f] + red[1][tok][f]) + red[2][tok][f]) + red[3][tok][f];
    if constexpr (GELU)
      H[(size_t)tok * N + f0 + f] = __float2bfloat16(gelu(v + __bfloat162float(bias[f0 + f])));
    else
      P[((size_t)blockIdx.y * M + tok) * N + f0 + f] = v;
  }
}

template <bool GELU>
cudaError_t launch_skinny(int NT, dim3 grid, cudaStream_t st, const bf16* X, const bf16* W,
                          const bf16* bias, bf16* H, float* P, int M, int N, int K, int k_block) {
  constexpr int T = kSkinnyWarps * 32;
  switch (NT) {
#define LVT_SKINNY(n) \
  case n:             \
    skinny_kernel<n, GELU><<<grid, T, 0, st>>>(X, W, bias, H, P, M, N, K, k_block); break;
    LVT_SKINNY(1) LVT_SKINNY(2) LVT_SKINNY(3) LVT_SKINNY(4)
    LVT_SKINNY(5) LVT_SKINNY(6) LVT_SKINNY(7) LVT_SKINNY(8)
#undef LVT_SKINNY
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// out [M, C] = LN(x + fc2(GELU(x w1^T + b1)) + b2) * ln_w + ln_b, all bf16
// and contiguous, x and the weights 16-byte aligned; h [M, HD] bf16 and
// part [S, M, C] f32 are scratch.  short_m (M <= 64) picks the regime, S
// fc2's K-slices (HD / S a multiple of 32, of 64 when long).  C % 32 == 0
// (of 64 when long), C <= 1024, HD % 32 == 0.
LVT_EXPORT int lvt_ffn_post_ln_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                                    const void* b2, const void* ln_w, const void* ln_b, void* h,
                                    void* part, void* out, int M, int C, int HD, int S, int short_m,
                                    float eps, void* stream) {
  if (M <= 0 || C <= 0 || C % 32 != 0 || C > 1024 || HD <= 0 || HD % 32 != 0 || S < 1 ||
      (HD / 32) % S != 0 || (short_m && M > 64) ||
      (!short_m && (C % lvt::wg::BK != 0 || (HD / S) % lvt::wg::BK != 0)))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto X = static_cast<const bf16*>(x);
  const auto H = static_cast<bf16*>(h);
  const auto P = static_cast<float*>(part);
  cudaError_t err;
  if (short_m) {
    const int NT = (M + 7) / 8;
    err = launch_skinny<true>(NT, dim3(HD / 16), st, X, static_cast<const bf16*>(w1),
                              static_cast<const bf16*>(b1), H, nullptr, M, HD, C, C);
    if (err != cudaSuccess) return (int)err;
    err = launch_skinny<false>(NT, dim3(C / 16, S), st, H, static_cast<const bf16*>(w2), nullptr,
                               nullptr, P, M, C, HD, HD / S);
  } else {  // the tile GEMM of gemm_tc.cu: fc1 + bias + GELU, fc2's K-slices
    lvt::GemmTc fc1{X, C, {static_cast<const bf16*>(w1)}, {static_cast<const bf16*>(b1)}, 1, H,
                    HD, nullptr, 0, M, HD, C, lvt::kEpiGelu, 128, 1};
    if ((err = (cudaError_t)lvt::gemm_tc(fc1, st)) != cudaSuccess) return (int)err;
    lvt::GemmTc fc2{H, HD, {static_cast<const bf16*>(w2)}, {nullptr}, 1, P, C, nullptr, 0, M, C,
                    HD, lvt::kEpiPartial, 128, S};
    err = (cudaError_t)lvt::gemm_tc(fc2, st);
  }
  if (err != cudaSuccess) return (int)err;
  return lvt::rows_ln(P, S, X, static_cast<const bf16*>(b2), static_cast<const bf16*>(ln_w),
                      static_cast<const bf16*>(ln_b), static_cast<bf16*>(out), M, C, eps, st);
}
