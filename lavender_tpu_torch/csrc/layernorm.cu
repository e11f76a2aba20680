// Row LayerNorm on bf16 rows: y = (x - mean) * rsqrt(var + eps) * g + b.
//
// The LN prologues and epilogues that the TPU kernels computed in VMEM
// (LN1/LN2 of lavender_tpu/ops/swin_block_attn.py _block_kernel_wm, the LN
// of fused_mlp.py _chunked_kernel, the post-LNs of fused_mlp.py
// _ffn_post_ln_kernel and encoder_attention.py _attn_block_kernel_kmask).
// Bound on the card: device-memory bandwidth (one read and one write of
// the row, 2 bytes each).  Design: one warp per row with the row held in
// registers (C <= 1024, 32 values per lane), so the row is read once;
// statistics in f32, two-pass variance (no E[x^2] - mean^2 cancellation).
// An optional row index gathers the input: output row m is the LN of input
// row rows[m], and a zero row where rows[m] < 0.  The spatial Swin block K14
// (lavender_tpu/ops/swin_block_attn.py _block_kernel) reads its LN1 this
// way, the cyclic shift and the window partition folded into the index, so
// that no permuted copy of the block input is ever written; the shifted wm
// block K16 (_block_kernel_wm_shift) gathers through the wm shift, whose
// window tail-pad rows are -1 (the TPU kernel's literal zero pad rows).
// Without an affine (g and b null) the launch is the pure normalize that
// the serving fold cache leaves (the LN affine folded into the next GEMM's
// weights, lavender_tpu/models/swin3d.py foldfn).
//
// dropout_add_ln is the row epilogue of the BERT train kernels K11
// (lavender_tpu/ops/fused_mlp.py _out_ln_train_kernel) and K12
// (_ffn_post_ln_train_kernel): y = LN(res + m * x) with m the hidden dropout
// of element (row, col) drawn from the counter hash of dropout.cuh (stream
// row, index col), in f32, and the binary keep mask written beside y as
// uint8 for the backward to replay (the TPU kernels export it as bf16 0/1).
// x is the bf16 output of the GEMM before it (projection + bias, or fc2 +
// bias).  Same design and bound as the LN: one warp per row held in
// registers; device memory sees x, res and y (2 bytes each) and the mask
// (1 byte) once.
#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // 8 warps
constexpr int kMaxPerLane = 32;   // C <= 1024

__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layernorm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                          const bf16* __restrict__ b, bf16* __restrict__ y, int M, int C,
                          float eps, const int* __restrict__ rows) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const int src = rows == nullptr ? row : rows[row];
  bf16* yr = y + (size_t)row * C;
  if (src < 0) {  // a gathered pad row: zeros
    for (int c = lane; c < C; c += 32) yr[c] = __float2bfloat16(0.0f);
    return;
  }
  const bf16* xr = x + (size_t)src * C;
  float v[kMaxPerLane];
  float s = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxPerLane; ++t) {
    const int c = lane + t * 32;
    v[t] = c < C ? __bfloat162float(xr[c]) : 0.0f;
    s += v[t];
  }
  const float mean = lvt::warp_sum(s) / C;
  float q = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxPerLane; ++t) {
    const int c = lane + t * 32;
    const float d = c < C ? v[t] - mean : 0.0f;
    q += d * d;
  }
  const float rstd = rsqrtf(lvt::warp_sum(q) / C + eps);
  const bool affine = g != nullptr;
#pragma unroll
  for (int t = 0; t < kMaxPerLane; ++t) {
    const int c = lane + t * 32;
    if (c < C) {
      const float n = (v[t] - mean) * rstd;
      yr[c] = __float2bfloat16(affine ? n * __bfloat162float(g[c]) + __bfloat162float(b[c]) : n);
    }
  }
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
    dropout_add_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                          const bf16* __restrict__ g, const bf16* __restrict__ b,
                          bf16* __restrict__ y, uint8_t* __restrict__ keep, int M, int C,
                          float eps, const int64_t* __restrict__ seed, uint32_t thresh,
                          float drop_scale) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const bool drop = seed != nullptr;
  const uint32_t key = drop ? lvt::dropout_key((uint32_t)*seed, (uint32_t)row) : 0u;
  const size_t off = (size_t)row * C;
  float v[kMaxPerLane];
  float s = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxPerLane; ++t) {
    const int c = lane + t * 32;
    v[t] = 0.0f;
    if (c < C) {
      const bool kp = !drop || lvt::dropout_bits(key, (uint32_t)c) >= thresh;
      const float xv = __bfloat162float(x[off + c]);
      v[t] = (drop ? (kp ? xv * drop_scale : 0.0f) : xv) + __bfloat162float(res[off + c]);
      keep[off + c] = kp ? 1 : 0;
    }
    s += v[t];
  }
  const float mean = lvt::warp_sum(s) / C;
  float q = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxPerLane; ++t) {
    const int c = lane + t * 32;
    const float d = c < C ? v[t] - mean : 0.0f;
    q += d * d;
  }
  const float rstd = rsqrtf(lvt::warp_sum(q) / C + eps);
#pragma unroll
  for (int t = 0; t < kMaxPerLane; ++t) {
    const int c = lane + t * 32;
    if (c < C)
      y[off + c] = __float2bfloat16((v[t] - mean) * rstd * __bfloat162float(g[c]) +
                                    __bfloat162float(b[c]));
  }
}

}  // namespace

// y[M, C] = LayerNorm(res + m * x) and keep[M, C] = (m != 0), rows contiguous,
// C <= 1024; seed (int64 on the device) or null (no dropout: m = 1, keep all
// ones); element kept iff its bits >= thresh, kept ones scaled by drop_scale.
LVT_EXPORT int lvt_dropout_add_ln_bf16(const void* x, const void* res, const void* g, const void* b,
                                       void* y, void* keep, int M, int C, float eps,
                                       const void* seed, uint32_t thresh, float drop_scale,
                                       void* stream) {
  if (M <= 0 || C <= 0 || C > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  if (g == nullptr || b == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  dropout_add_ln_kernel<<<blocks, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(res), static_cast<const bf16*>(g),
      static_cast<const bf16*>(b), static_cast<bf16*>(y), static_cast<uint8_t*>(keep), M, C, eps,
      static_cast<const int64_t*>(seed), thresh, drop_scale);
  return (int)cudaGetLastError();
}

// y[M, C] = LayerNorm(x[M, C]) with affine g, b, or the pure normalize when
// both are null; rows contiguous, C <= 1024; rows (int32 [M], indices of x's
// rows, or null): y[m] = LayerNorm(x[rows[m]]), zeros where rows[m] < 0.
LVT_EXPORT int lvt_layernorm_bf16(const void* x, const void* g, const void* b, void* y, int M,
                                  int C, float eps, const void* rows, void* stream) {
  if (M <= 0 || C <= 0 || C > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  if ((g == nullptr) != (b == nullptr)) return (int)cudaErrorInvalidValue;
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_bf16_kernel<<<blocks, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const bf16*>(b),
      static_cast<bf16*>(y), M, C, eps, static_cast<const int*>(rows));
  return (int)cudaGetLastError();
}
