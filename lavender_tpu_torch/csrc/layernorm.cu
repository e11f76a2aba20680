// Row LayerNorm on bf16 rows: y = (x - mean) * rsqrt(var + eps) * g + b.
//
// The LN prologues and epilogues that the TPU kernels computed in VMEM
// (LN1/LN2 of lavender_tpu/ops/swin_block_attn.py _block_kernel_wm, the LN
// of fused_mlp.py _chunked_kernel, the post-LNs of fused_mlp.py
// _ffn_post_ln_kernel and encoder_attention.py _attn_block_kernel_kmask).
// Bound on the card: device-memory bandwidth (one read and one write of
// the row, 2 bytes each).  Design: one warp per row with the row held in
// registers (C <= 1024, 32 values per lane; C <= lvt::kMaxRowC = 2048,
// Swin-L's stage 4 at C = 1536, as a template instance of its own with 64
// a lane, so that the narrower rows keep their code), so the row is read
// once;
// statistics in f32, two-pass variance (no E[x^2] - mean^2 cancellation).
// An optional row index gathers the input: output row m is the LN of input
// row rows[m], and a zero row where rows[m] < 0 (no model path gathers
// through this kernel any more: K14 and K16 take the chunk kernel's gather
// below).  Without an affine (g and b null) the launch
// is the pure normalize that the serving fold cache leaves (the LN affine
// folded into the next GEMM's weights, lavender_tpu/models/swin3d.py
// foldfn).
//
// lvt_layernorm_rows_bf16 is the same LN on 16-byte chunks, for rows whose
// width is a multiple of 8 (the LN of K3's and K9's LN + MLP and both LNs
// of the spatial Swin block K14, blocks.cu): a row's chunks spread over a
// group of 8, 16 or 32 lanes (one to four chunks a lane; six or eight for
// C up to 1536 or lvt::kMaxRowC, Swin-L's stage 4), so that each load
// and store is 16 bytes and a warp moves whole 512-byte runs.  The scalar
// kernel above moves 2 bytes a lane an instruction and reached about 0.4
// TB/s at C = 128 on an H100 SXM at 700 W (126,976 rows, the B = 8 stage-1
// LN2: 0.17 ms of K9's 0.34).  Its gathering mode (a template instance of
// its own, so that the plain rows keep their code) takes the same row index
// as the scalar kernel: a gathered row is still one contiguous run of C x 2
// bytes, so the loads stay 16 bytes wide.  K14's LN1
// (lavender_tpu/ops/swin_block_attn.py _block_kernel) gathers the spatial
// rows [B, D, H, W] in window order, the cyclic roll folded into the index;
// the shifted wm block K16 (_block_kernel_wm_shift) gathers its window-major
// slab's rows through the wm shift, whose window tail-pad rows are -1 (the
// TPU kernel's literal zero pad rows), so that no permuted copy of the
// block input is ever written.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // 8 warps

// PER: values a lane, C <= 32 * PER (32: C <= 1024; 64: C <= kMaxRowC)
template <int PER>
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
  float v[PER];
  float s = 0.0f;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int c = lane + t * 32;
    v[t] = c < C ? __bfloat162float(xr[c]) : 0.0f;
    s += v[t];
  }
  const float mean = lvt::warp_sum(s) / C;
  float q = 0.0f;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int c = lane + t * 32;
    const float d = c < C ? v[t] - mean : 0.0f;
    q += d * d;
  }
  const float rstd = rsqrtf(lvt::warp_sum(q) / C + eps);
  const bool affine = g != nullptr;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int c = lane + t * 32;
    if (c < C) {
      const float n = (v[t] - mean) * rstd;
      yr[c] = __float2bfloat16(affine ? n * __bfloat162float(g[c]) + __bfloat162float(b[c]) : n);
    }
  }
}

// y[row] = LN(x[row]) (* g + b) on 16-byte chunks: the row's C / 8 chunks
// over a group of LANES lanes, CH a lane (chunk k of lane l: l + k * LANES),
// 256 / LANES rows a block; sums over the group by xor shuffles, which
// every lane of the warp takes part in (a lane past the rows sums zeros).
// GATHER: y[row] = LN(x[rows[row]]), a zero row where rows[row] < 0.
template <int LANES, int CH, bool GATHER>
__global__ void __launch_bounds__(256)
    layernorm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                          const bf16* __restrict__ b, bf16* __restrict__ y, int M, int C,
                          float eps, const int* __restrict__ rows) {
  const int sub = threadIdx.x % LANES;
  const int row = (blockIdx.x * 256 + threadIdx.x) / LANES;
  const int n = C / 8;
  const bool live = row < M;
  const size_t off = (size_t)row * C;
  bool in = live;  // the row has an input
  const bf16* xr = x + off;
  if constexpr (GATHER) {
    const int src = live ? rows[row] : -1;
    in = src >= 0;
    xr = x + (size_t)(in ? src : 0) * C;
  }
  float v[CH][8];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int ch = sub + k * LANES;
    const bool on = in && ch < n;
    const uint4 u = on ? *reinterpret_cast<const uint4*>(xr + 8 * ch) : make_uint4(0, 0, 0, 0);
    lvt::unpack8(u, v[k]);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[k][e];
  }
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / C;
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    if (sub + k * LANES >= n) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) q += (v[k][e] - mean) * (v[k][e] - mean);
  }
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  const float rstd = rsqrtf(q / C + eps);
  if (!live) return;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int ch = sub + k * LANES;
    if (ch >= n) continue;
    if constexpr (GATHER) {
      if (!in) {  // a gathered pad row: zeros
        *reinterpret_cast<uint4*>(y + off + 8 * ch) = make_uint4(0, 0, 0, 0);
        continue;
      }
    }
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = (v[k][e] - mean) * rstd;
    if (g != nullptr) {
      float gv[8], bv[8];
      lvt::unpack8(*reinterpret_cast<const uint4*>(g + 8 * ch), gv);
      lvt::unpack8(*reinterpret_cast<const uint4*>(b + 8 * ch), bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = f[e] * gv[e] + bv[e];
    }
    *reinterpret_cast<uint4*>(y + off + 8 * ch) = lvt::pack8(f);
  }
}

template <int LANES, int CH>
cudaError_t launch_rows(const bf16* x, const bf16* g, const bf16* b, bf16* y, int M, int C,
                        float eps, const int* rows, cudaStream_t st) {
  const long long threads = (long long)M * LANES;
  const int blocks = (int)((threads + 255) / 256);
  if (rows == nullptr)
    layernorm_rows_kernel<LANES, CH, false><<<blocks, 256, 0, st>>>(x, g, b, y, M, C, eps, rows);
  else
    layernorm_rows_kernel<LANES, CH, true><<<blocks, 256, 0, st>>>(x, g, b, y, M, C, eps, rows);
  return cudaGetLastError();
}

}  // namespace

// y [M, C] = LayerNorm(x) (* g + b; both null: the pure normalize), rows
// contiguous, C a multiple of 8 and <= lvt::kMaxRowC, x, y, g and b
// 16-byte aligned, on 16-byte chunks (see layernorm_rows_kernel); rows (int32 [M],
// indices of x's rows, or null): y[m] = LayerNorm(x[rows[m]]), zeros where
// rows[m] < 0.
LVT_EXPORT int lvt_layernorm_rows_bf16(const void* x, const void* g, const void* b, void* y,
                                       int M, int C, float eps, const void* rows, void* stream) {
  if (M <= 0 || C <= 0 || C % 8 || C > lvt::kMaxRowC || (g == nullptr) != (b == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto X = static_cast<const bf16*>(x);
  const auto G = static_cast<const bf16*>(g);
  const auto B = static_cast<const bf16*>(b);
  const auto Y = static_cast<bf16*>(y);
  const auto R = static_cast<const int*>(rows);
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = C / 8;  // chunks a row
  // each instance covers LANES x CH chunks; past 256 none does
  const cudaError_t e = n <= 8     ? launch_rows<8, 1>(X, G, B, Y, M, C, eps, R, st)
                        : n <= 16  ? launch_rows<16, 1>(X, G, B, Y, M, C, eps, R, st)
                        : n <= 32  ? launch_rows<32, 1>(X, G, B, Y, M, C, eps, R, st)
                        : n <= 64  ? launch_rows<32, 2>(X, G, B, Y, M, C, eps, R, st)
                        : n <= 96  ? launch_rows<32, 3>(X, G, B, Y, M, C, eps, R, st)
                        : n <= 128 ? launch_rows<32, 4>(X, G, B, Y, M, C, eps, R, st)
                        : n <= 192 ? launch_rows<32, 6>(X, G, B, Y, M, C, eps, R, st)
                        : n <= 256 ? launch_rows<32, 8>(X, G, B, Y, M, C, eps, R, st)
                                   : cudaErrorInvalidValue;
  return (int)e;
}

// y[M, C] = LayerNorm(x[M, C]) with affine g, b, or the pure normalize when
// both are null; rows contiguous, C <= lvt::kMaxRowC; rows (int32 [M],
// indices of x's rows, or null): y[m] = LayerNorm(x[rows[m]]), zeros where rows[m] < 0.
LVT_EXPORT int lvt_layernorm_bf16(const void* x, const void* g, const void* b, void* y, int M,
                                  int C, float eps, const void* rows, void* stream) {
  static_assert(32 * 64 == lvt::kMaxRowC, "the widest instance covers kMaxRowC");
  if (M <= 0 || C <= 0 || C > lvt::kMaxRowC) return (int)cudaErrorInvalidValue;
  if ((g == nullptr) != (b == nullptr)) return (int)cudaErrorInvalidValue;
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto X = static_cast<const bf16*>(x);
  const auto G = static_cast<const bf16*>(g);
  const auto B = static_cast<const bf16*>(b);
  const auto Y = static_cast<bf16*>(y);
  const auto R = static_cast<const int*>(rows);
  if (C <= 32 * 32)
    layernorm_bf16_kernel<32><<<blocks, kRowsPerBlock * 32, 0, st>>>(X, G, B, Y, M, C, eps, R);
  else
    layernorm_bf16_kernel<64><<<blocks, kRowsPerBlock * 32, 0, st>>>(X, G, B, Y, M, C, eps, R);
  return (int)cudaGetLastError();
}
