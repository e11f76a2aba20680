// The uint8 patch embed (K17):  out[b, t, i, j, :] = bt[t] + sum_k feat[k] * w[k, :].
//
// Replaces lavender_tpu/ops/patch_embed_u8.py _pe_kernel: the Swin patch
// embed, Conv3d kernel (2, 4, 4) / stride (1, 4, 4) with the temporal end
// pad, on raw uint8 clips [B, D, H, W, 3], the ImageNet normalize folded into
// the conv weights w [96, E] and the bias table bt [D, E] (which leaves out
// the kd = 1 tap's folded shift at t = D - 1, so that the pad frame counts as
// a normalized zero).  feat is the im2col row of output (b, t, i, j), in the
// (kd, kh, kw, c) order of w's rows: pixel (t + kd, 4i + kh, 4j + kw, c),
// a raw zero past the last frame.
//
// Bound on the card: device-memory bandwidth (the u8 clip read once, the
// [B, D, H/4, W/4, E] output written once; 96 MACs per output value are
// ~1.5 GFLOP at Swin-B B=4, a microsecond of tensor-core time).  The TPU
// kernel contracted 96-lane chunks against 8x block-diagonal weights to
// avoid an im2col relayout in VMEM; here the im2col never leaves shared
// memory: one block owns up to 64 output columns j of one (b, t, i) row,
// reads the 8 (kd, kh) pixel rows it needs as 4-byte words (each (kd, kh, j)
// is 12 contiguous bytes of a row), writes them to shared memory as bf16
// (0..255 is exact), and multiplies them with the bf16 weights on wmma
// 16x16x16 tiles, f32 accumulation; the bias and the bf16 store run in the
// epilogue.  The block's output rows are one contiguous run of memory.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kK = 96;        // pd * ph * pw * 3 features a row
constexpr int kRows = 64;     // output columns j a block
constexpr int kSA = kK + 8;   // padded shared row of the im2col tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    patch_embed_u8_kernel(const uint8_t* __restrict__ x, const bf16* __restrict__ w,
                          const float* __restrict__ bt, bf16* __restrict__ out, int D, int H,
                          int W, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int SW = E + 8;  // padded shared row of the weights
  bf16* a_s = reinterpret_cast<bf16*>(smem);                       // [kRows][kSA]
  bf16* w_s = a_s + kRows * kSA;                                    // [kK][SW]
  float* scratch = reinterpret_cast<float*>(w_s + kK * SW);        // kWarps x 256
  const int w2 = W / 4, h2 = H / 4;
  const int j0 = blockIdx.x * kRows, i = blockIdx.y;
  const int t = blockIdx.z % D, b = blockIdx.z / D;
  const int nj = min(kRows, w2 - j0);

  const int ev = E / 8;  // 16-byte vectors of a weight row
  for (int c = threadIdx.x; c < kK * ev; c += kThreads) {
    const int r = c / ev, e8 = (c % ev) * 8;
    *reinterpret_cast<uint4*>(w_s + r * SW + e8) =
        *reinterpret_cast<const uint4*>(w + (size_t)r * E + e8);
  }
  // im2col: word u -> column j = u / 24, (kd, kh) = (u % 24) / 3, bytes
  // 4 * (u % 3) .. + 3 of that column's 12 (kw, c) bytes
  for (int u = threadIdx.x; u < kRows * 24; u += kThreads) {
    const int j = u / 24, tap = (u % 24) / 3, q = u % 3;
    const int kd = tap / 4, kh = tap % 4, f = t + kd;
    uint32_t word = 0u;
    if (j < nj && f < D) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          x + (((size_t)b * D + f) * H + 4 * i + kh) * (size_t)W * 3);
      word = src[(j0 + j) * 3 + q];
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(a_s + j * kSA + tap * 12 + q * 4);
    dst[0] = __floats2bfloat162_rn((float)(word & 0xffu), (float)((word >> 8) & 0xffu));
    dst[1] = __floats2bfloat162_rn((float)((word >> 16) & 0xffu), (float)(word >> 24));
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sc = scratch + warp * 256;
  const int r = lane / 2, c8 = (lane % 2) * 8;
  const int col_tiles = E / 16;
  const size_t out_row0 = (((size_t)b * D + t) * h2 + i) * w2 + j0;
  for (int tile = warp; tile < (kRows / 16) * col_tiles; tile += kWarps) {
    const int rt = tile / col_tiles, ct = tile % col_tiles;
    if (rt * 16 >= nj) continue;  // warp-uniform
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a_s + rt * 16 * kSA + kk, kSA);
      wmma::load_matrix_sync(fb, w_s + kk * SW + ct * 16, SW);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const int j = rt * 16 + r, e = ct * 16 + c8;
    if (j < nj) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = sc[r * 16 + c8 + k] + bt[(size_t)t * E + e + k];
      *reinterpret_cast<uint4*>(out + (out_row0 + j) * E + e) = lvt::pack8(v);
    }
    __syncwarp();
  }
}

}  // namespace

// out [B, D, H/4, W/4, E] bf16 = the patch embed of x [B, D, H, W, 3] uint8
// (4-byte aligned, contiguous) with folded weights w [96, E] bf16 (rows in
// (kd, kh, kw, c) order) and the per-time bias table bt [D, E] f32.
// H % 4 == W % 4 == 0, E % 16 == 0, E <= 256.
LVT_EXPORT int lvt_patch_embed_u8(const void* x, const void* w, const void* bt, void* out, int B,
                                  int D, int H, int W, int E, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || H % 4 || W % 4 || E <= 0 || E % 16 || E > 256)
    return (int)cudaErrorInvalidValue;
  const int w2 = W / 4, h2 = H / 4;
  if (h2 > 65535 || (long)B * D > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kRows * kSA * 2 + (size_t)kK * (E + 8) * 2 + kWarps * 256 * 4;
  cudaError_t err = cudaFuncSetAttribute(patch_embed_u8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w2 + kRows - 1) / kRows, h2, B * D);
  patch_embed_u8_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bt),
      static_cast<bf16*>(out), D, H, W, E);
  return (int)cudaGetLastError();
}
