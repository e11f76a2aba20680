// Tiled bf16 GEMM with fused epilogues:  C = epi(A @ W^T + bias [, R]).
//
// The dense products that the TPU kernels ran inside one pallas_call (the
// qkv / proj / fc1 / fc2 dots of lavender_tpu/ops/swin_block_attn.py
// _block_kernel_wm, fused_mlp.py _chunked_kernel and _ffn_post_ln_kernel,
// encoder_attention.py _attn_block_kernel_kmask) run here.  A is [M, K]
// row-major, W is a torch Linear weight [N, K] row-major (so both operands
// are K-contiguous: the tensor cores' row.col form), f32 accumulation.
//
// Bound on the card: tensor-core throughput for the Swin stage 1-3 products
// (M = B*nW*248 rows, K and N of 128..4096); the BERT products (M = B*276)
// are too short to fill 132 SMs with 128-row tiles.  Design: 128x128x32
// block tiles, 8 warps of 32x64 each on nvcuda::wmma 16x16x16 fragments,
// a two-stage cp.async pipeline (zero-filled past M and N), and the bias /
// exact-erf GELU / residual epilogue applied while the accumulators go to
// device memory, so no f32 intermediate is ever stored.  wgmma and TMA are
// left for a later change.
//
// An optional row index scatters the epilogue: output row m (and its
// residual row) is row rows[m] of C (and R), and is dropped where rows[m] <
// 0.  The spatial Swin block K14 (lavender_tpu/ops/swin_block_attn.py
// _block_kernel) computes its proj in window order and stores it, residual
// added, straight into the spatial layout this way; the shifted wm block
// K16 (_block_kernel_wm_shift) stores through the wm shift, whose window
// tail-pad rows (-1) have no destination.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int SK = BK + 8;  // padded smem row (80 bytes): spreads banks
constexpr int kThreads = 256;
constexpr int kStage = (BM + BN) * SK;  // elements of one pipeline stage

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void load_stage(bf16* st, const bf16* A, int lda, const bf16* W,
                                           int ldw, int M, int N, int m0, int n0, int k0) {
  constexpr int kChunks = BK / 8;  // 16-byte chunks per tile row
  for (int c = threadIdx.x; c < BM * kChunks; c += kThreads) {
    int r = c / kChunks, k8 = (c % kChunks) * 8;
    bool ok = m0 + r < M;
    const bf16* src = A + (size_t)(ok ? m0 + r : 0) * lda + k0 + k8;
    cp_async16(st + r * SK + k8, src, ok);
  }
  bf16* ws = st + BM * SK;
  for (int c = threadIdx.x; c < BN * kChunks; c += kThreads) {
    int r = c / kChunks, k8 = (c % kChunks) * 8;
    bool ok = n0 + r < N;
    const bf16* src = W + (size_t)(ok ? n0 + r : 0) * ldw + k0 + k8;
    cp_async16(ws + r * SK + k8, src, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
    gemm_bf16_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ W, int ldw,
                     const bf16* __restrict__ bias, const bf16* __restrict__ R, int ldr,
                     bf16* __restrict__ C, int ldc, int M, int N, int K, int epi,
                     const int* __restrict__ rows) {
  __shared__ __align__(128) bf16 smem[2 * kStage];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps, 32 x 64 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = K / BK;
  load_stage(smem, A, lda, W, ldw, M, N, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const bf16* cur = smem + (kt & 1) * kStage;
    if (kt + 1 < KT) {
      load_stage(smem + ((kt + 1) & 1) * kStage, A, lda, W, ldw, M, N, m0, n0, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = cur;
    const bf16* ws = cur + BM * SK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], as + (wm * 32 + i * 16) * SK + kk, SK);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], ws + (wn * 64 + j * 16) * SK + kk, SK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration overwrites the stage just read
  }

  // Epilogue: each warp stages one 16x16 accumulator at a time in its own
  // 1 KB of the (now idle) tile memory; lane l then owns row l/2, 8 columns.
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 32 + i * 16 + r;
      const int gc = n0 + wn * 64 + j * 16 + c;
      const int dst = gr < M ? (rows == nullptr ? gr : rows[gr]) : -1;
      if (dst >= 0 && gc < N) {  // N % 8 == 0, so all 8 columns are in range
        const size_t orow = dst;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = scratch[r * 16 + c + e];
        if (bias != nullptr) {
          float bv[8];
          lvt::unpack8(*reinterpret_cast<const uint4*>(bias + gc), bv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += bv[e];
        }
        if (epi == kBiasGelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.5f * v[e] * (1.0f + erff(v[e] * 0.70710678118654752f));
        } else if (epi == kBiasResidual) {
          float rv[8];
          lvt::unpack8(*reinterpret_cast<const uint4*>(R + orow * ldr + gc), rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += rv[e];
        }
        *reinterpret_cast<uint4*>(C + orow * ldc + gc) = lvt::pack8(v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// C[M, N] (row stride ldc) = epi(A[M, K] @ W[N, K]^T + bias[N] [+ R[M, N]]).
// Requires K % 32 == 0, N % 8 == 0, all strides % 8 == 0 and 16-byte
// aligned pointers (checked by the Python wrapper).  bias may be null;
// rows (int32 [M], distinct rows of C, or null) sends output row m to C's
// and R's row rows[m], and drops it where rows[m] < 0.
LVT_EXPORT int lvt_gemm_bf16(const void* A, int lda, const void* W, int ldw, const void* bias,
                             const void* R, int ldr, void* C, int ldc, int M, int N, int K,
                             int epi, const void* rows, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  if (epi == kBiasResidual && R == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  gemm_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), lda, static_cast<const bf16*>(W), ldw,
      static_cast<const bf16*>(bias), static_cast<const bf16*>(R), ldr, static_cast<bf16*>(C), ldc,
      M, N, K, epi, static_cast<const int*>(rows));
  return (int)cudaGetLastError();
}
