// The tensor-core tile helpers of the attention cores' mma.sync forward
// (attention_fwd_tc.cu): a block of kThreads = 4 warps owns a 64-row tile
// of one (sequence, head), each warp 16 rows, and sweeps 64-row tiles of
// the other side staged in shared memory by cp.async; products run as
// mma.sync m16n8k16 (bf16 operands from ldmatrix, f32 accumulation).  The
// wgmma kernels (attention_wg.cuh) share its cp.async, mask-tile and ex2
// pieces.
#pragma once

#include "common.cuh"
#include "dropout.cuh"

namespace lvt::tc {

constexpr int kRows = 64;      // rows of a block's own tile
constexpr int kCols = 64;      // rows of each swept tile
constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

// Blocks an SM the kernels are cut for: 3 (at most 168 registers a
// thread) with a bf16 mask; with an f32 mask only 2 fit in shared memory,
// and the registers stay at 255.
template <typename M>
inline constexpr int kBlocks = sizeof(M) == 2 ? 3 : 2;

// exp2 on the special-function unit (the __expf path without its multiply)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V bytes global -> shared, the first n of them from src and the rest
// (all V where n = 0) zero-filled; V = 16 bypasses L1.
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(V), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A mask tile: rows r0.. (64) x columns c0.. (64) of the mask of window w
// in shared memory.  Its rows are copied in the widest of 16, 8 or 4 bytes
// that divides the mask's row pitch (ld * sizeof(M), ld the elements
// between rows: N, or more where a caller pads the rows): at odd N a bf16
// row starts on a 2-byte boundary, which no asynchronous copy can, so there
// each row is fetched as the 4-byte words around it and its elements
// start at byte (start & 3) of the row (the lead; 0 on the wider paths).
// A row holds kWords words: 64 elements + 16 bytes, a multiple of 16 bytes.
// An ld of 0 stands for N.
template <typename M>
struct MaskTile {
  static constexpr int kWords = (kCols * (int)sizeof(M) + 16) / 4;
  static constexpr int kBytes = kRows * kWords * 4;
};

// byte offset in the mask buffer of element (row, col) of window w
template <typename M>
__device__ __forceinline__ long long mask_byte(int w, int row, int col, int N, int ld = 0) {
  return (((long long)w * N + row) * (ld ? ld : N) + col) * (long long)sizeof(M);
}

// bytes of an [n, N, N] mask buffer with row pitch ld, up to its last
// element
template <typename M>
__device__ __forceinline__ long long mask_span(int n, int N, int ld) {
  return (((long long)n * N - 1) * ld + N) * (long long)sizeof(M);
}

// kRows rows of the tile in V-byte copies, row r from byte row0 + r * pitch
// of the buffer; copies past its end (m_bytes) are cut or zero-filled.
template <typename M, int V>
__device__ __forceinline__ void copy_mask_rows(uint32_t* s, const char* base, long long m_bytes,
                                               long long row0, long long pitch) {
  constexpr int W = MaskTile<M>::kWords;
  constexpr int PER = kCols * (int)sizeof(M) / V + (V == 4 ? 1 : 0);  // copies a row
#pragma unroll
  for (int u = 0; u < (kRows * PER + kThreads - 1) / kThreads; ++u) {
    const int c = threadIdx.x + u * kThreads;
    if (c >= kRows * PER) break;
    const int r = c / PER, k = c - r * PER;
    const long long b = ((row0 + r * pitch) & ~(long long)(V - 1)) + (long long)V * k;
    const long long left = m_bytes - b;
    const int n = left >= V ? V : (left > 0 ? (int)left : 0);
    cp_async<V>(s + r * W + k * (V / 4), base + (n > 0 ? b : 0), n);
  }
}

// Stage a mask tile; m_bytes is the buffer's size.
template <typename M>
__device__ __forceinline__ void load_mask(uint32_t* s, const void* m, long long m_bytes, int w,
                                          int r0, int c0, int N, int ld = 0) {
  const char* base = static_cast<const char*>(m);
  const long long row0 = mask_byte<M>(w, r0, c0, N, ld),
                  pitch = (long long)(ld ? ld : N) * sizeof(M);
  if (pitch % 16 == 0)
    copy_mask_rows<M, 16>(s, base, m_bytes, row0, pitch);
  else if (pitch % 8 == 0)
    copy_mask_rows<M, 8>(s, base, m_bytes, row0, pitch);
  else
    copy_mask_rows<M, 4>(s, base, m_bytes, row0, pitch);
}

// Element (r, col) of a staged tile whose row r starts at byte lead (0..3)
// of its first word.
template <typename M>
__device__ __forceinline__ float mask_in(const uint32_t* s, int r, int lead, int col) {
  const char* p = reinterpret_cast<const char*>(s + r * MaskTile<M>::kWords) + lead +
                  col * (int)sizeof(M);
  if constexpr (sizeof(M) == 2)
    return __bfloat162float(*reinterpret_cast<const bf16*>(p));
  else
    return *reinterpret_cast<const float*>(p);
}

// Fragment coordinates (lane = 4 * g + t): accumulator element e of n-tile
// n is (row g + 8 * (e / 2), column 8 * n + 2 * t + e % 2) of the warp's
// 16 x 64 (or 16 x hd) block.

// A tile of 64 rows x HD from rows row0.. of a (sequence, head) with row
// stride ld into shared memory (row stride HD + 8: ldmatrix's 8 rows fall
// in distinct banks); rows >= N are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld, int row0, int N) {
  constexpr int LD = HD + 8, V = HD / 8;
#pragma unroll
  for (int u = 0; u < kRows * V / kThreads; ++u) {
    const int c = threadIdx.x + u * kThreads, r = c / V, k8 = (c % V) * 8;
    const bool ok = row0 + r < N;
    cp_async<16>(s + r * LD + k8, g + (ok ? (row0 + r) * ld + k8 : 0), ok ? 16 : 0);
  }
}

// The warp's 16 rows of a [64, HD] tile as A fragments, one per 16 columns.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4], const bf16* t, int warp,
                                       int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm4(a[kk], t + (warp * 16 + (lane & 15)) * LD + kk * 16 + ((lane >> 4) << 3));
}

// acc (16 x 8 NT) = A (16 x HD, fragments a) . T^T, T an [8 NT, HD] tile:
// the warp's rows against the rows of T.
template <int HD, int NT = 8>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&a)[HD / 16][4],
                                        const bf16* t, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm4(b, t + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                   (((lane >> 3) & 1) << 3));
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x HD) += P (16 x 8 NT, an accumulator rounded to bf16) . T, T
// an [8 NT, HD] tile: the accumulator's fragments are the A operand's.
template <int HD, int NT = 8>
__device__ __forceinline__ void mma_ab(float (&acc)[HD / 8][4], const float (&p)[NT][4],
                                       const bf16* t, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack2(p[2 * kk][0], p[2 * kk][1]), pack2(p[2 * kk][2], p[2 * kk][3]),
                           pack2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm4_t(b, t + (kk * 16 + (lane & 15)) * LD + dp * 16 + ((lane >> 4) << 3));
      mma(acc[2 * dp], a, b[0], b[1]);
      mma(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// rows row[0], row[1] (< N only) of a [*, HD] output at base + row * ld:
// acc (16 x HD) * scale in bf16
template <int HD>
__device__ __forceinline__ void store_rows(bf16* base, long long ld, const int (&row)[2], int N,
                                           const float (&acc)[HD / 8][4], float scale, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= N) continue;
    bf16* dst = base + row[r] * ld + 2 * tq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// The dropout factor of element index e: 1 without dropout.
template <bool DROP>
__device__ __forceinline__ float drop_factor(uint32_t key, uint32_t e, uint32_t thresh,
                                             float drop_scale) {
  if constexpr (!DROP) return 1.0f;
  return lvt::dropout_bits(key, e) >= thresh ? drop_scale : 0.0f;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace lvt::tc
