// The wgmma + TMA tile GEMM (gemm_tc.cu) as its users call it: K1's, K3's,
// K4's, K6's, K9's, K14's and K16's products (blocks.cu) and K5's and
// K12's long-M fc1 / fc2 and row kernel (ffn_post_ln.cu), and the device
// pieces the tile is built from: the Tensor Memory Accelerator's tensor
// maps and copies, the mbarriers that report them, the 128-byte-swizzle
// descriptor and the m64n128k16 warpgroup product.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "mma_tile.cuh"

namespace lvt {

// Epilogues of the tile GEMM: C = A . W^T + bias, then nothing, the GELU
// in its erf form (erf to 1.5e-7, gemm_tc.cu), or + R (bf16 out); or the
// f32 partial sum of one K-slice, bias-free, into part [S, M, N]; or the
// residual's row scatter: row m goes to out row rows[m] with R[rows[m]]
// added, and is dropped where rows[m] < 0 (K14's proj), or in its zeroing
// instance, where rows[m] < 0, a zero row goes to out row m itself (K16's
// proj: its pad rows, which no index names, come out zero).
enum GemmEpi {
  kEpiBias = 0,
  kEpiGelu = 1,
  kEpiResidual = 2,
  kEpiPartial = 3,
  kEpiScatter = 4,
  kEpiScatterZero = 5
};

// One tile-GEMM launch: out = epi(A [M, K] . W_g [N, K]^T + bias_g) for g
// < G, weight g's columns at out + g * N.  A's rows lda elements apart,
// every W_g contiguous, out's rows ldc apart (>= G * N) and R's ldr apart;
// bm the tile's rows (64, 128 or 256, BN = 128 columns); S the K-slices of
// the partial epilogue (S = 1 otherwise; whole 64-deep steps a slice),
// whose out is f32 [S, M, N].  K, N, lda, ldc, ldr multiples of 8, pointers
// 16-byte aligned; G in 1..3, G = 1 when S > 1.  rows: the scatter
// epilogues' int32 [M] (null for the others).
struct GemmTc {
  const bf16* a;
  long long lda;
  const bf16* w[3];
  const bf16* bias[3];  // each may be null
  int G;
  void* out;
  long long ldc;
  const bf16* r;
  long long ldr;
  int M, N, K, epi, bm, S;
  const int* rows = nullptr;
};

// Returns a cudaError_t.
int gemm_tc(const GemmTc& g, cudaStream_t stream);

// out[row] = LN(sum_s part[s, row] + b + x[row]) * ln_w + ln_b, the S f32
// slices [S, M, C] summed in the order s = 0..S-1, LN in f32 (two-pass
// variance); x, b, ln_w, ln_b, out bf16, C % 4 == 0, C <= 1024.  Returns a
// cudaError_t.
int rows_ln(const float* part, int S, const bf16* x, const bf16* b, const bf16* ln_w,
            const bf16* ln_b, bf16* out, int M, int C, float eps, cudaStream_t stream);

// The same row kernel without the LN: out[row] = sum_s part[s, row] + b +
// x[row] in f32 (the slices in the order s = 0..S-1), rounded to bf16; x
// and b each may be null.  C % 4 == 0, C <= 1024.  Returns a cudaError_t.
int rows_sum(const float* part, int S, const bf16* x, const bf16* b, bf16* out, int M, int C,
             cudaStream_t stream);

// The same row kernel with the hidden dropout of K11 before the residual:
// out[row] = LN(x[row] + m * (sum_s part[s, row] + b)) in f32, m the
// dropout of element (row, col) from the counter hash of dropout.cuh
// (stream row, index col), kept iff its bits >= thresh and scaled by
// drop_scale; keep [M, C] receives m != 0 as one byte an element (all
// ones where seed, an int64 on the device, is null: no dropout).  C % 4
// == 0, C <= 1024.  Returns a cudaError_t.
int rows_dropout_ln(const float* part, int S, const bf16* x, const bf16* b, const bf16* ln_w,
                    const bf16* ln_b, bf16* out, uint8_t* keep, int M, int C, float eps,
                    const int64_t* seed, uint32_t thresh, float drop_scale, cudaStream_t stream);

namespace wg {

constexpr int BN = 128;  // a tile's columns: the m64n128k16 product's n
constexpr int BK = 64;   // one 128-byte row of bf16: the swizzle's width

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(bar)), "r"(count)
               : "memory");
}

// Wait for phase `parity` of the barrier to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(tc::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_addr(bar)) : "memory");
}

// This thread's arrival, and `bytes` more that the copies below must land
// before the barrier's phase completes.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// The box of a 2-D tensor map at (column k0, row r0) into shared memory
// by the Tensor Memory Accelerator; rows and columns past the tensor are
// zero-filled, and all the box's bytes count towards the barrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k0,
                                         int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_addr(bar)), "r"(k0), "r"(r0)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart, the start 16-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x 128 f32 of a warpgroup) += A (64 x 16) . W (128 x 16)^T, both
// from shared memory
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t dw) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(dw), "r"(1));
}

// Tie the accumulators to this point of the instruction stream: the
// compiler may not move their reads or writes across it (wgmma writes
// them asynchronously, until its wait_group).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A [rows, cols] bf16, rows ld elements apart, as a tensor map of
// box_rows x BK boxes in the 128-byte swizzle (cuTensorMapEncodeTiled,
// looked up once; the last maps made are kept, a map being a function of
// its arguments alone).  Returns false where the CUDA driver refuses it.
bool tile_map(CUtensorMap* map, const void* ptr, int rows, int cols, long long ld, int box_rows);

}  // namespace wg
}  // namespace lvt
