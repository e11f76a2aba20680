// The pieces of the attention cores' Hopper kernels (the forward of
// attention_fwd_wgmma.cu, the backwards of attention_bwd_wgmma.cu): wgmma's
// shared-memory descriptors and its m64n16/32/64k16 products (A from shared
// memory or registers), the fences around them, the 4-D tensor maps of a
// (sequence, head) operand's 64-row boxes and their TMA copies, the
// elements of a TMA box in the 128-byte swizzle, and the arrival of a
// thread's cp.async copies on an mbarrier.  Internal to each
// source that includes it.
#pragma once

#include "attention_tc.cuh"
#include "gemm_tc.cuh"

namespace {

using namespace lvt::tc;

constexpr int kT = 64;      // rows of a query tile and of a key tile
constexpr int kCons = 128;  // one warpgroup

// wgmma's descriptor of a tile whose rows are sw bytes (128, 64 or 32) in
// the swizzle of that width, its 8-row groups 8 * sw bytes apart.  K-major:
// the product's depth along the row (the leading offset unused);
// MN-major (mn): the depth down the rows, the leading offset being the
// next swizzle atom along the row, which an operand one atom wide (64 x
// 64, 32 or 16) never reaches: set to the group offset as well.
__device__ __forceinline__ uint64_t desc(uint32_t addr, int sw, bool mn) {
  const uint64_t mode = sw == 128 ? 1 : (sw == 64 ? 2 : 3);
  const uint64_t sbo = (uint64_t)(8 * sw) >> 4, lbo = mn ? sbo : 1;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (mode << 62);
}

// d (64 x N f32 of the warpgroup) += A (64 x 16) . B (16 x N): ss with A
// and B in shared memory (TA / TB 1: MN-major), rs with A from registers
// (the m16n8k16 A fragment of each warp's 16 rows); acc 0: d = A . B.
template <int TA, int TB>
__device__ __forceinline__ void ss(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie registers to this point of the instruction stream: wgmma reads and
// writes them asynchronously, until its wait_group.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The box of a 4-D tensor map at (c0, c1, c2, c3) by the TMA; its bytes
// count towards the barrier.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Element (r, col) of a 64 x 64 bf16 box that the TMA staged in the
// 128-byte swizzle: row r at 128 r bytes, its 16-byte chunk k at k ^ (r %
// 8).
__device__ __forceinline__ float box_in(const char* s, int r, int col) {
  const int b = 2 * col;
  return __bfloat162float(
      *reinterpret_cast<const bf16*>(s + r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15)));
}

// An arrival on the barrier once this thread's cp.async copies so far have
// landed (its count includes it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The 4-D tensor map (hd, N, nH, nSeq) of one bf16 operand, row r of
// (sequence s, head h) at ptr + s * st[0] + h * st[1] + r * st[2]
// elements, boxes of 64 rows x hd in the swizzle of 2 * hd bytes; rows
// past N zero-filled.  An extent-1 dimension is never stepped, so its
// stride is replaced by a legal one.  False where cuTensorMapEncodeTiled
// refuses it.
bool head_map(CUtensorMap* map, const bf16* ptr, const long long (&st)[3], int nSeq, int nH, int N,
              int hd) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)N, (cuuint64_t)nH, (cuuint64_t)nSeq};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const int ext[3] = {N, nH, nSeq};
  for (int i = 0; i < 3; ++i)
    if (ext[i] == 1) strides[i] = i == 0 ? 2 * (cuuint64_t)hd : strides[i - 1];
  const cuuint32_t box[4] = {(cuuint32_t)hd, kT, 1, 1}, unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = hd == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : (hd == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
