// The BERT FFN sub-block (K5):  out = LN(x + fc2(GELU(fc1 x + b1)) + b2).
//
// Replaces lavender_tpu/ops/fused_mlp.py _ffn_post_ln_kernel (:283), the
// serving FFN of every fusion-encoder layer: x [M, C] bf16, w1 [HD, C] and
// w2 [C, HD] (torch Linear layout), f32 accumulation, exact-erf GELU, the
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
// - long M: 128 x 128 tiles of 2 warpgroups on wgmma (m64n128k16, both
//   operands from shared memory in the 128-byte swizzle), fed by the
//   Tensor Memory Accelerator through a 3-stage ring of 64-deep K steps
//   (97 KB: 2 blocks an SM); fc1 with the bias + GELU epilogue, fc2
//   split-K by S so that >= 132 blocks run, writing f32 partials.  wgmma
//   rather than mma.sync: the same tiles on mma.sync from ldmatrix
//   fragments were slower than one PyTorch call for the whole sub-block.
// - both: one block a row sums the S partials in the order s = 0..S-1,
//   adds bias and residual, and applies LN in f32 (two-pass variance).
//
// Every sum is taken in a fixed order and nothing is atomic, so two calls
// give the same bits.  The wrapper passes h [M, HD] bf16 and the partials
// [S, M, C] f32 as scratch.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "mma_tile.cuh"

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

// ---- long M --------------------------------------------------------------

constexpr int BM = 128, BN = 128;  // a block's tile: 2 warpgroups of 64 rows x 128 columns
constexpr int BK = 64;             // one 128-byte row of bf16: the swizzle's width
constexpr int kStages = 3;
constexpr int kTileThreads = 256;
constexpr int kSideBytes = BM * BK * 2;  // 16 KB of A (or W) a stage
constexpr int kStageBytes = 2 * kSideBytes;
constexpr size_t kTileSmem = (size_t)kStages * kStageBytes + 1024;  // + 1 KB to align

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(tc::smem_addr(bar)) : "memory");
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

// One stage's two tiles by the Tensor Memory Accelerator: A rows m0 .. m0
// + 128 and W rows n0 .. n0 + 128 at K columns k0 .. k0 + 64, 128 bytes a
// row in the 128-byte swizzle, rows past the tensor zero-filled; the
// barrier completes when all 32 KB have landed.
__device__ __forceinline__ void load_stage(char* s, uint64_t* bar, const CUtensorMap* a,
                                           const CUtensorMap* w, int m0, int n0, int k0) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(kStageBytes)
               : "memory");
  const CUtensorMap* maps[2] = {a, w};
  const int rows[2] = {m0, n0};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(tc::smem_addr(s + i * kSideBytes)),
        "l"(reinterpret_cast<uint64_t>(maps[i])), "r"(tc::smem_addr(bar)), "r"(k0), "r"(rows[i])
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

// C tile (m0, n0) of A [M, K] . W [N, K]^T (tensor maps) over K range
// [blockIdx.z * k_split, + k_split), on wgmma: each warpgroup multiplies
// its 64 rows of the stage's A tile by the W tile, 4 k-steps of 16, while
// thread 0 keeps the next stages' loads in flight.  GELU: + bias, GELU,
// into H [M, N] bf16; else the f32 partial of slice blockIdx.z into
// P [S, M, N].
template <bool GELU>
__global__ void __launch_bounds__(kTileThreads, 2)
    tile_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                const bf16* __restrict__ bias, bf16* __restrict__ H, float* __restrict__ P, int M,
                int N, int k_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  char* base = reinterpret_cast<char*>(smem_raw) + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_addr(base);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, kb = blockIdx.z * k_split;
  const int KT = k_split / BK;
  const int wg = threadIdx.x / 128;
  const bool producer = threadIdx.x == 0;
  if (producer) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer)
    for (int s = 0; s < kStages - 1 && s < KT; ++s)
      load_stage(base + s * kStageBytes, &full[s], &map_a, &map_w, m0, n0, kb + s * BK);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  for (int kt = 0; kt < KT; ++kt) {
    const int slot = kt % kStages;
    mbar_wait(&full[slot], (kt / kStages) & 1);  // stage kt has landed
    __syncthreads();  // every warpgroup is past stage kt - 1's products
    const uint32_t sa = sbase + slot * kStageBytes + wg * 64 * 128;
    const uint32_t sw = sbase + slot * kStageBytes + kSideBytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) wgmma_128(acc, smem_desc(sa + 32 * j), smem_desc(sw + 32 * j));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    const int nk = kt + kStages - 1;  // into the slot stage kt - 1 held
    if (producer && nk < KT)
      load_stage(base + (nk % kStages) * kStageBytes, &full[nk % kStages], &map_a, &map_w, m0, n0,
                 kb + nk * BK);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }
  // accumulator element 4j + e: row g + 8 (e / 2) of the warp's 16, column
  // 8j + 2t + e % 2
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int row0 = m0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= M || col >= N) continue;  // N % 8 == 0: col + 1 < N too
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if constexpr (GELU)
        *reinterpret_cast<uint32_t*>(H + (size_t)row * N + col) =
            tc::pack2(gelu(v0 + __bfloat162float(bias[col])),
                      gelu(v1 + __bfloat162float(bias[col + 1])));
      else
        *reinterpret_cast<float2*>(P + ((size_t)blockIdx.z * M + row) * N + col) =
            make_float2(v0, v1);
    }
  }
}

// ---- the row epilogue ----------------------------------------------------

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = lvt::warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) s += red[w];
  __syncthreads();  // red is written again by the next sum
  return s;
}

// out[row] = LN(sum_s P[s, row] + b2 + x[row]), 4 columns a thread (C / 4
// threads, rounded up to whole warps; the rest add zeros to the sums).
__global__ void __launch_bounds__(256)
    rows_kernel(const float* __restrict__ P, int S, const bf16* __restrict__ x,
                const bf16* __restrict__ b2, const bf16* __restrict__ ln_w,
                const bf16* __restrict__ ln_b, bf16* __restrict__ out, int M, int C, float eps) {
  __shared__ float red[8];
  const bool on = (int)threadIdx.x * 4 < C;
  const int c = on ? (int)threadIdx.x * 4 : 0;  // an idle thread reads column 0
  const size_t off = (size_t)blockIdx.x * C + c;
  float4 p = *reinterpret_cast<const float4*>(P + off);
  for (int s = 1; s < S; ++s) {
    const float4 q = *reinterpret_cast<const float4*>(P + (size_t)s * M * C + off);
    p.x += q.x, p.y += q.y, p.z += q.z, p.w += q.w;
  }
  const uint2 xv = *reinterpret_cast<const uint2*>(x + off);
  const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.x));
  const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.y));
  float v[4] = {p.x + __bfloat162float(b2[c]) + x01.x, p.y + __bfloat162float(b2[c + 1]) + x01.y,
                p.z + __bfloat162float(b2[c + 2]) + x23.x, p.w + __bfloat162float(b2[c + 3]) + x23.y};
  const float mean = block_sum(on ? (v[0] + v[1]) + (v[2] + v[3]) : 0.0f, red) / C;
  float q = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) q += (v[e] - mean) * (v[e] - mean);
  const float rstd = rsqrtf(block_sum(on ? q : 0.0f, red) / C + eps);
  if (!on) return;
  uint2 o;
  o.x = tc::pack2((v[0] - mean) * rstd * __bfloat162float(ln_w[c]) + __bfloat162float(ln_b[c]),
                  (v[1] - mean) * rstd * __bfloat162float(ln_w[c + 1]) +
                      __bfloat162float(ln_b[c + 1]));
  o.y = tc::pack2((v[2] - mean) * rstd * __bfloat162float(ln_w[c + 2]) +
                      __bfloat162float(ln_b[c + 2]),
                  (v[3] - mean) * rstd * __bfloat162float(ln_w[c + 3]) +
                      __bfloat162float(ln_b[c + 3]));
  *reinterpret_cast<uint2*>(out + off) = o;
}

// A [rows, cols] bf16 (row-major, contiguous) as a tensor map of 128 x 64
// boxes in the 128-byte swizzle (cuTensorMapEncodeTiled, looked up once).
// The last few maps made: a map is a function of (pointer, rows, cols)
// alone, and the weights and the scratch come back call after call.
struct MapEntry {
  const void* ptr;
  int rows, cols;
  CUtensorMap map;
};
MapEntry map_cache[16];
int map_next = 0;

bool tile_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  for (const MapEntry& e : map_cache)
    if (e.ptr == ptr && e.rows == rows && e.cols == cols) {
      *map = e.map;
      return true;
    }
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
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {BK, BM}, unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  map_cache[map_next] = {ptr, rows, cols, *map};
  map_next = (map_next + 1) % 16;
  return true;
}

}  // namespace

// out [M, C] = LN(x + fc2(GELU(x w1^T + b1)) + b2) * ln_w + ln_b, all bf16
// and contiguous, x and the weights 16-byte aligned; h [M, HD] bf16 and
// part [S, M, C] f32 are scratch.  short_m (M <= 64) picks the regime, S
// fc2's K-slices (HD / S a multiple of 32, of BK when long).  C % 32 == 0
// (of BK when long), C <= 1024, HD % 32 == 0.
LVT_EXPORT int lvt_ffn_post_ln_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                                    const void* b2, const void* ln_w, const void* ln_b, void* h,
                                    void* part, void* out, int M, int C, int HD, int S, int short_m,
                                    float eps, void* stream) {
  if (M <= 0 || C <= 0 || C % 32 != 0 || C > 1024 || HD <= 0 || HD % 32 != 0 || S < 1 ||
      (HD / 32) % S != 0 || (short_m && M > 64) || (M + BM - 1) / BM > 65535 ||
      (!short_m && (C % BK != 0 || (HD / S) % BK != 0)))
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
  } else {
    if ((err = tc::allow_smem(tile_kernel<true>, kTileSmem)) != cudaSuccess ||
        (err = tc::allow_smem(tile_kernel<false>, kTileSmem)) != cudaSuccess)
      return (int)err;
    CUtensorMap mx, mw1, mh, mw2;
    if (!tile_map(&mx, x, M, C) || !tile_map(&mw1, w1, HD, C) || !tile_map(&mh, h, M, HD) ||
        !tile_map(&mw2, w2, C, HD))
      return (int)cudaErrorInvalidValue;
    const int bands = (M + BM - 1) / BM;
    tile_kernel<true><<<dim3((HD + BN - 1) / BN, bands), kTileThreads, kTileSmem, st>>>(
        mx, mw1, static_cast<const bf16*>(b1), H, nullptr, M, HD, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    tile_kernel<false><<<dim3((C + BN - 1) / BN, bands, S), kTileThreads, kTileSmem, st>>>(
        mh, mw2, nullptr, nullptr, P, M, C, HD / S);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  rows_kernel<<<M, (C / 4 + 31) / 32 * 32, 0, st>>>(
      P, S, X, static_cast<const bf16*>(b2), static_cast<const bf16*>(ln_w),
      static_cast<const bf16*>(ln_b), static_cast<bf16*>(out), M, C, eps);
  return (int)cudaGetLastError();
}
