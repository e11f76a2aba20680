// The tile GEMM on wgmma and the Tensor Memory Accelerator:
//   out = epi(A [M, K] . W_g [N, K]^T + bias_g),  g < G,
// bf16 operands, f32 accumulation; epi the bias alone, + the GELU in its
// erf form, + a residual R (in place, or scattered through a row index), or
// the f32 partial sum of one K-slice (see gemm_tc.cuh).
//
// Replaces the dense products of two TPU kernels, which ran them inside
// one pallas_call: lavender_tpu/ops/swin_block_attn.py _block_kernel_wm
// (K1: qkv + bias, proj + bias + residual, fc1 + bias + GELU, fc2 + bias +
// residual, on the window-major rows of the Swin block) and
// lavender_tpu/ops/encoder_attention.py _attn_block_kernel_kmask (K4: q, k
// and v in ONE launch, a tile's slice z picking the weight, the bias and
// the output's column block of the packed [M, 3C] slab, so that the weights
// are not concatenated; proj as f32 K-slices that the row kernel below
// sums with the bias and the residual before the LN).  K5's long-M fc1 and
// fc2 (lavender_tpu/ops/fused_mlp.py _ffn_post_ln_kernel, ffn_post_ln.cu)
// run here too, and its LN in the row kernel; so do K3's and K9's LN +
// MLP (lavender_tpu/ops/fused_mlp.py _chunked_kernel and _kernel, through
// blocks.cu), whose fc2 K-slices the row kernel sums without an LN; K6's
// (encoder_attention.py _attn_block_kernel, K4's launches under a full
// mask, blocks.cu); and K11's proj (fused_mlp.py _out_ln_train_kernel:
// f32 K-slices that the row kernel's dropout mode sums with the bias,
// drops by the counter hash of dropout.cuh, adds to the residual and
// normalizes, writing the keep mask, lvt_gemm_tc_dropout_ln_bf16 below).
// K12's fc1 and fc2 (fused_mlp.py _ffn_post_ln_train_kernel) are K5's,
// into that dropout mode (ffn_post_ln.cu); K14's products
// (swin_block_attn.py _block_kernel, blocks.cu) are K1's, its proj through
// the scatter epilogue, which writes row m of the product, plus the
// residual's row, to the spatial row rows[m] that K14's gathering LN read
// it from (16-byte chunks as the residual epilogue stores them; a row
// index below 0 drops the row).  K16's products (swin_block_attn.py
// _block_kernel_wm_shift, blocks.cu) are K14's on the window-major slab,
// its proj through the scatter epilogue's zeroing instance, which writes
// a zero row at out row m where rows[m] < 0: the shifted slab's pad rows,
// which sit at the same positions in the unshifted output.
//
// Bound on the card: at B = 4 serving, Swin-B stages 1-2 (M = 63,488 /
// 15,872 rows, K = C = 128 / 256) by device memory (the stage-1 qkv
// product moves 65 MB for 6.2 GFLOP: 19 us at 3.35 TB/s, 6 us of tensor
// work), stages 3-4 (M = 3,968 / 992, C = 512 / 1024) and K4 (M = 1104 /
// 1000, C = 768) by the tensor cores' 989 TFLOP/s.  Design: persistent
// blocks, each walking tiles t = blockIdx.x, + gridDim.x, ... of bm x 128
// outputs, bm = 256, 128 or 64 rows (4, 2 or 1 consumer warpgroups of 64
// rows; 1, 2 and 2 blocks an SM), and one producer warp.  Its lane 0 runs
// a ring of 64-deep K steps (4 stages at bm = 256, else 3) ahead across
// tile boundaries, so the next tile's operands load while this one's
// epilogue runs: the A and W boxes of a step by TMA in the 128-byte
// swizzle (rows and columns past the tensor zero-filled, so M, N and K
// need not be multiples of the tile), one mbarrier a stage reporting the
// bytes, another that the consumers' warps arrive on once their products
// have read it.  A consumer warpgroup issues a step as 4 m64n128k16 wgmma
// from shared memory and keeps one step's group in flight while it waits
// for the next stage.  256-row tiles stage 85 FLOP a byte from L2 (64 at
// 128 rows), which the tensor cores need at stage 3-4; ``gemm_tc_plan``
// in lavender_tpu_torch/ops/_build.py picks bm by waves x rows / rate and
// S.  The epilogue adds the bias (and the GELU) in f32 and rounds to
// bf16, stages each warp's 16 x 32 pieces in 1 KB of shared memory, then
// stores 16-byte chunks, 64 contiguous bytes a row, adding the residual's
// chunk there: stores of 2 bf16 a thread straight from the fragments
// (8 rows x 16 bytes a warp instruction) ran the stage-1 products at half
// the memory rate.  The partial epilogue stores f32 pairs.
//
// Every output element is summed by one thread in a fixed order (the
// K-slices by the row kernel in slice order); nothing is atomic, so two
// calls give the same bits.
#include "dropout.cuh"
#include "gemm_tc.cuh"

namespace {

using namespace lvt::wg;
namespace tc = lvt::tc;

// GELU in its erf form, v * Phi(v), Phi(v) = erfc(-v / sqrt 2) / 2, with
// erfc(x) = t P(t) exp(-x^2), t = 1 / (1 + 0.3275911 x) for x >= 0
// (Abramowitz and Stegun 7.1.26, |error| <= 1.5e-7): branch-free, about
// half the instructions of erff's two branches, which diverge in every
// warp; the negative tail without cancellation.
__device__ __forceinline__ float gelu(float v) {
  const float x = fabsf(v) * 0.70710678118654752f;
  const float t = __fdividef(1.0f, fmaf(0.3275911f, x, 1.0f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float q = 0.5f * poly * __expf(-x * x);  // Phi(-|v|)
  return v * (v < 0.0f ? q : 1.0f - q);
}

// The launch's operands: the tensor maps (read by the TMA from the kernel
// parameters, hence __grid_constant__), the epilogue's pointers and the
// tile grid: tile t is column tile t % tiles_n of row band (t / tiles_n)
// % tiles_m of slice z = t / (tiles_n * tiles_m) (weight z / S, K-slice
// z % S), so that the blocks at work at one time share A's bands in L2.
struct TileArgs {
  CUtensorMap a;
  CUtensorMap w[3];
  const bf16* bias[3];
  void* out;
  long long ldc;
  const bf16* r;
  long long ldr;
  int M, N, steps, S;  // steps: the 64-deep K steps of one slice
  int tiles_n, tiles_m, tiles;
  const int* rows;  // kEpiScatter: the output row of each row
};

// bm = 64 WGS rows a tile.  WGS = 4: 48 KB a stage, 4 stages, one block an
// SM; 2: 32 KB, 3 stages, two; 1: 24 KB, 3 stages, two.  Each consumer warp
// also owns 1 KB where its epilogue stages 16 rows x 32 columns.
template <int WGS>
struct Tile {
  static constexpr int kRows = 64 * WGS;
  static constexpr int kThreads = 128 * WGS + 32;  // + the producer warp
  static constexpr int kBlocks = WGS == 4 ? 1 : 2;
  static constexpr int kStages = WGS == 4 ? 4 : 3;
  static constexpr int kABytes = kRows * BK * 2;
  static constexpr int kStageBytes = kABytes + BN * BK * 2;
  static constexpr int kOutBytes = 4 * WGS * 1024;
  static constexpr size_t kSmem =
      (size_t)kStages * kStageBytes + kOutBytes + 1024;  // + 1 KB to align
};

struct TileAt {
  int m0, n0, g, s;
};

__device__ __forceinline__ TileAt tile_at(const TileArgs& p, int t, int rows) {
  const int nt = t % p.tiles_n, r = t / p.tiles_n;
  const int z = r / p.tiles_m;
  return {(r - z * p.tiles_m) * rows, nt * BN, z / p.S, z % p.S};
}

// Persistent: block b takes tiles b, b + gridDim.x, ...  The producer
// warp's lane 0 runs the ring ahead across tile boundaries, so the next
// tile's steps load while the consumers store this one's.
template <int WGS, int EPI>
__global__ void __launch_bounds__(Tile<WGS>::kThreads, Tile<WGS>::kBlocks)
    tile_kernel(const __grid_constant__ TileArgs p) {
  using T = Tile<WGS>;
  constexpr int ST = T::kStages;
  constexpr bool kScatter = EPI == lvt::kEpiScatter || EPI == lvt::kEpiScatterZero;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  char* base = reinterpret_cast<char*>(smem_raw) + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = tc::smem_addr(base);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int KT = p.steps;
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * WGS);  // a warp's arrival each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 4 * WGS) {  // the producer
    if (lane == 0) {
      int it = 0;  // position in the ring, across tiles
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const TileAt at = tile_at(p, t, T::kRows);
        const CUtensorMap* mw = at.g == 0 ? &p.w[0] : (at.g == 1 ? &p.w[1] : &p.w[2]);
        const int kb = at.s * KT * BK;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int slot = it % ST;
          if (it >= ST) mbar_wait(&empty[slot], (it / ST - 1) & 1);
          char* st = base + slot * T::kStageBytes;
          mbar_expect(&full[slot], T::kStageBytes);
          tma_load(st, &p.a, &full[slot], kb + kt * BK, at.m0);
          tma_load(st + T::kABytes, mw, &full[slot], kb + kt * BK, at.n0);
        }
      }
    }
    return;
  }
  const int wgi = warp / 4;
  const int gq = lane >> 2, t4 = lane & 3;
  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const TileAt at = tile_at(p, t, T::kRows);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int slot = it % ST;
      mbar_wait(&full[slot], (it / ST) & 1);  // step it has landed
      const uint32_t sa = sbase + slot * T::kStageBytes + wgi * 64 * 128;
      const uint32_t sw = sbase + slot * T::kStageBytes + T::kABytes;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_128(acc, smem_desc(sa + 32 * j), smem_desc(sw + 32 * j));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // step it - 1 is read
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % ST]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % ST]);  // the tile's last step

    // accumulator element 4j + e: row g + 8 (e / 2) of the warp's 16,
    // column 8j + 2t + e % 2.  Partial: f32 pairs straight from them (a
    // quad's 32 bytes fill a sector).  Else + bias (and the GELU) in f32,
    // rounded to bf16, through the warp's 1 KB in 4 passes of 32 columns:
    // 16-byte chunk k of row r held at chunk k ^ ((r / 2) % 4), so that
    // neither the pairs' writes nor the chunks' reads conflict; then each
    // lane takes two 16-byte chunks, adds the residual's (loaded at the
    // pass's start) in f32, and stores them, 4 lanes a row's 64 bytes.
    const int row0 = at.m0 + wgi * 64 + (warp % 4) * 16;
    const int M = p.M, N = p.N;
    if constexpr (EPI == lvt::kEpiPartial) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = at.n0 + 8 * j + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + gq + 8 * half;
          if (row < M && col < N)
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) +
                                       ((size_t)at.s * M + row) * N + col) =
                make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
    } else {
      const bf16* bias = at.g == 0 ? p.bias[0] : (at.g == 1 ? p.bias[1] : p.bias[2]);
      uint32_t* so = reinterpret_cast<uint32_t*>(base + ST * T::kStageBytes) + warp * 256;
      int dst[2] = {-1, -1};  // kEpiScatter: the output rows of this lane's two rows
      if constexpr (kScatter) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + lane / 4 + 8 * i;
          dst[i] = row < M ? __ldg(p.rows + row) : -1;
        }
      }
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
        uint4 rv[2];  // the residual's two chunks, in flight while this pass stages
        if constexpr (EPI == lvt::kEpiResidual) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + lane / 4 + 8 * i, col = at.n0 + 32 * q + 8 * (lane % 4);
            rv[i] = row < M && col < N
                        ? *reinterpret_cast<const uint4*>(p.r + (size_t)row * p.ldr + col)
                        : make_uint4(0u, 0u, 0u, 0u);
          }
        }
        if constexpr (kScatter) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int col = at.n0 + 32 * q + 8 * (lane % 4);
            rv[i] = dst[i] >= 0 && col < N
                        ? *reinterpret_cast<const uint4*>(p.r + (size_t)dst[i] * p.ldr + col)
                        : make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * q + jj, col = at.n0 + 8 * j + 2 * t4;
          float2 bv = make_float2(0.0f, 0.0f);
          if (bias != nullptr && col < N)
            bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = gq + 8 * half;
            float v0 = acc[4 * j + 2 * half] + bv.x, v1 = acc[4 * j + 2 * half + 1] + bv.y;
            if constexpr (EPI == lvt::kEpiGelu) v0 = gelu(v0), v1 = gelu(v1);
            so[r * 16 + ((jj ^ ((r >> 1) & 3)) << 2) + t4] = tc::pack2(v0, v1);
          }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = lane / 4 + 8 * i, k = lane % 4;
          const int row = row0 + r, col = at.n0 + 32 * q + 8 * k;
          uint4 v = reinterpret_cast<const uint4*>(so)[r * 4 + (k ^ ((r >> 1) & 3))];
          if constexpr (kScatter) {
            if (dst[i] >= 0 && col < N) {
              float f[8], rf[8];
              lvt::unpack8(v, f);
              lvt::unpack8(rv[i], rf);
#pragma unroll
              for (int e = 0; e < 8; ++e) f[e] += rf[e];
              *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + (size_t)dst[i] * p.ldc +
                                        col) = lvt::pack8(f);
            } else if constexpr (EPI == lvt::kEpiScatterZero) {
              if (row < M && col < N)  // rows[row] < 0: out row `row` is a pad row
                *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + (size_t)row * p.ldc + col) =
                    make_uint4(0u, 0u, 0u, 0u);
            }
          } else if (row < M && col < N) {  // N % 8 == 0: the whole chunk is in
            if constexpr (EPI == lvt::kEpiResidual) {
              float f[8], rf[8];
              lvt::unpack8(v, f);
              lvt::unpack8(rv[i], rf);
#pragma unroll
              for (int e = 0; e < 8; ++e) f[e] += rf[e];
              v = lvt::pack8(f);
            }
            *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + (size_t)row * p.ldc +
                                      at.g * N + col) = v;
          }
        }
        __syncwarp();
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

template <int WGS, int EPI>
cudaError_t launch_tile(TileArgs& p, cudaStream_t st) {
  using T = Tile<WGS>;
  static int ready = -1;  // the device the shared-memory opt-in was made on
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != ready) {
    e = tc::allow_smem(tile_kernel<WGS, EPI>, T::kSmem);
    if (e == cudaSuccess) ready = dev;
  }
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const int grid = p.tiles < sms * T::kBlocks ? p.tiles : sms * T::kBlocks;
  tile_kernel<WGS, EPI><<<grid, T::kThreads, T::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int WGS>
cudaError_t launch_epi(TileArgs& p, int epi, cudaStream_t st) {
  switch (epi) {
    case lvt::kEpiBias: return launch_tile<WGS, lvt::kEpiBias>(p, st);
    case lvt::kEpiGelu: return launch_tile<WGS, lvt::kEpiGelu>(p, st);
    case lvt::kEpiResidual: return launch_tile<WGS, lvt::kEpiResidual>(p, st);
    case lvt::kEpiPartial: return launch_tile<WGS, lvt::kEpiPartial>(p, st);
    case lvt::kEpiScatter: return launch_tile<WGS, lvt::kEpiScatter>(p, st);
    case lvt::kEpiScatterZero: return launch_tile<WGS, lvt::kEpiScatterZero>(p, st);
    default: return cudaErrorInvalidValue;
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

// The row kernel's modes: the sum alone, + LN, or dropout + LN.
enum RowsMode { kRowsSum = 0, kRowsLn = 1, kRowsDropLn = 2 };

// out[row] = LN(sum_s P[s, row] + b + x[row]), 4 columns a thread (C / 4
// threads, rounded up to whole warps; the rest add zeros to the sums), at
// most THREADS of them: 256 for C <= 1024, and for C <= kMaxRowC (Swin-L's
// stage 4, C = 1536) an instance of its own of up to 512, so that the
// narrower rows keep their code.  Each column sums its slices in the
// order s = 0..S-1 in every instance.
// kRowsSum: out[row] = sum_s P[s, row] + b + x[row] rounded to bf16, b
// and x each may be null (ln_w, ln_b and eps unread).  kRowsDropLn:
// out[row] = LN(x[row] + m * (sum_s P[s, row] + b)), m the dropout of
// element (row, col) from dropout.cuh's hash (stream row, index col: the
// bits dropout.row_keep draws), kept values scaled by drop_scale, and the
// keep mask written as one byte an element (all ones without a seed);
// the other modes read none of keep, seed, thresh and drop_scale.
template <int MODE, int THREADS>
__global__ void __launch_bounds__(THREADS)
    rows_kernel(const float* __restrict__ P, int S, const bf16* __restrict__ x,
                const bf16* __restrict__ b2, const bf16* __restrict__ ln_w,
                const bf16* __restrict__ ln_b, bf16* __restrict__ out, int M, int C, float eps,
                uint8_t* __restrict__ keep, const int64_t* __restrict__ seed, uint32_t thresh,
                float drop_scale) {
  __shared__ float red[THREADS / 32];
  const bool on = (int)threadIdx.x * 4 < C;
  const int c = on ? (int)threadIdx.x * 4 : 0;  // an idle thread reads column 0
  const size_t off = (size_t)blockIdx.x * C + c;
  float4 p = *reinterpret_cast<const float4*>(P + off);
  for (int s = 1; s < S; ++s) {
    const float4 q = *reinterpret_cast<const float4*>(P + (size_t)s * M * C + off);
    p.x += q.x, p.y += q.y, p.z += q.z, p.w += q.w;
  }
  if constexpr (MODE == kRowsSum) {
    if (!on) return;
    float v[4] = {p.x, p.y, p.z, p.w};
    if (b2 != nullptr) {
      const uint2 bv = *reinterpret_cast<const uint2*>(b2 + c);
      const float2 b01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv.x));
      const float2 b23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv.y));
      v[0] += b01.x, v[1] += b01.y, v[2] += b23.x, v[3] += b23.y;
    }
    if (x != nullptr) {
      const uint2 xv = *reinterpret_cast<const uint2*>(x + off);
      const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.x));
      const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.y));
      v[0] += x01.x, v[1] += x01.y, v[2] += x23.x, v[3] += x23.y;
    }
    *reinterpret_cast<uint2*>(out + off) = make_uint2(tc::pack2(v[0], v[1]), tc::pack2(v[2], v[3]));
    return;
  }
  const uint2 xv = *reinterpret_cast<const uint2*>(x + off);
  const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.x));
  const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.y));
  float v[4];
  if constexpr (MODE == kRowsLn) {
    v[0] = p.x + __bfloat162float(b2[c]) + x01.x;
    v[1] = p.y + __bfloat162float(b2[c + 1]) + x01.y;
    v[2] = p.z + __bfloat162float(b2[c + 2]) + x23.x;
    v[3] = p.w + __bfloat162float(b2[c + 3]) + x23.y;
  } else {
    float y[4] = {p.x + __bfloat162float(b2[c]), p.y + __bfloat162float(b2[c + 1]),
                  p.z + __bfloat162float(b2[c + 2]), p.w + __bfloat162float(b2[c + 3])};
    uint32_t kb = 0x01010101u;  // the four keep bytes
    if (seed != nullptr) {
      const uint32_t key = lvt::dropout_key((uint32_t)*seed, blockIdx.x);
      kb = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool kp = lvt::dropout_bits(key, (uint32_t)(c + e)) >= thresh;
        y[e] = kp ? y[e] * drop_scale : 0.0f;
        kb |= (uint32_t)kp << (8 * e);
      }
    }
    if (on) *reinterpret_cast<uint32_t*>(keep + off) = kb;
    v[0] = y[0] + x01.x, v[1] = y[1] + x01.y, v[2] = y[2] + x23.x, v[3] = y[3] + x23.y;
  }
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

struct MapEntry {
  const void* ptr;
  int rows, cols, box_rows;
  long long ld;
  CUtensorMap map;
};
constexpr int kMaps = 64;
MapEntry map_cache[kMaps];
int map_next = 0;

}  // namespace

bool lvt::wg::tile_map(CUtensorMap* map, const void* ptr, int rows, int cols, long long ld,
                       int box_rows) {
  for (const MapEntry& e : map_cache)
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.ld == ld &&
        e.box_rows == box_rows) {
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
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  map_cache[map_next] = {ptr, rows, cols, box_rows, ld, *map};
  map_next = (map_next + 1) % kMaps;
  return true;
}

int lvt::gemm_tc(const GemmTc& g, cudaStream_t st) {
  const int KT = (g.K + wg::BK - 1) / wg::BK;
  const bool partial = g.epi == kEpiPartial;
  if (g.M <= 0 || g.N <= 0 || g.K <= 0 || g.N % 8 || g.K % 8 || g.lda % 8 || g.lda < g.K ||
      g.G < 1 || g.G > 3 || g.S < 1 || KT % g.S || (g.S > 1 && (!partial || g.G != 1)) ||
      (g.bm != 64 && g.bm != 128 && g.bm != 256) || g.epi < kEpiBias ||
      g.epi > kEpiScatterZero ||
      ((g.epi == kEpiResidual || g.epi >= kEpiScatter) &&
       (g.r == nullptr || g.ldr % 8 || g.ldr < g.N)) ||
      (g.epi >= kEpiScatter && (g.rows == nullptr || g.G != 1)) ||
      (!partial && (g.ldc % 8 || g.ldc < (long long)g.G * g.N)))
    return (int)cudaErrorInvalidValue;
  TileArgs p{};
  if (!wg::tile_map(&p.a, g.a, g.M, g.K, g.lda, g.bm)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < g.G; ++i) {
    if (!wg::tile_map(&p.w[i], g.w[i], g.N, g.K, g.K, wg::BN)) return (int)cudaErrorInvalidValue;
    p.bias[i] = g.bias[i];
  }
  p.out = g.out, p.ldc = g.ldc, p.r = g.r, p.ldr = g.ldr, p.rows = g.rows;
  p.M = g.M, p.N = g.N, p.steps = KT / g.S, p.S = g.S;
  p.tiles_n = (g.N + wg::BN - 1) / wg::BN, p.tiles_m = (g.M + g.bm - 1) / g.bm;
  const long long tiles = (long long)p.tiles_n * p.tiles_m * g.G * g.S;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const cudaError_t e = g.bm == 256   ? launch_epi<4>(p, g.epi, st)
                        : g.bm == 128 ? launch_epi<2>(p, g.epi, st)
                                      : launch_epi<1>(p, g.epi, st);
  return (int)e;
}

namespace {

// The row kernel of mode MODE over M rows of C columns: the 256-thread
// instance up to C = 1024, the 512-thread one up to lvt::kMaxRowC.
template <int MODE>
cudaError_t launch_rows(const float* part, int S, const bf16* x, const bf16* b, const bf16* ln_w,
                        const bf16* ln_b, bf16* out, int M, int C, float eps, uint8_t* keep,
                        const int64_t* seed, uint32_t thresh, float drop_scale,
                        cudaStream_t st) {
  static_assert(512 * 4 == lvt::kMaxRowC, "the widest instance covers kMaxRowC");
  if (M <= 0 || C <= 0 || C % 4 || C > lvt::kMaxRowC || S < 1) return cudaErrorInvalidValue;
  const int threads = (C / 4 + 31) / 32 * 32;
  if (threads <= 256)
    rows_kernel<MODE, 256><<<M, threads, 0, st>>>(part, S, x, b, ln_w, ln_b, out, M, C, eps, keep,
                                                  seed, thresh, drop_scale);
  else
    rows_kernel<MODE, 512><<<M, threads, 0, st>>>(part, S, x, b, ln_w, ln_b, out, M, C, eps, keep,
                                                  seed, thresh, drop_scale);
  return cudaGetLastError();
}

}  // namespace

int lvt::rows_ln(const float* part, int S, const bf16* x, const bf16* b, const bf16* ln_w,
                 const bf16* ln_b, bf16* out, int M, int C, float eps, cudaStream_t st) {
  return (int)launch_rows<kRowsLn>(part, S, x, b, ln_w, ln_b, out, M, C, eps, nullptr, nullptr,
                                   0u, 1.0f, st);
}

int lvt::rows_sum(const float* part, int S, const bf16* x, const bf16* b, bf16* out, int M, int C,
                  cudaStream_t st) {
  return (int)launch_rows<kRowsSum>(part, S, x, b, nullptr, nullptr, out, M, C, 0.0f, nullptr,
                                    nullptr, 0u, 1.0f, st);
}

int lvt::rows_dropout_ln(const float* part, int S, const bf16* x, const bf16* b, const bf16* ln_w,
                         const bf16* ln_b, bf16* out, uint8_t* keep, int M, int C, float eps,
                         const int64_t* seed, uint32_t thresh, float drop_scale,
                         cudaStream_t st) {
  if (keep == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_rows<kRowsDropLn>(part, S, x, b, ln_w, ln_b, out, M, C, eps, keep, seed,
                                       thresh, drop_scale, st);
}

// out = epi(a [M, K] . w_g [N, K]^T + b_g) for the G (1..3) weights w0..,
// their biases b0.. (null: none), weight g's columns at out + g * N (rows
// ldc apart), or with epi 3 the f32 partials [S, M, N]; r the residual
// (epi 2, rows ldr apart); bm 64, 128 or 256 the tile's rows, S the
// K-slices.
// All bf16; see gemm_tc.cuh for what the shapes must be.
LVT_EXPORT int lvt_gemm_tc_bf16(const void* a, int lda, const void* w0, const void* w1,
                                const void* w2, const void* b0, const void* b1, const void* b2,
                                int G, const void* r, int ldr, void* out, int ldc, int M, int N,
                                int K, int epi, int bm, int S, void* stream) {
  lvt::GemmTc g{static_cast<const bf16*>(a),
                lda,
                {static_cast<const bf16*>(w0), static_cast<const bf16*>(w1),
                 static_cast<const bf16*>(w2)},
                {static_cast<const bf16*>(b0), static_cast<const bf16*>(b1),
                 static_cast<const bf16*>(b2)},
                G,
                out,
                ldc,
                static_cast<const bf16*>(r),
                ldr,
                M, N, K, epi, bm, S};
  return lvt::gemm_tc(g, static_cast<cudaStream_t>(stream));
}

// out[rows[m]] = a [M, K] . w [N, K]^T + b + r[rows[m]] for m < M, rows
// int32 [M] (a row below 0 dropped, or with pad_zero out[m] set to zeros),
// r's and out's rows ldr and ldc apart: the scatter epilogue at bm rows a
// tile (K14's proj; K16's with pad_zero).  All bf16 but rows.
LVT_EXPORT int lvt_gemm_tc_scatter_bf16(const void* a, int lda, const void* w, const void* b,
                                        const void* r, int ldr, const void* rows, void* out,
                                        int ldc, int M, int N, int K, int bm, int pad_zero,
                                        void* stream) {
  lvt::GemmTc g{static_cast<const bf16*>(a), lda, {static_cast<const bf16*>(w)},
                {static_cast<const bf16*>(b)}, 1, out, ldc, static_cast<const bf16*>(r), ldr,
                M, N, K, pad_zero ? lvt::kEpiScatterZero : lvt::kEpiScatter, bm, 1};
  g.rows = static_cast<const int*>(rows);
  return lvt::gemm_tc(g, static_cast<cudaStream_t>(stream));
}

// out [M, C] = LN(x + a [M, K] . w [C, K]^T + b) * ln_w + ln_b: the product
// as S f32 K-slices into part [S, M, C] (bm-row tiles), then the row
// kernel; a's rows lda apart, the rest contiguous, all bf16 but part.
LVT_EXPORT int lvt_gemm_tc_ln_bf16(const void* a, int lda, const void* w, const void* b,
                                   const void* x, const void* ln_w, const void* ln_b, void* part,
                                   void* out, int M, int C, int K, int bm, int S, float eps,
                                   void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  lvt::GemmTc g{static_cast<const bf16*>(a), lda, {static_cast<const bf16*>(w)}, {nullptr}, 1,
                part, C, nullptr, 0, M, C, K, lvt::kEpiPartial, bm, S};
  const int err = lvt::gemm_tc(g, st);
  if (err != 0) return err;
  return lvt::rows_ln(static_cast<const float*>(part), S, static_cast<const bf16*>(x),
                      static_cast<const bf16*>(b), static_cast<const bf16*>(ln_w),
                      static_cast<const bf16*>(ln_b), static_cast<bf16*>(out), M, C, eps, st);
}

// (out, keep) = (LN(x + dropout(a [M, K] . w [C, K]^T + b)) * ln_w + ln_b,
// the keep mask [M, C] as one byte an element): the product as S f32
// K-slices into part [S, M, C] (bm-row tiles), then the row kernel's
// dropout mode; seed an int64 on the device (null: no dropout, keep all
// ones), element (row, col) kept iff its bits >= thresh and scaled by
// drop_scale.  a's rows lda apart, the rest contiguous, all bf16 but
// part and keep.
LVT_EXPORT int lvt_gemm_tc_dropout_ln_bf16(const void* a, int lda, const void* w, const void* b,
                                           const void* x, const void* ln_w, const void* ln_b,
                                           void* part, void* out, void* keep, int M, int C, int K,
                                           int bm, int S, float eps, const void* seed,
                                           uint32_t thresh, float drop_scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  lvt::GemmTc g{static_cast<const bf16*>(a), lda, {static_cast<const bf16*>(w)}, {nullptr}, 1,
                part, C, nullptr, 0, M, C, K, lvt::kEpiPartial, bm, S};
  const int err = lvt::gemm_tc(g, st);
  if (err != 0) return err;
  return lvt::rows_dropout_ln(static_cast<const float*>(part), S, static_cast<const bf16*>(x),
                              static_cast<const bf16*>(b), static_cast<const bf16*>(ln_w),
                              static_cast<const bf16*>(ln_b), static_cast<bf16*>(out),
                              static_cast<uint8_t*>(keep), M, C, eps,
                              static_cast<const int64_t*>(seed), thresh, drop_scale, st);
}
