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
// [B, D, H/4, W/4, E] output written once: at Swin-B's B = 4 serving clips
// 3.0 MB in and 16.1 MB out, 5.7 us at 3.35 TB/s; the 96 MACs an output
// value are ~1.5 GFLOP, 1.6 us of tensor-core time).  The TPU kernel
// contracted 96-lane chunks against 8x block-diagonal weights to avoid an
// im2col relayout in VMEM.  Here the work unit is one (b, t, i) row of up to
// 64 patches j (64 x 96 of im2col, 64 x E out); the design serves the
// stores, 84% of the bytes:
// - persistent blocks (two an SM at E <= 128), each walking units u =
//   blockIdx.x, + gridDim.x, ...; consecutive units write consecutive
//   output rows;
// - a warp's share of the weights lives in registers as mma.sync B
//   fragments for the block's life, loaded once (no per-unit staging);
// - the unit's 8 (kd, kh) pixel-row segments (64 patches x 12 bytes each)
//   arrive by cp.async (16 bytes a copy where aligned) into one of two
//   buffers while the block computes the unit before; a frame past the
//   last is zero-filled by the copy;
// - warp w copies and converts two taps' segments for 32 of the patches
//   into a bf16 im2col tile in shared memory (0..255 is exact, by byte
//   permutes; 16-byte stores; two tiles in turns, so one barrier a unit),
//   then takes 32 rows x a quarter of the columns
//   on mma.sync m16n8k16 (A by ldmatrix, f32 accumulation), adds the bias
//   and rounds once to bf16;
// - and stores straight from the accumulators: the mma's columns are
//   permuted (in the staged weights) so that a lane holds 8 contiguous
//   output columns of a row, one 16-byte store, a warp's store 8 rows x 64
//   contiguous bytes.
// A pixel row is read by two units (as kd = 0 and kd = 1); the clip is 3 MB
// and the second read comes from L2.  Every output value is summed by one
// thread in a fixed order: two calls give the same bits.
#include "mma_tile.cuh"

namespace {

namespace tc = lvt::tc;

constexpr int kK = 96;                   // pd * ph * pw * 3 features a row
constexpr int kSteps = kK / 16;          // mma k-steps
constexpr int kTaps = 8;                 // (kd, kh) pixel-row segments a unit
constexpr int kRows = 64;                // patches j a unit
constexpr int kSeg = kRows * 12;         // bytes of a segment: 64 x (kw, c)
constexpr int kLdA = kK + 8;             // im2col row pitch: 208 bytes, ldmatrix conflict-free
constexpr int kThreads = 32 * kTaps;     // 8 warps: 2 row halves x 4 column groups
constexpr int kBytesSeg = 2 * kTaps * kSeg;  // two segment buffers
constexpr int kBytesA = kRows * kLdA * 2;    // an im2col tile (two of them)

// Shared bytes of a block at width E: the segment buffers, then the two
// im2col tiles, where the weights are staged first ([96][E + 8]).
constexpr size_t smem_bytes(int E) {
  const size_t staged = (size_t)kK * (E + 8) * 2;
  return kBytesSeg + (staged > 2 * kBytesA ? staged : 2 * kBytesA);
}

// Bytes k0 and k0 + 1 of v as bf16x2, exactly: 2^23 + p has p in its low
// mantissa bits (one byte permute), less 2^23 is float(p), whose upper 16
// bits are its bf16 (p < 256 needs 8 significant bits); a second permute
// packs the two upper halves.  Full-rate integer and FMA-pipe work, where
// an int-to-float conversion runs at a quarter of that.
template <int K0>
__device__ __forceinline__ uint32_t bytes_bf16x2(uint32_t v) {
  const float lo = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + K0)) - 8388608.0f;
  const float hi = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7541 + K0)) - 8388608.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The columns in groups of 32 (the last may hold 16), and in a group of
// width GW the mma's columns permuted: tile s, column c is output column
// (GW / 4) (c / 2) + 2 s + c % 2, so that the lane (g, t4) holding
// columns 2 t4, 2 t4 + 1 of the group's tiles holds GW / 4 contiguous
// output columns (GW / 4) t4 .. of its rows: one 16-byte store (8 at GW =
// 16) a row, no staging of the output.
__device__ __forceinline__ int group_width(int E, int grp) { return min(32, E - 32 * grp); }

// NT: a warp's column tiles at most (its groups' tiles, 4 a group), E <=
// 32 NT; V: the bytes of a pixel copy (16, or 4 where the segments are
// not 16-byte aligned).  Warp w copies and converts taps 2 (w % 4) and
// 2 (w % 4) + 1 of patches 32 (w / 4) .. + 31 alone, and computes, rounds
// and stores its own part of the output: rows
// 32 (w % 2) .. + 31 x column groups w / 2 + 4 gi.  So one barrier a unit
// suffices, the one between the im2col tile's writers and its readers
// (two tiles, in turns).
template <int NT, int V>
__global__ void __launch_bounds__(kThreads, NT == 4 ? 2 : 1)
    patch_embed_kernel(const uint8_t* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bt, bf16* __restrict__ out, int D, int H, int W,
                       int E, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w2 = W / 4, h2 = H / 4, n_jc = (w2 + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int ngroups = (E + 31) / 32, row0 = 32 * (warp % 2), grp0 = warp / 2;
  // tile slot 4 gi + s of this warp: tile s of group grp0 + 4 gi, if any
  auto live = [&](int gi, int s) {
    const int grp = grp0 + 4 * gi;
    return grp < ngroups && 8 * s < group_width(E, grp);
  };

  // unit u: patch row r = (b D + t) h2 + i of the output, patches j0 ..
  // j0 + nj - 1; its pixel row kh of frame t + kd is row 4 r + kh + kd H of
  // the clip tensor [B D H, W, 3]
  struct Unit {
    int r, t, j0, nj;
  };
  auto unit = [&](int u) {
    Unit v;
    v.r = u / n_jc;
    v.j0 = (u - v.r * n_jc) * kRows;
    v.nj = min(kRows, w2 - v.j0);
    v.t = (v.r / h2) % D;
    return v;
  };
  // this warp's taps 2 tp, 2 tp + 1 (tap = (kd, kh) = (tap / 4, tap % 4))
  // and patches 32 jh .. 32 jh + 31 of a unit
  const int tp = warp % 4, jh = warp / 4;
  // cp.async them into buffer p: bytes 12 (j0 + 32 jh) .. of each tap's
  // pixel row, zeros past the last frame
  auto load = [&](const Unit& v, int p) {
    const int n = min(32, v.nj - 32 * jh), per = n * 12 / V;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tap = 2 * tp + h, kd = tap / 4, kh = tap % 4;
      const bool in = v.t + kd < D;
      const uint8_t* src =
          x + ((size_t)(4 * v.r + kh + kd * H) * W + 4 * (v.j0 + 32 * jh)) * 3;
      uint8_t* dst = smem + (p * kTaps + tap) * kSeg + 12 * 32 * jh;
      for (int c = lane; c < per; c += 32)
        tc::cp_async<V>(dst + c * V, in ? src + c * V : x, in ? V : 0);
    }
  };

  int u = blockIdx.x;
  Unit cur = unit(u < units ? u : 0);
  if (u < units) load(cur, 0);

  // b[kk][4 gi + s]: the B fragment of k-step kk, tile s of the warp's
  // group gi: w into shared memory, [96][E + 8] in the permuted column
  // order, where the im2col tiles go later, by 4-byte cp.async (a pair of
  // output columns; all in flight at once, with the first unit's pixels),
  // then by ldmatrix.trans, a pair of tiles a load
  uint32_t b[kSteps][NT][2];
  {
    bf16* w_s = reinterpret_cast<bf16*>(smem + kBytesSeg);
    const int ldw = E + 8;
    for (int pr = lane; pr < E / 2; pr += 32) {
      const int col = 2 * pr, grp = col >> 5, rr = col & 31;
      const int v = 32 * grp + (E - 32 * grp < 32 ? 8 * ((rr & 3) >> 1) + 2 * (rr >> 2)
                                                  : 8 * ((rr & 7) >> 1) + 2 * (rr >> 3));
      for (int k = warp; k < kK; k += kTaps) tc::cp_async<4>(w_s + k * ldw + v, w + k * E + col, 4);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < NT / 4; ++gi)
#pragma unroll
      for (int s = 0; s < 4; s += 2)
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t r[4] = {0u, 0u, 0u, 0u};
          if (live(gi, s))
            tc::ldsm4_t(r, w_s + (16 * kk + (lane & 15)) * ldw +
                               8 * (4 * (grp0 + 4 * gi) + s + (lane >> 4)));
          b[kk][4 * gi + s][0] = r[0], b[kk][4 * gi + s][1] = r[1];
          b[kk][4 * gi + s + 1][0] = r[2], b[kk][4 * gi + s + 1][1] = r[3];
        }
    __syncthreads();  // before the first unit's im2col overwrites w_s
  }

  for (int it = 0; u < units; ++it, u += gridDim.x) {
    const int p = it & 1, nu = u + gridDim.x;
    Unit nxt = cur;
    if (nu < units) {
      nxt = unit(nu);
      load(nxt, p ^ 1);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this lane's copies of unit u have landed
    __syncwarp();            // and the warp's (its segment)

    // the im2col tile p: patch j's 12 bytes of taps 2 tp and 2 tp + 1 are
    // features 24 tp .. + 23 of row j, three 16-byte stores
    bf16* a_s = reinterpret_cast<bf16*>(smem + kBytesSeg + p * kBytesA);  // [kRows][kLdA]
    if (const int j = 32 * jh + lane; j < cur.nj) {
      const uint8_t* sp = smem + (p * kTaps + 2 * tp) * kSeg + 12 * j;
      uint32_t px[6];
#pragma unroll
      for (int e = 0; e < 6; ++e)
        px[e] = reinterpret_cast<const uint32_t*>(sp + (e / 3) * kSeg)[e % 3];
      uint4* dst = reinterpret_cast<uint4*>(a_s + j * kLdA + 24 * tp);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        dst[c] = make_uint4(bytes_bf16x2<0>(px[2 * c]), bytes_bf16x2<2>(px[2 * c]),
                            bytes_bf16x2<0>(px[2 * c + 1]), bytes_bf16x2<2>(px[2 * c + 1]));
    }
    // every warp's taps are in tile p; every warp is done with tile p ^ 1
    // (unit u - gridDim.x), which the next unit rewrites
    __syncthreads();

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int s = 0; s < NT; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][s][e] = 0.0f;
    if (row0 < cur.nj) {  // warp-uniform; rows past nj are computed and not stored
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t a[4];
          tc::ldsm4(a, a_s + (row0 + 16 * mt + (lane & 15)) * kLdA + 16 * kk + ((lane >> 4) << 3));
#pragma unroll
          for (int s = 0; s < NT; ++s)
            if (live(s / 4, s % 4)) tc::mma(acc[mt][s], a, b[kk][s][0], b[kk][s][1]);
        }
    }
    // + bias in f32, rounded once, stored: row, group grp's columns q t4 ..
    // q t4 + q - 1 (q = GW / 4) from tiles s = 0 .. GW / 8 - 1, columns
    // 2 t4, 2 t4 + 1 of each
    const float* bias = bt + (size_t)cur.t * E;
    bf16* dst = out + ((size_t)cur.r * w2 + cur.j0) * E;
#pragma unroll
    for (int gi = 0; gi < NT / 4; ++gi) {
      const int grp = grp0 + 4 * gi;
      if (grp >= ngroups) continue;
      const int q = group_width(E, grp) / 4, col = 32 * grp + q * t4;
      float bv[8] = {};
      *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(bias + col);
      if (q == 8)
        *reinterpret_cast<float4*>(bv + 4) = *reinterpret_cast<const float4*>(bias + col + 4);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 16 * mt + g + 8 * h;
          if (row >= cur.nj) continue;
          uint32_t o[4];
#pragma unroll
          for (int s = 0; s < 4; ++s)
            o[s] = tc::pack2(acc[mt][4 * gi + s][2 * h] + bv[(2 * s) % 8],
                             acc[mt][4 * gi + s][2 * h + 1] + bv[(2 * s + 1) % 8]);
          bf16* at = dst + (size_t)row * E + col;
          if (q == 8)
            *reinterpret_cast<uint4*>(at) = make_uint4(o[0], o[1], o[2], o[3]);
          else
            *reinterpret_cast<uint2*>(at) = make_uint2(o[0], o[1]);
        }
    }
    cur = nxt;
  }
  tc::cp_async_wait<0>();
}

template <int NT, int V>
cudaError_t launch(const uint8_t* x, const bf16* w, const float* bt, bf16* out, int D, int H,
                   int W, int E, int units, int blocks, cudaStream_t st) {
  static int ready = -1;  // the device the shared-memory opt-in was made on
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != ready) {
    e = tc::allow_smem(patch_embed_kernel<NT, V>, smem_bytes(32 * NT));
    if (e == cudaSuccess) ready = dev;
  }
  if (e != cudaSuccess) return e;
  patch_embed_kernel<NT, V><<<blocks, kThreads, smem_bytes(E), st>>>(x, w, bt, out, D, H, W, E,
                                                                     units);
  return cudaGetLastError();
}

}  // namespace

// out [B, D, H/4, W/4, E] bf16 = the patch embed of x [B, D, H, W, 3] uint8
// (contiguous; 16-byte aligned with W % 16 == 0 for vec 16, else 4-byte
// aligned and vec 4) with folded weights w [96, E] bf16 (rows in (kd, kh,
// kw, c) order, 16-byte aligned) and the per-time bias table bt [D, E]
// f32 (16-byte aligned).  H % 4 == W % 4 == 0, E % 16 == 0, E <= 256; blocks the
// persistent grid (lavender_tpu_torch/ops/_build.py patch_embed_plan).
LVT_EXPORT int lvt_patch_embed_u8(const void* x, const void* w, const void* bt, void* out, int B,
                                  int D, int H, int W, int E, int blocks, int vec, void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || H % 4 || W % 4 || E <= 0 || E % 16 || E > 256 ||
      blocks <= 0 || reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(bt) % 16 ||
      (vec == 16 ? xa % 16 || W % 16 : vec != 4 || xa % 4))
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)B * D * (H / 4) * ((W / 4 + kRows - 1) / kRows);
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto X = static_cast<const uint8_t*>(x);
  const auto Wt = static_cast<const bf16*>(w);
  const auto Bt = static_cast<const float*>(bt);
  const auto O = static_cast<bf16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = (int)units;
  const cudaError_t e =
      E <= 128 ? (vec == 16 ? launch<4, 16>(X, Wt, Bt, O, D, H, W, E, n, blocks, st)
                            : launch<4, 4>(X, Wt, Bt, O, D, H, W, E, n, blocks, st))
               : (vec == 16 ? launch<8, 16>(X, Wt, Bt, O, D, H, W, E, n, blocks, st)
                            : launch<8, 4>(X, Wt, Bt, O, D, H, W, E, n, blocks, st));
  return (int)e;
}
