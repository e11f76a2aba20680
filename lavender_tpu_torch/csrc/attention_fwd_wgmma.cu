// The Hopper forward of the Swin window core:
//   s = q k^T * scale + bias[h] + mask[w],  p = softmax(s) over the keys,
//   o = p v,  lse = each row's log-sum-exp of s,
// w = sequence mod nW, lse the row sums the backward (attention_bwd_wgmma.cu)
// reads instead of forming them again.
//
// Replaces lavender_tpu/ops/swin_core_attn.py _core_fwd_kernel (:112, K8a:
// the packed slab [B*nW*Npad, 3C] of the Swin backward's recompute, a bf16
// rel-pos bias [nH, Npad, Npad] and a bf16 shift mask [nW, Npad, Npad] or
// none, no dropout), through lvt_attention_bf16 of attention.cu, which
// sends it every call that carries both lse and a bias.  It computes what
// that kernel computes, not its blocks.
//
// Bound on the card: device memory.  At B = 8, Swin-B stage 1 (512 windows
// of 248 rows, 4 heads of 32): q, k, v and o slabs, lse and bias, 132.5 MB
// unshifted (0.040 ms at 3.35 TB/s), against 16.1 GFLOP of products (0.016
// ms at 989 TFLOP/s).  Under them, about ten instructions a score (the
// bias and mask from shared memory, the max, ex2, the sum, the rounding)
// issue on the warp schedulers, and these set the pace (PERF.md).
//
// Design.  A CTA owns one (sequence, head) and is two warpgroups (256
// threads, two query rows a thread), one CTA an SM (up to 255 registers a
// thread; 169 KB of shared memory at hd 32 for Swin-B's 248 keys and for
// Swin-L's 720 alike).  The window's K and V arrive once, whole, by the
// Tensor Memory Accelerator as 64-row boxes of 4-D tensor maps (hd, N,
// heads, sequences) over the slab's own strides (rows >= N zero-filled per
// (sequence, head), never read from the next window), and stay in shared
// memory; warpgroup i takes the query tiles i, i + 2, .. of 64 rows, each
// with its Q by TMA and, for each key block, its bias and mask tiles (64
// query rows x the block's keys): by TMA as 64 x 64 boxes of 2-D maps in
// the 128-byte swizzle where the rows are 16-byte aligned (N % 8 == 0:
// Npad = 248, 720), else by cp.async as the aligned 16-byte chunks around
// each row (the spatial route's N = 245, whose rows lie 490 bytes apart).
// The whole bias of a stage (3.9 MB at Swin-B's stage 4) stays in the 50
// MB L2, so the tiles of every window of a head come from there.  For each
// key block the warpgroup forms, on wgmma,
//   S = Q K^T as m64n64k16 products (64-key chunks, the chunks past N
//     skipped), from shared memory, K-major,
// then on the accumulators (a (query, key) element a thread element) the
// scores s * scale + bias + mask in log2 units, a key >= N set to -inf (a
// select, no branch), the row max over the quad of lanes that share a row,
// p = ex2(t - max), the row sum, and p rounded to bf16 as the A fragments
// of
//   O += P V (A from registers, V as an MN-major B).
// Up to 256 keys one block of 256 holds the whole row (Swin-B's 248 and
// 245): the softmax is exact in registers, with no running rescale; beyond,
// blocks of 128 keys (Swin-L's 720: six) with the online rescale of the
// running max, sum and O, which leaves room for K and V whole.  The next
// step's Q, bias and mask tiles load while the current one's P V product
// and epilogue run.  The ragged edge: p = 0 for a key >= N, rows >= N
// never stored (in the packed slab they are the next window's).  Each
// output element is summed by one thread in a fixed order: the same bits
// on every run.  The design's iterations and their times are in PERF.md.
#include <math.h>

#include "attention_wg.cuh"

namespace lvt {

// The kernel's operands: q, k, v as tensor maps; the rest as TcFwd's.
struct TcFwdWg {
  CUtensorMap x[3];   // q, k, v: (hd, N, nH, nSeq) maps, 64-row boxes
  CUtensorMap bm[2];  // the bias [nH N, N] and mask [nW N, N] as 2-D maps of
  //                     64 x 64 boxes (where their rows are 16-byte aligned)
  bf16* o;
  long long ost[3];   // o's (sequence, head, row) element strides
  float* lse;         // [nSeq, nH, N] f32
  const bf16* bias;   // [nH, N, N]
  const bf16* mask;   // [nW, N, N] or null
  float scale;
  int N, nH, nW, nQ, nB;  // query tiles, key blocks of a (sequence, head)
};

}  // namespace lvt

namespace {

namespace wg = lvt::wg;

constexpr int kWGs = 2;  // consumer warpgroups a CTA
constexpr float kLn2 = 0.6931471805599453f;

// The shared memory of one CTA: each warpgroup's Q tile, bias tile and
// mask tile (64 query rows x KB keys: by TMA, KB / 64 boxes of 64 x 64 in
// the 128-byte swizzle; by cp.async, rows of KB elements + 16 bytes),
// then the window's K and V whole, T tiles of 64 rows each (in the swizzle
// of their row width, 2 * HD bytes).
template <int HD, int KB, bool TMB>
struct FwdSmem {
  static constexpr int kSw = 2 * HD;
  static constexpr int kTile = kT * kSw;
  static constexpr int kWords = (2 * KB + 16) / 4;  // a cp.async bias / mask row
  static constexpr int kWide = TMB ? KB * 128 : kT * kWords * 4;
  static constexpr int kWG = kTile + 2 * kWide;  // a warpgroup's Q, bias, mask
  static constexpr int kKV = kWGs * kWG;
  static constexpr size_t bytes(int T) { return kKV + 2 * (size_t)T * kTile + 1024; }
};

// Rows r0.. (64) x keys c0.. (up to KB, < N) of matrix w of an [n, N, N]
// bf16 buffer of `bytes` bytes whose rows are not 16-byte aligned, by a
// warpgroup's 128 threads (wt; two a row) in 16-byte copies: each row as
// the aligned chunks around its elements, the first at byte lead = (start
// & 15) of the staged row; copies past the buffer's end are cut or
// zero-filled.
template <int KB>
__device__ __forceinline__ void load_wide(uint32_t* s, const bf16* m, long long bytes, int w,
                                          int r0, int c0, int N, int wt) {
  static_assert(kCons == 2 * kT, "two threads a row");
  constexpr int W = (2 * KB + 16) / 4;
  const int cols = min(KB, N - c0);
  const int per = min(W / 4, (2 * cols + 29) / 16);  // 16-byte chunks a row
  const int r = wt >> 1;
  const char* base = reinterpret_cast<const char*>(m);
  const long long b0 = ((((long long)w * N + r0 + r) * N + c0) * 2) & ~15LL;
  for (int k = wt & 1; k < per; k += 2) {
    const long long b = b0 + 16 * k, left = bytes - b;
    const int n = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
    cp_async<16>(s + r * W + 4 * k, base + (n > 0 ? b : 0), n);
  }
}

// Elements (r, col) and (r, col + 1), col even, of a staged bias or mask
// tile in f32: by TMA (TMB), box col / 64, row r's 16-byte chunk k at k ^
// (r % 8); by cp.async, row r from byte lead.
template <int KB, bool TMB>
__device__ __forceinline__ float2 pair_in(const char* s, int r, int lead, int col) {
  if constexpr (TMB) {
    const int b = (col & 63) * 2;
    const uint32_t u = *reinterpret_cast<const uint32_t*>(
        s + (col >> 6) * (kT * 128) + r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15));
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  } else {
    const bf16* e = reinterpret_cast<const bf16*>(s + r * (2 * KB + 16) + lead + 2 * col);
    return make_float2(__bfloat162float(e[0]), __bfloat162float(e[1]));
  }
}

// The warpgroup's own barrier (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wgi), "r"(kCons) : "memory");
}

// One (sequence, head): blockIdx.x = sequence * nH + head.  Its K and V
// arrive once; warpgroup i takes query tiles i, i + 2, .., each over its
// key blocks of KB keys.  TMB: the bias and mask tiles by TMA (rows 16-byte
// aligned), else by cp.async.
template <int HD, bool MASK, int KB, bool TMB>
__global__ void __launch_bounds__(kWGs * kCons, 1)
    fwd_wg_kernel(const __grid_constant__ lvt::TcFwdWg p) {
  using L = FwdSmem<HD, KB, TMB>;
  constexpr int SW = L::kSw, R = HD / 2, KC = KB / kT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_k, bar_v, bar_q[kWGs], bar_b[kWGs];
  char* base = reinterpret_cast<char*>(smem_raw) + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int N = p.N, nT = (N + kT - 1) / kT, bh = blockIdx.x;
  const int seq = bh / p.nH, h = bh - seq * p.nH, w = seq % p.nW;
  // thread (warpgroup wgi, warp, g = lane / 4, tq = lane % 4) holds query
  // rows wr and wr + 8 of its tile's S and O
  const int tid = threadIdx.x, wgi = tid / kCons, wt = tid % kCons;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int wr = warp * 16 + g;
  if (tid == 0) {
    wg::mbar_init(&bar_k, 1);  // K (TMA)
    wg::mbar_init(&bar_v, 1);  // V (TMA)
    for (int i = 0; i < kWGs; ++i) {
      wg::mbar_init(&bar_q[i], 1);  // warpgroup i's Q (TMA)
      // its bias and mask tiles: TMA, or its threads' cp.async
      wg::mbar_init(&bar_b[i], TMB ? 1 : kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < (TMB ? 5 : 3); ++i)  // the tensor maps into the TMA unit's cache
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(
                       i < 3 ? &p.x[i] : &p.bm[i - 3]))
                   : "memory");
  }
  __syncthreads();

  char* wbase = base + wgi * L::kWG;
  char* sB = wbase + L::kTile;
  char* sM = wbase + L::kTile + L::kWide;
  char* kbase = base + L::kKV;
  char* vbase = kbase + nT * L::kTile;
  if (tid == 0) {  // the window's K and V, once
    wg::mbar_expect(&bar_k, nT * L::kTile);
    for (int t = 0; t < nT; ++t) tma_load_4d(kbase + t * L::kTile, &p.x[1], &bar_k, 0, t * kT, h, seq);
    wg::mbar_expect(&bar_v, nT * L::kTile);
    for (int t = 0; t < nT; ++t) tma_load_4d(vbase + t * L::kTile, &p.x[2], &bar_v, 0, t * kT, h, seq);
  }
  const long long b_bytes = (long long)p.nH * N * N * 2, m_bytes = (long long)p.nW * N * N * 2;
  const int nB = p.nB, steps = (p.nQ - wgi + kWGs - 1) / kWGs * nB;
  // step s (query tile wgi + 2 (s / nB), key block s % nB): Q with a
  // tile's first block (TMA, by the warpgroup's thread 0), the bias and
  // mask tiles (TMA by that thread, or cp.async by its 128 threads)
  auto issue = [&](int s) {
    const int i = s / nB, kb = s - i * nB, i0 = (wgi + i * kWGs) * kT, j0 = kb * KB;
    if (kb == 0 && wt == 0) {
      wg::mbar_expect(&bar_q[wgi], L::kTile);
      tma_load_4d(wbase, &p.x[0], &bar_q[wgi], 0, i0, h, seq);
    }
    if constexpr (TMB) {
      if (wt == 0) {
        const int nc = min(KB / kT, (N - j0 + kT - 1) / kT);
        wg::mbar_expect(&bar_b[wgi], nc * kT * 128 * (MASK ? 2 : 1));
        for (int c = 0; c < nc; ++c) {
          wg::tma_load(sB + c * kT * 128, &p.bm[0], &bar_b[wgi], j0 + c * kT, h * N + i0);
          if (MASK)
            wg::tma_load(sM + c * kT * 128, &p.bm[1], &bar_b[wgi], j0 + c * kT, w * N + i0);
        }
      }
    } else {
      load_wide<KB>(reinterpret_cast<uint32_t*>(sB), p.bias, b_bytes, h, i0, j0, N, wt);
      if (MASK) load_wide<KB>(reinterpret_cast<uint32_t*>(sM), p.mask, m_bytes, w, i0, j0, N, wt);
      cp_async_arrive(&bar_b[wgi]);
    }
  };
  if (steps > 0) issue(0);

  const float sl2 = p.scale * kLog2e;
  const uint32_t aQ = smem_addr(wbase), aK = smem_addr(kbase), aV = smem_addr(vbase);
  bf16* ob = p.o + seq * p.ost[0] + h * p.ost[1];
  float o[R];
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] = 0.0f;
  // per row: the running max of the scores in log2 units and the thread's
  // part of the row sum, relative to it
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  if (steps > 0) wg::mbar_wait(&bar_k, 0);
  for (int s = 0; s < steps; ++s) {
    const int i = s / nB, kb = s - i * nB, i0 = (wgi + i * kWGs) * kT, j0 = kb * KB;
    const int nc = min(KC, (N - j0 + kT - 1) / kT);
    // S = Q K^T, a 64-key chunk an accumulator
    float sc[KC][32];
    if (kb == 0) wg::mbar_wait(&bar_q[wgi], i & 1);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (c < nc) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          ss<0, 0>(sc[c], desc(aQ + 32 * kk, SW, false),
                   desc(aK + (kb * KC + c) * L::kTile + 32 * kk, SW, false), kk);
      }
    wgmma_commit();
    wg::mbar_wait(&bar_b[wgi], s & 1);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < KC; ++c) fence_regs(sc[c]);

    // the scores s * scale + bias + mask in log2 units (-inf on keys >= N),
    // the row max
    int blead[2] = {0, 0}, mlead[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = i0 + wr + 8 * r;
      if (!TMB) blead[r] = (int)((((long long)h * N + row) * N + j0) * 2 & 15);
      if (!TMB && MASK) mlead[r] = (int)((((long long)w * N + row) * N + j0) * 2 & 15);
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c >= nc) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = c * kT + 8 * n + 2 * tq;
          float2 b = pair_in<KB, TMB>(sB, wr + 8 * r, blead[r], col);
          if (MASK) {
            const float2 m = pair_in<KB, TMB>(sM, wr + 8 * r, mlead[r], col);
            b.x += m.x, b.y += m.y;
          }
          const int x = 4 * n + 2 * r;
          const float t0 = fmaf(sc[c][x], sl2, b.x * kLog2e);
          const float t1 = fmaf(sc[c][x + 1], sl2, b.y * kLog2e);
          sc[c][x] = j0 + col < N ? t0 : -INFINITY;
          sc[c][x + 1] = j0 + col + 1 < N ? t1 : -INFINITY;
          tmax[r] = fmaxf(tmax[r], fmaxf(sc[c][x], sc[c][x + 1]));
        }
      }
    }
    // Q (read by S) and the bias and mask tiles are free: the next step's
    // loads run while this one finishes
    wg_sync(wgi);
    if (s + 1 < steps) issue(s + 1);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mn = fmaxf(mx[r], tmax[r]);
      corr[r] = ex2(mx[r] - mn);  // 0 on a tile's first block (mx = -inf)
      mx[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[4 * n] *= corr[0], o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1], o[4 * n + 3] *= corr[1];
    }
    // p = ex2(t - max) (0 on keys >= N), the row sums, p in bf16 as the A
    // fragments of P V, a 16-key step each
    uint32_t pa[KC][4][4];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c >= nc) continue;
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const float pv = ex2(sc[c][x] - mx[(x >> 1) & 1]);
        l[(x >> 1) & 1] += pv;
        sc[c][x] = pv;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          pa[c][kk][u] = pack2(sc[c][8 * kk + 2 * u], sc[c][8 * kk + 2 * u + 1]);
    }

    // O += P V
    if (s == 0) wg::mbar_wait(&bar_v, 0);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (c < nc) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          rs<1>(o, pa[c][kk], desc(aV + (kb * KC + c) * L::kTile + kk * 16 * SW, SW, true), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int c = 0; c < KC; ++c) fence_regs(pa[c]);
    if (kb < nB - 1) continue;

    // the tile's last block: O / l in bf16 and lse, rows i0 + wr and i0 +
    // wr + 8 (< N only); then the next tile starts afresh
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = i0 + wr + 8 * r;
      if (row < N) {
        const float inv = 1.0f / l[r];
        bf16* dst = ob + row * p.ost[2] + 2 * tq;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<uint32_t*>(dst + 8 * n) =
              pack2(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
        if (tq == 0) p.lse[(size_t)bh * N + row] = (mx[r] + log2f(l[r])) * kLn2;
      }
      mx[r] = -INFINITY;
      l[r] = 0.0f;
    }
#pragma unroll
    for (int x = 0; x < R; ++x) o[x] = 0.0f;
  }
}

template <int HD, bool MASK, int KB, bool TMB>
int launch(const lvt::TcFwdWg& p, int nSeq, cudaStream_t stream) {
  using L = FwdSmem<HD, KB, TMB>;
  const size_t smem = L::bytes((p.N + kT - 1) / kT);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = fwd_wg_kernel<HD, MASK, KB, TMB>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)((long long)nSeq * p.nH), kWGs * kCons, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD, int KB>
int launch_tmb(const lvt::TcFwdWg& p, int nSeq, bool tmb, cudaStream_t stream) {
  if (p.mask != nullptr)
    return tmb ? launch<HD, true, KB, true>(p, nSeq, stream)
               : launch<HD, true, KB, false>(p, nSeq, stream);
  return tmb ? launch<HD, false, KB, true>(p, nSeq, stream)
             : launch<HD, false, KB, false>(p, nSeq, stream);
}

// Up to 256 keys: one block, the softmax exact; beyond, blocks of 128
// keys, which leave room for the window's K and V.
template <int HD>
int launch_mask(const lvt::TcFwdWg& p, int nSeq, bool tmb, cudaStream_t stream) {
  return p.N <= 256 ? launch_tmb<HD, 256>(p, nSeq, tmb, stream)
                    : launch_tmb<HD, 128>(p, nSeq, tmb, stream);
}

}  // namespace

int lvt::attention_fwd_wgmma(const TcFwd& a, int hd, cudaStream_t stream) {
  const int heads_total = a.heads_total <= 0 ? a.nH : a.heads_total;
  if (a.lse == nullptr || a.bias == nullptr || a.seed != nullptr || a.keep != nullptr ||
      a.head0 < 0 || a.head0 + a.nH > heads_total || a.nSeq <= 0 || a.N <= 0 || a.nH <= 0 ||
      a.nW <= 0 || a.nSeq % a.nW != 0 || a.N > 65535 || (a.mask_ld != 0 && a.mask_ld != a.N) ||
      (a.bias_ld != 0 && a.bias_ld != a.N) || (hd != 16 && hd != 32 && hd != 64))
    return (int)cudaErrorInvalidValue;
  const int kb = a.N <= 256 ? 256 : 128;
  const int nQ = (a.N + kT - 1) / kT, nB = (a.N + kb - 1) / kb;
  if ((long long)a.nSeq * a.nH > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // every stride a multiple of 8 elements (16 bytes) where its extent is
  // over 1, every pointer 16-byte aligned: the tensor maps' rule, and the
  // bias's and mask's 16-byte copies
  const int ext[3] = {a.nSeq, a.nH, a.N};
  for (int t = 0; t < 4; ++t) {
    const void* ptr = t < 3 ? (const void*)a.x[t] : (const void*)a.o;
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 3; ++i)
      if (ext[i] > 1 && a.st[t][i] % 8) return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(a.bias) % 16 || reinterpret_cast<uintptr_t>(a.mask) % 16)
    return (int)cudaErrorInvalidValue;
  lvt::TcFwdWg p{};
  for (int t = 0; t < 3; ++t)
    if (!head_map(&p.x[t], a.x[t], a.st[t], a.nSeq, a.nH, a.N, hd))
      return (int)cudaErrorInvalidValue;
  p.o = a.o;
  for (int i = 0; i < 3; ++i) p.ost[i] = a.st[3][i];
  p.lse = a.lse;
  p.bias = a.bias;
  p.mask = static_cast<const bf16*>(a.mask);
  p.scale = a.scale;
  p.N = a.N;
  p.nH = a.nH;
  p.nW = a.nW;
  p.nQ = nQ;
  p.nB = nB;
  // the bias's and mask's rows 16-byte aligned: both by TMA
  const bool tmb = a.N % 8 == 0;
  if (tmb && (!wg::tile_map(&p.bm[0], a.bias, a.nH * a.N, a.N, a.N, kT) ||
              (a.mask != nullptr &&
               !wg::tile_map(&p.bm[1], a.mask, a.nW * a.N, a.N, a.N, kT))))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_mask<16>(p, a.nSeq, tmb, stream);
    case 32: return launch_mask<32>(p, a.nSeq, tmb, stream);
    default: return launch_mask<64>(p, a.nSeq, tmb, stream);
  }
}
