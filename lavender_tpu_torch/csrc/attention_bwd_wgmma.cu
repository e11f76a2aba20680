// The Hopper backwards of the fusion encoder's train attention and of the
// Swin window core:
//   s = q k^T * scale + bias[h] + mask,  p = exp(s - lse),  o = (m * p) v
//   dv = (m * p)^T g,  dp = m * (g v^T),  ds = p * (dp - D),
//   dq = ds k * scale,  dk = ds^T q * scale,
//   dbias[h] = the sum of ds over every sequence (f32, from f32 ds),
// D = rowsum(o * g) from the forward's bf16 output (row_dot_kernel below),
// m the dropout factor of each probability, regenerated from the forward's
// seed by the counter hash of dropout.cuh (stream dropout.cuh
// attention_stream(sequence, head, head0, heads_total), index row * N +
// key), lse the forward's row log-sum-exp (attention_fwd_tc.cu,
// attention_fwd_wgmma.cu).
//
// Replaces lavender_tpu/ops/encoder_attention.py
// _enc_attn_train_lanes_bwd_kernel (:780, K10b: q, k, v column slices of
// the packed qkv slab [B*L, 3C], a bf16 [B, L, L] mask) and
// _enc_attn_train_bwd_kernel (:555, K13b without the mask's gradient: q, k,
// v and g [B, nH, L, hd] by their strides, the f32 [B, L, L] mask clamped
// at -1e4), both with dropout and no bias, and
// lavender_tpu/ops/swin_core_attn.py _core_bwd_kernel (:147, K8b: the
// packed slab [B*nW*Npad, 3C] of the Swin backward's recompute, a bf16
// rel-pos bias [nH, Npad, Npad] and its gradient dbias, a bf16 shift mask
// [nW, Npad, Npad] or none, no dropout), through the C entries of
// attention_bwd.cu.  It computes what they compute, not their blocks.
//
// Bound on the card: at the default train step (64 pairs, L = 276, 12
// heads of 64) device memory, 200.5 MB (7 bf16 [B*L, C] slabs, the mask,
// lse) = 0.060 ms at 3.35 TB/s against 37.4 GFLOP = 0.038 ms of products;
// at Swin-L's L = 751 the products, 277 GFLOP = 0.280 ms at 989 TFLOP/s.
// K8b at B = 8, Swin-B stage 1 shifted (512 windows of 248 rows, 4 heads
// of 32): 7 slabs of C = 128 columns + lse, bias, dbias and mask, 239 MB =
// 0.071 ms; 40.3 GFLOP.  Under both sit about 30 instructions of softmax,
// dropout hash and rounding for every score (about 20 without the hash,
// with the bias), which the card issues at 4 warp instructions a clock an
// SM: at 64 x 64 tiles they take longer than the five products.
//
// Design.  A CTA owns one 64-key tile of one (sequence, head) and is one
// warpgroup (128 threads, two key rows a thread), two CTAs an SM (up to 255
// registers a thread; 92 KB of shared memory with the bf16 mask, 108 KB
// with the f32 one).  K and V arrive once by the Tensor Memory Accelerator
// (4-D tensor maps (hd, L, heads, sequences) over each operand's own
// strides: rows >= L are zero-filled per (sequence, head), never read from
// the next sequence).  A two-stage ring then brings each query tile: Q and
// G by TMA (thread 0), its mask rows and lse and D rows by cp.async (warps
// 0-2; the mask's row pitch, 552 bytes at L = 276, 1502 at 751, is no
// multiple of 16, so the mask cannot be a tensor map: each row comes as
// the aligned 16-byte chunks around it, read from its lead offset), all
// reported to one mbarrier a stage and issued one step ahead, while that
// step's first products run.  For each query tile the warpgroup forms, on
// wgmma:
//   S^T = K Q^T and dP^T = V G^T (from shared memory, K-major),
// then on the accumulators, a (key, query) element a thread element, p
// (a select to 0 for rows or keys >= L, no branch), m (one hash an
// element), m * p and ds = p * (m * dp - D), each rounded to bf16 (as the
// JAX kernels round p * m and ds), and then
//   dV += (m * P)^T G and dK += dS^T Q (A from registers: the accumulator
//     layout is wgmma's A-fragment layout; G and Q as MN-major B),
//   dQ_t = dS K (dS^T written to shared memory in the 128-byte swizzle and
//     read as an MN-major A, K as an MN-major B):
// five products for each (key tile, query tile), where the mma.sync kernels
// this replaces formed S and dP twice (seven).  dK and dV stay in registers
// for the whole sweep and are written once.  A producer warp beside the
// warpgroup was measured first: five warps a CTA cap the registers at 168
// and spill, and the loads cost the warpgroup less than that (PERF.md).
//
// dQ is summed across the key tiles in a fixed order, without atomics of
// varying order: a (sequence, head, query tile)'s f32 sum lives in a
// scratch buffer, and each key tile's CTA, when a turn counter for that
// tile says it is its turn, stores its dQ_t there (the first turn) or adds
// it (a bulk copy shared -> global whose f32 add is performed in L2, one
// at a time), or, the last turn, reads the sum, adds its own, writes dq in
// bf16 x scale and resets the counter to 0.  dQ_t goes out through shared
// memory by warp 3's lane 0, which waits for the copy and releases the next
// turn at the next step, while the products run (its fence then waits on
// no load of its own).  The sweeps run diagonally: key tile t takes query
// tile (t + s) mod T at its step s, and its turn there is s, so at every
// step each tile's next adder is the CTA that finished the step before (no
// chain of waits along the key tiles).  A CTA waits only on CTAs of its
// own (sequence, head), dispatched in the same group: the C entry refuses a
// length whose key tiles cannot all be resident at once.  The same inputs
// give the same bits on every run.
//
// A CTA of two warpgroups and 128 keys (one CTA an SM, each warpgroup
// sweeping its own 64 keys over shared query tiles, warpgroup 0 adding
// warpgroup 1's dQ_t before the hand-off: half the hand-offs and half the
// query tiles' loads a key) was built and measured too, and ran slower at
// L = 276 and at 751 (PERF.md).
//
// K8b: the same kernel's BIAS instance, which stages each step's bias tile
// (64 query rows x 64 keys of head h's [N, N]) beside its mask tile and
// adds it before the mask in f32, as the forward does: both by TMA as 64 x
// 64 boxes of 2-D maps in the 128-byte swizzle where the rows are 16-byte
// aligned (N % 8 == 0: Npad = 248, 720), else by the loading warps'
// 16-byte cp.async chunks (the spatial route's N = 245).  Then dbias, in a
// kernel of its own: a CTA a (query tile, key tile, head, chunk of
// sequences) forms S^T and dP^T once more on wgmma for each sequence of its
// chunk (K, V, Q and G by TMA through a two-stage ring), p and ds = p * (dp
// - D) in f32 exactly as the backward forms them, and sums ds in f32
// registers in the chunk's order (window-major, so that the mask tile
// changes only with the window); the chunks' slices are then added in
// chunk order (sum_chunks).  Seven products in two launches where the
// mma.sync kernels this replaces took nine in four; no atomics: the same
// bits on every run.  Folding dbias into the backward would need a 64 x
// Npad f32 partial in shared memory (63.5 KB at 248, 184 KB at 720): one
// CTA an SM at Swin-B, none at Swin-L.
#include "attention_wg.cuh"

namespace lvt {

// The kernel's operands: q, k, v, g as tensor maps; the rest as TcBwd's.
struct TcBwdWg {
  CUtensorMap x[4];     // q, k, v, g: (hd, N, nH, nSeq) maps, 64-row boxes
  bf16* dx[3];          // dq, dk, dv
  long long st[3][3];   // their (sequence, head, row) element strides
  const float* lse;     // [nSeq, nH, N] f32
  const float* dd;      // [nSeq, nH, N] f32: D
  const void* mask;     // [nW, N, N] (sequence s reads s % nW) or null
  const int64_t* seed;  // or null: no dropout
  float* acc;           // the dQ sums [nSeq * nH, T, hd / 8, 128] float4
  int* sem;             // the turn counters [nSeq * nH, T], 0 between calls
  uint32_t thresh;
  float drop_scale, scale;
  int N, nH, nW, nT, head0, heads_total;
  // K8b: the bf16 bias [nH, N, N] (head h reads bias[h]), and dbias's
  // partial sums part [nChunks, nH, N, N] f32, chunk c summing the
  // sequences [c * nSeq / nChunks, (c + 1) * nSeq / nChunks) in order
  const bf16* bias;
  float* part;
  int nSeq, nChunks;
  // K8b where the rows are 16-byte aligned (N % 8 == 0): the bias [nH N, N]
  // and the mask [nW N, N] as 2-D maps of 64 x 64 boxes in the 128-byte
  // swizzle, their tiles by TMA
  CUtensorMap bm[2];
};

}  // namespace lvt

namespace {

namespace wg = lvt::wg;

// Warps 0-2 load the query tiles' mask, lse and D rows; warp 3's lane 0
// hands the dQ sums on (its fence then waits on no load of its own).
constexpr int kLoaders = 96, kHander = 96;

// The shared memory of one CTA: K, V, then Q and G of each stage (all in
// the swizzle of their row width, 2 * HD bytes), the dS^T tile, dQ_t's f32
// hand-off, the mask tile and the (lse, D) rows of each stage.
template <int HD, typename M, bool BIAS, bool TMB>
struct Smem {
  static constexpr int kStages = 2;
  static constexpr int kSw = 2 * HD;
  static constexpr int kTile = kT * kSw;
  // a mask or bias tile: by cp.async (a row 64 elements + 16 bytes) or by
  // TMA (TMB: a 64 x 64 box in the 128-byte swizzle)
  static constexpr int kMask = TMB ? kT * 128 : MaskTile<M>::kBytes;
  static constexpr int kBiasTile = TMB ? kT * 128 : MaskTile<bf16>::kBytes;
  static constexpr int kLd = 2 * kT * 4;
  static constexpr int kQ = 2 * kTile;
  static constexpr int kDs = kQ + 2 * kStages * kTile;
  static constexpr int kHand = kDs + kT * 128;
  static constexpr int kMaskOff = kHand + kT * HD * 4;
  static constexpr int kLdOff = kMaskOff + kStages * kMask;
  // BIAS: each stage's bias tile, a bf16 mask tile of head h's [N, N]
  static constexpr int kBiasOff = kLdOff + kStages * kLd;
  static constexpr size_t kBytes =
      kBiasOff + (BIAS ? kStages * kBiasTile : 0) + 1024;  // + 1 KB to align
};

// The bulk copies of one 16-byte-aligned run shared -> global: a store, or
// an f32 add performed in L2; committed as a group, waited for whole (their
// writes done) or read (the shared source free).
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_reduce_add(void* dst, const void* src, int bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
// The dQ sum through L2 (other SMs' CTAs added to it).
__device__ __forceinline__ float4 ld_cg(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}


// The mask tile (64 query rows from r0 x 64 keys from c0 of window w) by
// the loading threads (tid < kLoaders) in 16-byte copies: each row as the
// aligned 16-byte chunks around its 64 elements (9 of them in bf16, 17 in
// f32: MaskTile's row, 64 elements + 16 bytes), its elements from byte
// lead = (start & 15) of the row; copies past the buffer's end (m_bytes)
// are cut or zero-filled.  Whatever the row pitch (552 bytes at L = 276,
// 1502 at 751), a tile takes 576 or 1088 copies.
template <typename M>
__device__ __forceinline__ void load_mask_tile(uint32_t* s, const void* m, long long m_bytes,
                                               int w, int r0, int c0, int N, int tid) {
  constexpr int W = MaskTile<M>::kWords, PER = W / 4;  // 16-byte chunks a row
  const char* base = static_cast<const char*>(m);
  const long long row0 = mask_byte<M>(w, r0, c0, N), pitch = (long long)N * sizeof(M);
#pragma unroll
  for (int u = 0; u < (kT * PER + kLoaders - 1) / kLoaders; ++u) {
    const int c = tid + u * kLoaders;
    if (c >= kT * PER) break;
    const int r = c / PER, k = c - r * PER;
    const long long b = ((row0 + r * pitch) & ~15LL) + 16 * k;
    const long long left = m_bytes - b;
    const int n = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
    cp_async<16>(s + r * W + 4 * k, base + (n > 0 ? b : 0), n);
  }
}

// p = exp2(s * scale * log2(e) + (bias + mask - lse) * log2(e)) on the
// keys and queries < N, 0 elsewhere, into sc; element 4n + 2r + c of the
// accumulators is (key jr0 + 8r, query 8n + 2tq + c).  BIAS: the bias tile
// cB (row lead blead0 of its first row), added before the mask in f32, as
// the forward adds them.  No branch: every element's loads and ex2 issue
// back to back, and the edge is a select.
template <typename M, bool MASK, bool BIAS = false, bool TMB = false>
__device__ __forceinline__ void probs(float (&sc)[32], const uint32_t* cM, const float* cL,
                                      int lead0, int i0, int j0, int jr0, int tq, int N,
                                      float sl2, const uint32_t* cB = nullptr, int blead0 = 0) {
  const bool kok[2] = {j0 + jr0 < N, j0 + jr0 + 8 < N};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ic = 8 * n + 2 * tq + c;
      const bool qok = i0 + ic < N;
      const float l2 = cL[ic] * kLog2e;
      const int lead = MASK ? (lead0 + ic * N * (int)sizeof(M)) & 15 : 0;
      const int blead = BIAS ? (blead0 + ic * N * 2) & 15 : 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float b;
        if constexpr (BIAS && TMB)
          b = box_in(reinterpret_cast<const char*>(cB), ic, jr0 + 8 * r) +
              (MASK ? box_in(reinterpret_cast<const char*>(cM), ic, jr0 + 8 * r) : 0.0f);
        else if constexpr (BIAS)
          b = mask_in<bf16>(cB, ic, blead, jr0 + 8 * r) +
              (MASK ? mask_in<M>(cM, ic, lead, jr0 + 8 * r) : 0.0f);
        else
          b = MASK ? mask_in<M>(cM, ic, lead, jr0 + 8 * r) : 0.0f;
        const float pv = ex2(fmaf(sc[4 * n + 2 * r + c], sl2, fmaf(b, kLog2e, -l2)));
        sc[4 * n + 2 * r + c] = qok && kok[r] ? pv : 0.0f;
      }
    }
  }
}

// One (key tile, sequence, head) of the backward: blockIdx.x = (sequence *
// nH + head) * T + key tile.  BIAS (K8b): each step's bias tile beside its
// mask tile (a bf16 mask or none, no dropout), both by TMA where TMB.
template <int HD, typename M, bool DROP, bool BIAS, bool TMB = false>
__global__ void __launch_bounds__(kCons, 2) bwd_wg_kernel(const __grid_constant__ lvt::TcBwdWg p) {
  using L = Smem<HD, M, BIAS, TMB>;
  constexpr int ST = L::kStages, SW = L::kSw, R = HD / 2, V4 = HD / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], kv_full;
  char* base = reinterpret_cast<char*>(smem_raw) + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int nT = p.nT, N = p.N, t = blockIdx.x % nT, bh = blockIdx.x / nT;
  const int seq = bh / p.nH, h = bh - seq * p.nH, w = seq % p.nW, j0 = t * kT;
  // thread (warp, g = lane / 4, tq = lane % 4) holds key rows jr0 and jr0 +
  // 8 of S^T, dP^T, dK and dV, and query rows of dQ_t
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int jr0 = warp * 16 + g;
  const bool has_mask = p.mask != nullptr;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) wg::mbar_init(&full[s], 1 + kCons);  // TMA + cp.async
    wg::mbar_init(&kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < (TMB ? 6 : 4); ++i)  // the tensor maps into the TMA unit's cache
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(
                       i < 4 ? &p.x[i] : &p.bm[i - 4]))
                   : "memory");
  }
  __syncthreads();

  // step s's query tile (Q and G by TMA, its mask tile, lse and D rows by
  // cp.async) into stage s % ST, all reported to its barrier
  const long long m_bytes = (long long)p.nW * N * N * (long long)sizeof(M);
  const long long b_bytes = (long long)p.nH * N * N * 2;
  const float* lse_bh = p.lse + (size_t)bh * N;
  const float* dd_bh = p.dd + (size_t)bh * N;
  auto issue = [&](int s) {
    const int slot = s % ST, i0 = ((t + s) % nT) * kT;
    char* q = base + L::kQ + 2 * slot * L::kTile;
    char* sMk = base + L::kMaskOff + slot * L::kMask;
    char* sBk = base + L::kBiasOff + slot * L::kBiasTile;
    if (tid == 0) {
      wg::mbar_expect(&full[slot], 2 * L::kTile + (TMB ? (has_mask ? 2 : 1) * L::kBiasTile : 0));
      tma_load_4d(q, &p.x[0], &full[slot], 0, i0, h, seq);
      tma_load_4d(q + L::kTile, &p.x[3], &full[slot], 0, i0, h, seq);
      if constexpr (TMB) {
        wg::tma_load(sBk, &p.bm[0], &full[slot], j0, h * N + i0);
        if (has_mask) wg::tma_load(sMk, &p.bm[1], &full[slot], j0, w * N + i0);
      }
    }
    if (tid < kLoaders) {
      if (has_mask && !TMB)
        load_mask_tile<M>(reinterpret_cast<uint32_t*>(sMk), p.mask, m_bytes, w, i0, j0, N, tid);
      if constexpr (BIAS && !TMB)
        load_mask_tile<bf16>(reinterpret_cast<uint32_t*>(sBk), p.bias, b_bytes, h, i0, j0, N,
                             tid);
      float* ld = reinterpret_cast<float*>(base + L::kLdOff + slot * L::kLd);
      for (int c = tid; c < 2 * kT; c += kLoaders) {  // lse rows, then D rows
        const int r = c % kT;
        const bool ok = i0 + r < N;
        cp_async<4>(ld + c, (c < kT ? lse_bh : dd_bh) + (ok ? i0 + r : 0), ok ? 4 : 0);
      }
    }
    cp_async_arrive(&full[slot]);
  };
  if (tid == 0) {
    wg::mbar_expect(&kv_full, 2 * L::kTile);
    tma_load_4d(base, &p.x[1], &kv_full, 0, j0, h, seq);
    tma_load_4d(base + L::kTile, &p.x[2], &kv_full, 0, j0, h, seq);
  }
  for (int s = 0; s < ST - 1 && s < nT; ++s) issue(s);

  const float sl2 = p.scale * kLog2e;
  const uint32_t key =
      DROP ? lvt::dropout_key((uint32_t)*p.seed,
                              lvt::attention_stream(seq, h, p.head0, p.heads_total))
           : 0u;
  const uint32_t aK = smem_addr(base), aV = aK + L::kTile, aDS = aK + L::kDs;
  char* sDS = base + L::kDs;
  float4* sHand = reinterpret_cast<float4*>(base + L::kHand);  // dQ_t on its way out
  int* sem = p.sem + (size_t)bh * nT;
  float4* acc_bh = reinterpret_cast<float4*>(p.acc) + (size_t)bh * nT * V4 * kCons;
  float dv[R], dk[R];
#pragma unroll
  for (int i = 0; i < R; ++i) dv[i] = dk[i] = 0.0f;
  wg::mbar_wait(&kv_full, 0);

  for (int s = 0; s < nT; ++s) {
    const int slot = s % ST, it = (t + s) % nT, i0 = it * kT;
    const uint32_t aQ = aK + L::kQ + 2 * slot * L::kTile, aG = aQ + L::kTile;
    const uint32_t* cM = reinterpret_cast<const uint32_t*>(base + L::kMaskOff + slot * L::kMask);
    const float* cL = reinterpret_cast<const float*>(base + L::kLdOff + slot * L::kLd);
    wg::mbar_wait(&full[slot], (s / ST) & 1);

    // S^T = K Q^T and dP^T = V G^T: the warpgroup's 64 keys x 64 queries
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ss<0, 0>(sc, desc(aK + 32 * kk, SW, false), desc(aQ + 32 * kk, SW, false), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ss<0, 0>(dp, desc(aV + 32 * kk, SW, false), desc(aG + 32 * kk, SW, false), kk);
    wgmma_commit();
    // while they run: every thread is past step s - 1 (the loop's last
    // barrier), so its stage takes step s + ST - 1; and once the previous
    // step's dQ sum has landed, its tile's next turn
    if (s + ST - 1 < nT) issue(s + ST - 1);
    if (tid == kHander && s > 0) {
      bulk_wait<false>();
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      st_release(sem + (t + s - 1) % nT, s);
    }
    wgmma_wait<1>();
    fence_regs(sc);
    if constexpr (BIAS) {
      const uint32_t* cB =
          reinterpret_cast<const uint32_t*>(base + L::kBiasOff + slot * L::kBiasTile);
      const int blead0 = TMB ? 0 : (int)(mask_byte<bf16>(h, i0, j0, N) & 15);
      if (has_mask)
        probs<M, true, true, TMB>(sc, cM, cL, TMB ? 0 : (int)(mask_byte<M>(w, i0, j0, N) & 15),
                                  i0, j0, jr0, tq, N, sl2, cB, blead0);
      else
        probs<M, false, true, TMB>(sc, cM, cL, 0, i0, j0, jr0, tq, N, sl2, cB, blead0);
    } else if (has_mask) {
      probs<M, true>(sc, cM, cL, (int)(mask_byte<M>(w, i0, j0, N) & 15), i0, j0, jr0, tq, N, sl2);
    } else {
      probs<M, false>(sc, cM, cL, 0, i0, j0, jr0, tq, N, sl2);
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // m * p (into sc) and ds = p * (m * dp - D) (into dp), m from the hash
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ic = 8 * n + 2 * tq + c;
        const float D = cL[kT + ic];
        const uint32_t e0 = (uint32_t)(i0 + ic) * (uint32_t)N + (uint32_t)(j0 + jr0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * n + 2 * r + c;
          const float m = drop_factor<DROP>(key, e0 + 8 * r, p.thresh, p.drop_scale);
          const float pv = sc[x];
          sc[x] = pv * m;
          dp[x] = pv * (dp[x] * m - D);
        }
      }
    }
    // both as bf16 A fragments, a 16-query step each, and dS^T into shared
    // memory: row jr (128 bytes, 64 queries), 16-byte chunk n at n ^ (jr % 8)
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pa[kk][u] = pack2(sc[8 * kk + 2 * u], sc[8 * kk + 2 * u + 1]);
        da[kk][u] = pack2(dp[8 * kk + 2 * u], dp[8 * kk + 2 * u + 1]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int jr = jr0 + 8 * hf;
        *reinterpret_cast<uint32_t*>(sDS + jr * 128 + ((n ^ (jr & 7)) << 4) + 4 * tq) =
            da[n >> 1][(n & 1) * 2 + hf];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // dQ_t = dS K, dV += (m P)^T G, dK += dS^T Q
    float dq[R];
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ss<1, 1>(dq, desc(aDS + kk * 16 * 128, 128, true), desc(aK + kk * 16 * SW, SW, true), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) rs<1>(dv, pa[kk], desc(aG + kk * 16 * SW, SW, true), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) rs<1>(dk, da[kk], desc(aQ + kk * 16 * SW, SW, true), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);
    fence_regs(pa);
    fence_regs(da);

    // query tile it's dQ sum, this CTA's turn s of it (key tiles t, t - 1,
    // .. in turn)
    float4* acc = acc_bh + (size_t)it * V4 * kCons;
    if (s == nT - 1) {  // the last turn: the sum in bf16 x scale into dq
      if (s > 0) {
        if (tid == kHander)
          while (ld_acquire(sem + it) != s) {
          }
        __syncthreads();
#pragma unroll
        for (int v = 0; v < V4; ++v) {
          const float4 o = ld_cg(acc + v * kCons + tid);
          dq[4 * v] += o.x;
          dq[4 * v + 1] += o.y;
          dq[4 * v + 2] += o.z;
          dq[4 * v + 3] += o.w;
        }
      }
      bf16* dqb = p.dx[0] + seq * p.st[0][0] + h * p.st[0][1];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = i0 + warp * 16 + g + 8 * hf;
        if (i >= N) continue;
        bf16* dst = dqb + i * p.st[0][2] + 2 * tq;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<uint32_t*>(dst + 8 * n) =
              pack2(dq[4 * n + 2 * hf] * p.scale, dq[4 * n + 2 * hf + 1] * p.scale);
      }
      if (s > 0 && tid == kHander) sem[it] = 0;  // for the next call
    } else {
      // dQ_t into shared memory (the previous one has left: kHander waited
      // for its bulk copy before the barrier above), then one bulk copy
      // stores it (turn 0) or adds it in L2 (the turns after); the barrier
      // between also says this step's stage is read
#pragma unroll
      for (int v = 0; v < V4; ++v)
        sHand[v * kCons + tid] =
            make_float4(dq[4 * v], dq[4 * v + 1], dq[4 * v + 2], dq[4 * v + 3]);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == kHander) {
        if (s > 0) {
          while (ld_acquire(sem + it) != s) {
          }
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          bulk_reduce_add(acc, sHand, V4 * kCons * 16);
        } else {
          bulk_store(acc, sHand, V4 * kCons * 16);
        }
        bulk_commit();
      }
    }
  }

  // dK x scale and dV, rows j0 + jr0 and j0 + jr0 + 8 (< N only)
  bf16* dkb = p.dx[1] + seq * p.st[1][0] + h * p.st[1][1];
  bf16* dvb = p.dx[2] + seq * p.st[2][0] + h * p.st[2][1];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = j0 + jr0 + 8 * hf;
    if (j >= N) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + j * p.st[1][2] + 8 * n + 2 * tq) =
          pack2(dk[4 * n + 2 * hf] * p.scale, dk[4 * n + 2 * hf + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + j * p.st[2][2] + 8 * n + 2 * tq) =
          pack2(dv[4 * n + 2 * hf], dv[4 * n + 2 * hf + 1]);
    }
  }
}


// The shared memory of one dbias CTA: each stage's K, V, Q and G tiles (in
// the swizzle of their row width), then each stage's mask tile and (lse, D)
// rows, and the bias tile, which is the same for every sequence of a head.
template <int HD, bool TMB>
struct DbSmem {
  static constexpr int kStages = 2;
  static constexpr int kSw = 2 * HD;
  static constexpr int kTile = kT * kSw;
  static constexpr int kMask = TMB ? kT * 128 : MaskTile<bf16>::kBytes;
  static constexpr int kLd = 2 * kT * 4;
  static constexpr int kMaskOff = kStages * 4 * kTile;
  static constexpr int kLdOff = kMaskOff + kStages * kMask;
  static constexpr int kBiasOff = kLdOff + kStages * kLd;
  static constexpr size_t kBytes = kBiasOff + kMask + 1024;  // + 1 KB to align
};

// dbias of K8b: one (query tile, key tile) of head h summed over a chunk of
// sequences, blockIdx = (query tile * T + key tile, head, chunk).  The
// sequences are taken window-major (k = w * (nSeq / nW) + b for sequence b
// * nW + w), so that the mask tile changes only with the window, and the
// chunks are runs of k.  For each sequence of the chunk in order: S^T = K
// Q^T and dP^T = V G^T on wgmma, p as bwd_wg_kernel forms it (the same
// bits), ds = p * (dp - D) in f32 added to the thread's 32 sums; then the
// chunk's sums into its slice of part, which sum_chunks adds in chunk
// order.  A two-stage ring brings the next sequence's K, V, Q and G by TMA
// and its (lse, D) rows by cp.async while the current one multiplies, and
// its mask tile where the stage held another window's; the bias tile comes
// once.
template <int HD, bool MASK, bool TMB>
__global__ void __launch_bounds__(kCons, 2) dbias_wg_kernel(const __grid_constant__ lvt::TcBwdWg p) {
  using L = DbSmem<HD, TMB>;
  constexpr int ST = L::kStages, SW = L::kSw;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];
  char* base = reinterpret_cast<char*>(smem_raw) + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int nT = p.nT, N = p.N, t = blockIdx.x % nT, it = blockIdx.x / nT, h = blockIdx.y;
  const int j0 = t * kT, i0 = it * kT;
  const int k0 = (int)((long long)blockIdx.z * p.nSeq / p.nChunks);
  const int n = (int)((long long)(blockIdx.z + 1) * p.nSeq / p.nChunks) - k0;
  const int per_w = p.nSeq / p.nW;  // sequences a window
  auto w_of = [&](int k) { return (k0 + k) / per_w; };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int jr0 = warp * 16 + g;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) wg::mbar_init(&full[s], 1 + kCons);  // TMA + cp.async
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < (TMB ? 6 : 4); ++i)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(
                       i < 4 ? &p.x[i] : &p.bm[i - 4]))
                   : "memory");
  }
  __syncthreads();

  const long long m_bytes = (long long)p.nW * N * N * 2, b_bytes = (long long)p.nH * N * N * 2;
  uint32_t* sB = reinterpret_cast<uint32_t*>(base + L::kBiasOff);
  // the chunk's k-th sequence's tiles into stage k % ST, all reported to its barrier
  // (the bias tile with stage 0's)
  auto issue = [&](int k) {
    const int slot = k % ST, w = w_of(k), seq = (k0 + k - w * per_w) * p.nW + w;
    char* st = base + slot * 4 * L::kTile;
    char* sMk = base + L::kMaskOff + slot * L::kMask;
    const bool new_mask = MASK && (k < ST || w != w_of(k - ST));  // the stage held another window's
    if (tid == 0) {
      wg::mbar_expect(&full[slot], 4 * L::kTile + (TMB ? ((k == 0) + new_mask) * L::kMask : 0));
      tma_load_4d(st, &p.x[1], &full[slot], 0, j0, h, seq);
      tma_load_4d(st + L::kTile, &p.x[2], &full[slot], 0, j0, h, seq);
      tma_load_4d(st + 2 * L::kTile, &p.x[0], &full[slot], 0, i0, h, seq);
      tma_load_4d(st + 3 * L::kTile, &p.x[3], &full[slot], 0, i0, h, seq);
      if constexpr (TMB) {
        if (k == 0) wg::tma_load(sB, &p.bm[0], &full[slot], j0, h * N + i0);
        if (new_mask) wg::tma_load(sMk, &p.bm[1], &full[slot], j0, w * N + i0);
      }
    }
    if (tid < kLoaders) {
      if (new_mask && !TMB)
        load_mask_tile<bf16>(reinterpret_cast<uint32_t*>(sMk), p.mask, m_bytes, w, i0, j0, N, tid);
      if (k == 0 && !TMB) load_mask_tile<bf16>(sB, p.bias, b_bytes, h, i0, j0, N, tid);
      const size_t bh = (size_t)seq * p.nH + h;
      float* ld = reinterpret_cast<float*>(base + L::kLdOff + slot * L::kLd);
      for (int c = tid; c < 2 * kT; c += kLoaders) {  // lse rows, then D rows
        const int r = c % kT;
        const bool ok = i0 + r < N;
        cp_async<4>(ld + c, (c < kT ? p.lse : p.dd) + bh * N + (ok ? i0 + r : 0), ok ? 4 : 0);
      }
    }
    cp_async_arrive(&full[slot]);
  };
  if (n > 0) issue(0);

  const float sl2 = p.scale * kLog2e;
  const int blead0 = TMB ? 0 : (int)(mask_byte<bf16>(h, i0, j0, N) & 15);
  float db[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) db[i] = 0.0f;
  for (int k = 0; k < n; ++k) {
    const int slot = k % ST, w = w_of(k);
    const uint32_t aK = smem_addr(base + slot * 4 * L::kTile), aV = aK + L::kTile,
                   aQ = aV + L::kTile, aG = aQ + L::kTile;
    const uint32_t* cM = reinterpret_cast<const uint32_t*>(base + L::kMaskOff + slot * L::kMask);
    const float* cL = reinterpret_cast<const float*>(base + L::kLdOff + slot * L::kLd);
    wg::mbar_wait(&full[slot], (k / ST) & 1);
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ss<0, 0>(sc, desc(aK + 32 * kk, SW, false), desc(aQ + 32 * kk, SW, false), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ss<0, 0>(dp, desc(aV + 32 * kk, SW, false), desc(aG + 32 * kk, SW, false), kk);
    wgmma_commit();
    // while they run: every thread is past sequence k - 1 (the loop's
    // barrier), so its stage takes sequence k + 1
    if (k + 1 < n) issue(k + 1);
    wgmma_wait<1>();
    fence_regs(sc);
    probs<bf16, MASK, true, TMB>(sc, cM, cL,
                                 MASK && !TMB ? (int)(mask_byte<bf16>(w, i0, j0, N) & 15) : 0,
                                 i0, j0, jr0, tq, N, sl2, sB, blead0);
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float D = cL[kT + 8 * nn + 2 * tq + c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * nn + 2 * r + c;
          db[x] += sc[x] * (dp[x] - D);
        }
      }
    }
    __syncthreads();  // this stage is read: sequence k + 2 may take it
  }

  // dbias[h][query][key] of the chunk, queries and keys < N
  float* out = p.part + ((size_t)blockIdx.z * p.nH + h) * N * N;
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = i0 + 8 * nn + 2 * tq + c;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + jr0 + 8 * r;
        if (i < N && j < N) out[(size_t)i * N + j] = db[4 * nn + 2 * r + c];
      }
    }
}

// D = rowsum(o * g) of each (sequence, head, row) in f32, o the forward's
// output: HD / 8 lanes a row, 8 products each, then a fixed butterfly (the
// same bits on every run).
template <int HD>
__global__ void __launch_bounds__(256) row_dot_kernel(const lvt::RowDot a) {
  constexpr int LANES = HD / 8;
  const long long rows = (long long)a.nSeq * a.nH * a.N;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const int l = threadIdx.x % LANES;
  float acc = 0.0f;
  if (r < rows) {
    const long long bh = r / a.N;
    const int i = (int)(r - bh * a.N), seq = (int)(bh / a.nH), h = (int)(bh - (long long)seq * a.nH);
    float fo[8], fg[8];
    lvt::unpack8(*reinterpret_cast<const uint4*>(a.o + seq * a.st[0][0] + h * a.st[0][1] +
                                                 i * a.st[0][2] + l * 8),
                 fo);
    lvt::unpack8(*reinterpret_cast<const uint4*>(a.g + seq * a.st[1][0] + h * a.st[1][1] +
                                                 i * a.st[1][2] + l * 8),
                 fg);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(fo[e], fg[e], acc);
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && l == 0) a.dd[r] = acc;
}

// sum_chunks' pass: out[e] = sum over chunks of part[chunk][e], in order.
__global__ void sum_chunks_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int nChunks, size_t n) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < nChunks; ++c) s += part[(size_t)c * n + e];
    out[e] = s;
  }
}

template <int HD, typename M, bool DROP, bool BIAS, bool TMB = false>
int launch(const lvt::TcBwdWg& p, int nSeq, cudaStream_t stream) {
  using L = Smem<HD, M, BIAS, TMB>;
  auto kernel = bwd_wg_kernel<HD, M, DROP, BIAS, TMB>;
  static int ready = -1, resident = 0;  // the device the opt-in was made on; CTAs it holds
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != ready) {
    e = allow_smem(kernel, L::kBytes);
    int per_sm = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCons, L::kBytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      ready = dev;
      resident = per_sm * sms;
    }
  }
  if (e != cudaSuccess) return (int)e;
  // key tile t waits on tile t + 1 of its (sequence, head): all T of them
  // must be able to run at once
  if (p.nT > resident) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)((long long)nSeq * p.nH * p.nT), kCons, L::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD, typename M>
int launch_drop(const lvt::TcBwdWg& p, int nSeq, bool drop, cudaStream_t stream) {
  return drop ? launch<HD, M, true, false>(p, nSeq, stream)
              : launch<HD, M, false, false>(p, nSeq, stream);
}

template <typename M>
int launch_hd(const lvt::TcBwdWg& p, int nSeq, int hd, bool drop, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_drop<16, M>(p, nSeq, drop, stream);
    case 32: return launch_drop<32, M>(p, nSeq, drop, stream);
    case 64: return launch_drop<64, M>(p, nSeq, drop, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8b: the backward with the bias, then dbias by chunks of sequences and
// the chunks' sum; TMB: the bias and mask tiles by TMA.
template <int HD, bool TMB>
int launch_bias(const lvt::TcBwdWg& p, float* dbias, cudaStream_t stream) {
  int e = launch<HD, bf16, false, true, TMB>(p, p.nSeq, stream);
  if (e != 0) return e;
  using L = DbSmem<HD, TMB>;
  const bool mask = p.mask != nullptr;
  auto kernel = mask ? dbias_wg_kernel<HD, true, TMB> : dbias_wg_kernel<HD, false, TMB>;
  cudaError_t err = allow_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.nT * p.nT, p.nH, p.nChunks), kCons, L::kBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return lvt::sum_chunks(p.part, dbias, p.nChunks, (size_t)p.nH * p.N * p.N, stream);
}

template <int HD>
int launch_row_dot(const lvt::RowDot& a, cudaStream_t stream) {
  const long long threads = (long long)a.nSeq * a.nH * a.N * (HD / 8);
  row_dot_kernel<HD><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

int lvt::attention_bwd_wgmma(const TcBwd& a, float* acc, int* sem, int hd, bool mask_f32,
                             cudaStream_t stream) {
  const int heads_total = a.heads_total <= 0 ? a.nH : a.heads_total;
  if (a.head0 < 0 || a.head0 + a.nH > heads_total || a.nSeq <= 0 || a.N <= 0 || a.nH <= 0 ||
      a.nW <= 0 || a.nSeq % a.nW != 0 || a.N > 65535 || a.dd == nullptr || a.lse == nullptr ||
      (hd != 16 && hd != 32 && hd != 64))
    return (int)cudaErrorInvalidValue;
  const bool bias = a.bias != nullptr;
  // K8b: a bf16 mask or none, no dropout, dbias and its chunks' scratch
  if (bias && (mask_f32 || a.seed != nullptr || a.dbias == nullptr || a.part == nullptr ||
               a.nChunks < 1 || a.nChunks > a.nSeq || a.nChunks > 65535 || a.nH > 65535 ||
               reinterpret_cast<uintptr_t>(a.bias) % 16))
    return (int)cudaErrorInvalidValue;
  const int nT = (a.N + kT - 1) / kT;
  if ((long long)a.nSeq * a.nH * nT > 0x7fffffffLL ||
      (nT > 1 && (acc == nullptr || sem == nullptr)))
    return (int)cudaErrorInvalidValue;
  // every stride a multiple of 8 elements (16 bytes) where its extent is
  // over 1, every pointer 16-byte aligned: the tensor maps' rule
  const int ext[3] = {a.nSeq, a.nH, a.N};
  for (int t = 0; t < 7; ++t) {
    const void* ptr = t < 4 ? (const void*)a.x[t] : (const void*)a.dx[t - 4];
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 3; ++i)
      if (ext[i] > 1 && a.st[t][i] % 8) return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(a.mask) % 16) return (int)cudaErrorInvalidValue;
  TcBwdWg p{};
  for (int t = 0; t < 4; ++t)
    if (!head_map(&p.x[t], a.x[t], a.st[t], a.nSeq, a.nH, a.N, hd))
      return (int)cudaErrorInvalidValue;
  for (int t = 0; t < 3; ++t) {
    p.dx[t] = a.dx[t];
    for (int i = 0; i < 3; ++i) p.st[t][i] = a.st[4 + t][i];
  }
  p.lse = a.lse;
  p.dd = a.dd;
  p.mask = a.mask;
  p.seed = a.seed;
  p.acc = acc;
  p.sem = sem;
  p.thresh = a.thresh;
  p.drop_scale = a.drop_scale;
  p.scale = a.scale;
  p.N = a.N;
  p.nH = a.nH;
  p.nW = a.nW;
  p.nT = nT;
  p.head0 = a.head0;
  p.heads_total = heads_total;
  p.bias = a.bias;
  p.part = a.part;
  p.nSeq = a.nSeq;
  p.nChunks = a.nChunks;
  if (bias) {
    // the bias's and mask's rows 16-byte aligned: their tiles by TMA
    const bool tmb = a.N % 8 == 0;
    if (tmb && (!wg::tile_map(&p.bm[0], a.bias, a.nH * a.N, a.N, a.N, kT) ||
                (a.mask != nullptr &&
                 !wg::tile_map(&p.bm[1], a.mask, a.nW * a.N, a.N, a.N, kT))))
      return (int)cudaErrorInvalidValue;
    switch (hd) {
      case 16: return tmb ? launch_bias<16, true>(p, a.dbias, stream)
                          : launch_bias<16, false>(p, a.dbias, stream);
      case 32: return tmb ? launch_bias<32, true>(p, a.dbias, stream)
                          : launch_bias<32, false>(p, a.dbias, stream);
      default: return tmb ? launch_bias<64, true>(p, a.dbias, stream)
                          : launch_bias<64, false>(p, a.dbias, stream);
    }
  }
  const bool drop = a.seed != nullptr;
  return mask_f32 ? launch_hd<float>(p, a.nSeq, hd, drop, stream)
                  : launch_hd<bf16>(p, a.nSeq, hd, drop, stream);
}

int lvt::sum_chunks(const float* part, float* out, int nChunks, size_t n, cudaStream_t stream) {
  const size_t blocks = (n + 255) / 256 < 132 * 8 ? (n + 255) / 256 : 132 * 8;
  sum_chunks_kernel<<<(unsigned)blocks, 256, 0, stream>>>(part, out, nChunks, n);
  return (int)cudaGetLastError();
}

int lvt::attention_row_dot(const RowDot& a, int hd, cudaStream_t stream) {
  if (a.nSeq <= 0 || a.N <= 0 || a.nH <= 0 || a.dd == nullptr) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_row_dot<16>(a, stream);
    case 32: return launch_row_dot<32>(a, stream);
    case 64: return launch_row_dot<64>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
