// The Hopper backward of the fusion encoder's train attention:
//   s = q k^T * scale + mask,  p = exp(s - lse),  o = (m * p) v
//   dv = (m * p)^T g,  dp = m * (g v^T),  ds = p * (dp - D),
//   dq = ds k * scale,  dk = ds^T q * scale,
// D = rowsum(o * g) from the forward's bf16 output (row_dot_kernel of
// attention_bwd_tc.cu), m the dropout factor of each probability,
// regenerated from the forward's seed by the counter hash of dropout.cuh
// (stream dropout.cuh attention_stream(sequence, head, head0, heads_total),
// index row * N + key), lse the forward's row log-sum-exp
// (attention_fwd_tc.cu).
//
// Replaces lavender_tpu/ops/encoder_attention.py
// _enc_attn_train_lanes_bwd_kernel (:780, K10b: q, k, v column slices of
// the packed qkv slab [B*L, 3C], a bf16 [B, L, L] mask) and
// _enc_attn_train_bwd_kernel (:555, K13b without the mask's gradient: q, k,
// v and g [B, nH, L, hd] by their strides, the f32 [B, L, L] mask clamped
// at -1e4), both with dropout, through the C entries of attention_bwd.cu.
// It computes what they compute, not their blocks.
//
// Bound on the card: at the default train step (64 pairs, L = 276, 12
// heads of 64) device memory, 200.5 MB (7 bf16 [B*L, C] slabs, the mask,
// lse) = 0.060 ms at 3.35 TB/s against 37.4 GFLOP = 0.038 ms of products;
// at Swin-L's L = 751 the products, 277 GFLOP = 0.280 ms at 989 TFLOP/s.
// Under both sit about 30 instructions of softmax, dropout hash and
// rounding for every score, which the card issues at 4 warp instructions a
// clock an SM: at 64 x 64 tiles they take longer than the five products.
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
#include "attention_tc.cuh"
#include "gemm_tc.cuh"

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
};

}  // namespace lvt

namespace {

using namespace lvt::tc;
namespace wg = lvt::wg;

constexpr int kT = 64;      // rows of a key tile and of a query tile
constexpr int kCons = 128;  // the CTA: one warpgroup
// Warps 0-2 load the query tiles' mask, lse and D rows; warp 3's lane 0
// hands the dQ sums on (its fence then waits on no load of its own).
constexpr int kLoaders = 96, kHander = 96;

// The shared memory of one CTA: K, V, then Q and G of each stage (all in
// the swizzle of their row width, 2 * HD bytes), the dS^T tile, dQ_t's f32
// hand-off, the mask tile and the (lse, D) rows of each stage.
template <int HD, typename M>
struct Smem {
  static constexpr int kStages = 2;
  static constexpr int kSw = 2 * HD;
  static constexpr int kTile = kT * kSw;
  static constexpr int kMask = MaskTile<M>::kBytes;
  static constexpr int kLd = 2 * kT * 4;
  static constexpr int kQ = 2 * kTile;
  static constexpr int kDs = kQ + 2 * kStages * kTile;
  static constexpr int kHand = kDs + kT * 128;
  static constexpr int kMaskOff = kHand + kT * HD * 4;
  static constexpr int kLdOff = kMaskOff + kStages * kMask;
  static constexpr size_t kBytes = kLdOff + kStages * kLd + 1024;  // + 1 KB to align
};

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

// An arrival on the barrier once this thread's cp.async copies so far have
// landed (its count includes it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
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

// p = exp2(s * scale * log2(e) + (mask - lse) * log2(e)) on the keys and
// queries < N, 0 elsewhere, into sc; element 4n + 2r + c of the
// accumulators is (key jr0 + 8r, query 8n + 2tq + c).  No branch: every
// element's loads and ex2 issue back to back, and the edge is a select.
template <typename M, bool MASK>
__device__ __forceinline__ void probs(float (&sc)[32], const uint32_t* cM, const float* cL,
                                      int lead0, int i0, int j0, int jr0, int tq, int N,
                                      float sl2) {
  const bool kok[2] = {j0 + jr0 < N, j0 + jr0 + 8 < N};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ic = 8 * n + 2 * tq + c;
      const bool qok = i0 + ic < N;
      const float l2 = cL[ic] * kLog2e;
      const int lead = MASK ? (lead0 + ic * N * (int)sizeof(M)) & 15 : 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float b = MASK ? mask_in<M>(cM, ic, lead, jr0 + 8 * r) : 0.0f;
        const float pv = ex2(fmaf(sc[4 * n + 2 * r + c], sl2, fmaf(b, kLog2e, -l2)));
        sc[4 * n + 2 * r + c] = qok && kok[r] ? pv : 0.0f;
      }
    }
  }
}

// One (key tile, sequence, head) of the backward: blockIdx.x = (sequence *
// nH + head) * T + key tile.
template <int HD, typename M, bool DROP>
__global__ void __launch_bounds__(kCons, 2) bwd_wg_kernel(const __grid_constant__ lvt::TcBwdWg p) {
  using L = Smem<HD, M>;
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
    for (int i = 0; i < 4; ++i)  // the tensor maps into the TMA unit's cache
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&p.x[i]))
                   : "memory");
  }
  __syncthreads();

  // step s's query tile (Q and G by TMA, its mask tile, lse and D rows by
  // cp.async) into stage s % ST, all reported to its barrier
  const long long m_bytes = (long long)p.nW * N * N * (long long)sizeof(M);
  const float* lse_bh = p.lse + (size_t)bh * N;
  const float* dd_bh = p.dd + (size_t)bh * N;
  auto issue = [&](int s) {
    const int slot = s % ST, i0 = ((t + s) % nT) * kT;
    char* q = base + L::kQ + 2 * slot * L::kTile;
    if (tid == 0) {
      wg::mbar_expect(&full[slot], 2 * L::kTile);
      tma_load_4d(q, &p.x[0], &full[slot], 0, i0, h, seq);
      tma_load_4d(q + L::kTile, &p.x[3], &full[slot], 0, i0, h, seq);
    }
    if (tid < kLoaders) {
      if (has_mask)
        load_mask_tile<M>(reinterpret_cast<uint32_t*>(base + L::kMaskOff + slot * L::kMask),
                          p.mask, m_bytes, w, i0, j0, N, tid);
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
    if (has_mask)
      probs<M, true>(sc, cM, cL, (int)(mask_byte<M>(w, i0, j0, N) & 15), i0, j0, jr0, tq, N, sl2);
    else
      probs<M, false>(sc, cM, cL, 0, i0, j0, jr0, tq, N, sl2);
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

// The 4-D tensor map (hd, N, nH, nSeq) of one bf16 operand, row r of
// (sequence s, head h) at ptr + s * st[0] + h * st[1] + r * st[2]
// elements, boxes of 64 rows x hd in the swizzle of 2 * hd bytes; rows
// past N zero-filled.  An extent-1 dimension is never stepped, so its
// stride is replaced by a legal one.  False where the driver refuses it.
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

template <int HD, typename M, bool DROP>
int launch(const lvt::TcBwdWg& p, int nSeq, cudaStream_t stream) {
  using L = Smem<HD, M>;
  auto kernel = bwd_wg_kernel<HD, M, DROP>;
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
  return drop ? launch<HD, M, true>(p, nSeq, stream) : launch<HD, M, false>(p, nSeq, stream);
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

}  // namespace

int lvt::attention_bwd_wgmma(const TcBwd& a, float* acc, int* sem, int hd, bool mask_f32,
                             cudaStream_t stream) {
  const int heads_total = a.heads_total <= 0 ? a.nH : a.heads_total;
  if (a.head0 < 0 || a.head0 + a.nH > heads_total || a.nSeq <= 0 || a.N <= 0 || a.nH <= 0 ||
      a.nW <= 0 || a.nSeq % a.nW != 0 || a.N > 65535 || a.dd == nullptr || a.lse == nullptr ||
      a.bias != nullptr || (hd != 16 && hd != 32 && hd != 64))
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
  const bool drop = a.seed != nullptr;
  return mask_f32 ? launch_hd<float>(p, a.nSeq, hd, drop, stream)
                  : launch_hd<bf16>(p, a.nSeq, hd, drop, stream);
}
