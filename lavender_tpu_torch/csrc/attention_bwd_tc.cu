// Tensor-core backward of the Swin window core, and D for every tensor-core
// backward:
//   s = q k^T * scale + bias[h] + mask[w],  p = exp(s - lse),  o = p v
//   dv = p^T g,  dp = g v^T,  D = rowsum(p * dp) = rowsum(o * g),
//   ds = p * (dp - D),  dq = ds k * scale,  dk = ds^T q * scale,
//   dbias[h] = sum over sequences of ds,
// lse the forward's row log-sum-exp (attention_fwd_tc.cu).
//
// Replaces lavender_tpu/ops/swin_core_attn.py _core_bwd_kernel (:147, K8b:
// the packed slab of the Swin backward's recompute, a bf16 rel-pos bias
// [nH, Npad, Npad] and its gradient summed over every (batch, window) in
// f32, a bf16 shift mask or none, no dropout), through lvt_attention_bwd_bf16
// of attention_bwd.cu.  The fusion encoder's backwards (K10b, K13b) run on
// attention_bwd_wgmma.cu; this file's row_dot_kernel forms their D too.
// Only the bias's instances are built (a bf16 mask or none, no dropout);
// the templates' dropout and no-bias branches are never instantiated.
//
// Bound on the card: device memory.  K8b at B = 8, Swin-B stage 1 (512
// windows of 248 rows, 4 heads of 32): 7 slabs of C = 128 columns (q, k,
// v, g, dq, dk, dv) + lse, bias and dbias, 231 MB unshifted and 239 MB
// with the shift mask (0.069 / 0.071 ms at 3.35 TB/s); 40.3 GFLOP in its
// five products.  (The design below also reads the forward's output o, an
// eighth slab.)
//
// Design.  Every product runs on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulation; operands from shared memory by ldmatrix,
// .trans where the product contracts over rows), in 64 x 64 tiles: a block
// of 4 warps owns 64 rows, each warp 16, and sweeps the other side's tiles
// through a two-stage cp.async ring (the next tiles, their mask and bias
// tiles included, load while the current ones multiply; the bias tile is
// staged as a mask tile of the [nH, N, N] buffer, the head in the window's
// place).  p and ds are formed on the accumulator fragments in registers
// and rounded to bf16 as the next product's A operand, so nothing
// [N, N]-shaped leaves registers.  FlashAttention-2's two loops as two
// kernels, so that every output element is summed by one thread in a
// fixed order (no atomics: the same bits on every run), after a pass
// forming D:
//   row_dot_kernel: D = rowsum(o * g) in f32 (FlashAttention-2's D; equal
//     to rowsum(p * dp) up to o's bf16 rounding; the JAX kernels sum the
//     latter exactly, and a first sweep of the dq kernel over the keys for
//     it measured slower on the card, PERF.md);
//   dq kernel, a block per (query tile, sequence, head): one sweep over the
//     key tiles (3 products);
//   dk/dv kernel, a block per (key tile, sequence, head): one sweep over the
//     query tiles, each taken in two halves of 32 so that half the score
//     accumulators are live (4 products);
//   dbias kernel, a block per (query tile x key tile, head, chunk of
//     sequences): S and dP once more (2 products) for each sequence of the
//     chunk, dS summed in f32 registers in the chunk's order into the
//     chunk's slice of a scratch buffer, then sum_chunks adds the slices
//     in chunk order.  dbias is the same on every run; no atomics, and no
//     [N, 64] f32 accumulator in shared memory (which folding dS into the
//     dk/dv kernel would need, at one block an SM).
// All recompute s and p from lse.  The ragged edge (N = 245, Npad = 248)
// is zero-filled by the copies' source size and predicated: p = 0 for a
// row or key >= N (never by -inf arithmetic), and rows >= N are never
// stored (in the packed slab they are the next sequence's); a warp whose
// 16 rows all lie past N skips its products.  The dq and dbias kernels
// form S as the forward forms it (the same mma_abt, Q against a key tile,
// scaled in f32 after the product): the same bits, so their p differs from
// the forward's only through lse against the forward's running max; the
// dk/dv kernel forms S^T, equal up to the order of the tensor cores' sums.
// The tile helpers are mma_tile.cuh's.  Registers are cut to 168 a thread,
// so 3 blocks (12 warps) share an SM.
#include "attention_tc.cuh"
#include "mma_tile.cuh"

namespace {

using namespace lvt::tc;

// (bias + mask) * log2(e) - lse2 of element (r, col) of the staged tiles
// (row leads lead / blead), as the forward adds them; without BIAS the
// mask alone, as before the bias existed.
template <typename M, bool BIAS>
__device__ __forceinline__ float bias_mask_l2(const uint32_t* cM, int lead, const uint32_t* cB,
                                              int blead, bool has_mask, int r, int col,
                                              float lse2) {
  if constexpr (BIAS)
    return fmaf(mask_in<bf16>(cB, r, blead, col) + (has_mask ? mask_in<M>(cM, r, lead, col) : 0.0f),
                kLog2e, -lse2);
  else
    return has_mask ? fmaf(mask_in<M>(cM, r, lead, col), kLog2e, -lse2) : -lse2;
}

// dq of one 64-row query tile of one (sequence, head), from D of
// row_dot_kernel.  BIAS: a per-head bf16 bias tile staged beside the mask.
template <int HD, typename M, bool DROP, bool BIAS>
__global__ void __launch_bounds__(kThreads, kBlocks<M>) bwd_dq_kernel(const lvt::TcBwd a) {
  constexpr int LD = HD + 8, TILE = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + TILE;
  bf16* sKV = sG + TILE;                                       // two stages of (K, V)
  uint32_t* sM = reinterpret_cast<uint32_t*>(sKV + 4 * TILE);  // two stages of the mask
  constexpr int MT = MaskTile<M>::kBytes / 4, BT = MaskTile<bf16>::kBytes / 4;
  uint32_t* sB = sM + 2 * MT;  // BIAS: two stages of the bias
  const int bh = blockIdx.x, seq = bh / a.nH, h = bh - seq * a.nH;
  const int N = a.N, i0 = blockIdx.y * kRows, w = seq % a.nW;
  const bool has_mask = a.mask != nullptr;
  const long long m_bytes = (long long)a.nW * N * N * (long long)sizeof(M);
  const long long b_bytes = (long long)a.nH * N * N * (long long)sizeof(bf16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const bf16* qb = a.x[0] + seq * a.st[0][0] + h * a.st[0][1];
  const bf16* kb = a.x[1] + seq * a.st[1][0] + h * a.st[1][1];
  const bf16* vb = a.x[2] + seq * a.st[2][0] + h * a.st[2][1];
  const bf16* gb = a.x[3] + seq * a.st[3][0] + h * a.st[3][1];
  load_tile<HD>(sQ, qb, a.st[0][2], i0, N);
  load_tile<HD>(sG, gb, a.st[3][2], i0, N);
  load_tile<HD>(sKV, kb, a.st[1][2], 0, N);
  load_tile<HD>(sKV + TILE, vb, a.st[2][2], 0, N);
  if (has_mask) load_mask<M>(sM, a.mask, m_bytes, w, i0, 0, N);
  if constexpr (BIAS) load_mask<bf16>(sB, a.bias, b_bytes, h, i0, 0, N);
  cp_async_commit();

  const int wr = warp * 16 + (lane >> 2);  // the thread's first row in the tile
  const int row[2] = {i0 + wr, i0 + wr + 8};
  const bool live = i0 + warp * 16 < N;  // the warp has rows to form
  // p = exp2(s * scale * log2(e) + mask * log2(e) - lse * log2(e)), 0 off the rows
  float lse2[2], D[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = row[r] < N ? a.lse[(size_t)bh * N + row[r]] * kLog2e : 0.0f;
    D[r] = row[r] < N ? a.dd[(size_t)bh * N + row[r]] : 0.0f;
  }
  const float sl2 = a.scale * kLog2e;
  const uint32_t key =
      DROP ? lvt::dropout_key((uint32_t)*a.seed,
                              lvt::attention_stream(seq, h, a.head0, a.heads_total))
           : 0u;

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
  const int nT = (N + kCols - 1) / kCols;
  for (int t = 0; t < nT; ++t) {
    const int j0 = t * kCols;
    const bf16* cur = sKV + (t & 1) * 2 * TILE;
    const uint32_t* cM = sM + (t & 1) * MT;
    const uint32_t* cB = sB + (t & 1) * BT;
    if (t + 1 < nT) {
      bf16* nxt = sKV + ((t + 1) & 1) * 2 * TILE;
      load_tile<HD>(nxt, kb, a.st[1][2], j0 + kCols, N);
      load_tile<HD>(nxt + TILE, vb, a.st[2][2], j0 + kCols, N);
      if (has_mask) load_mask<M>(sM + ((t + 1) & 1) * MT, a.mask, m_bytes, w, i0, j0 + kCols, N);
      if constexpr (BIAS)
        load_mask<bf16>(sB + ((t + 1) & 1) * BT, a.bias, b_bytes, h, i0, j0 + kCols, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cn = N - j0;  // columns < cn are keys
    if (live) {
      float s[8][4], dp[8][4];
      {  // the warp's rows of Q and G as A fragments, reloaded (registers are scarcer)
        uint32_t f[HD / 16][4];
        load_a<HD>(f, sQ, warp, lane);
        mma_abt<HD>(s, f, cur, lane);
        load_a<HD>(f, sG, warp, lane);
        mma_abt<HD>(dp, f, cur + TILE, lane);
      }
      const int lead[2] = {(int)(mask_byte<M>(w, row[0], j0, N) & 3),
                           (int)(mask_byte<M>(w, row[1], j0, N) & 3)};
      const int blead[2] = {(int)(mask_byte<bf16>(h, row[0], j0, N) & 3),
                            (int)(mask_byte<bf16>(h, row[1], j0, N) & 3)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, i = row[r], c = n * 8 + 2 * tq + (e & 1);
          float p = 0.0f;
          if (i < N && c < cn) {
            const float b = bias_mask_l2<M, BIAS>(cM, lead[r], cB, blead[r], has_mask,
                                                  wr + 8 * r, c, lse2[r]);
            p = ex2(fmaf(s[n][e], sl2, b));
          }
          const float d =
              dp[n][e] * drop_factor<DROP>(key, (uint32_t)(i * N + j0 + c), a.thresh, a.drop_scale);
          s[n][e] = p * (d - D[r]);  // ds
        }
      }
      mma_ab<HD>(dq, s, cur, lane);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  store_rows<HD>(a.dx[0] + seq * a.st[4][0] + h * a.st[4][1], a.st[4][2], row, N, dq, a.scale, tq);
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

// dk and dv of one 64-row key tile of one (sequence, head), from D of
// row_dot_kernel.  BIAS as in bwd_dq_kernel.
template <int HD, typename M, bool DROP, bool BIAS>
__global__ void __launch_bounds__(kThreads, kBlocks<M>) bwd_dkdv_kernel(const lvt::TcBwd a) {
  constexpr int LD = HD + 8, TILE = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE;
  bf16* sQG = sV + TILE;                                   // two stages of (Q, G)
  float* sLD = reinterpret_cast<float*>(sQG + 4 * TILE);  // two stages of (lse, D) rows
  uint32_t* sM = reinterpret_cast<uint32_t*>(sLD + 4 * kCols);  // two stages of the mask
  constexpr int MT = MaskTile<M>::kBytes / 4, BT = MaskTile<bf16>::kBytes / 4;
  uint32_t* sB = sM + 2 * MT;  // BIAS: two stages of the bias
  const int bh = blockIdx.x, seq = bh / a.nH, h = bh - seq * a.nH;
  const int N = a.N, j0 = blockIdx.y * kRows, w = seq % a.nW;
  const bool has_mask = a.mask != nullptr;
  const long long m_bytes = (long long)a.nW * N * N * (long long)sizeof(M);
  const long long b_bytes = (long long)a.nH * N * N * (long long)sizeof(bf16);
  const void* mask = a.mask;
  const bf16* bias = a.bias;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const bf16* qb = a.x[0] + seq * a.st[0][0] + h * a.st[0][1];
  const bf16* kb = a.x[1] + seq * a.st[1][0] + h * a.st[1][1];
  const bf16* vb = a.x[2] + seq * a.st[2][0] + h * a.st[2][1];
  const bf16* gb = a.x[3] + seq * a.st[3][0] + h * a.st[3][1];
  const float* lse_bh = a.lse + (size_t)bh * N;
  const float* dd_bh = a.dd + (size_t)bh * N;
  const long long q_ld = a.st[0][2], g_ld = a.st[3][2];
  // the query tile at rows i0.. with its lse, D and mask rows into stage buf
  auto load_stage = [=](int buf, int i0) {
    bf16* q = sQG + buf * 2 * TILE;
    load_tile<HD>(q, qb, q_ld, i0, N);
    load_tile<HD>(q + TILE, gb, g_ld, i0, N);
    const int c = threadIdx.x, r = c % kCols;  // kThreads == 2 * kCols
    const bool ok = i0 + r < N;
    cp_async<4>(sLD + buf * 2 * kCols + c, (c < kCols ? lse_bh : dd_bh) + (ok ? i0 + r : 0),
                ok ? 4 : 0);
    if (has_mask) load_mask<M>(sM + buf * MT, mask, m_bytes, w, i0, j0, N);
    if constexpr (BIAS) load_mask<bf16>(sB + buf * BT, bias, b_bytes, h, i0, j0, N);
  };
  load_tile<HD>(sK, kb, a.st[1][2], j0, N);
  load_tile<HD>(sV, vb, a.st[2][2], j0, N);
  load_stage(0, 0);
  cp_async_commit();

  const int wc = warp * 16 + (lane >> 2);  // the thread's first key in the tile
  const int col[2] = {j0 + wc, j0 + wc + 8};
  const bool live = j0 + warp * 16 < N;  // the warp has keys to form
  const float sl2 = a.scale * kLog2e;
  const uint32_t key =
      DROP ? lvt::dropout_key((uint32_t)*a.seed,
                              lvt::attention_stream(seq, h, a.head0, a.heads_total))
           : 0u;

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  const int nT = (N + kCols - 1) / kCols;
  for (int t = 0; t < nT; ++t) {
    const int buf = t & 1, i0 = t * kCols;
    if (t + 1 < nT) {
      load_stage(buf ^ 1, i0 + kCols);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQG + buf * 2 * TILE;
    const bf16* cG = cQ + TILE;
    const float* cL = sLD + buf * 2 * kCols;
    const uint32_t* cM = sM + buf * MT;
    const uint32_t* cB = sB + buf * BT;
    const int lead0 = (int)(mask_byte<M>(w, i0, j0, N) & 3);  // row c's: + c * N * sizeof(M)
    const int blead0 = (int)(mask_byte<bf16>(h, i0, j0, N) & 3);
    const int cn = N - i0;                                     // columns < cn are queries
    // the tile's queries in two halves of 32: half the accumulators live
#pragma unroll 1
    for (int half = 0; half < 2 && live; ++half) {
      const int c0 = half * 32;
      float s[4][4], dp[4][4];  // transposed: the warp's keys x 32 of the tile's queries
      {  // the warp's rows of K and V as A fragments, reloaded (registers are scarcer)
        uint32_t f[HD / 16][4];
        load_a<HD>(f, sK, warp, lane);
        mma_abt<HD, 4>(s, f, cQ + c0 * LD, lane);
        load_a<HD>(f, sV, warp, lane);
        mma_abt<HD, 4>(dp, f, cG + c0 * LD, lane);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + n * 8 + 2 * tq + (e & 1), r = e >> 1, j = col[r];
          float p = 0.0f;
          if (c < cn && j < N) {
            float b =
                has_mask ? mask_in<M>(cM, c, (lead0 + c * N * (int)sizeof(M)) & 3, wc + 8 * r)
                         : 0.0f;
            if constexpr (BIAS)
              b = mask_in<bf16>(cB, c, (blead0 + c * N * (int)sizeof(bf16)) & 3, wc + 8 * r) + b;
            p = ex2(fmaf(s[n][e], sl2, (b - cL[c]) * kLog2e));
          }
          const float m =
              drop_factor<DROP>(key, (uint32_t)((i0 + c) * N + j), a.thresh, a.drop_scale);
          s[n][e] = p * (dp[n][e] * m - cL[kCols + c]);  // ds
          dp[n][e] = p * m;
        }
      }
      mma_ab<HD, 4>(dv, dp, cG + c0 * LD, lane);
      mma_ab<HD, 4>(dk, s, cQ + c0 * LD, lane);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  store_rows<HD>(a.dx[1] + seq * a.st[5][0] + h * a.st[5][1], a.st[5][2], col, N, dk, a.scale, tq);
  store_rows<HD>(a.dx[2] + seq * a.st[6][0] + h * a.st[6][1], a.st[6][2], col, N, dv, 1.0f, tq);
}

// The partial dbias of one 64 x 64 tile (query tile, key tile) of one head
// over one chunk of sequences: sum over the chunk of ds = p * (dp - D), S
// and dP recomputed on the tensor cores as the dq kernel forms them (the
// same mma_abt, the same f32 expression for p: the same bits), dS summed
// on the accumulator fragments in f32 (32 floats a thread) in the chunk's
// fixed order and written once into the chunk's slice of part.  The chunk
// takes its sequences window-major (entry u is sequence (u % nb) * nW +
// u / nb, nb = nSeq / nW), so a stage's mask tile is copied only where its
// window changes; the bias tile, the head's, is copied once.
template <int HD>
__global__ void __launch_bounds__(kThreads, kBlocks<bf16>) bwd_dbias_kernel(const lvt::TcBwd a) {
  constexpr int LD = HD + 8, TILE = kRows * LD, MT = MaskTile<bf16>::kBytes / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sT = reinterpret_cast<bf16*>(smem);               // two stages of (Q, G, K, V)
  float* sLD = reinterpret_cast<float*>(sT + 8 * TILE);  // two stages of (lse, D) rows
  uint32_t* sM = reinterpret_cast<uint32_t*>(sLD + 4 * kRows);  // two stages of the mask
  uint32_t* sB = sM + 2 * MT;                                   // the bias
  const int N = a.N, nT = (N + kRows - 1) / kRows;
  const int qt = blockIdx.x / nT, i0 = qt * kRows, j0 = (blockIdx.x - qt * nT) * kCols;
  const int h = blockIdx.y, nb = a.nSeq / a.nW;
  const int u0 = (int)((long long)blockIdx.z * a.nSeq / a.nChunks);
  const int u1 = (int)((long long)(blockIdx.z + 1) * a.nSeq / a.nChunks);
  const bool has_mask = a.mask != nullptr;
  const long long m_bytes = (long long)a.nW * N * N * (long long)sizeof(bf16);
  const long long b_bytes = (long long)a.nH * N * N * (long long)sizeof(bf16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  int held0 = -1, held1 = -1;  // the window whose mask tile stage 0 / 1 holds
  // sequence u's Q, G rows i0.. and K, V rows j0.., its lse and D rows, and
  // (where the stage holds another window's) its mask tile into stage buf
  auto load_stage = [&](int buf, int u) {
    const int w = u / nb, seq = (u - w * nb) * a.nW + w;
    bf16* t = sT + buf * 4 * TILE;
    load_tile<HD>(t, a.x[0] + seq * a.st[0][0] + h * a.st[0][1], a.st[0][2], i0, N);
    load_tile<HD>(t + TILE, a.x[3] + seq * a.st[3][0] + h * a.st[3][1], a.st[3][2], i0, N);
    load_tile<HD>(t + 2 * TILE, a.x[1] + seq * a.st[1][0] + h * a.st[1][1], a.st[1][2], j0, N);
    load_tile<HD>(t + 3 * TILE, a.x[2] + seq * a.st[2][0] + h * a.st[2][1], a.st[2][2], j0, N);
    const int c = threadIdx.x, r = c % kRows;  // kThreads == 2 * kRows
    const bool ok = i0 + r < N;
    const size_t bh = (size_t)seq * a.nH + h;
    cp_async<4>(sLD + buf * 2 * kRows + c, (c < kRows ? a.lse : a.dd) + bh * N + (ok ? i0 + r : 0),
                ok ? 4 : 0);
    int& held = buf ? held1 : held0;
    if (has_mask && held != w) {
      load_mask<bf16>(sM + buf * MT, a.mask, m_bytes, w, i0, j0, N);
      held = w;
    }
  };
  load_mask<bf16>(sB, a.bias, b_bytes, h, i0, j0, N);
  load_stage(0, u0);
  cp_async_commit();

  const int wr = warp * 16 + (lane >> 2);  // the thread's first row in the tile
  const int row[2] = {i0 + wr, i0 + wr + 8};
  const bool live = i0 + warp * 16 < N;  // the warp has rows to form
  const int cn = N - j0;                 // columns < cn are keys
  const int blead[2] = {(int)(mask_byte<bf16>(h, row[0], j0, N) & 3),
                        (int)(mask_byte<bf16>(h, row[1], j0, N) & 3)};
  const float sl2 = a.scale * kLog2e;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  for (int u = u0; u < u1; ++u) {
    const int buf = (u - u0) & 1, w = u / nb;
    if (u + 1 < u1) {
      load_stage(buf ^ 1, u + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const bf16* cT = sT + buf * 4 * TILE;
      const float* cL = sLD + buf * 2 * kRows;
      const uint32_t* cM = sM + buf * MT;
      const int lead[2] = {(int)(mask_byte<bf16>(w, row[0], j0, N) & 3),
                           (int)(mask_byte<bf16>(w, row[1], j0, N) & 3)};
      const float lse2[2] = {cL[wr] * kLog2e, cL[wr + 8] * kLog2e};
      const float D[2] = {cL[kRows + wr], cL[kRows + wr + 8]};
      // the tile's keys in two halves of 32: half the score accumulators
      // live (each n-tile's S is summed as mma_abt<HD> sums it: the same bits)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s[4][4], dp[4][4];
        {
          uint32_t f[HD / 16][4];
          load_a<HD>(f, cT, warp, lane);
          mma_abt<HD, 4>(s, f, cT + (2 * kRows + half * 32) * LD, lane);
          load_a<HD>(f, cT + TILE, warp, lane);
          mma_abt<HD, 4>(dp, f, cT + (3 * kRows + half * 32) * LD, lane);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = half * 32 + n * 8 + 2 * tq + (e & 1);
            if (row[r] < N && c < cn) {
              const float b = bias_mask_l2<bf16, true>(cM, lead[r], sB, blead[r], has_mask,
                                                       wr + 8 * r, c, lse2[r]);
              acc[half * 4 + n][e] += ex2(fmaf(s[n][e], sl2, b)) * (dp[n][e] - D[r]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  if (!live) return;
  float* out = a.part + ((size_t)blockIdx.z * a.nH + h) * N * N;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, c = n * 8 + 2 * tq + (e & 1);
      if (row[r] < N && c < cn) out[(size_t)row[r] * N + j0 + c] = acc[n][e];
    }
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

template <int HD, typename M, bool DROP, bool BIAS>
int launch(const lvt::TcBwd& a, cudaStream_t stream) {
  constexpr size_t kTile = kRows * (HD + 8) * sizeof(bf16);
  // two stages of the mask and of the bias
  constexpr size_t kMask = 2 * MaskTile<M>::kBytes + (BIAS ? 2 * MaskTile<bf16>::kBytes : 0);
  constexpr size_t smem_dq = 6 * kTile + kMask;  // Q, G and two stages of K, V
  constexpr size_t smem_dkdv = 6 * kTile + 4 * kCols * sizeof(float) + kMask;
  cudaError_t e = allow_smem(bwd_dq_kernel<HD, M, DROP, BIAS>, smem_dq);
  if (e == cudaSuccess) e = allow_smem(bwd_dkdv_kernel<HD, M, DROP, BIAS>, smem_dkdv);
  if (e != cudaSuccess) return (int)e;
  const int nT = (a.N + kRows - 1) / kRows;
  const dim3 grid(a.nSeq * a.nH, nT);
  bwd_dq_kernel<HD, M, DROP, BIAS><<<grid, kThreads, smem_dq, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv_kernel<HD, M, DROP, BIAS><<<grid, kThreads, smem_dkdv, stream>>>(a);
  e = cudaGetLastError();
  if constexpr (BIAS) {
    if (e != cudaSuccess) return (int)e;
    // two stages of (Q, G, K, V), of the (lse, D) rows and of the mask; the bias
    constexpr size_t smem_db = 8 * kTile + 4 * kRows * sizeof(float) + 3 * MaskTile<bf16>::kBytes;
    e = allow_smem(bwd_dbias_kernel<HD>, smem_db);
    if (e != cudaSuccess) return (int)e;
    bwd_dbias_kernel<HD><<<dim3(nT * nT, a.nH, a.nChunks), kThreads, smem_db, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return lvt::sum_chunks(a.part, a.dbias, a.nChunks, (size_t)a.nH * a.N * a.N, stream);
  }
  return (int)e;
}

template <int HD>
int launch_row_dot(const lvt::RowDot& a, cudaStream_t stream) {
  const long long threads = (long long)a.nSeq * a.nH * a.N * (HD / 8);
  row_dot_kernel<HD><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The bias's instances alone (K8b): a bf16 mask or none, no dropout.
int launch_hd(const lvt::TcBwd& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, bf16, false, true>(a, stream);
    case 32: return launch<32, bf16, false, true>(a, stream);
    case 64: return launch<64, bf16, false, true>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

int lvt::attention_bwd_tc(const TcBwd& call, int hd, bool mask_f32, cudaStream_t stream) {
  TcBwd a = call;
  if (a.heads_total <= 0) a.heads_total = a.nH;
  if (a.head0 < 0 || a.head0 + a.nH > a.heads_total) return (int)cudaErrorInvalidValue;
  if (a.nSeq <= 0 || a.N <= 0 || a.nH <= 0 || a.nW <= 0 || a.nSeq % a.nW != 0 ||
      (long long)a.nSeq * a.nH > 0x7fffffffLL || a.N > 65535 || a.dd == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a.bias == nullptr || mask_f32 || a.seed != nullptr || a.dbias == nullptr ||
      a.part == nullptr || a.nChunks < 1 || a.nChunks > a.nSeq || a.nChunks > 65535 ||
      a.nH > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_hd(a, hd, stream);
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
