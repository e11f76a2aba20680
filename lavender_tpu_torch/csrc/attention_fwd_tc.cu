// Tensor-core forward of the attention cores:
//   s = q k^T * scale + bias[h] + mask[w],  p = softmax(s) over the keys,
//   o = ((m * p) v) / l,  lse = log(l) + max,
// l the row sum of the undropped p, m the dropout factor of each
// probability (0 or 1 / (1 - rate)) from the counter hash of dropout.cuh
// (stream sequence * nH + head, or with a head offset
// sequence * heads_total + head0 + head: dropout.cuh attention_stream; index row * N + key, the logical
// coordinates, never an address): the bits the backward
// (attention_bwd_wgmma.cu) regenerates from the seed, which also reads lse
// and o as this kernel writes them.  lse is stored only where the call
// gives it a buffer.
//
// Replaces lavender_tpu/ops/encoder_attention.py
// _enc_attn_train_lanes_kernel (:750, K10a: q, k, v column slices of the
// packed qkv slab [B*L, 3C], a bf16 [B, L, L] mask, dropout),
// _enc_attn_train_kernel (:526, K13a: q, k, v [B, nH, L, hd] by their
// strides, views of one qkv product, an f32 [B, L, L] mask, dropout),
// _enc_attn_kernel (:75, K7: the same layout and mask, no dropout, no
// lse) and lavender_tpu/ops/window_attention.py
// _attn_kernel (:49, K15: q, k, v [W, nH, N, hd], strided views of the
// module path's qkv product, a bf16 rel-pos bias [nH, N, N] and a bf16 or
// f32 shift mask [nW, N, N] or none, no lse), and the cores of two
// whole-block kernels: lavender_tpu/ops/swin_block_attn.py
// _block_kernel_wm (:954, K1: the packed slab with the rel-pos bias and
// the bf16 shift mask or none, the BIAS instance) and
// lavender_tpu/ops/encoder_attention.py _attn_block_kernel_kmask (:322,
// K4: the packed slab [B*L, 3C] with a key-keep vector [B, L], the KEEP
// variant) and _attn_block_kernel (:242, K6: the packed slab under a bf16
// [B, L, L] mask, clamped at -1e4, one mask a sequence, no key skipped).
// All reach it through the C entries of attention.cu (every call that
// writes lse without a bias, every heads-layout call, and the packed calls
// that select it, K1 and K4; the Swin window core K8a, lse with its bias,
// runs on attention_fwd_wgmma.cu) but K6, K14 and K16, whose C entries in blocks.cu call
// it directly with the mask's and the bias's pitch.  The rows of the mask
// and of the bias lie
// mask_ld / bias_ld elements apart (N, or a pitch a wrapper rounded up to
// 16 bytes so that the widest copy runs).
//
// Bound on the card: device memory.  At the train step's 64 pairs, L =
// 276, 12 heads of 64 (K10a / K13a) each input read once and each output
// written once is 4 bf16 [B*L, C] slabs (q, k, v, o) + the mask + lse,
// 119.1 MB with K10a's bf16 mask (0.036 ms at 3.35 TB/s) and 128.9 MB with
// K13a's f32 one (0.038 ms); the two products are 15.0 GFLOP, 0.015 ms at
// 989 TFLOP/s in bf16.  K15 at the "pallas" serving forward's B = 4,
// stage 1 (256 windows of 245 rows, 4 heads of 32, the f32 shift mask):
// 80.1 MB (0.024 ms), 7.9 GFLOP; K7 at B = 4, L = 275, 12 heads of 64: 8.0
// MB (0.0024 ms); K1 at B = 4, stage 1 (256 windows of 248 rows, bias
// and shift mask): 73 MB (0.022 ms), 8.1 GFLOP; K4 at B = 4, L = 276: 6.8
// MB (0.0020 ms).  hd 32 halves the products per byte staged, and the
// bias is one more tile a stage.
//
// Design: FlashAttention-2's forward, shaped as the backward's dq kernel.
// A block of 4 warps owns one 64-row query tile of one (sequence, head),
// each warp 16 rows, the warp's Q A-fragments loaded once into registers
// by ldmatrix; the grid is (sequence x head, query tile), the heads of a
// sequence adjacent so that they read one mask from L2.  The block sweeps
// 64-key tiles of K, V, the mask and the bias through a two-stage cp.async
// ring (the next tile loads while the current one multiplies); the bias
// tile is staged as a mask tile of the [nH, N, N] buffer, the head in the
// window's place.  No whole sequence sits in shared memory, so N is not
// capped by it.  S = Q K^T and O += (m * P) V run on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulation); S comes from the
// backward's mma_abt in the same tile order and is scaled in f32 after the
// product, so both form the same S bits.  The online softmax runs on the
// accumulator fragments, bias + mask added in f32 (in that order, as the
// backward adds them) before the max: the row max over the quad of lanes
// that share a row (shfl_xor), the rescale of l and O, p = ex2(fmaf(s,
// scale * log2(e), (bias + mask) * log2(e) - max2)) (max2 the running max
// in log2 units), the dropout factor, and m * p rounded to bf16 as the next
// product's A operand (the JAX kernel's (p * m).astype(v.dtype)); nothing
// [N, N]-shaped leaves registers.  The ragged edge (N = 276 = 4 * 64 + 20,
// Npad = 248 = 3 * 64 + 56): the copies zero-fill rows >= N, p = 0 by
// predicate for a row or key >= N (never by -inf arithmetic: such a row's
// max stays -inf and its rescale is 1), rows >= N are never stored (in the
// packed slab they are the next sequence's), and a warp whose 16 rows all
// lie past N skips its products.  One thread owns each output element and
// sums it in a fixed order (the row sums over the quad by a fixed
// butterfly): the same bits on every run.
#include <math.h>

#include <type_traits>

#include "attention_tc.cuh"
#include "mma_tile.cuh"

namespace {

using namespace lvt::tc;

constexpr float kLn2 = 0.6931471805599453f;
// a tile's 64 keep bytes from any byte offset: 17 words, rounded up to
// whole 16 bytes
constexpr int kKeepWords = 20;

// Stage keep bytes [start, start + 64) of a buffer of `bytes` bytes: the
// 17 words from the one that holds byte start, cut or zero-filled past the
// buffer's end (cp.async takes no source under 4-byte alignment); the
// tile's first byte is byte start & 3 of the staged words.
__device__ __forceinline__ void load_keep(uint32_t* s, const uint8_t* keep, long long bytes,
                                          long long start) {
  if (threadIdx.x < 17) {
    const long long b = (start & ~3LL) + 4 * (long long)threadIdx.x;
    const long long left = bytes - b;
    const int n = left >= 4 ? 4 : (left > 0 ? (int)left : 0);
    cp_async<4>(s + threadIdx.x, keep + (n > 0 ? b : 0), n);
  }
}

// Whether the thread's column 8n + 2tq + e of the tile is a kept key
// (the ballots of fwd_kernel, n and e unrolled: a constant bit).
__device__ __forceinline__ bool kept(uint32_t klo, uint32_t khi, int n, int e) {
  return ((n < 4 ? klo : khi) >> (8 * (n & 3) + e)) & 1u;
}

// BIAS: a per-head bf16 bias tile staged beside the mask tile.  KEEP: the
// key-keep bytes of each K/V tile staged with it; a key whose byte is 0
// gets p = 0 by predicate, as a key >= N does.
template <int HD, typename M, bool DROP, bool BIAS, bool KEEP>
__global__ void __launch_bounds__(kThreads, kBlocks<M>) fwd_kernel(const lvt::TcFwd a) {
  constexpr int LD = HD + 8, TILE = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + TILE;                                       // two stages of (K, V)
  uint32_t* sM = reinterpret_cast<uint32_t*>(sKV + 4 * TILE);  // two stages of the mask
  constexpr int MT = MaskTile<M>::kBytes / 4, BT = MaskTile<bf16>::kBytes / 4;
  uint32_t* sB = sM + 2 * MT;  // BIAS: two stages of the bias
  uint32_t* sKp = sB + (BIAS ? 2 * BT : 0);  // KEEP: two stages of keep bytes
  const int bh = blockIdx.x, seq = bh / a.nH, h = bh - seq * a.nH;
  const int N = a.N, i0 = blockIdx.y * kRows, w = seq % a.nW;
  const bool has_mask = a.mask != nullptr;
  const int m_ld = a.mask_ld, b_ld = a.bias_ld;
  const long long m_bytes = mask_span<M>(a.nW, N, m_ld);
  const long long b_bytes = mask_span<bf16>(a.nH, N, b_ld);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const bf16* kb = a.x[1] + seq * a.st[1][0] + h * a.st[1][1];
  const bf16* vb = a.x[2] + seq * a.st[2][0] + h * a.st[2][1];
  load_tile<HD>(sQ, a.x[0] + seq * a.st[0][0] + h * a.st[0][1], a.st[0][2], i0, N);
  load_tile<HD>(sKV, kb, a.st[1][2], 0, N);
  load_tile<HD>(sKV + TILE, vb, a.st[2][2], 0, N);
  if (has_mask) load_mask<M>(sM, a.mask, m_bytes, w, i0, 0, N, m_ld);
  if constexpr (BIAS) load_mask<bf16>(sB, a.bias, b_bytes, h, i0, 0, N, b_ld);
  const long long keep0 = (long long)seq * N, keep_bytes = (long long)a.nSeq * N;
  if constexpr (KEEP) load_keep(sKp, a.keep, keep_bytes, keep0);
  cp_async_commit();

  const int wr = warp * 16 + (lane >> 2);  // the thread's first row in the tile
  const int row[2] = {i0 + wr, i0 + wr + 8};
  const bool live = i0 + warp * 16 < N;  // the warp has rows to form
  const float sl2 = a.scale * kLog2e;
  const uint32_t key =
      DROP ? lvt::dropout_key((uint32_t)*a.seed,
                              lvt::attention_stream(seq, h, a.head0, a.heads_total))
           : 0u;

  uint32_t qf[HD / 16][4];  // the warp's rows of Q as A fragments
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  // per row: the running max of s * scale + bias + mask in log2 units and the
  // thread's part of the row sum, relative to it
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
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
      if (has_mask)
        load_mask<M>(sM + ((t + 1) & 1) * MT, a.mask, m_bytes, w, i0, j0 + kCols, N, m_ld);
      if constexpr (BIAS)
        load_mask<bf16>(sB + ((t + 1) & 1) * BT, a.bias, b_bytes, h, i0, j0 + kCols, N, b_ld);
      if constexpr (KEEP)
        load_keep(sKp + ((t + 1) & 1) * kKeepWords, a.keep, keep_bytes, keep0 + j0 + kCols);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cn = N - j0;  // columns < cn are keys
    // KEEP: the tile's keep bits by warp ballot, shifted so that bit 8 (n
    // % 4) + e is the thread's column 8n + 2tq + e (n < 4 in klo, else khi)
    uint32_t klo = 0u, khi = 0u;
    if constexpr (KEEP) {
      const uint8_t* kp =
          reinterpret_cast<const uint8_t*>(sKp + (t & 1) * kKeepWords) + ((keep0 + j0) & 3);
      klo = __ballot_sync(0xffffffffu, kp[lane] != 0) >> (2 * tq);
      khi = __ballot_sync(0xffffffffu, kp[lane + 32] != 0) >> (2 * tq);
    }
    if (live) {
      if (t == 0) load_a<HD>(qf, sQ, warp, lane);
      // the scores and (bias + mask) * log2(e) of the warp's 16 x 64
      float s[8][4], b[8][4];
      mma_abt<HD>(s, qf, cur, lane);
      const int lead[2] = {(int)(mask_byte<M>(w, row[0], j0, N, m_ld) & 3),
                           (int)(mask_byte<M>(w, row[1], j0, N, m_ld) & 3)};
      const int blead[2] = {(int)(mask_byte<bf16>(h, row[0], j0, N, b_ld) & 3),
                            (int)(mask_byte<bf16>(h, row[1], j0, N, b_ld) & 3)};
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = n * 8 + 2 * tq + (e & 1);
          if constexpr (BIAS)
            b[n][e] = (mask_in<bf16>(cB, wr + 8 * r, blead[r], c) +
                       (has_mask ? mask_in<M>(cM, wr + 8 * r, lead[r], c) : 0.0f)) *
                      kLog2e;
          else
            b[n][e] = has_mask ? mask_in<M>(cM, wr + 8 * r, lead[r], c) * kLog2e : 0.0f;
          if (row[r] < N && c < cn && (!KEEP || kept(klo, khi, n, e & 1)))
            tmax[r] = fmaxf(tmax[r], fmaf(s[n][e], sl2, b[n][e]));
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float mn = fmaxf(mx[r], tmax[r]);
        corr[r] = mn == -INFINITY ? 1.0f : ex2(mx[r] - mn);  // 0 on a row's first tile
        mx[r] = mn;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= corr[0], o[n][1] *= corr[0];
        o[n][2] *= corr[1], o[n][3] *= corr[1];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, i = row[r], c = n * 8 + 2 * tq + (e & 1);
          float p = 0.0f;
          if (i < N && c < cn && (!KEEP || kept(klo, khi, n, e & 1)))
            p = ex2(fmaf(s[n][e], sl2, b[n][e] - mx[r]));
          l[r] += p;  // the undropped p
          s[n][e] = p * drop_factor<DROP>(key, (uint32_t)i * (uint32_t)N + (uint32_t)(j0 + c),
                                          a.thresh, a.drop_scale);
        }
      }
      mma_ab<HD>(o, s, cur + TILE, lane);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // KEEP: a row whose keys are all dropped has l = 0 and writes 0
    const float inv = row[r] < N && (!KEEP || l[r] > 0.0f) ? 1.0f / l[r] : 0.0f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][2 * r] *= inv, o[n][2 * r + 1] *= inv;
    if (a.lse != nullptr && tq == 0 && row[r] < N)
      a.lse[(size_t)bh * N + row[r]] = (mx[r] + log2f(l[r])) * kLn2;
  }
  store_rows<HD>(a.o + seq * a.st[3][0] + h * a.st[3][1], a.st[3][2], row, N, o, 1.0f, tq);
}

template <int HD, typename M, bool DROP, bool BIAS, bool KEEP>
int launch(const lvt::TcFwd& a, cudaStream_t stream) {
  // Q and two stages of K, V, the mask and the bias: at hd 32 Q and the
  // K/V ring take 25.6 KB, the mask ring 18.4 KB in bf16 and 34.8 KB in
  // f32, the bias ring 18.4 KB, so K15's bias under an f32 mask takes
  // 78.8 KB (99.3 KB at hd 64): 2 blocks an SM, as kBlocks<float> says
  constexpr size_t smem = 5 * kRows * (HD + 8) * sizeof(bf16) + 2 * MaskTile<M>::kBytes +
                          (BIAS ? 2 * MaskTile<bf16>::kBytes : 0) + (KEEP ? 2 * kKeepWords * 4 : 0);
  const cudaError_t e = allow_smem(fwd_kernel<HD, M, DROP, BIAS, KEEP>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.nSeq * a.nH, (a.N + kRows - 1) / kRows);
  fwd_kernel<HD, M, DROP, BIAS, KEEP><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// A bias (K1, K14, K15, K16) comes without dropout; a keep vector (K4) without
// bias, dropout or lse, under a bf16 mask or none.
template <int HD, typename M>
int launch_drop(const lvt::TcFwd& a, cudaStream_t stream) {
  if (a.keep != nullptr) {
    if constexpr (std::is_same_v<M, bf16>) {
      if (a.bias == nullptr && a.seed == nullptr && a.lse == nullptr)
        return launch<HD, M, false, false, true>(a, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (a.bias != nullptr)
    return a.seed == nullptr ? launch<HD, M, false, true, false>(a, stream)
                             : (int)cudaErrorInvalidValue;
  return a.seed != nullptr ? launch<HD, M, true, false, false>(a, stream)
                           : launch<HD, M, false, false, false>(a, stream);
}

template <typename M>
int launch_hd(const lvt::TcFwd& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_drop<16, M>(a, stream);
    case 32: return launch_drop<32, M>(a, stream);
    case 64: return launch_drop<64, M>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

int lvt::attention_fwd_tc(const TcFwd& call, int hd, bool mask_f32, cudaStream_t stream) {
  TcFwd a = call;
  if (a.heads_total <= 0) a.heads_total = a.nH;
  if (a.head0 < 0 || a.head0 + a.nH > a.heads_total) return (int)cudaErrorInvalidValue;
  if (a.mask_ld == 0) a.mask_ld = a.N;
  if (a.bias_ld == 0) a.bias_ld = a.N;
  if (a.nSeq <= 0 || a.N <= 0 || a.nH <= 0 || a.nW <= 0 || a.nSeq % a.nW != 0 ||
      (long long)a.nSeq * a.nH > 0x7fffffffLL || a.N > 65535 || a.mask_ld < a.N ||
      a.bias_ld < a.N)
    return (int)cudaErrorInvalidValue;
  return mask_f32 ? launch_hd<float>(a, hd, stream) : launch_hd<bf16>(a, hd, stream);
}
