// The attention cores' C entries: the packed qkv slab [nSeq * N, 3C] that
// the qkv GEMM writes (columns s*C + h*hd + d, the JAX qkv layout), the
// heads layout (q, k, v [B, nH, N, hd] by their strides) and the per-window
// layout, each handed to the tensor-core forward (attention_fwd_tc.cu).
//
// Every caller runs there: the calls that write each row's log-sum-exp for
// a backward (K10a, lavender_tpu/ops/encoder_attention.py
// _enc_attn_train_lanes_kernel, and K13a, _enc_attn_train_kernel, with
// dropout; the Swin window core K8a, lavender_tpu/ops/swin_core_attn.py
// _core_fwd_kernel, with its per-head bias), the heads-layout calls
// without lse: K7 (encoder_attention.py _enc_attn_kernel, under an f32
// [B, N, N] mask) and K15 (lavender_tpu/ops/window_attention.py
// _attn_kernel, under a per-head bias and a per-window mask, bf16 or
// f32), and the packed calls whose wrapper selects the tensor cores: K1
// (lavender_tpu/ops/swin_block_attn.py _block_kernel_wm, bias + shift
// mask) and K4 (encoder_attention.py _attn_block_kernel_kmask, the
// key-keep vector).  K6, K14 and K16 call the tensor-core forward from
// blocks.cu.  A packed call that neither selects the tensor cores nor
// asks for lse is refused: the f32-pipe core that took such calls (K14's
// and K16's until they moved) is gone.
#include "attention_tc.cuh"
#include "common.cuh"

namespace {

// The heads layout (K7, K13a, K15) on the tensor cores: q, k, v and out by
// the element strides st[12] (host memory) of (sequence, head, row) in
// turn.
int heads_tc(const void* q, const void* k, const void* v, void* out, const long long* st,
             const void* bias, int bias_ld, const void* mask, int mask_ld, bool mask_f32,
             void* lse, int nSeq, int N, int nH, int hd, int nW, float scale, const void* seed,
             uint32_t thresh, float drop_scale, cudaStream_t s) {
  lvt::TcFwd a{{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v)},
               static_cast<bf16*>(out), {}, static_cast<float*>(lse), mask,
               static_cast<const bf16*>(bias), static_cast<const int64_t*>(seed), thresh,
               drop_scale, scale, nSeq, N, nH, nW, mask_ld, bias_ld};
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i) a.st[t][i] = st[3 * t + i];
  return lvt::attention_fwd_tc(a, hd, mask_f32, s);
}

}  // namespace

// qkv [nSeq * N, 3 * nH * hd] -> out [nSeq * N, nH * hd].  Optional (null):
// bias [nH, N, N] per head, mask [nW, N, N] for sequence s's window s % nW,
// keep [nSeq, N] uint8 (0 = key dropped; 4-byte aligned), lse [nSeq, nH,
// N] f32 (each row's log-sum-exp of its scores), seed (int64 on the
// device: dropout of the probabilities, element (i, j) kept iff its bits
// >= thresh, kept ones scaled by drop_scale).  hd in {16, 32, 64}.  A call
// with lse or tensor_cores != 0 runs on the tensor cores
// (attention_fwd_tc.cu; nW must divide nSeq; no bias with dropout; keep
// only without lse, dropout and bias): K10a with dropout, K8a with a bias,
// K1 (tensor_cores) with a bias, K4 (tensor_cores) with keep; any other
// call is refused (cudaErrorInvalidValue).
LVT_EXPORT int lvt_attention_bf16(const void* qkv, void* out, const void* bias, const void* mask,
                                  const void* keep, void* lse, int nSeq, int N, int nH, int hd,
                                  int nW, float scale, const void* seed, uint32_t thresh,
                                  float drop_scale, int tensor_cores, void* stream) {
  if (nSeq <= 0 || N <= 0 || nH <= 0 || nW <= 0 || nH > 65535) return (int)cudaErrorInvalidValue;
  if (lse == nullptr && !tensor_cores) return (int)cudaErrorInvalidValue;
  if (keep != nullptr && (lse != nullptr || seed != nullptr || bias != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)nH * hd, ld = 3 * C;
  const bf16* x = static_cast<const bf16*>(qkv);
  lvt::TcFwd a{{x, x + C, x + 2 * C}, static_cast<bf16*>(out),
               {{N * ld, hd, ld}, {N * ld, hd, ld}, {N * ld, hd, ld}, {N * C, hd, C}},
               static_cast<float*>(lse), mask, static_cast<const bf16*>(bias),
               static_cast<const int64_t*>(seed), thresh, drop_scale, scale, nSeq, N, nH, nW};
  a.keep = static_cast<const uint8_t*>(keep);
  return lvt::attention_fwd_tc(a, hd, false, static_cast<cudaStream_t>(stream));
}

// The heads layout on the tensor cores: q, k, v -> out, each [B, nH, N, hd]
// addressed by the element strides st[12] (host memory): (sequence, head,
// row) of q, k, v and out in turn, the head dim contiguous, every stride a
// multiple of 8 and every pointer 16-byte aligned; mask [B, N, N] f32, its
// rows mask_ld elements apart (null: none).  lse [B, nH, N] f32 (null: not
// written), seed, thresh and drop_scale as in lvt_attention_bf16 (null
// seed: no dropout; K7 passes neither, the train attention K13a both).  No
// bias or key-keep.  hd in {16, 32, 64}.
LVT_EXPORT int lvt_attention_heads_bf16(const void* q, const void* k, const void* v, void* out,
                                        const long long* st, const void* mask, int mask_ld,
                                        void* lse, int B, int N, int nH, int hd, float scale,
                                        const void* seed, uint32_t thresh, float drop_scale,
                                        void* stream) {
  if (B <= 0 || N <= 0 || nH <= 0 || nH > 65535) return (int)cudaErrorInvalidValue;
  return heads_tc(q, k, v, out, st, nullptr, 0, mask, mask_ld, true, lse, B, N, nH, hd, B, scale,
                  seed, thresh, drop_scale, static_cast<cudaStream_t>(stream));
}

// Per-window attention (K15) on the tensor cores: q, k, v -> out, each
// [W, nH, N, hd] addressed as in lvt_attention_heads_bf16 by the element
// strides st[12]; bias [nH, N, N] bf16 (null: none), mask [nW, N, N] for
// window w's w % nW, f32 where mask_f32 and bf16 otherwise (null: none),
// the rows of each bias_ld and mask_ld elements apart.  hd in {16, 32,
// 64}.
LVT_EXPORT int lvt_window_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         const long long* st, const void* bias, int bias_ld,
                                         const void* mask, int mask_ld, int mask_f32, int W,
                                         int N, int nH, int hd, int nW, float scale,
                                         void* stream) {
  if (W <= 0 || N <= 0 || nH <= 0 || nW <= 0 || W % nW != 0 || nH > 65535)
    return (int)cudaErrorInvalidValue;
  return heads_tc(q, k, v, out, st, bias, bias_ld, mask, mask_ld, mask_f32 != 0, nullptr, W, N,
                  nH, hd, nW, scale, nullptr, 0, 1.0f, static_cast<cudaStream_t>(stream));
}
