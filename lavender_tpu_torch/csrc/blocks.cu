// The whole-block kernels K1, K4, K6, K14 and K16, and the LN + MLP of K3
// and K9, as one C entry each (K16 is K14's): their primitives launched
// back to back on one stream from one call, so that the host pays one crossing into the
// library a block instead of one a launch (at B = 4 serving, K1's stage-3
// block and K4 were bound by those crossings: 0.23-0.28 ms of host time
// against 0.14 and 0.04 ms of device time).  The kernels are the
// primitives' own; nothing is fused here.
//
// K1, lavender_tpu/ops/swin_block_attn.py _block_kernel_wm (:954): LN1
// (layernorm.cu) -> qkv + bias (gemm_tc.cu) -> the window core on the
// tensor cores with the rel-pos bias and the shift mask
// (attention_fwd_tc.cu through lvt_attention_bf16) -> proj + bias +
// residual, and with the MLP LN2 -> fc1 + bias + GELU -> fc2 + bias +
// residual.  K4, lavender_tpu/ops/encoder_attention.py
// _attn_block_kernel_kmask (:322): q | k | v in one tile-GEMM launch ->
// the core on the tensor cores with the key-keep vector -> proj as f32
// K-slices -> the row kernel (+ bias + residual, LN).  K6,
// _attn_block_kernel (:242), is K4 under a full additive [B, L, L] mask:
// the same launches, the core reading sequence b's mask rows (bf16,
// clamped at -1e4 by the caller, a pitch of its own) where K4 reads the
// keep vector, and no key skipped.  K14,
// lavender_tpu/ops/swin_block_attn.py _block_kernel (:468), is K1 on the
// spatial layout [B, D, H, W, C]: the 16-byte-chunk LN1 gathers the rows
// in window order through the caller's row index (the cyclic roll folded
// in), the qkv product, the tensor-core core at the window's own N
// (unpadded, 245 at T = 5) with the bias and the shift mask read at their
// row pitch, the proj's scatter epilogue writing each row back to the
// spatial row it came from with the residual's row added; with the MLP
// K3's path on the spatial rows (chunk LN2, fc1 + GELU, fc2 + residual).
// The TPU kernel cut the rolled, lane-padded map into slabs by its
// BlockSpec; here no permuted copy of the map is written.  K16,
// lavender_tpu/ops/swin_block_attn.py _block_kernel_wm_shift (:1137), the
// shifted attention half on the UNSHIFTED window-major slab [B, nW, Npad,
// C] with the cyclic shift inside, is K14's call without the MLP on that
// slab: n_tok = Npad, the row index the wm shift's (the slab row that each
// shifted row comes from, -1 at the window's tail-pad rows, whose gathered
// LN1 rows are zero as the TPU kernel's), the bias and the padded shift
// mask at pitch Npad, and the proj's zeroing scatter instance: a pad row
// of the shifted slab sits at the same position as one of the output, so
// the epilogue writes zeros there and the output's pad rows come out zero
// with no launch of their own (K14's instance keeps its code).  K9,
// lavender_tpu/ops/fused_mlp.py _kernel (:91), and K3, _chunked_kernel
// (:183): the MLP half of K1 on its own, LN -> fc1 + bias + GELU -> fc2 +
// bias (+ residual), the hidden layer [M, 4C] in device memory (the TPU
// kernels kept it in VMEM; K3 streamed the weights in HD chunks, which
// the card's L2 does for it); where the caller's plan cuts fc2 into f32
// K-slices, the row kernel sums them in order with bias and residual.
// Bound: the products' 16 M C^2 FLOPs at the tensor cores' rate; at
// Swin-B's stages 1-2 the LN output and the hidden layer, written and
// read again, hold it to the memory rate instead.  Its LN is layernorm.cu's 16-byte-chunk kernel (lvt_layernorm_rows_bf16):
// K1's LN2 is the scalar one, which K1 keeps, and the products after it
// are the one composition both share (run_mlp below).
// The intermediates live in one scratch buffer that the caller passes;
// the tile heights and K-slices are the caller's plan
// (lavender_tpu_torch/ops/_build.py gemm_tc_plan, ln_mlp_plan).
#include "attention_tc.cuh"
#include "gemm_tc.cuh"

LVT_EXPORT int lvt_layernorm_bf16(const void* x, const void* g, const void* b, void* y, int M,
                                  int C, float eps, const void* rows, void* stream);
LVT_EXPORT int lvt_layernorm_rows_bf16(const void* x, const void* g, const void* b, void* y,
                                       int M, int C, float eps, const void* rows, void* stream);
LVT_EXPORT int lvt_attention_bf16(const void* qkv, void* out, const void* bias, const void* mask,
                                  const void* keep, void* lse, int nSeq, int N, int nH, int hd,
                                  int nW, float scale, const void* seed, uint32_t thresh,
                                  float drop_scale, int tensor_cores, int head0, int heads_total,
                                  void* stream);

namespace {

// The next 256-byte aligned piece of `bytes` bytes of the scratch.
char* take(char*& at, size_t bytes) {
  char* p = at;
  at += (bytes + 255) / 256 * 256;
  return p;
}

long long round256(long long bytes) { return (bytes + 255) / 256 * 256; }

// The MLP after the LN that K1's MLP half, K3 and K9 run: out = fc2(GELU(
// fc1(h))) + b2 (+ R where R is not null), h [M, C] the LN's output; hid
// [M, HD] bf16 scratch, part [S, M, C] f32 scratch when fc2 runs as S > 1
// K-slices; bm1 and bm2 the tile heights of fc1 and fc2.
int run_mlp(const bf16* h, const void* w1, const void* b1, const void* w2, const void* b2,
            const bf16* R, bf16* hid, float* part, bf16* out, int M, int C, int HD, int bm1,
            int bm2, int S, cudaStream_t st) {
  lvt::GemmTc g{h, C, {static_cast<const bf16*>(w1)}, {static_cast<const bf16*>(b1)}, 1, hid, HD,
                nullptr, 0, M, HD, C, lvt::kEpiGelu, bm1, 1};
  int err = lvt::gemm_tc(g, st);
  if (err) return err;
  const auto B2 = static_cast<const bf16*>(b2);
  const bool residual = R != nullptr;
  if (S == 1) {
    g = {hid, HD, {static_cast<const bf16*>(w2)}, {B2}, 1, out, C, R, C, M, C, HD,
         residual ? lvt::kEpiResidual : lvt::kEpiBias, bm2, 1};
    return lvt::gemm_tc(g, st);
  }
  g = {hid, HD, {static_cast<const bf16*>(w2)}, {nullptr}, 1, part, C, nullptr, 0, M, C, HD,
       lvt::kEpiPartial, bm2, S};
  if ((err = lvt::gemm_tc(g, st))) return err;
  return lvt::rows_sum(part, S, R, B2, out, M, C, st);
}

}  // namespace

// K1: out [M, C] for x [M, C] = [nSeq * N, C] (window-major rows), all bf16
// and contiguous: ln_w, ln_b (both null: the pure normalize), wqkv [3C, C],
// bqkv, wproj [C, C], bproj, bias [nH, N, N], mask [nW, N, N] or null; with
// w1 non-null the MLP: n2w, n2b (both null: pure), w1 [HD, C], b1, w2 [C,
// HD], b2.  bm[4]: the tile heights of qkv, proj, fc1, fc2 (host memory).
// C <= lvt::kMaxRowC (the scalar LN's instances; Swin-L's stage 4 at C =
// 1536 takes the 64-a-lane one), head dim 16, 32 or 64.
// scratch: lvt_swin_block_wm_scratch(M, C, HD) bytes.
LVT_EXPORT long long lvt_swin_block_wm_scratch(int M, int C, int HD) {
  const long long r = ((long long)M * C * 2 + 255) / 256 * 256;  // h, qkv (3), o, y
  return 6 * r + (HD > 0 ? ((long long)M * HD * 2 + 255) / 256 * 256 : 0);
}

LVT_EXPORT int lvt_swin_block_wm_bf16(const void* x, const void* ln_w, const void* ln_b,
                                      const void* wqkv, const void* bqkv, const void* wproj,
                                      const void* bproj, const void* bias, const void* mask,
                                      const void* n2w, const void* n2b, const void* w1,
                                      const void* b1, const void* w2, const void* b2,
                                      void* scratch, void* out, int nSeq, int N, int C, int nH,
                                      int HD, int nW, float scale, float eps, const int* bm,
                                      void* stream) {
  if (nSeq <= 0 || N <= 0 || C <= 0 || nH <= 0 || C % nH) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int M = nSeq * N;
  const size_t row = (size_t)M * C * 2;
  char* at = static_cast<char*>(scratch);
  bf16* h = reinterpret_cast<bf16*>(take(at, row));
  bf16* qkv = reinterpret_cast<bf16*>(take(at, 3 * row));
  bf16* o = reinterpret_cast<bf16*>(take(at, row));
  const bool mlp = w1 != nullptr;
  bf16* y = mlp ? reinterpret_cast<bf16*>(take(at, row)) : static_cast<bf16*>(out);
  const auto X = static_cast<const bf16*>(x);
  int err = lvt_layernorm_bf16(x, ln_w, ln_b, h, M, C, eps, nullptr, stream);
  if (err) return err;
  lvt::GemmTc g{h, C, {static_cast<const bf16*>(wqkv)}, {static_cast<const bf16*>(bqkv)}, 1,
                qkv, 3 * C, nullptr, 0, M, 3 * C, C, lvt::kEpiBias, bm[0], 1};
  if ((err = lvt::gemm_tc(g, st))) return err;
  if ((err = lvt_attention_bf16(qkv, o, bias, mask, nullptr, nullptr, nSeq, N, nH, C / nH, nW,
                                scale, nullptr, 0u, 1.0f, 1, 0, 0, stream)))
    return err;
  g = {o, C, {static_cast<const bf16*>(wproj)}, {static_cast<const bf16*>(bproj)}, 1, y, C, X, C,
       M, C, C, lvt::kEpiResidual, bm[1], 1};
  if ((err = lvt::gemm_tc(g, st)) || !mlp) return err;
  bf16* hid = reinterpret_cast<bf16*>(take(at, (size_t)M * HD * 2));
  if ((err = lvt_layernorm_bf16(y, n2w, n2b, h, M, C, eps, nullptr, stream))) return err;
  return run_mlp(h, w1, b1, w2, b2, y, hid, nullptr, static_cast<bf16*>(out), M, C, HD, bm[2],
                 bm[3], 1, st);
}

// K3 and K9: out [M, C] = fc2(GELU(fc1(LN(x)))) + b2 (+ x with residual)
// for x [M, C] contiguous: ln_w, ln_b (both null: the pure normalize), w1
// [HD, C], b1, w2 [C, HD], b2, all bf16, contiguous and 16-byte aligned,
// C a multiple of 8 and <= lvt::kMaxRowC (the chunk LN's and the row
// kernel's instances: Swin-L's stage 4 runs C = 1536); bm1 and bm2 the
// tile heights of fc1 and fc2, S fc2's K-slices (whole 64-deep steps
// each).  scratch: at least lvt_ln_mlp_scratch(M, C, HD, S) bytes, given
// as scratch_bytes.
LVT_EXPORT long long lvt_ln_mlp_scratch(int M, int C, int HD, int S) {
  return round256((long long)M * C * 2) + round256((long long)M * HD * 2) +
         (S > 1 ? round256((long long)S * M * C * 4) : 0);  // h, hid, part
}

LVT_EXPORT int lvt_ln_mlp_bf16(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* scratch,
                               long long scratch_bytes, void* out, int M, int C, int HD, float eps,
                               int residual, int bm1, int bm2, int S, void* stream) {
  if (M <= 0 || C <= 0 || HD <= 0 || S < 1 || scratch_bytes < lvt_ln_mlp_scratch(M, C, HD, S))
    return (int)cudaErrorInvalidValue;
  char* at = static_cast<char*>(scratch);
  bf16* h = reinterpret_cast<bf16*>(take(at, (size_t)M * C * 2));
  bf16* hid = reinterpret_cast<bf16*>(take(at, (size_t)M * HD * 2));
  float* part = S > 1 ? reinterpret_cast<float*>(take(at, (size_t)S * M * C * 4)) : nullptr;
  const int err = lvt_layernorm_rows_bf16(x, ln_w, ln_b, h, M, C, eps, nullptr, stream);
  if (err) return err;
  const auto X = static_cast<const bf16*>(x);
  return run_mlp(h, w1, b1, w2, b2, residual ? X : nullptr, hid, part, static_cast<bf16*>(out), M,
                 C, HD, bm1, bm2, S, static_cast<cudaStream_t>(stream));
}

namespace {

// The BERT attention sub-block of K4 and K6: q | k | v in one tile-GEMM
// launch into the packed slab, the core on the tensor cores under the
// key-keep vector (K4) or the bf16 [B, L, L] mask, rows mask_ld apart
// (K6; sequence b reads mask + b L mask_ld), the proj as f32 K-slices,
// then the row kernel (+ bias + residual, LN).
int bert_block(const void* x, const void* wq, const void* wk, const void* wv, const void* bq,
               const void* bk, const void* bv, const void* wproj, const void* bproj,
               const void* ln_w, const void* ln_b, const void* keep, const void* mask,
               int mask_ld, void* scratch, void* out, int B, int L, int C, int nH, float scale,
               float eps, int bm_qkv, int bm_proj, int S, cudaStream_t st) {
  if (B <= 0 || L <= 0 || C <= 0 || nH <= 0 || C % nH || (keep == nullptr) == (mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const int M = B * L;
  char* at = static_cast<char*>(scratch);
  bf16* qkv = reinterpret_cast<bf16*>(take(at, (size_t)M * 3 * C * 2));
  bf16* o = reinterpret_cast<bf16*>(take(at, (size_t)M * C * 2));
  float* part = reinterpret_cast<float*>(take(at, (size_t)S * M * C * 4));
  const auto X = static_cast<const bf16*>(x);
  lvt::GemmTc g{X,
                C,
                {static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
                 static_cast<const bf16*>(wv)},
                {static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
                 static_cast<const bf16*>(bv)},
                3,
                qkv,
                3 * C,
                nullptr,
                0,
                M, C, C, lvt::kEpiBias, bm_qkv, 1};
  int err = lvt::gemm_tc(g, st);
  if (err) return err;
  const long long ld = 3LL * C, hd = C / nH;
  lvt::TcFwd a{{qkv, qkv + C, qkv + 2 * C}, o,
               {{L * ld, hd, ld}, {L * ld, hd, ld}, {L * ld, hd, ld}, {(long long)L * C, hd, C}},
               nullptr, mask, nullptr, nullptr, 0u, 1.0f, scale, B, L, nH, mask != nullptr ? B : 1,
               mask_ld};
  a.keep = static_cast<const uint8_t*>(keep);
  if ((err = lvt::attention_fwd_tc(a, (int)hd, false, st))) return err;
  g = {o, C, {static_cast<const bf16*>(wproj)}, {nullptr}, 1, part, C, nullptr, 0, M, C, C,
       lvt::kEpiPartial, bm_proj, S};
  if ((err = lvt::gemm_tc(g, st))) return err;
  return lvt::rows_ln(part, S, X, static_cast<const bf16*>(bproj), static_cast<const bf16*>(ln_w),
                      static_cast<const bf16*>(ln_b), static_cast<bf16*>(out), M, C, eps, st);
}

}  // namespace

// K4: out [M, C] = LN(x + proj(attention(q, k, v))) for x [M, C] = [B * L,
// C]: wq, wk, wv, wproj [C, C], bq, bk, bv (each may be null), bproj, ln_w,
// ln_b, keep [B, L] uint8 (4-byte aligned), all contiguous; bm_qkv the q |
// k | v launch's tile height, bm_proj and S the proj's and its K-slices.
// scratch: lvt_bert_attn_block_scratch(M, C, S) bytes.
LVT_EXPORT long long lvt_bert_attn_block_scratch(int M, int C, int S) {
  const long long r = ((long long)M * C * 2 + 255) / 256 * 256;
  return 4 * r + ((long long)S * M * C * 4 + 255) / 256 * 256;  // qkv (3), o, part
}

LVT_EXPORT int lvt_bert_attn_block_bf16(const void* x, const void* wq, const void* wk,
                                        const void* wv, const void* bq, const void* bk,
                                        const void* bv, const void* wproj, const void* bproj,
                                        const void* ln_w, const void* ln_b, const void* keep,
                                        void* scratch, void* out, int B, int L, int C, int nH,
                                        float scale, float eps, int bm_qkv, int bm_proj, int S,
                                        void* stream) {
  return bert_block(x, wq, wk, wv, bq, bk, bv, wproj, bproj, ln_w, ln_b, keep, nullptr, 0,
                    scratch, out, B, L, C, nH, scale, eps, bm_qkv, bm_proj, S,
                    static_cast<cudaStream_t>(stream));
}

// K6: the same sub-block under an additive bf16 mask [B, L, L] (clamped
// and cast by the caller; masked keys are not skipped: a row whose every
// key is at -1e4 takes the softmax over those scores), its rows mask_ld
// >= L elements apart, 16-byte aligned; the rest and the scratch as K4's.
LVT_EXPORT int lvt_bert_attn_block_mask_bf16(const void* x, const void* wq, const void* wk,
                                             const void* wv, const void* bq, const void* bk,
                                             const void* bv, const void* wproj, const void* bproj,
                                             const void* ln_w, const void* ln_b, const void* mask,
                                             int mask_ld, void* scratch, void* out, int B, int L,
                                             int C, int nH, float scale, float eps, int bm_qkv,
                                             int bm_proj, int S, void* stream) {
  if (mask == nullptr || mask_ld < L) return (int)cudaErrorInvalidValue;
  return bert_block(x, wq, wk, wv, bq, bk, bv, wproj, bproj, ln_w, ln_b, nullptr, mask, mask_ld,
                    scratch, out, B, L, C, nH, scale, eps, bm_qkv, bm_proj, S,
                    static_cast<cudaStream_t>(stream));
}

// K14: out [M, C] for x [M, C] = [B * D * H * W, C] in spatial row order,
// rows int32 [M] the spatial row of each window row (window_partition's
// order after the roll; a permutation): out = x + proj(attn(LN1(x[rows])))
// scattered back by rows; with w1 non-null then out = y + fc2(GELU(fc1(
// LN2(y)))) on the spatial rows y.  K16 (pad_zero != 0, no MLP): x the
// unshifted window-major slab [B * nW * Npad, C], N = Npad, rows an index
// with -1 at the pad rows (LN1 gathers a zero row there); out row m is
// zero where rows[m] < 0, which must be the rows that no index names.  All bf16 but rows, contiguous and
// 16-byte aligned: ln_w, ln_b, wqkv [3C, C], bqkv, wproj [C, C], bproj,
// n2w, n2b, w1 [HD, C], b1, w2 [C, HD], b2 (the LN affines both null: the
// pure normalize); bias [nH, N, N] rows bias_ld elements apart, mask [nW,
// N, N] (bf16, or f32 where mask_f32; sequence s reads window s % nW) rows
// mask_ld apart, or null (nW = 1).  bm_*: the tile heights of qkv, proj,
// fc1, fc2; S fc2's K-slices.  C a multiple of 8 and <= lvt::kMaxRowC,
// head dim 16, 32 or 64.  scratch: at least lvt_swin_block_spatial_scratch(M, C, HD, S)
// bytes (HD 0 without the MLP), given as scratch_bytes.
LVT_EXPORT long long lvt_swin_block_spatial_scratch(int M, int C, int HD, int S) {
  const long long r = round256((long long)M * C * 2);  // h, qkv (3), o
  return 5 * r + (HD > 0 ? lvt_ln_mlp_scratch(M, C, HD, S) : 0);  // + y, hid, part
}

LVT_EXPORT int lvt_swin_block_spatial_bf16(
    const void* x, const void* rows, const void* ln_w, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias, int bias_ld,
    const void* mask, int mask_ld, int mask_f32, const void* n2w, const void* n2b,
    const void* w1, const void* b1, const void* w2, const void* b2, void* scratch,
    long long scratch_bytes, void* out, int nSeq, int N, int C, int nH, int HD, int nW,
    float scale, float eps, int bm_qkv, int bm_proj, int bm1, int bm2, int S, int pad_zero,
    void* stream) {
  const bool mlp = w1 != nullptr;
  if (nSeq <= 0 || N <= 0 || C <= 0 || nH <= 0 || C % nH || nW <= 0 || nSeq % nW ||
      rows == nullptr || bias == nullptr || bias_ld < N ||
      (mask == nullptr ? nW != 1 : mask_ld < N) || (mlp && (HD <= 0 || S < 1 || pad_zero)))
    return (int)cudaErrorInvalidValue;
  const int M = nSeq * N, hd = C / nH;
  if (scratch_bytes < lvt_swin_block_spatial_scratch(M, C, mlp ? HD : 0, S))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t row = (size_t)M * C * 2;
  char* at = static_cast<char*>(scratch);
  bf16* h = reinterpret_cast<bf16*>(take(at, row));
  bf16* qkv = reinterpret_cast<bf16*>(take(at, 3 * row));
  bf16* o = reinterpret_cast<bf16*>(take(at, row));
  bf16* y = mlp ? reinterpret_cast<bf16*>(take(at, row)) : static_cast<bf16*>(out);
  int err = lvt_layernorm_rows_bf16(x, ln_w, ln_b, h, M, C, eps, rows, stream);
  if (err) return err;
  lvt::GemmTc g{h, C, {static_cast<const bf16*>(wqkv)}, {static_cast<const bf16*>(bqkv)}, 1,
                qkv, 3 * C, nullptr, 0, M, 3 * C, C, lvt::kEpiBias, bm_qkv, 1};
  if ((err = lvt::gemm_tc(g, st))) return err;
  const long long ld = 3LL * C;
  lvt::TcFwd a{{qkv, qkv + C, qkv + 2 * C}, o,
               {{N * ld, hd, ld}, {N * ld, hd, ld}, {N * ld, hd, ld}, {(long long)N * C, hd, C}},
               nullptr, mask, static_cast<const bf16*>(bias), nullptr, 0u, 1.0f, scale, nSeq, N,
               nH, nW, mask != nullptr ? mask_ld : 0, bias_ld};
  if ((err = lvt::attention_fwd_tc(a, hd, mask_f32 != 0, st))) return err;
  const int scatter = pad_zero ? lvt::kEpiScatterZero : lvt::kEpiScatter;
  g = {o, C, {static_cast<const bf16*>(wproj)}, {static_cast<const bf16*>(bproj)}, 1, y, C,
       static_cast<const bf16*>(x), C, M, C, C, scatter, bm_proj, 1};
  g.rows = static_cast<const int*>(rows);
  if ((err = lvt::gemm_tc(g, st)) || !mlp) return err;
  bf16* hid = reinterpret_cast<bf16*>(take(at, (size_t)M * HD * 2));
  float* part = S > 1 ? reinterpret_cast<float*>(take(at, (size_t)S * M * C * 4)) : nullptr;
  if ((err = lvt_layernorm_rows_bf16(y, n2w, n2b, h, M, C, eps, nullptr, stream))) return err;
  return run_mlp(h, w1, b1, w2, b2, y, hid, part, static_cast<bf16*>(out), M, C, HD, bm1, bm2, S,
                 st);
}
