// The tensor-core forwards (attention_fwd_tc.cu; attention_fwd_wgmma.cu:
// the Swin window core K8a with its per-head bias) and backwards
// (attention_bwd_wgmma.cu: the fusion encoder's K10b and K13b, and K8b
// with its dbias) of the train attention cores, the first forward also of
// the heads-layout cores K7 and K15, as the C entries of attention.cu and
// attention_bwd.cu call them.
#pragma once

#include "common.cuh"

namespace lvt {

// Operands of one forward call.  Row r of operand t of (sequence s, head
// h) starts at x[t] + s * st[t][0] + h * st[t][1] + r * st[t][2]
// (elements), the head dim contiguous; t in order q, k, v, o.  Every
// stride a multiple of 8, every pointer 16-byte aligned.
struct TcFwd {
  const bf16* x[3];     // q, k, v
  bf16* o;
  long long st[4][3];   // (sequence, head, row) strides of q, k, v, o
  float* lse;           // [nSeq, nH, N] f32: each row's log-sum-exp of its scores, or null
  const void* mask;     // [nW, N, N] (sequence s reads s % nW) or null
  const bf16* bias;     // [nH, N, N] (head h reads bias[h]) or null
  const int64_t* seed;  // dropout seed, or null: no dropout
  uint32_t thresh;      // bits >= thresh are kept ...
  float drop_scale;     // ... and scaled by 1 / (1 - rate)
  float scale;
  int nSeq, N, nH, nW;
  int mask_ld = 0, bias_ld = 0;  // elements between rows of the mask / bias; 0: N
  const uint8_t* keep = nullptr;  // [nSeq, N]: key j of sequence s dropped where 0, or null
  // the dropout stream of (s, h) is s * heads_total + head0 + h
  // (dropout.cuh attention_stream); heads_total 0: nH
  int head0 = 0, heads_total = 0;
};

// o = ((m * p) v) / l and lse of softmax(q k^T * scale + bias + mask)
// with dropout m on the probabilities (l the undropped row sum), on the
// tensor cores; hd in {16, 32, 64}; the mask bf16, or f32 where mask_f32;
// a bias only without dropout; a key-keep vector only without bias,
// dropout or lse, under a bf16 mask or none (a row whose keys are all
// dropped is 0).  Returns a cudaError_t.
int attention_fwd_tc(const TcFwd& a, int hd, bool mask_f32, cudaStream_t stream);

// o and lse of softmax(q k^T * scale + bias + mask) on wgmma + TMA (K8a):
// lse and the bias required, a bf16 mask or none, no dropout and no
// key-keep, the mask's and the bias's rows N elements apart; hd in {16,
// 32, 64}; every stride a multiple of 8 elements where its extent is over
// 1, every pointer 16-byte aligned.  Returns a cudaError_t.
int attention_fwd_wgmma(const TcFwd& a, int hd, cudaStream_t stream);

// Operands of one backward call, addressed as TcFwd's; t in order q, k,
// v, g (the cotangent of o), dq, dk, dv.
struct TcBwd {
  const bf16* x[4];     // q, k, v, g
  bf16* dx[3];          // dq, dk, dv
  long long st[7][3];   // (sequence, head, row) strides of q, k, v, g, dq, dk, dv
  const float* lse;     // [nSeq, nH, N] f32, the forward's row log-sum-exp
  const void* mask;     // [nW, N, N] (sequence s reads s % nW) or null
  const float* dd;      // [nSeq, nH, N] f32: D = rowsum(o * g), from attention_row_dot
  const int64_t* seed;  // the forward's dropout seed, or null: no dropout
  uint32_t thresh;      // bits >= thresh are kept ...
  float drop_scale;     // ... and scaled by 1 / (1 - rate)
  float scale;
  int nSeq, N, nH, nW;
  // With a bias (as the forward's): dbias [nH, N, N] f32 = the sum over
  // sequences of ds, formed as nChunks partial sums into part [nChunks,
  // nH, N, N] f32 (1 <= nChunks <= nSeq), then added in chunk order.
  const bf16* bias;
  float* dbias;
  float* part;
  int nChunks;
  int head0 = 0, heads_total = 0;  // the dropout stream, as TcFwd's
};

// dq, dk, dv of softmax(q k^T * scale + mask) with dropout, no bias (K10b,
// K13b), or of softmax(q k^T * scale + bias + mask) with dbias, no dropout
// (K8b: a bf16 mask or none, dbias by the chunks of part), on the wgmma +
// TMA kernels of attention_bwd_wgmma.cu; hd in {16, 32, 64}; the mask
// bf16, or f32 where mask_f32; every stride a multiple of 8 elements where
// its extent is over 1, every pointer 16-byte aligned.
// acc: f32 scratch of nSeq * nH * T * 64 * hd floats (T = ceil(N / 64)),
// sem: int32 [nSeq * nH * T], all 0 before the call and 0 after it (both
// unused where T = 1).  Returns a cudaError_t.
int attention_bwd_wgmma(const TcBwd& a, float* acc, int* sem, int hd, bool mask_f32,
                        cudaStream_t stream);

// out[e] = sum over c < nChunks of part[c * n + e], c in order (the same
// bits on every run), e < n.  Returns a cudaError_t.
int sum_chunks(const float* part, float* out, int nChunks, size_t n, cudaStream_t stream);

// D = rowsum(o * g) in f32 per (sequence, head, row): o the forward's
// output and g its cotangent, each by (sequence, head, row) strides st,
// into dd [nSeq, nH, N] (D = rowsum(p * dp) up to o's rounding to bf16).
struct RowDot {
  const bf16* o;
  const bf16* g;
  long long st[2][3];
  float* dd;
  int nSeq, N, nH;
};
int attention_row_dot(const RowDot& a, int hd, cudaStream_t stream);

}  // namespace lvt
