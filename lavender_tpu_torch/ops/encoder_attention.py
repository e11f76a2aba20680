"""BERT attention (port of lavender_tpu/ops/encoder_attention.py): the
serving sub-block K4 and the train attention K10a / K10b.

``fused_bert_attn_block_kmask`` replaces the TPU kernel
``_attn_block_kernel_kmask`` (lavender_tpu/ops/encoder_attention.py:322,
wrapper ``fused_bert_attn_block_kmask_forward`` :354): LN(x + proj(
softmax(q k^T * scale, key-padding mask) v)) for the post-LN fusion
encoder.  On the card: three GEMMs (+bias) write q, k and v straight into
one packed [B*L, 3C] slab -> attention core with the key-keep vector ->
proj GEMM (+bias, +residual) -> LN.  The TPU kernel deleted masked keys by
zeroing their k/v rows and subtracting their exp2(0) = 1 count from the
softmax denominator, which holds only without max-subtraction; the port's
attention core runs a stable softmax and skips masked keys instead.  L is
not padded (the TPU padded it to a multiple of 8 for its tiles).  Bound:
the qkv/proj GEMMs at M = B*276 rows and the attention core's f32 FLOPs.

``fused_encoder_attention_train_lanes`` replaces the TPU kernel
``_enc_attn_train_lanes_kernel`` (K10a, lavender_tpu/ops/
encoder_attention.py:750, wrapper ``fused_encoder_attention_train_lanes``
:890) and ``encoder_attention_train_lanes_bwd`` its backward
``_enc_attn_train_lanes_bwd_kernel`` (K10b, :780, ``_lanes_bwd`` :907): the
train route's attention o = (m * softmax(q k^T * scale + max(mask, -1e4)))
v on q, k, v in lanes layout [B, L, C] (head h = columns h*hd..), with
dropout m on the probabilities drawn from ``seed`` by the counter hash of
``dropout.py``, and its vjp, which regenerates m from the seed.  On the
card both are the port's attention core and its backward
(``csrc/attention.cu``, ``csrc/attention_bwd.cu``) on the packed qkv slab
[B*L, 3C]: where q, k and v are column views of one such slab (the model's
single qkv GEMM) it is passed without a copy.  The forward writes each
row's log-sum-exp of the undropped scores; the backward takes it and the
seed, so nothing [L, L]-shaped is stored between the two.  Bound: device
memory (q, k, v, o and the [B, L, L] mask, each once) at the f32 pipes'
speed of this first version, which runs far from it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lavender_tpu_torch.ops import _build, dropout, layer_norm


def _attn_block_plain(x, wq, wk, wv, bq, bk, bv, wproj, bproj, ln_w, ln_b,
                      keep, nH, scale, eps=1e-12):
    """Plain PyTorch version of ``fused_bert_attn_block_kmask``.

    x [B, L, C]; wq/wk/wv/wproj [C, C] (torch Linear layout); keep [B, L]
    bool (False = key masked for every query).  Returns [B, L, C]."""
    B, L, C = x.shape
    hd = C // nH

    def heads(t):
        return t.reshape(B, L, nH, hd).transpose(1, 2).float()

    q, k, v = (heads(F.linear(x, w, b))
               for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    s = (q * scale) @ k.transpose(-1, -2)
    s = s.masked_fill(~keep.bool()[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # all keys masked -> 0
    o = (p @ v).to(x.dtype).transpose(1, 2).reshape(B, L, C)
    return layer_norm(x + F.linear(o, wproj, bproj), ln_w, ln_b, eps)


def _attn_block_cuda(x, wq, wk, wv, bq, bk, bv, wproj, bproj, ln_w, ln_b,
                     keep, nH, scale, eps=1e-12):
    B, L, C = x.shape
    if not x.is_contiguous():
        raise ValueError("fused_bert_attn_block_kmask: x must be contiguous")
    x2 = x.view(B * L, C)
    qkv = torch.empty(B * L, 3 * C, dtype=x.dtype, device=x.device)
    for i, (w, b) in enumerate(((wq, bq), (wk, bk), (wv, bv))):
        _build.gemm(x2, w, b, out=qkv[:, i * C:(i + 1) * C])
    o = _build.attention(qkv, B, L, nH, scale, keep=keep)
    y = _build.gemm(o, wproj, bproj, residual=x2)
    return _build.layernorm(y, ln_w, ln_b, eps).view(B, L, C)


fused_bert_attn_block_kmask = _build.KernelOp(
    "K4 fused_bert_attn_block_kmask", _attn_block_plain, _attn_block_cuda)


def _lanes_plain(q, k, v, mask, seed, scale, rate, nH):
    """Plain PyTorch version of ``fused_encoder_attention_train_lanes``.

    q, k, v [B, L, C] (heads are column slices); mask [B, L, L] additive,
    clamped at -1e4 as the JAX kernel does; seed int64 [1]; rate the
    dropout of the probabilities (``dropout.attention_keep``), kept ones
    scaled by 1 / (1 - rate).  Scores, softmax and products in f32;
    returns [B, L, C] in q's dtype."""
    B, L, C = q.shape
    hd = C // nH

    def heads(t):
        return t.float().reshape(B, L, nH, hd).transpose(1, 2)

    s = (heads(q) * scale) @ heads(k).transpose(-1, -2)
    p = torch.softmax(s + mask.float().clamp_min(-1e4)[:, None], dim=-1)
    if rate > 0.0:
        keep = dropout.attention_keep(seed, B, nH, L, rate)
        p = p * keep.float() * (1.0 / (1.0 - rate))
    o = (p @ heads(v)).transpose(1, 2).reshape(B, L, C)
    return o.to(q.dtype)


def _lanes_bwd_plain(q, k, v, mask, seed, g, scale, rate, nH, lse=None):
    """Plain PyTorch version of ``encoder_attention_train_lanes_bwd``:
    autograd of ``_lanes_plain`` (``lse``, the kernel forward's row
    log-sum-exp, is not needed here).  Returns (dq, dk, dv)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = _lanes_plain(*ins, mask, seed, scale, rate, nH)
        return torch.autograd.grad(o, ins, g.to(o.dtype))


def _packed(q, k, v):
    """The [B*L, 3C] slab of q | k | v: a view where the three are column
    slices of one contiguous [B, L, 3C] tensor, else a copy."""
    B, L, C = q.shape
    e = q.element_size()
    if (q.stride() == k.stride() == v.stride() == (L * 3 * C, 3 * C, 1)
            and k.data_ptr() == q.data_ptr() + C * e
            and v.data_ptr() == q.data_ptr() + 2 * C * e):
        return q.as_strided((B * L, 3 * C), (3 * C, 1))
    return torch.cat([q, k, v], dim=-1).reshape(B * L, 3 * C)


def _check_lanes(q, k, v, mask, nH, what):
    B, L, C = q.shape
    if k.shape != q.shape or v.shape != q.shape or C % nH:
        raise ValueError(f"{what}: q, k, v must be [B, L, C] with C % nH == 0")
    if tuple(mask.shape) != (B, L, L):
        raise ValueError(f"{what}: mask must be [{B}, {L}, {L}], got "
                         f"{tuple(mask.shape)}")


def _lanes_bwd_cuda(q, k, v, mask, seed, g, scale, rate, nH,
                    lse: Optional[torch.Tensor] = None):
    _check_lanes(q, k, v, mask, nH, "encoder_attention_train_lanes_bwd")
    if lse is None:
        raise ValueError("encoder_attention_train_lanes_bwd: the forward's "
                         "lse is required on the card")
    B, L, C = q.shape
    dqkv, _ = _build.attention_bwd(
        _packed(q, k, v), lse, g.contiguous().view(B * L, C), B, L, nH, scale,
        mask=mask.contiguous(), seed=seed, rate=rate)
    d = dqkv.view(B, L, 3 * C)
    return d[..., :C], d[..., C:2 * C], d[..., 2 * C:]


encoder_attention_train_lanes_bwd = _build.KernelOp(
    "K10b encoder_attention_train_lanes_bwd", _lanes_bwd_plain,
    _lanes_bwd_cuda)


class _LanesFn(torch.autograd.Function):
    """K10a with K10b as its backward.  Saves the qkv slab, the mask, the
    rows' log-sum-exp and the seed tensor (never an [L, L] dropout mask);
    the mask gets no gradient (it is built from token masks, never a
    leaf; the JAX backward computes one and the model discards it)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, q, k, v, mask, seed, scale, rate, nH):
        _check_lanes(q, k, v, mask, nH, "fused_encoder_attention_train_lanes")
        B, L, C = q.shape
        qkv, mask = _packed(q, k, v), mask.contiguous()
        lse = torch.empty(B, nH, L, dtype=torch.float32, device=q.device)
        out = _build.attention(qkv, B, L, nH, scale, mask=mask, lse=lse,
                               seed=seed, rate=rate)
        ctx.save_for_backward(qkv, mask, lse, seed)
        ctx.args = (scale, rate, nH)
        return out.view(B, L, C)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        qkv, mask, lse, seed = ctx.saved_tensors
        scale, rate, nH = ctx.args
        B, L, C = g.shape
        q, k, v = qkv.view(B, L, 3 * C).split(C, dim=-1)
        dq, dk, dv = encoder_attention_train_lanes_bwd(
            q, k, v, mask, seed, g.to(qkv.dtype), scale, rate, nH, lse=lse)
        return dq, dk, dv, None, None, None, None, None


def _lanes_cuda(q, k, v, mask, seed, scale, rate, nH):
    # clamped before the Function casts it to bf16, where finfo(f32).min
    # would become -inf (the plain version clamps after that cast)
    return _LanesFn.apply(q, k, v, mask.clamp_min(-1e4), seed, scale, rate,
                          nH)


fused_encoder_attention_train_lanes = _build.KernelOp(
    "K10a fused_encoder_attention_train_lanes", _lanes_plain, _lanes_cuda)
