"""BERT attention (port of lavender_tpu/ops/encoder_attention.py): the
serving sub-blocks K4 and K6, the heads-layout core K7 and the train
attention in lanes layout K10a / K10b and in heads layout K13a / K13b.

``fused_bert_attn_block_kmask`` replaces the TPU kernel
``_attn_block_kernel_kmask`` (lavender_tpu/ops/encoder_attention.py:322,
wrapper ``fused_bert_attn_block_kmask_forward`` :354): LN(x + proj(
softmax(q k^T * scale, key-padding mask) v)) for the post-LN fusion
encoder.  On the card, four launches from one C call
(``_build.bert_attn_block``, ``csrc/blocks.cu``): ONE wgmma + TMA tile GEMM
(``_build.gemm_tc``, ``csrc/gemm_tc.cu``) writes q, k and v (+bias)
straight into one packed [B*L, 3C] slab, a grid dimension picking the
weight (none concatenated) -> the tensor-core forward
(``csrc/attention_fwd_tc.cu``, its KEEP variant: a key whose keep byte is
0 gets p = 0 by predicate, a row with every key dropped is 0) -> proj as
f32 K-slices (the 54 tiles of M = 1104, N = 768 would leave most of the
card idle) -> a row kernel summing the slices in order, + bias +
residual, LN (``_build.gemm_tc_ln``).  The TPU kernel deleted masked keys
by zeroing their k/v rows and subtracting their exp2(0) = 1 count from
the softmax denominator, which holds only without max-subtraction; the
port's core runs an online softmax and masks keys by predicate instead.
L is not padded (the TPU padded it to a multiple of 8 for its tiles).
Bound: the products' tensor-core rate at M = B*276 rows.

``fused_bert_attn_block`` replaces ``_attn_block_kernel`` (K6, :242,
wrapper ``fused_bert_attn_block_forward`` :261): the same sub-block under
a full additive [B, L, L] mask (the seq2seq / captioning masks, or the
stride-0 expansion of a key-padding bias under ``LVT_KMASK=0``), which the
wrapper clamps at -1e4 and casts to bf16 (``finfo(f32).min`` would become
-inf there) into rows padded to 16 bytes (``padded_clamped_mask``: the
core stages them by its widest copy), and the core adds per sequence.
On the card it is K4's one C call with that mask in place of the keep
vector (``_build.bert_attn_block(..., mask=...)``,
``lvt_bert_attn_block_mask_bf16`` in ``csrc/blocks.cu``): the same
q | k | v tile-GEMM launch, the tensor-core forward reading sequence b's
mask rows, the proj K-slices and the row LN.  Masked keys are not
skipped: a row whose keys are all masked gets the softmax over its -1e4
scores, as the JAX oracle ``bert_attn_block_reference`` computes (the TPU
kernel, which pads L to a multiple of 8, lets its pad keys into such a
row), and the tensor-core forward without its keep vector has no
shortcut that zeroes such a row.  Bound: as K4's, plus the mask read.

``fused_encoder_attention`` replaces ``_enc_attn_kernel`` (K7, :75, wrapper
``fused_encoder_attention`` :192): softmax(q k^T * scale + max(mask, -1e4))
v on q, k, v in heads layout [B, nH, L, hd] under an f32 [B, L, L] mask.
On the card it is the tensor-core forward of K13a below without dropout
and without the lse store, which reads each operand by its own
(sequence, head, row) strides, so a transposed [B, L, nH, hd] view is
read in place; the wrapper's clamped copy of the mask has its rows padded
to 16 bytes.  It lies on no model path, as in JAX (``BertAttention``
takes the whole sub-block first).  Bound: device memory (q, k, v, o and
the mask, each once).  K4, K6 and K7 have the JAX custom_vjps' backward:
autograd of the plain version, recomputed from the saved inputs
(``_build.RecomputeVjp``), so a model in ``eval()`` mode under autograd
gets its gradients through them.

``fused_encoder_attention_train_lanes`` replaces the TPU kernel
``_enc_attn_train_lanes_kernel`` (K10a, lavender_tpu/ops/
encoder_attention.py:750, wrapper ``fused_encoder_attention_train_lanes``
:890) and ``encoder_attention_train_lanes_bwd`` its backward
``_enc_attn_train_lanes_bwd_kernel`` (K10b, :780, ``_lanes_bwd`` :907): the
train route's attention o = (m * softmax(q k^T * scale + max(mask, -1e4)))
v on q, k, v in lanes layout [B, L, C] (head h = columns h*hd..), with
dropout m on the probabilities drawn from ``seed`` by the counter hash of
``dropout.py``, and its vjp, which regenerates m from the seed.  On the
card both run on the tensor cores: the forward in
``csrc/attention_fwd_tc.cu`` (FlashAttention-2's forward on mma.sync
tiles, the online softmax on the accumulator fragments), the backward in
``csrc/attention_bwd_wgmma.cu`` (D = rowsum(o * g) from the forward's
output, as FlashAttention-2 forms it; then one CTA a 64-key tile sweeping
the query tiles, Q and G by TMA, five wgmma products a tile pair, dQ
summed across the key tiles in a fixed order), both on the packed qkv
slab [B*L, 3C]: where
q, k and v are column views of one such slab (the model's single qkv
GEMM) it is passed without a copy.  The forward writes each row's
log-sum-exp of the undropped scores; the backward takes it, the output
and the seed, so nothing [L, L]-shaped is stored between the two.  Bound:
device memory (the forward: q, k, v, o and the [B, L, L] mask, each once;
the backward also g, dq, dk, dv).

``fused_encoder_attention_train`` replaces the TPU kernel
``_enc_attn_train_kernel`` (K13a, lavender_tpu/ops/encoder_attention.py:526,
wrapper ``fused_encoder_attention_train`` :670) and
``encoder_attention_train_bwd`` its backward ``_enc_attn_train_bwd_kernel``
(K13b, :555, ``_train_bwd`` :696): the same train attention and vjp on q,
k, v in heads layout [B, nH, L, hd], which the fusion encoder runs under
``LVT_ATTNLANES=0``.  On the card: the same tensor-core forward and
wgmma backward, each operand read by its own
(sequence, head, row) strides (strided views of one qkv product in place),
under the f32 [B, L, L] mask that forward and backward both read (never a
bf16 copy: its -1e4 would round), with the bits of K10's hash at the logical
(sequence, head, row, key), so K13 on heads views and K10 on the [B, L, C]
tensors they view drop the same probabilities.  Under tensor parallelism
K10 and K13 take a rank's own heads with ``head0`` (the first of them) and
``heads_total``: their dropout streams are then seq * heads_total + head0 +
h, those heads' streams in one process.  K13b also forms, where the
mask requires grad, the TPU kernel's dmask = the sum over heads of the
scores' gradient, zeroed where the mask is <= -1e4 (its wrapper's rule,
:715), on the f32-pipe backward of ``csrc/attention_bwd.cu``; the model's
mask never does, so its step pays nothing for it.
Bound: device memory (q, k, v, o and the mask, each once; the backward
also g, dq, dk, dv).
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
    """q/k/v in one tile-GEMM launch into one slab -> the tensor-core core
    with the key-keep vector -> proj K-slices + residual + LN."""
    B, L, C = x.shape
    if not x.is_contiguous():
        raise ValueError("BERT attention sub-block: x must be contiguous")
    return _build.bert_attn_block(x.view(B * L, C), wq, wk, wv, bq, bk, bv,
                                  wproj, bproj, ln_w, ln_b, keep, B, L, nH,
                                  scale, eps).view(B, L, C)


fused_bert_attn_block_kmask = _build.KernelOp(
    "K4 fused_bert_attn_block_kmask", _attn_block_plain, _attn_block_cuda,
    recompute_vjp=True)


def _core_plain(q, k, v, mask, scale):
    """Plain PyTorch version of ``fused_encoder_attention`` (JAX
    ``encoder_attention_reference``).

    q, k, v [B, nH, L, hd]; mask [B, L, L] additive, clamped at -1e4;
    scores, softmax and the P.V sum in f32.  Returns [B, nH, L, hd] in q's
    dtype."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s + mask.float().clamp_min(-1e4)[:, None], dim=-1)
    return (p @ v.float()).to(q.dtype)


# clamp_min's tensor form (a CPU scalar) computes in the mask's dtype and
# casts into ``out``, so one launch clamps, casts and pads
_MASK_FLOOR = torch.tensor(-1e4)


def padded_clamped_mask(mask: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The [B, L, L] mask the tensor-core forward reads, in ``dtype`` (f32
    for K7, bf16 for K6), in one launch: ``mask`` (any strides, a stride-0
    expansion too) clamped at -1e4 (an autocast cast may have made it
    bf16, where finfo(f32).min is -inf; the clamp restores it and keeps
    the kernel's (mask * log2(e) - max) finite), written into rows padded
    to 16 bytes (``_build.padded_rows``), which the kernel stages by its
    widest copy.  In f32 the clamp runs in f32; in bf16 the result is the
    plain versions' ``mask.clamp_min(-1e4).to(torch.bfloat16)``."""
    B, L, _ = mask.shape
    src = mask.float() if dtype == torch.float32 else mask
    return torch.clamp_min(src, _MASK_FLOOR,
                           out=_build.padded_rows(B, L, dtype, mask.device))


def _core_cuda(q, k, v, mask, scale):
    _check_heads(q, k, v, mask, "fused_encoder_attention")
    return _build.attention_heads(q, k, v, padded_clamped_mask(mask), scale)


fused_encoder_attention = _build.KernelOp(
    "K7 fused_encoder_attention", _core_plain, _core_cuda,
    recompute_vjp=True)


def _attn_block_mask_plain(x, wq, wk, wv, bq, bk, bv, wproj, bproj, ln_w,
                           ln_b, mask, nH, scale, eps=1e-12):
    """Plain PyTorch version of ``fused_bert_attn_block`` (JAX
    ``bert_attn_block_reference``): LN(x + proj(attention(q, k, v))) with
    q/k/v = x W + b, 12 heads of ``_core_plain`` under the [B, L, L]
    additive mask, clamped at -1e4 and cast to x's dtype as the kernel
    takes it.  Weights in torch Linear layout; returns [B, L, C]."""
    B, L, C = x.shape

    def heads(t):
        return t.view(B, L, nH, C // nH).transpose(1, 2)

    q, k, v = (heads(F.linear(x, w, b))
               for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    o = _core_plain(q, k, v, mask.clamp_min(-1e4).to(x.dtype), scale)
    o = o.transpose(1, 2).reshape(B, L, C)
    return layer_norm(x + F.linear(o, wproj, bproj), ln_w, ln_b, eps)


def _attn_block_mask_cuda(x, wq, wk, wv, bq, bk, bv, wproj, bproj, ln_w,
                          ln_b, mask, nH, scale, eps=1e-12):
    """K4's one C call with the mask, clamped, cast to bf16 and padded, in
    place of the keep vector."""
    B, L, C = x.shape
    if tuple(mask.shape) != (B, L, L) or mask.device != x.device:
        raise ValueError(f"fused_bert_attn_block: mask must be [{B}, {L}, "
                         f"{L}] on {x.device}, got {tuple(mask.shape)} on "
                         f"{mask.device}")
    if not x.is_contiguous():
        raise ValueError("BERT attention sub-block: x must be contiguous")
    return _build.bert_attn_block(
        x.view(B * L, C), wq, wk, wv, bq, bk, bv, wproj, bproj, ln_w, ln_b,
        None, B, L, nH, scale, eps,
        mask=padded_clamped_mask(mask, torch.bfloat16)).view(B, L, C)


fused_bert_attn_block = _build.KernelOp(
    "K6 fused_bert_attn_block", _attn_block_mask_plain, _attn_block_mask_cuda,
    recompute_vjp=True)


def _lanes_plain(q, k, v, mask, seed, scale, rate, nH, head0=0,
                 heads_total=0):
    """Plain PyTorch version of ``fused_encoder_attention_train_lanes``.

    q, k, v [B, L, C] (heads are column slices); mask [B, L, L] additive,
    clamped at -1e4 as the JAX kernel does; seed int64 [1]; rate the
    dropout of the probabilities (``dropout.attention_keep``), kept ones
    scaled by 1 / (1 - rate); ``head0`` / ``heads_total`` its stream (a
    tensor-parallel rank's heads).  Scores, softmax and products in f32;
    returns [B, L, C] in q's dtype."""
    B, L, C = q.shape
    hd = C // nH

    def heads(t):
        return t.float().reshape(B, L, nH, hd).transpose(1, 2)

    s = (heads(q) * scale) @ heads(k).transpose(-1, -2)
    p = torch.softmax(s + mask.float().clamp_min(-1e4)[:, None], dim=-1)
    if rate > 0.0:
        keep = dropout.attention_keep(seed, B, nH, L, rate, head0,
                                      heads_total)
        p = p * keep.float() * (1.0 / (1.0 - rate))
    o = (p @ heads(v)).transpose(1, 2).reshape(B, L, C)
    return o.to(q.dtype)


def _lanes_bwd_plain(q, k, v, mask, seed, g, scale, rate, nH, lse=None,
                     o=None, head0=0, heads_total=0):
    """Plain PyTorch version of ``encoder_attention_train_lanes_bwd``:
    autograd of ``_lanes_plain`` (``lse`` and ``o``, the kernel forward's
    row log-sum-exp and output, are not needed here).  Returns (dq, dk,
    dv)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = _lanes_plain(*ins, mask, seed, scale, rate, nH, head0,
                         heads_total)
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
                    lse: Optional[torch.Tensor] = None,
                    o: Optional[torch.Tensor] = None, head0: int = 0,
                    heads_total: int = 0):
    _check_lanes(q, k, v, mask, nH, "encoder_attention_train_lanes_bwd")
    if lse is None or o is None:
        raise ValueError("encoder_attention_train_lanes_bwd: the forward's "
                         "lse and output are required on the card")
    B, L, C = q.shape
    dqkv, _ = _build.attention_bwd(
        _packed(q, k, v), lse, g.contiguous().view(B * L, C), B, L, nH, scale,
        mask=mask.contiguous(), seed=seed, rate=rate,
        out=o.contiguous().view(B * L, C), head0=head0,
        heads_total=heads_total)
    d = dqkv.view(B, L, 3 * C)
    return d[..., :C], d[..., C:2 * C], d[..., 2 * C:]


encoder_attention_train_lanes_bwd = _build.KernelOp(
    "K10b encoder_attention_train_lanes_bwd", _lanes_bwd_plain,
    _lanes_bwd_cuda)


class _LanesFn(torch.autograd.Function):
    """K10a with K10b as its backward.  Saves the qkv slab, the mask, the
    rows' log-sum-exp, the output (the tensor the out-proj K11 saves too)
    and the seed tensor (never an [L, L] dropout mask); the mask gets no
    gradient (it is built from token masks, never a leaf; the JAX
    backward computes one and the model discards it)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, q, k, v, mask, seed, scale, rate, nH, head0, heads_total):
        _check_lanes(q, k, v, mask, nH, "fused_encoder_attention_train_lanes")
        B, L, C = q.shape
        qkv, mask = _packed(q, k, v), mask.contiguous()
        lse = torch.empty(B, nH, L, dtype=torch.float32, device=q.device)
        out = _build.attention(qkv, B, L, nH, scale, mask=mask, lse=lse,
                               seed=seed, rate=rate, head0=head0,
                               heads_total=heads_total)
        out = out.view(B, L, C)
        ctx.save_for_backward(qkv, mask, lse, out, seed)
        ctx.args = (scale, rate, nH, head0, heads_total)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        qkv, mask, lse, out, seed = ctx.saved_tensors
        scale, rate, nH, head0, heads_total = ctx.args
        B, L, C = g.shape
        q, k, v = qkv.view(B, L, 3 * C).split(C, dim=-1)
        dq, dk, dv = encoder_attention_train_lanes_bwd(
            q, k, v, mask, seed, g.to(qkv.dtype), scale, rate, nH, lse=lse,
            o=out, head0=head0, heads_total=heads_total)
        return dq, dk, dv, None, None, None, None, None, None, None


def _lanes_cuda(q, k, v, mask, seed, scale, rate, nH, head0=0,
                heads_total=0):
    # clamped before the cast to bf16 (the Function's under autocast, else
    # here to q's dtype), where finfo(f32).min would become -inf (the plain
    # version clamps after that cast)
    return _LanesFn.apply(q, k, v, mask.clamp_min(-1e4).to(q.dtype), seed,
                          scale, rate, nH, head0, heads_total)


fused_encoder_attention_train_lanes = _build.KernelOp(
    "K10a fused_encoder_attention_train_lanes", _lanes_plain, _lanes_cuda)


def _heads_train_plain(q, k, v, mask, seed, scale, rate, head0=0,
                       heads_total=0):
    """Plain PyTorch version of ``fused_encoder_attention_train``.

    q, k, v [B, nH, L, hd]; mask [B, L, L] additive, taken as max(mask,
    -1e4) with its gradient only above -1e4 (the JAX kernel's clamp and
    its wrapper's dmask rule); seed int64 [1]; rate the dropout of the
    probabilities (``dropout.attention_keep``: stream b * nH + h, index
    row * L + key; with a head offset, as ``_lanes_plain``), kept ones
    scaled by 1 / (1 - rate).  Scores, softmax and products in f32;
    returns [B, nH, L, hd] in q's dtype."""
    B, nH, L, _ = q.shape
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    m = mask.float()
    p = torch.softmax(s + torch.where(m > -1e4, m, -1e4)[:, None], dim=-1)
    if rate > 0.0:
        keep = dropout.attention_keep(seed, B, nH, L, rate, head0,
                                      heads_total)
        p = p * keep.float() * (1.0 / (1.0 - rate))
    return (p @ v.float()).to(q.dtype)


def _heads_train_bwd_plain(q, k, v, mask, seed, g, scale, rate, lse=None,
                           dmask=False, o=None, head0=0, heads_total=0):
    """Plain PyTorch version of ``encoder_attention_train_bwd``: autograd of
    ``_heads_train_plain`` (``lse`` and ``o``, the kernel forward's row
    log-sum-exp and output, are not needed here).  Returns (dq, dk, dv,
    dmask [B, L, L] f32 or None)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        m = mask.detach().float().requires_grad_(dmask)
        o = _heads_train_plain(*ins, m, seed, scale, rate, head0,
                               heads_total)
        got = torch.autograd.grad(o, ins + ([m] if dmask else []),
                                  g.to(o.dtype))
    return (*got[:3], got[3] if dmask else None)


def _check_heads(q, k, v, mask, what):
    if k.shape != q.shape or v.shape != q.shape or q.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be one [B, nH, L, hd] shape")
    B, _, L, _ = q.shape
    if tuple(mask.shape) != (B, L, L):
        raise ValueError(f"{what}: mask must be [{B}, {L}, {L}], got "
                         f"{tuple(mask.shape)}")


def _clamped_mask(mask):
    """The f32 [B, L, L] mask the K13 kernels read, clamped at -1e4."""
    return mask.float().clamp_min(-1e4).contiguous()


def _heads_train_bwd_cuda(q, k, v, mask, seed, g, scale, rate, lse=None,
                          dmask=False, o=None, head0=0, heads_total=0):
    _check_heads(q, k, v, mask, "encoder_attention_train_bwd")
    if lse is None or (o is None and not dmask):
        raise ValueError("encoder_attention_train_bwd: the forward's lse "
                         "(and, without dmask, its output) is required on "
                         "the card")
    m = _clamped_mask(mask)
    bf = torch.bfloat16
    dq, dk, dv, dm = _build.attention_heads_bwd(
        q.to(bf), k.to(bf), v.to(bf), g.to(bf), lse, m, scale, seed=seed,
        rate=rate, dmask=dmask, out=o, head0=head0, heads_total=heads_total)
    if dm is not None:
        dm.masked_fill_(m <= -1e4, 0.0)
    return dq, dk, dv, dm


encoder_attention_train_bwd = _build.KernelOp(
    "K13b encoder_attention_train_bwd", _heads_train_bwd_plain,
    _heads_train_bwd_cuda)


class _HeadsTrainFn(torch.autograd.Function):
    """K13a with K13b as its backward.  Casts q, k and v to bf16 itself
    and keeps the mask f32 (``custom_fwd(cast_inputs=bfloat16)`` would
    round -1e4 and take finfo(f32).min to -inf); saves q, k, v (views, in
    place), the clamped f32 mask, the rows' log-sum-exp, the output and
    the seed tensor, never an [L, L] dropout mask."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, mask, seed, scale, rate, head0, heads_total):
        _check_heads(q, k, v, mask, "fused_encoder_attention_train")
        B, nH, L, _ = q.shape
        bf = torch.bfloat16
        q, k, v, m = q.to(bf), k.to(bf), v.to(bf), _clamped_mask(mask)
        lse = torch.empty(B, nH, L, dtype=torch.float32, device=q.device)
        out = _build.attention_heads(q, k, v, m, scale, lse=lse, seed=seed,
                                     rate=rate, head0=head0,
                                     heads_total=heads_total)
        ctx.save_for_backward(q, k, v, m, lse, out, seed)
        ctx.args = (scale, rate, head0, heads_total)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        q, k, v, m, lse, out, seed = ctx.saved_tensors
        scale, rate, head0, heads_total = ctx.args
        dq, dk, dv, dm = encoder_attention_train_bwd(
            q, k, v, m, seed, g, scale, rate, lse=lse,
            dmask=ctx.needs_input_grad[3], o=out, head0=head0,
            heads_total=heads_total)
        return dq, dk, dv, dm, None, None, None, None, None


def _heads_train_cuda(q, k, v, mask, seed, scale, rate, head0=0,
                      heads_total=0):
    return _HeadsTrainFn.apply(q, k, v, mask, seed, scale, rate, head0,
                               heads_total)


fused_encoder_attention_train = _build.KernelOp(
    "K13a fused_encoder_attention_train", _heads_train_plain,
    _heads_train_cuda)
