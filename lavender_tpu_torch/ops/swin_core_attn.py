"""Window-attention core with a kernel backward (port of
lavender_tpu/ops/swin_core_attn.py).

``swin_core_attn`` replaces the TPU kernel ``_core_fwd_kernel`` (K8a,
lavender_tpu/ops/swin_core_attn.py:112) and its backward
``swin_core_attn_bwd`` replaces ``_core_bwd_kernel`` (K8b, :147): o =
softmax(q k^T * scale + rel-pos bias + shift mask) v per (window, head)
on the packed qkv slab [B, nW, Npad, 3C], and its vjp.  The K1 block's
backward recomputes through it (``swin_block_attn._block_attn_recompute``,
the JAX ``_wm_ref_core``).

On the card both run on wgmma + TMA: K8a is ``csrc/attention_fwd_wgmma.cu``
(a CTA a (window, head), its K and V whole in shared memory, two
warpgroups over its 64-row query tiles, the bias and mask tiles by TMA
where their rows are 16-byte aligned), which also writes each query row's
log-sum-exp; K8b is the bias instance of ``csrc/attention_bwd_wgmma.cu``'s
backward (one pass of five products a tile pair, dQ summed across key
tiles in a fixed order) and its dbias kernel, which take the lse instead
of recomputing the row sums and D = rowsum(o * g) from the forward's
output (which the autograd Function saves: the proj that follows holds it
anyway).  ``_build.attention_fwd_plan`` and ``attention_bwd_plan(...,
bias=True)`` size both and raise where they do not run.  Scores and
probabilities stay on chip in both directions; device memory sees the
qkv, output and cotangent slabs and the [nH, Npad, Npad] dbias.  dbias is
summed over every (batch, window) in f32, in chunks of sequences added in
a fixed order; the mask's cotangent is zero (it is geometry).  Pad keys
must carry a strongly negative bias (``rel_pos_bias_wm`` writes -100), as
in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from lavender_tpu_torch.ops import _build


def _core_plain(qkv: torch.Tensor, bias: torch.Tensor,
                mask: Optional[torch.Tensor], nH: int,
                scale: float) -> torch.Tensor:
    """Plain PyTorch version of ``swin_core_attn``.

    qkv [B, nW, Npad, 3C] (q | k | v, heads h*hd.. within each); bias
    [nH, Npad, Npad]; mask [nW, Npad, Npad] additive or None.  Scores and
    softmax in f32; returns [B, nW, Npad, C] in qkv's dtype."""
    B, nW, Npad, C3 = qkv.shape
    C = C3 // 3
    hd = C // nH
    q, k, v = qkv.reshape(B * nW, Npad, 3, nH, hd).permute(2, 0, 3, 1, 4)
    s = (q.float() * scale) @ k.float().transpose(-1, -2) + bias.float()
    if mask is not None:
        s = (s.reshape(B, nW, nH, Npad, Npad)
             + mask.float()[None, :, None]).reshape(B * nW, nH, Npad, Npad)
    o = torch.softmax(s, dim=-1) @ v.float()
    return o.to(qkv.dtype).transpose(1, 2).reshape(B, nW, Npad, C)


def _core_bwd_plain(qkv: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                    bias: torch.Tensor, mask: Optional[torch.Tensor], nH: int,
                    scale: float, out: Optional[torch.Tensor] = None):
    """Plain PyTorch version of ``swin_core_attn_bwd``: autograd of
    ``_core_plain``.  ``lse`` and ``out`` (the kernel forward's row
    log-sum-exp and output) are not needed here.  Returns (dqkv in qkv's
    dtype, dbias f32)."""
    with torch.enable_grad():
        q = qkv.detach().requires_grad_(True)
        b = bias.detach().float().requires_grad_(True)
        o = _core_plain(q, b, mask, nH, scale)
        dq, db = torch.autograd.grad(o, (q, b), dout.to(o.dtype))
    return dq, db


def _core_bwd_cuda(qkv, lse, dout, bias, mask, nH, scale, out=None):
    B, nW, Npad, C3 = qkv.shape
    if out is None:
        raise ValueError("swin_core_attn_bwd: the forward's output is "
                         "required on the card")
    dqkv, dbias = _build.attention_bwd(
        qkv.reshape(-1, C3), lse, dout.contiguous().reshape(-1, C3 // 3),
        B * nW, Npad, nH, scale, out.contiguous().reshape(-1, C3 // 3),
        bias=bias, mask=mask)
    return dqkv.view(qkv.shape), dbias


swin_core_attn_bwd = _build.KernelOp(
    "K8b swin_core_attn_bwd", _core_bwd_plain, _core_bwd_cuda)


class _CoreFn(torch.autograd.Function):
    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, qkv, bias, mask, nH, scale):
        B, nW, Npad, C3 = qkv.shape
        qkv, bias = qkv.contiguous(), bias.contiguous()
        lse = torch.empty(B * nW, nH, Npad, dtype=torch.float32,
                          device=qkv.device)
        out = _build.attention(qkv.view(-1, C3), B * nW, Npad, nH, scale,
                               bias=bias, mask=mask, lse=lse)
        out = out.view(B, nW, Npad, C3 // 3)
        ctx.save_for_backward(qkv, bias, mask, lse, out)
        ctx.nH, ctx.scale = nH, scale
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        qkv, bias, mask, lse, out = ctx.saved_tensors
        dqkv, dbias = swin_core_attn_bwd(qkv, lse, g.to(qkv.dtype), bias,
                                         mask, ctx.nH, ctx.scale, out=out)
        return dqkv, dbias.to(bias.dtype), None, None, None


def _core_cuda(qkv, bias, mask, nH, scale):
    return _CoreFn.apply(qkv, bias, mask, nH, scale)


swin_core_attn = _build.KernelOp("K8a swin_core_attn", _core_plain,
                                 _core_cuda)
