"""Per-window attention (port of lavender_tpu/ops/window_attention.py).

``fused_window_attention`` replaces the TPU kernel ``_attn_kernel`` (K15,
lavender_tpu/ops/window_attention.py:49, wrapper ``_fused_forward`` :98):
softmax(q k^T * scale + bias[h] + mask[w % nW]) v for each (window w,
head h) on q, k, v in heads layout [W, nH, N, hd], the rel-pos bias
[nH, N, N] and the shift mask [nW, N, N] (or none).  The Swin module path
runs it under ``attn_impl="pallas"`` (``models/swin3d.py
WindowAttention3D``).

On the card it is the heads-layout instantiation of the port's attention
core (``csrc/attention.cu``, K7's) given a per-head bias and a per-window
f32 mask: one block per (window, head), K and V of the window in shared
memory, one query row per thread with a running max (the TPU kernel took
a plain exp after subtracting the row max too), scores never leaving
registers.  q, k and v arrive as strided views of the module's qkv
product and are read in place.  Bound: device memory (q, k, v, o, the
bias and the mask, each once) at the f32 pipes' speed of this first
version, which runs far from it.  Its backward is the JAX custom_vjp's
(:157): autograd of the plain version, recomputed from the saved inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

from lavender_tpu_torch.ops import _build


def window_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: Optional[torch.Tensor],
                               mask: Optional[torch.Tensor],
                               scale: float) -> torch.Tensor:
    """Plain PyTorch version of ``fused_window_attention`` (the JAX
    ``window_attention_reference``): q, k, v [W, nH, N, hd]; bias
    [nH, N, N] or None; mask [nW, N, N] additive or None (W a multiple of
    nW, window w takes mask[w % nW]).  Scores, softmax and the P.V sum in
    f32; returns [W, nH, N, hd] in q's dtype."""
    W, nH, N, _ = q.shape
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        nW = mask.shape[0]
        s = (s.view(W // nW, nW, nH, N, N)
             + mask.float()[None, :, None]).view(W, nH, N, N)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def _launch(q, k, v, bias, mask, scale):
    # the kernel reads the mask in f32 (the autocast cast of the Function
    # may have made it bf16; its values, 0 and -100, are exact in both)
    return _build.window_attention(
        q, k, v, None if bias is None else bias.contiguous(),
        None if mask is None else mask.float().contiguous(), scale)


fused_window_attention = _build.KernelOp(
    "K15 fused_window_attention", window_attention_reference, _launch,
    recompute_vjp=True)
