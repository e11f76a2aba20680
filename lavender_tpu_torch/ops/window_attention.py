"""Per-window attention (port of lavender_tpu/ops/window_attention.py).

``fused_window_attention`` replaces the TPU kernel ``_attn_kernel`` (K15,
lavender_tpu/ops/window_attention.py:49, wrapper ``_fused_forward`` :98):
softmax(q k^T * scale + bias[h] + mask[w % nW]) v for each (window w,
head h) on q, k, v in heads layout [W, nH, N, hd], the rel-pos bias
[nH, N, N] and the shift mask [nW, N, N] (or none).  The Swin module path
runs it under ``attn_impl="pallas"`` (``models/swin3d.py
WindowAttention3D``).

On the card it is the tensor-core forward of ``csrc/attention_fwd_tc.cu``
(K8a's and K13a's, without the lse store): a block of 4 warps per 64-row
query tile of one (window, head), 64-key tiles of K, V, the bias and the
mask streamed through a two-stage cp.async ring, S = Q K^T and O += P V
on mma.sync, the online softmax on the accumulator fragments, bias + mask
added in f32.  q, k and v arrive as strided views of the module's qkv
product and are read in place; the mask is read in the dtype it arrives
in (bf16 under the Function's autocast cast, where the shift mask's 0 and
-100 are exact; an f32 mask given outside autocast keeps its values, the
JAX kernel adding it in f32).  Bound: device memory (q, k, v, o, the bias
and the mask, each once).  Its backward is the JAX custom_vjp's (:157):
autograd of the plain version, recomputed from the saved inputs.
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


fused_window_attention = _build.KernelOp(
    "K15 fused_window_attention", window_attention_reference,
    _build.window_attention,
    recompute_vjp=True)
