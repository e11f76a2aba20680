"""Window-major Swin block (port of lavender_tpu/ops/swin_block_attn.py).

Layout ops of the window-major ("wm") stages — ``wm_partition``,
``wm_reverse``, ``rel_pos_bias_wm`` — as plain torch (they were plain XLA
in JAX), the cyclic shift ``wm_shift`` (the K2 kernel, ``wm_permute.py``)
and the whole-block kernel ``fused_swin_block_wm``.

``fused_swin_block_wm`` replaces the TPU kernel ``_block_kernel_wm``
(lavender_tpu/ops/swin_block_attn.py:954, host wrapper
``_fused_block_forward_wm`` :1369).  On the card it is a sequence of the
port's own kernels (``_build.py``): LN1 -> qkv GEMM (+bias) -> attention
core (rel-pos bias, shift mask) -> proj GEMM (+bias, +residual), and for
stages 1-3 LN2 -> fc1 GEMM (+bias, exact GELU) -> fc2 GEMM (+bias,
+residual).  The TPU kernel kept the slab in VMEM across those steps; here
each step reads and writes device memory once, which bounds the LN and
attention launches by bandwidth and the GEMMs by tensor-core rate.  The
TPU-only tiling (128-lane head groups, G windows per grid step, exp2
pre-scaling) has no counterpart.

Training runs the attention half (no ``mlp``) under autograd: its
backward (the JAX ``custom_vjp`` ``_wm_bwd`` :1663) recomputes LN1 -> qkv
-> the window-attention core ``swin_core_attn`` (K8a forward, K8b
backward) -> proj, with the pad rows passed through as identity
(``_wm_ref_core`` :1565), and differentiates that.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from lavender_tpu_torch.ops import _build, layer_norm
from lavender_tpu_torch.ops.swin_core_attn import swin_core_attn
from lavender_tpu_torch.ops.wm_permute import wm_shift  # noqa: F401 (K2)


def round8(n: int) -> int:
    return ((n + 7) // 8) * 8


def wm_partition(x: torch.Tensor, window: Sequence[int], Npad: int
                 ) -> torch.Tensor:
    """[B, D, H, W, C] -> window-major [B, nW, Npad, C] (tail zero-pad).

    In-window token order is row-major (d, i, j); windows are row-major
    over (H / wh, W / ww).  The temporal window equals D (window shrink)."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    nR, nWc = H // wh, W // ww
    N = wd * wh * ww
    t = x.reshape(B, D, nR, wh, nWc, ww, C).permute(0, 2, 4, 1, 3, 5, 6)
    t = t.reshape(B, nR * nWc, N, C)
    if Npad > N:
        t = F.pad(t, (0, 0, 0, Npad - N))
    return t.contiguous()


def wm_reverse(t: torch.Tensor, window: Sequence[int], D: int, H: int,
               W: int) -> torch.Tensor:
    """window-major [B, nW, >=N, C] -> [B, D, H, W, C] (drops pad rows)."""
    B, C = t.shape[0], t.shape[-1]
    wd, wh, ww = window
    nR, nWc = H // wh, W // ww
    N = wd * wh * ww
    s = t[:, :, :N].reshape(B, nR, nWc, D, wh, ww, C)
    return s.permute(0, 3, 1, 4, 2, 5, 6).reshape(B, D, H, W, C)


def rel_pos_bias_wm(table: torch.Tensor, rel_index: np.ndarray, N: int,
                    Npad: int, dtype: torch.dtype) -> torch.Tensor:
    """Tail-padded rel-pos bias [nH, Npad, Npad] gathered from ``table``
    [(2wd-1)(2wh-1)(2ww-1), nH].

    ``rel_index`` is the FULL window's relative-position index, of which
    the first N tokens are used (the reference's ``[:N, :N]`` slice when
    the window shrinks, video_swin.py:153).  Pad rows duplicate token N-1;
    pad COLUMNS are -100 (pad keys masked for every query)."""
    t = np.minimum(np.arange(Npad), N - 1)
    idx = torch.as_tensor(rel_index[t[:, None], t[None, :]].reshape(-1),
                          device=table.device)
    out = table.to(dtype).t()[:, idx].reshape(-1, Npad, Npad)
    out[:, :, N:] = -100.0
    return out.contiguous()


def pad_window_mask(mask: torch.Tensor, Npad: int) -> torch.Tensor:
    """[nW, N, N] additive shift mask -> [nW, Npad, Npad], zero-padded
    (pad keys are already -100 in the bias; pad rows are dead)."""
    N = mask.shape[-1]
    return F.pad(mask, (0, Npad - N, 0, Npad - N)).contiguous()


def _block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, nH,
                 scale, eps, mlp=None, n_valid=None):
    """Plain PyTorch version of ``fused_swin_block_wm``.

    x [B, nW, Npad, C]; wqkv [3C, C] and wproj [C, C] in torch Linear
    layout; bias [nH, Npad, Npad] (``rel_pos_bias_wm``); mask [nW, Npad,
    Npad] additive or None; mlp = (ln2_w, ln2_b, w1 [HD, C], b1, w2
    [C, HD], b2) or None.  Returns x + proj(attn(LN1(x))) (then + MLP(LN2)
    when ``mlp``).  Pad query rows hold finite garbage that the stage exit
    drops; scores and softmax in f32.  ``n_valid`` (the real rows of a
    window) is read only by the kernel's backward, which passes the pad
    rows through as identity; here autograd sees the whole slab (the pad
    rows' cotangents are zero either way)."""
    B, nW, Npad, C = x.shape
    hd = C // nH
    h = layer_norm(x, ln_w, ln_b, eps)
    qkv = F.linear(h, wqkv, bqkv).reshape(B * nW, Npad, 3, nH, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).float()  # [B*nW, nH, Npad, hd]
    s = (q * scale) @ k.transpose(-1, -2) + bias.float()
    if mask is not None:
        s = (s.reshape(B, nW, nH, Npad, Npad)
             + mask.float()[None, :, None]).reshape(B * nW, nH, Npad, Npad)
    o = torch.softmax(s, dim=-1) @ v
    o = o.to(x.dtype).transpose(1, 2).reshape(B, nW, Npad, C)
    y = x + F.linear(o, wproj, bproj)
    if mlp is not None:
        n2w, n2b, w1, b1, w2, b2 = mlp
        h2 = F.linear(layer_norm(y, n2w, n2b, eps), w1, b1)
        h2 = F.gelu(h2.float()).to(x.dtype)
        y = y + F.linear(h2, w2, b2)
    return y


def _block_cuda(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, nH,
                scale, eps, mlp=None):
    B, nW, Npad, C = x.shape
    if not x.is_contiguous():
        raise ValueError("fused_swin_block_wm: x must be contiguous")
    x2 = x.view(-1, C)
    h = _build.layernorm(x2, ln_w, ln_b, eps)
    qkv = _build.gemm(h, wqkv, bqkv)
    o = _build.attention(qkv, B * nW, Npad, nH, scale, bias=bias, mask=mask)
    y = _build.gemm(o, wproj, bproj, residual=x2)
    if mlp is not None:
        n2w, n2b, w1, b1, w2, b2 = mlp
        h2 = _build.gemm(_build.layernorm(y, n2w, n2b, eps), w1, b1,
                         gelu=True)
        y = _build.gemm(h2, w2, b2, residual=y)
    return y.view(B, nW, Npad, C)


def _block_attn_recompute(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                          mask, nH, scale, eps, N):
    """The attention half x + proj(attn(LN1(x))) as the backward recomputes
    it: the core through ``swin_core_attn`` (K8 on the card), the pad rows
    (>= N) passed through as identity (JAX ``_wm_ref_core``)."""
    B, nW, Npad, C = x.shape
    qkv = F.linear(layer_norm(x, ln_w, ln_b, eps), wqkv, bqkv)
    o = swin_core_attn(qkv, bias, mask, nH, scale)
    y = x[:, :, :N] + F.linear(o[:, :, :N], wproj, bproj)
    return torch.cat([y, x[:, :, N:]], dim=2) if Npad > N else y


class _BlockAttnFn(torch.autograd.Function):
    """K1's attention half under autograd: the kernel forward, and a
    backward that recomputes through K8 (see the module notes)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, nH,
                scale, eps, N):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                              mask)
        ctx.args = (nH, scale, eps, N)
        return _block_cuda(x.contiguous(), ln_w, ln_b, wqkv, bqkv, wproj,
                           bproj, bias.contiguous(), mask, nH, scale, eps)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        *inputs, mask = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in inputs]
            y = _block_attn_recompute(*inputs, mask, *ctx.args)
            grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None, None, None, None, None)


def _block_launch(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, nH,
                  scale, eps, mlp=None, n_valid=None):
    """The kernel; ``_BlockAttnFn`` when autograd records the call."""
    if not _build.needs_grad(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias):
        return _block_cuda(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                           mask, nH, scale, eps, mlp)
    if mlp is not None:
        raise NotImplementedError("fused_swin_block_wm: gradients flow only "
                                  "through the attention half (mlp=None)")
    return _BlockAttnFn.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                              mask, nH, scale, eps, n_valid or x.shape[2])


fused_swin_block_wm = _build.KernelOp(
    "K1 fused_swin_block_wm", _block_plain, _block_launch)


def mlp_in_block(C: int, HD: int, nH: int, Npad: int,
                 budget: int = 13 * 1024 * 1024) -> bool:
    """Whether a block's MLP runs inside ``fused_swin_block_wm`` (stages
    1-3 of Swin-B) or as the separate ``fused_ln_mlp_chunked`` (stage 4).

    The same split as the JAX package's ``full_block_fits_vmem``
    (lavender_tpu/ops/swin_block_attn.py:843), kept so that each TPU kernel
    of the path has its counterpart running."""
    attn_w = (3 * C * C + C * C) * 2
    mlp_w = 2 * C * HD * 2
    bias_b = nH * Npad * Npad * 2
    return attn_w + mlp_w + bias_b + 4 * 1024 * 1024 <= budget
