"""Swin blocks (port of lavender_tpu/ops/swin_block_attn.py): the
window-major block K1 and the spatial block K14.

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
+residual), all from one C call (``_build.swin_block_wm``,
``csrc/blocks.cu``).  The GEMMs run on the wgmma + TMA tiles of
``csrc/gemm_tc.cu``, the core on the tensor-core forward of
``csrc/attention_fwd_tc.cu`` (K8a's bias variant without the lse store,
which the call selects).  The TPU kernel kept the
slab in VMEM across those steps; here each step reads and writes device
memory once, which bounds the LN launches and the stage 1-2 products by
bandwidth and the stage 3-4 products by tensor-core rate.  The TPU-only
tiling (128-lane head groups, G windows per grid step, exp2 pre-scaling)
has no counterpart.

``folded`` (serving only, never under autograd): the LN1 affine (and,
with ``mlp``, the LN2 affine) already folded into the qkv (and fc1)
weights by the serving fold cache (JAX ``foldfn``, models/swin3d.py:1073,
used by ``_fused_block_forward_wm(..., folded=)`` :1369); the LN launches
then apply the pure normalize only.

Training runs the attention half (no ``mlp``) under autograd: its
backward (the JAX ``custom_vjp`` ``_wm_bwd`` :1663) recomputes LN1 -> qkv
-> the window-attention core ``swin_core_attn`` (K8a forward, K8b
backward) -> proj, with the pad rows passed through as identity
(``_wm_ref_core`` :1565), and differentiates that.  The whole block under
autograd (a model in ``eval()`` mode whose gradients are taken)
differentiates its plain version.

``fused_swin_block_attn`` and ``fused_swin_block_full`` replace the TPU
kernel ``_block_kernel`` (K14, :468, host wrapper ``_fused_block_forward``
:565, entries :746 / :798): x + proj(window_attn(LN1(x))), and in the full
variant + fc2(GELU(fc1(LN2(.)))), on the SPATIAL layout x [B, D, H, W, C]
of the ``attn_impl="fused"`` stages (and of every stage that the wm route
refuses).  The TPU kernel cut the rolled, 7 -> 8 lane-padded map into
(batch, window-row) slabs by its BlockSpec.  On the card it is ONE C call
(``_build.swin_block_spatial``, ``csrc/blocks.cu``), K1's composition with
one int32 row index (``window_rows``: window row -> spatial row, with the
cyclic roll folded in): the 16-byte-chunk LN1 gathers its input rows by
it, so the window-major rows exist only as LN1's output, and the proj's
scatter epilogue on the wgmma + TMA tile GEMM (``csrc/gemm_tc.cu``)
writes each row back by it, adding the residual it reads at the same
spatial row.  Between the two run the qkv product and the attention core
on the tensor cores (``csrc/attention_fwd_tc.cu``, K1's bias variant) on
N = D*wh*ww tokens a window (no pad rows, no lane pad, no exp2
pre-scale, no head groups), the bias and mask read at their row pitch
(the serving cache keeps them in rows padded to 16 bytes).  The MLP of
the full variant is pointwise, so it runs on the spatial rows: K3's path
(the chunk LN2, fc1 + GELU and fc2 + residual on the tile GEMM, plan
``_build.swin_spatial_plan``).  Bound: the products' tensor-core rate at
stages 3-4, device memory at stages 1-2 (x once on the way in and the
output once on the way out, plus the LN, qkv, attention and hidden slabs
written and read again).  The bias is the reference's: the FULL
window's relative-position index sliced ``[:N, :N]`` (the wm path's
``rel_pos_bias_wm`` without pad rows); the shift mask is the finite -100
of ``compute_shift_mask``.  Backward: the attention half recomputes the
gather -> LN1 -> qkv -> ``swin_core_attn`` (K8a / K8b) -> proj -> scatter
under autograd (the JAX custom_vjp recomputes its XLA reference, :786);
the full variant differentiates its plain version (``_full_bwd`` :834).

``fused_swin_block_wm_shifted`` replaces the TPU kernel
``_block_kernel_wm_shift`` (K16, :1137, wrapper
``fused_swin_block_wm_shifted`` :1290): the SHIFTED attention half of a wm
block pair with the cyclic shift inside, ``wm_shift^-1(x' + proj(attn(
LN1(x'))))`` for ``x' = wm_shift(x)``, input and output in the UNSHIFTED
window-major layout, the output's window pad rows zero.  The TPU kernel
held the whole window axis of a clip in VMEM and moved rows through a
static run decomposition; on the card it is K14's one C call
(``_build.swin_block_spatial(..., pad_zero=True)``) on the window-major
slab, n_tok = Npad, with the wm shift's row index
(``_batch_shift_rows``: -1 at the window's tail-pad rows): the chunk LN1
gathers its rows through it (a zero row at -1, the TPU kernel's literal
zero pad rows), the qkv product, the tensor-core core with the bias and
padded shift mask at pitch Npad, and the proj's scatter epilogue writing
each row back through the same index with the residual added.  The shift
maps valid rows onto valid rows and leaves each pad row where it is, so
the rows whose index is -1 are exactly the output's pad rows: the
epilogue's zeroing instance writes zeros there, with no launch of its
own.  So neither shifted copy of the slab (K2's two permutes) is
written.  Bound: as K1's attention half, the products' tensor-core rate
and the core.  Backward (the JAX ``_wms_bwd`` :1313 differentiates
``_wm_shifted_ref``): ``wm_shift`` (K2) -> ``_block_attn_recompute``
(through K8a / K8b) -> ``wm_shift^-1``, under autograd.
"""
from __future__ import annotations

from typing import Sequence
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lavender_tpu_torch.ops import _build, layer_norm
from lavender_tpu_torch.ops.fused_mlp import _mlp_plain
from lavender_tpu_torch.ops.swin_core_attn import swin_core_attn
from lavender_tpu_torch.ops.window_attention import (
    window_attention_reference)
from lavender_tpu_torch.ops.wm_permute import (  # noqa: F401 (K2)
    _permute_plain, shift_indices, wm_shift, wm_shift_rows)


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


def rel_pos_bias_rows(table: torch.Tensor, rel_index: np.ndarray, N: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """The spatial routes' rel-pos bias [nH, N, N] in ``dtype``
    (``rel_pos_bias_wm`` without pad rows), its rows ld elements apart, ld
    = N rounded up to 16 bytes (``_build.padded_rows``' pitch, which the
    tensor-core forward stages with its widest copies): the view [:, :, :N]
    of one gather into [nH, N, ld] whose pad columns repeat column N - 1,
    in the table's dtype (under autograd its gradient sums there), then
    cast, so that no copy pads the rows."""
    per = 16 // dtype.itemsize
    ld = -(-N // per) * per
    cols = np.minimum(np.arange(ld), N - 1)
    idx = torch.as_tensor(rel_index[:N, cols].reshape(-1),
                          device=table.device)
    return table.t()[:, idx].reshape(-1, N, ld).to(dtype)[:, :, :N]


def pad_window_mask(mask: torch.Tensor, Npad: int) -> torch.Tensor:
    """[nW, N, N] additive shift mask -> [nW, Npad, Npad], zero-padded
    (pad keys are already -100 in the bias; pad rows are dead)."""
    N = mask.shape[-1]
    return F.pad(mask, (0, Npad - N, 0, Npad - N)).contiguous()


def _fold_in(ln_w, ln_b, wqkv, bqkv, mlp, folded):
    """The block's LN1 affine, qkv weights and MLP with ``folded`` =
    (wqkv', bqkv', w1', b1') substituted: no LN affine, the folded qkv
    and fc1 (the pure normalize of the serving fold cache)."""
    if folded is None:
        return ln_w, ln_b, wqkv, bqkv, mlp
    wqkv, bqkv, w1, b1 = folded
    if mlp is not None:
        mlp = (None, None, w1, b1, mlp[4], mlp[5])
    return None, None, wqkv, bqkv, mlp


def _block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, nH,
                 scale, eps, mlp=None, n_valid=None, folded=None):
    """Plain PyTorch version of ``fused_swin_block_wm``.

    x [B, nW, Npad, C]; wqkv [3C, C] and wproj [C, C] in torch Linear
    layout; bias [nH, Npad, Npad] (``rel_pos_bias_wm``); mask [nW, Npad,
    Npad] additive or None; mlp = (ln2_w, ln2_b, w1 [HD, C], b1, w2
    [C, HD], b2) or None.  Returns x + proj(attn(LN1(x))) (then + MLP(LN2)
    when ``mlp``).  Pad query rows hold finite garbage that the stage exit
    drops; scores and softmax in f32.  ``n_valid`` (the real rows of a
    window) is read only by the kernel's backward, which passes the pad
    rows through as identity; here autograd sees the whole slab (the pad
    rows' cotangents are zero either way).  ``folded`` = (wqkv' [3C, C],
    bqkv', w1' [HD, C], b1') replaces the LN affines and the qkv / fc1
    weights (see the module notes)."""
    ln_w, ln_b, wqkv, bqkv, mlp = _fold_in(ln_w, ln_b, wqkv, bqkv, mlp,
                                           folded)
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
    y = _build.swin_block_wm(x.view(-1, C), ln_w, ln_b, wqkv, bqkv, wproj,
                             bproj, bias, mask, B * nW, Npad, nH, scale, eps,
                             mlp)
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


def _block_full_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                      n2_w, n2_b, w1, b1, w2, b2, nH, scale, eps):
    return _block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                        nH, scale, eps, mlp=(n2_w, n2_b, w1, b1, w2, b2))


def _block_full_cuda(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                     n2_w, n2_b, w1, b1, w2, b2, nH, scale, eps):
    return _block_cuda(x.contiguous(), ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                       bias.contiguous(), mask, nH, scale, eps,
                       mlp=(n2_w, n2_b, w1, b1, w2, b2))


def _block_launch(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, nH,
                  scale, eps, mlp=None, n_valid=None, folded=None):
    """The kernel; under autograd ``_BlockAttnFn`` (the attention half), or
    with ``mlp`` the whole block in ``RecomputeVjp`` (the JAX custom_vjp
    ``_wm_full_bwd`` :1712 differentiates its reference).  ``folded`` is
    serving-only: under autograd it raises (the folded weights are no
    parameters)."""
    grad = _build.needs_grad(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                             *(mlp or ()), *(folded or ()))
    if folded is not None:
        if grad:
            raise ValueError("fused_swin_block_wm: the folded weights are "
                             "serving-only (no gradient)")
        ln_w, ln_b, wqkv, bqkv, mlp = _fold_in(ln_w, ln_b, wqkv, bqkv, mlp,
                                               folded)
    if not grad:
        *tensors, mlp = _build.autocast_inputs(
            x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, mlp)
        return _block_cuda(*tensors, nH, scale, eps, mlp)
    if mlp is not None:
        return _build.RecomputeVjp.apply(
            _block_full_cuda, _block_full_plain, x, ln_w, ln_b, wqkv, bqkv,
            wproj, bproj, bias, mask, *mlp, nH, scale, eps)
    return _BlockAttnFn.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                              mask, nH, scale, eps, n_valid or x.shape[2])


fused_swin_block_wm = _build.KernelOp(
    "K1 fused_swin_block_wm", _block_plain, _block_launch)


# --------------------------------------------------------------------------
# K16: the shifted wm attention half with the cyclic shift inside.
# --------------------------------------------------------------------------


def supports_inkernel_shift(window, spatial, Npad: int, C: int, nH: int,
                            nW: int, dtype_size: int = 2) -> bool:
    """Whether a shifted wm block takes K16 (JAX ``supports_inkernel_shift``,
    ops/swin_block_attn.py:1259, kept as a routing predicate): the temporal
    window covers D, the window tiles H and W, at most 4 windows a clip (the
    TPU kernel's unroll bound) and the TPU kernel's 11 MiB VMEM budget."""
    D, H, W = spatial
    wd, wh, ww = window
    if wd != D or H % wh or W % ww or Npad % 8:
        return False
    if nW > 4:
        return False
    weights = (4 * C * C) * dtype_size
    bias_b = nH * Npad * Npad * dtype_size
    mask_b = nW * Npad * Npad * dtype_size
    slabs = 4 * nW * Npad * C * dtype_size
    return weights + bias_b + mask_b + slabs <= 11 * 1024 * 1024


def _shifted_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                   spatial, window, shift, nH, scale, eps):
    """Plain PyTorch version of ``fused_swin_block_wm_shifted`` (JAX
    ``_wm_shifted_ref``): the shift, ``fused_swin_block_wm``'s plain
    attention half, the inverse shift, on x [B, nW, Npad, C] unshifted
    window-major; bias [nH, Npad, Npad]; mask [nW, Npad, Npad] the padded
    shift mask.  The output's pad rows are zero (the inverse shift's)."""
    D, H, W = spatial
    fwd, inv = shift_indices(window, D, H, W, x.shape[2], shift, x.device)
    xs = _permute_plain(x, fwd, inv)
    ys = _block_plain(xs, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                      nH, scale, eps)
    return _permute_plain(ys, inv, fwd)


_batch_rows_on_device: Dict[tuple, torch.Tensor] = {}


def _batch_shift_rows(B: int, index: torch.Tensor) -> torch.Tensor:
    """int32 [B * R]: row b * R + index[r] of a [B * R, C] slab, -1 where
    index[r] < 0; built once per (B, index), outside inference mode.  For
    the wm shift's index (R = nW * Npad) the -1 entries are exactly the
    slab's pad rows w * Npad + r, r >= N (K16 zeroes its output there)."""
    key = (B, index.data_ptr(), str(index.device))
    if key not in _batch_rows_on_device:
        R = index.shape[0]
        with torch.inference_mode(False):
            off = torch.arange(B, device=index.device, dtype=torch.int32)
            rows = (off[:, None] * R + index[None]).reshape(-1)
            _batch_rows_on_device[key] = torch.where(
                index[None].expand(B, R).reshape(-1) >= 0, rows,
                torch.full_like(rows, -1)).contiguous()
    return _batch_rows_on_device[key]


def _shifted_cuda(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                  spatial, window, shift, nH, scale, eps):
    """K16 on the card: K14's one C call on the window-major slab (the
    gathering chunk LN1 -> qkv -> the tensor-core core -> the proj's
    zeroing scatter + residual), the wm shift's row index in."""
    B, nW, Npad, C = x.shape
    D, H, W = spatial
    fwd, _ = shift_indices(window, D, H, W, Npad, shift, x.device)
    x2 = x.contiguous().view(-1, C)
    out = _build.swin_block_spatial(
        x2, _batch_shift_rows(B, fwd), ln_w, ln_b, wqkv, bqkv, wproj, bproj,
        bias.contiguous(), mask.contiguous(), B * nW, Npad, nH, scale, eps,
        pad_zero=True)
    return out.view(B, nW, Npad, C)


def _shifted_recompute(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                       spatial, window, shift, nH, scale, eps):
    """K16 as its backward recomputes it: ``wm_shift_rows`` (K2) ->
    ``_block_attn_recompute`` (the core through K8) -> the inverse shift."""
    D, H, W = spatial
    fwd, inv = shift_indices(window, D, H, W, x.shape[2], shift, x.device)
    ys = _block_attn_recompute(wm_shift_rows(x, fwd, inv), ln_w, ln_b, wqkv,
                               bqkv, wproj, bproj, bias, mask, nH, scale, eps,
                               int(np.prod(window)))
    return wm_shift_rows(ys, inv, fwd)


class _BlockShiftFn(torch.autograd.Function):
    """K16 under autograd: the kernel forward, and a backward that
    recomputes K2 -> the attention half through K8 -> K2^-1 (see the module
    notes)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                spatial, window, shift, nH, scale, eps):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                              mask)
        ctx.args = (spatial, window, shift, nH, scale, eps)
        return _shifted_cuda(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                             mask, spatial, window, shift, nH, scale, eps)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        *inputs, mask = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in inputs]
            y = _shifted_recompute(*inputs, mask, *ctx.args)
            grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None, None, None, None, None, None, None)


def _shifted_launch(x, *args):
    """The kernel; ``_BlockShiftFn`` when autograd records the call."""
    if not _build.needs_grad(x, *args):
        return _shifted_cuda(*_build.autocast_inputs(x, *args))
    return _BlockShiftFn.apply(x, *args)


fused_swin_block_wm_shifted = _build.KernelOp(
    "K16 fused_swin_block_wm_shifted", _shifted_plain, _shifted_launch)


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


# --------------------------------------------------------------------------
# The spatial layout: the module path's helpers and K14.
# --------------------------------------------------------------------------


def window_partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """[B, D, H, W, C] -> [B * nW, wd * wh * ww, C]: windows in (b, d, h, w)
    order (window w of a clip takes the shift mask's row w), tokens
    row-major (d, i, j) inside (JAX ``window_partition``, swin3d.py:74)."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    t = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return t.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, C)


def window_reverse(windows: torch.Tensor, window: Sequence[int], B: int,
                   D: int, H: int, W: int) -> torch.Tensor:
    """[B * nW, N, C] -> [B, D, H, W, C] (JAX ``window_reverse``, :82)."""
    wd, wh, ww = window
    t = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    return t.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def window_msa(x: torch.Tensor, wqkv: torch.Tensor,
               bqkv: Optional[torch.Tensor], wproj: torch.Tensor,
               bproj: torch.Tensor, bias: torch.Tensor,
               mask: Optional[torch.Tensor], nH: int, scale: float,
               core: Callable = window_attention_reference) -> torch.Tensor:
    """Window multi-head self-attention of windows x [B * nW, N, C]: qkv
    -> heads [B * nW, nH, N, hd] -> ``core(q, k, v, bias, mask, scale)``
    -> proj (JAX ``WindowAttention3D``, swin3d.py:340; ``core`` is the
    plain attention, or K15 under ``attn_impl="pallas"``)."""
    B_, N, C = x.shape
    qkv = F.linear(x, wqkv, bqkv).reshape(B_, N, 3, nH, C // nH)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = core(q, k, v, bias, mask, scale)
    return F.linear(o.transpose(1, 2).reshape(B_, N, C), wproj, bproj)


@functools.lru_cache(maxsize=64)
def window_rows(D: int, H: int, W: int, window: Tuple[int, int, int],
                shift: Tuple[int, int, int]) -> np.ndarray:
    """int32 [D * H * W]: the spatial row (d * H * W + h * W + w) of every
    window row of one clip, windows in ``window_partition`` order, after
    the cyclic roll by -shift (``roll(x, -s)[c] == x[(c + s) % size]``).
    A permutation: the block gathers its LN1 input by it and scatters its
    output back by it, which also undoes the roll."""
    wd, wh, ww = window
    cd, ch, cw = np.meshgrid(np.arange(D), np.arange(H), np.arange(W),
                             indexing="ij")
    src = (((cd + shift[0]) % D) * H + (ch + shift[1]) % H) * W \
        + (cw + shift[2]) % W
    t = src.reshape(D // wd, wd, H // wh, wh, W // ww, ww)
    return t.transpose(0, 2, 4, 1, 3, 5).reshape(-1).astype(np.int32)


_rows_on_device: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _device_rows(B: int, D: int, H: int, W: int, window, shift, device):
    """(rows int32 [B * L], inverse int64 [B * L]) of ``window_rows`` over
    a batch (row b * L + r, L = D * H * W) on ``device``, built once, outside
    inference mode (a training step may save them for its backward)."""
    key = (B, D, H, W, tuple(window), tuple(shift), str(device))
    if key not in _rows_on_device:
        L = D * H * W
        rows = window_rows(D, H, W, tuple(window), tuple(shift))
        full = (np.arange(B)[:, None] * L + rows[None]).reshape(-1)
        inv = np.empty_like(full)
        inv[full] = np.arange(full.size)
        with torch.inference_mode(False):
            _rows_on_device[key] = (
                torch.as_tensor(full.astype(np.int32), device=device),
                torch.as_tensor(inv.astype(np.int64), device=device))
    return _rows_on_device[key]


def _spatial_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                   window, shift, nH, scale, eps, mlp=None):
    """Plain PyTorch version of K14 (JAX ``swin_block_attn_reference`` and
    ``_full_ref``): x [B, D, H, W, C] -> x + proj(attn(LN1(x))) in rolled
    windows, rolled back (then + MLP(LN2(.)) with ``mlp`` = (ln2_w, ln2_b,
    w1, b1, w2, b2)).  Weights in torch Linear layout; bias [nH, N, N]
    (N = wd * wh * ww); mask [nW, N, N] additive (the shift mask) or
    None.  The window must tile the map (``supports_fused_block``)."""
    B, D, H, W, C = x.shape
    h = layer_norm(x, ln_w, ln_b, eps)
    shifted = any(s > 0 for s in shift)
    if shifted:
        h = torch.roll(h, tuple(-s for s in shift), (1, 2, 3))
    o = window_msa(window_partition(h, window), wqkv, bqkv, wproj, bproj,
                   bias, mask, nH, scale)
    o = window_reverse(o, window, B, D, H, W)
    if shifted:
        o = torch.roll(o, tuple(shift), (1, 2, 3))
    y = x + o.to(x.dtype)
    if mlp is not None:
        y = _mlp_plain(y.reshape(-1, C), *mlp, eps, True).reshape(y.shape)
    return y


def _spatial_cuda(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                  window, shift, nH, scale, eps, mlp=None):
    """K14 on the card: the one C call of ``_build.swin_block_spatial``
    (gathered LN1 -> qkv -> the tensor-core core -> proj scattered into the
    spatial rows + residual [-> LN2 + MLP + residual])."""
    B, D, H, W, C = x.shape
    N = int(np.prod(window))
    rows, _ = _device_rows(B, D, H, W, window, shift, x.device)
    x2 = x.contiguous().view(-1, C)
    y = _build.swin_block_spatial(x2, rows, ln_w, ln_b, wqkv, bqkv, wproj,
                                  bproj, bias, mask, x2.shape[0] // N, N, nH,
                                  scale, eps, mlp)
    return y.view(B, D, H, W, C)


def _spatial_attn_recompute(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                            mask, window, shift, nH, scale, eps):
    """K14's attention half as its backward recomputes it: the gather by
    ``window_rows`` -> LN1 -> qkv -> ``swin_core_attn`` (K8a, whose
    backward is K8b, on the card) -> proj -> the inverse gather, + x."""
    B, D, H, W, C = x.shape
    N = int(np.prod(window))
    rows, inv = _device_rows(B, D, H, W, window, shift, x.device)
    h = layer_norm(x, ln_w, ln_b, eps).reshape(-1, C)
    qkv = F.linear(h.index_select(0, rows.long()), wqkv, bqkv)
    if mask is not None:  # K8 reads the mask's rows at N's own pitch
        mask = mask.contiguous()
    o = swin_core_attn(qkv.view(B, -1, N, 3 * C), bias, mask, nH, scale)
    o = F.linear(o.reshape(-1, C), wproj, bproj).index_select(0, inv)
    return x + o.view_as(x).to(x.dtype)


class _SpatialAttnFn(torch.autograd.Function):
    """K14's attention half under autograd: the kernel forward, and a
    backward that recomputes through K8 (``_spatial_attn_recompute``)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                window, shift, nH, scale, eps):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                              mask)
        ctx.args = (window, shift, nH, scale, eps)
        return _spatial_cuda(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                             mask, window, shift, nH, scale, eps)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        *inputs, mask = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in inputs]
            y = _spatial_attn_recompute(*inputs, mask, *ctx.args)
            grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None, None, None, None, None, None)


def _attn_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, window,
                shift, nH, scale, eps):
    """Plain PyTorch version of ``fused_swin_block_attn``: see
    ``_spatial_plain`` (no MLP)."""
    return _spatial_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                          mask, window, shift, nH, scale, eps)


def _attn_launch(x, *args):
    """The kernel; ``_SpatialAttnFn`` when autograd records the call."""
    if not _build.needs_grad(x, *args):
        return _spatial_cuda(x, *args)
    return _SpatialAttnFn.apply(x, *args)


fused_swin_block_attn = _build.KernelOp(
    "K14 fused_swin_block_attn", _attn_plain, _attn_launch)


def _full_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, n2_w,
                n2_b, w1, b1, w2, b2, window, shift, nH, scale, eps):
    """Plain PyTorch version of ``fused_swin_block_full``: see
    ``_spatial_plain``, with the MLP (w1 [HD, C], w2 [C, HD])."""
    return _spatial_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias,
                          mask, window, shift, nH, scale, eps,
                          mlp=(n2_w, n2_b, w1, b1, w2, b2))


def _full_launch(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, n2_w,
                 n2_b, w1, b1, w2, b2, window, shift, nH, scale, eps):
    return _spatial_cuda(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                         window, shift, nH, scale, eps,
                         mlp=(n2_w, n2_b, w1, b1, w2, b2))


fused_swin_block_full = _build.KernelOp(
    "K14 fused_swin_block_full", _full_plain, _full_launch,
    recompute_vjp=True)
