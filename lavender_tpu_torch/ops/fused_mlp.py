"""LN + MLP blocks (port of lavender_tpu/ops/fused_mlp.py).

``fused_ln_mlp`` replaces the TPU kernel ``_kernel`` (K9,
lavender_tpu/ops/fused_mlp.py:91, wrapper ``fused_ln_mlp`` :153): the
Swin MLP fc2(GELU(fc1(LN(x)))), + x with ``add_residual``, which the
train routes run after the attention half under drop-path and the
spatial serving routes after their attention.  ``fused_ln_mlp_chunked``
replaces ``_chunked_kernel`` (K3, :183, wrapper ``fused_ln_mlp_chunked``
:229): the Swin stage-4 x + fc2(GELU(fc1(LN(x)))) of serving.

On the card both are ONE C call, ``_build.ln_mlp`` (``csrc/blocks.cu``):
the row LN on 16-byte chunks (``csrc/layernorm.cu``) -> fc1 (+ bias, the
GELU's erf form) -> fc2 (+ bias, + x where there is a residual) on the
wgmma + TMA tiles of ``csrc/gemm_tc.cu``, the products the composition
K1's MLP half runs after its LN2; where 128-row tiles of fc2 would give
fewer than half the SMs a tile (K3 at B=4, M = 992) fc2 runs as f32
K-slices that the row kernel sums in order with bias and residual
(``_build.ln_mlp_plan``).  The hidden layer [M, 4C] lives in device
memory (L2 at stage 3-4), where the TPU kept it in VMEM; K3's streaming
of the 16.8 MB of stage-4 weights through VMEM in HD chunks, with the
fc2 partials summed in the bf16 output block, has no counterpart: the
products sum the whole HD in f32, so the bf16 results differ slightly
from the TPU's.  The TPU's split between K9 and K3 is a VMEM budget; the
window-major train route runs K9 at every stage, the spatial routes keep
the JAX split (``weights_fit_vmem``) as a routing predicate, so that
their launches are JAX's.  Bound on the card: the two products' 16 M
C^2 FLOPs at 989 TFLOP/s at every Swin-B stage (0.034 ms at B = 8; x and
the output once take 0.019 ms of device memory at stage 1).  The
composition adds LN(x) and the hidden layer, each written and read again
(325 MB at B = 8 stage 1), which holds stages 1-2 to the memory rate.
The backward of both is the plain recompute under autograd, as the JAX
``custom_vjp`` (:164) does.

``fused_ffn_post_ln`` replaces ``_ffn_post_ln_kernel`` (K5, :283,
wrapper ``_ffn_forward`` :304): the BERT FFN LN(x + fc2(GELU(fc1 x))),
on the card ``csrc/ffn_post_ln.cu``: fc1 (+bias, GELU) -> fc2 in f32
K-slices -> one row kernel summing the slices in order, + bias +
residual, LN.  ``ffn_plan`` picks the regime by M: at most 64 rows (the
KV decoder's step) the weights take mma.sync's 16-row side and the
tokens the 8-wide one, else 128 x 128 wgmma tiles fed by the Tensor
Memory Accelerator (``csrc/gemm_tc.cu``, shared with K1 and K4); fc2 is
cut into the fewest K-slices that give the
card's 132 SMs a block each.  Bound: the 9.4 MB of weights at M = 8, the
two products at M = B*276.

``fused_out_ln_train`` replaces ``_out_ln_train_kernel`` (K11, :505,
wrapper ``fused_out_ln_train`` :577): the train route's BERT attention
output LN(res + dropout(x W + b)); ``fused_ffn_post_ln_train`` replaces
``_ffn_post_ln_train_kernel`` (K12, :379, wrapper
``fused_ffn_post_ln_train`` :462): LN(x + dropout(fc2(GELU(fc1 x)))).
Both return the output and the bool keep mask they drew from ``seed``
(``dropout.row_keep``: the counter hash of (row, col)).  On the card K11
is one C call, ``_build.gemm_tc_dropout_ln`` (``csrc/gemm_tc.cu``): the
proj on the wgmma + TMA tiles as f32 K-slices (``gemm_tc_plan(...,
split=True)``, K4's proj) -> the row kernel's dropout mode, which sums the
slices in order with the bias, draws the same bits, scales the kept
values, adds the residual and applies the LN in f32, writing the keep
mask as one byte an element, 4 a thread; the proj is never rounded to
bf16 before the dropout (the plain version rounds F.linear's output).
K12 is one C call too, ``_build.ffn_dropout_ln`` (``csrc/ffn_post_ln.cu``):
K5's long-M products on the tile GEMM (fc1 + bias + GELU on
``gemm_tc_plan``'s tile, fc2 as ``ffn_plan``'s f32 K-slices) into K11's
dropout mode of the row kernel, with the same two deviations: fc2's sum
stays f32 into the dropout, and the GELU's erf is the tile GEMM's (to
1.5e-7).  Their backward is, as in JAX (``_out_ln_bwd`` :592,
``_ffn_train_bwd`` :477), autograd of the plain version with the saved
keep mask replayed.  Bound: K11 device memory (x, res, out, the mask),
K12 the two products.

GELU is the erf form (the TPU kernels used a clamped polynomial in bf16;
the JAX oracles use erf): erff in K5's short-M kernels, erf to 1.5e-7 by Abramowitz and Stegun 7.1.26 in ``gemm_tc.cu`` (K3, K9,
K12 and K5's long-M fc1).  K3 and K5 launch outside autograd, so
they carry the JAX custom_vjps' backward: autograd of the plain version,
recomputed from the saved inputs (``_build.RecomputeVjp``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lavender_tpu_torch.ops import _build, dropout, layer_norm

H100_SMS = _build.H100_SMS


def weights_fit_vmem(C: int, HD: int, bytes_per: int = 2,
                     budget: int = 10 * 1024 * 1024) -> bool:
    """The JAX package's VMEM gate of K9 (lavender_tpu/ops/fused_mlp.py:178),
    kept as a routing predicate of the spatial Swin routes: whether a
    block's MLP runs as ``fused_ln_mlp`` (stages 1-3 of Swin-B) or, at
    stage 4, as K3 (serving) or plain torch (training)."""
    return 2 * C * HD * bytes_per <= budget


def _mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps=1e-5, add_residual=False):
    """Plain PyTorch version of ``fused_ln_mlp``: x [M, C] ->
    fc2(GELU(fc1(LN(x)))) (+ x with ``add_residual``); w1 [HD, C], w2
    [C, HD] (torch Linear)."""
    h = F.linear(layer_norm(x, ln_w, ln_b, eps), w1, b1)
    h = F.gelu(h.float()).to(x.dtype)
    out = F.linear(h, w2, b2)
    return x + out if add_residual else out


def _ln_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps=1e-5):
    """Plain PyTorch version of ``fused_ln_mlp_chunked``: x [M, C] ->
    x + fc2(GELU(fc1(LN(x)))); w1 [HD, C], w2 [C, HD] (torch Linear)."""
    return _mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, True)


def _ln_mlp_cuda(x, ln_w, ln_b, w1, b1, w2, b2, eps=1e-5):
    return _build.ln_mlp(x, ln_w, ln_b, w1, b1, w2, b2, eps, True)


fused_ln_mlp_chunked = _build.KernelOp(
    "K3 fused_ln_mlp_chunked", _ln_mlp_plain, _ln_mlp_cuda,
    recompute_vjp=True)


def _mlp_cuda(x, ln_w, ln_b, w1, b1, w2, b2, eps=1e-5, add_residual=False):
    return _build.ln_mlp(x.contiguous(), ln_w, ln_b, w1, b1, w2, b2, eps,
                         add_residual)


fused_ln_mlp = _build.KernelOp("K9 fused_ln_mlp", _mlp_plain, _mlp_cuda,
                               recompute_vjp=True)


def _ffn_plain(x, w1, b1, w2, b2, ln_w, ln_b, eps=1e-12):
    """Plain PyTorch version of ``fused_ffn_post_ln``: x [M, C] ->
    LN(x + fc2(GELU(fc1 x))) (BERT post-LN FFN)."""
    h = F.gelu(F.linear(x, w1, b1).float()).to(x.dtype)
    return layer_norm(x + F.linear(h, w2, b2), ln_w, ln_b, eps)


class FfnPlan(NamedTuple):
    short: bool       # M <= 64: weights on the 16-row side, tokens on the 8
    splits: int       # fc2's K-slices, summed in order by the row kernel
    fc1_blocks: int
    fc2_blocks: int


@functools.lru_cache(maxsize=256)
def ffn_plan(M: int, C: int, HD: int, sms: int = H100_SMS,
             long_m: bool = False) -> FfnPlan:
    """The launch plan of ``fused_ffn_post_ln`` on the card for x [M, C],
    w1 [HD, C].  Short M: fc1 is HD / 16 blocks of 16 features, fc2 C / 16
    column blocks x ``splits``, a K-slice whole 32-wide chunks; long M:
    128 x 128 tiles, fc2's x ``splits``, a K-slice whole tile steps
    (``_build.TILE_K``, the depth of ``csrc/gemm_tc.cu``'s tiles).
    ``splits`` is the least of 1..8 that divides HD into such slices and
    gives fc2 ``sms`` blocks, else the largest such divisor.  ``long_m``
    takes the long-M regime at any M (K12's one C call has no other).
    Pure arithmetic: the kernel's wrapper checks the shapes."""
    short = M <= 64 and not long_m
    if short:
        fc1, tiles, unit = HD // 16, C // 16, 32
    else:
        bands = -(-M // 128)
        fc1, tiles = bands * -(-HD // 128), bands * -(-C // 128)
        unit = _build.TILE_K
    fits = [s for s in range(1, 9) if (HD // unit) % s == 0]
    splits = next((s for s in fits if tiles * s >= sms), fits[-1])
    return FfnPlan(short, splits, fc1, tiles * splits)


def _ffn_cuda(x, w1, b1, w2, b2, ln_w, ln_b, eps=1e-12):
    plan = ffn_plan(x.shape[0], x.shape[-1], w1.shape[0])
    return _build.ffn_post_ln(x, w1, b1, w2, b2, ln_w, ln_b, eps, plan.short,
                              plan.splits)


fused_ffn_post_ln = _build.KernelOp(
    "K5 fused_ffn_post_ln", _ffn_plain, _ffn_cuda, recompute_vjp=True)


def _dropout_residual_ln(o, res, ln_w, ln_b, keep, eps, rate):
    """LN(res + keep * o / (1 - rate)) in f32, in res's dtype."""
    o = o.float()
    if rate > 0.0:
        o = o * keep.float() * (1.0 / (1.0 - rate))
    return layer_norm(o + res.float(), ln_w, ln_b, eps).to(res.dtype)


def _out_ln_masked(x, res, w, b, ln_w, ln_b, keep, eps, rate):
    """``fused_out_ln_train`` with a given keep mask (its backward)."""
    return _dropout_residual_ln(F.linear(x, w, b), res, ln_w, ln_b, keep,
                                eps, rate)


def _out_ln_train_plain(x, res, w, b, ln_w, ln_b, seed, eps=1e-12,
                        rate=0.1):
    """Plain PyTorch version of ``fused_out_ln_train``: x, res [M, C], w
    [C, C] (torch Linear) -> (LN(res + dropout(x w^T + b)), keep [M, C]
    bool), the dropout of (row, col) from ``seed`` (int64 [1])."""
    keep = dropout.row_keep(seed, x.shape[0], w.shape[0], rate)
    return _out_ln_masked(x, res, w, b, ln_w, ln_b, keep, eps, rate), keep


class _ReplayFn(torch.autograd.Function):
    """Forward: a train kernel's launcher (returns out, keep).  Backward:
    autograd of its plain version ``masked`` with the forward's keep mask
    replayed (the JAX custom_vjp backward of K11 and K12)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, launch, masked, seed, eps, rate, *tensors):
        out, keep = launch(*(t.contiguous() for t in tensors), seed, eps,
                           rate)
        ctx.save_for_backward(keep, *tensors)
        ctx.masked, ctx.eps, ctx.rate = masked, eps, rate
        ctx.mark_non_differentiable(keep)
        return out, keep

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g, _g_keep):
        keep, *saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in saved]
            y = ctx.masked(*ins, keep, ctx.eps, ctx.rate)
            grads = torch.autograd.grad(y, ins, g)
        return (None, None, None, None, None, *grads)


def _out_ln_launch(x, res, w, b, ln_w, ln_b, seed, eps, rate):
    return _build.gemm_tc_dropout_ln(x, w, b, res, ln_w, ln_b, eps, seed,
                                     rate)


def _out_ln_train_cuda(x, res, w, b, ln_w, ln_b, seed, eps=1e-12, rate=0.1):
    return _ReplayFn.apply(_out_ln_launch, _out_ln_masked, seed, eps, rate,
                           x, res, w, b, ln_w, ln_b)


fused_out_ln_train = _build.KernelOp(
    "K11 fused_out_ln_train", _out_ln_train_plain, _out_ln_train_cuda)


def _ffn_masked(x, w1, b1, w2, b2, ln_w, ln_b, keep, eps, rate):
    """``fused_ffn_post_ln_train`` with a given keep mask (its backward)."""
    h = F.gelu(F.linear(x, w1, b1).float()).to(x.dtype)
    return _dropout_residual_ln(F.linear(h, w2, b2), x, ln_w, ln_b, keep,
                                eps, rate)


def _ffn_train_plain(x, w1, b1, w2, b2, ln_w, ln_b, seed, eps=1e-12,
                     rate=0.1):
    """Plain PyTorch version of ``fused_ffn_post_ln_train``: x [M, C] ->
    (LN(x + dropout(fc2(GELU(fc1 x)))), keep [M, C] bool), the dropout of
    (row, col) from ``seed`` (int64 [1])."""
    keep = dropout.row_keep(seed, x.shape[0], x.shape[1], rate)
    return _ffn_masked(x, w1, b1, w2, b2, ln_w, ln_b, keep, eps, rate), keep


def _ffn_train_launch(x, w1, b1, w2, b2, ln_w, ln_b, seed, eps, rate):
    splits = ffn_plan(x.shape[0], x.shape[1], w1.shape[0],
                      long_m=True).splits
    return _build.ffn_dropout_ln(x, w1, b1, w2, b2, ln_w, ln_b, eps, seed,
                                 rate, splits)


def _ffn_train_cuda(x, w1, b1, w2, b2, ln_w, ln_b, seed, eps=1e-12,
                    rate=0.1):
    return _ReplayFn.apply(_ffn_train_launch, _ffn_masked, seed, eps, rate,
                           x, w1, b1, w2, b2, ln_w, ln_b)


fused_ffn_post_ln_train = _build.KernelOp(
    "K12 fused_ffn_post_ln_train", _ffn_train_plain, _ffn_train_cuda)
