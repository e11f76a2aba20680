"""LN + MLP blocks (port of lavender_tpu/ops/fused_mlp.py).

``fused_ln_mlp`` replaces the TPU kernel ``_kernel`` (K9,
lavender_tpu/ops/fused_mlp.py:91, wrapper ``fused_ln_mlp`` :153): the
Swin MLP fc2(GELU(fc1(LN(x)))) without the residual, which the train
route runs after the attention half under drop-path.  On the card it is
the launcher of K3 without its residual epilogue: LN -> fc1 GEMM (+bias,
exact GELU) -> fc2 GEMM (+bias).  The TPU split between weights resident
in VMEM (K9) and streamed in HD chunks (K3) is a VMEM budget with no
counterpart on the card, so K9 runs at every stage.  Bound: the two
GEMMs' tensor-core rate at M = B*nW*Npad rows.  Its backward is the plain
recompute under autograd, as the JAX ``custom_vjp`` (:164) does.

``fused_ln_mlp_chunked`` replaces the TPU kernel ``_chunked_kernel``
(lavender_tpu/ops/fused_mlp.py:183, wrapper ``fused_ln_mlp_chunked``
:229): the Swin stage-4 x + fc2(GELU(fc1(LN(x)))).  The TPU streamed the
16.8 MB of stage-4 weights through VMEM in HD chunks and accumulated the
fc2 partials in the bf16 output block; here it is LN -> fc1 GEMM (+bias,
exact GELU) -> fc2 GEMM (+bias, +residual) with f32 accumulation over the
whole HD in one pass, so the bf16 results differ slightly from the TPU's.
Bound on the card: tensor-core rate of the two GEMMs (M = B*248 rows is
short, so the fc1 grid of 128x128 tiles only partly fills the card).

``fused_ffn_post_ln`` replaces ``_ffn_post_ln_kernel`` (:283, wrapper
``_ffn_forward`` :304): the BERT FFN LN(x + fc2(GELU(fc1 x))), as fc1
GEMM (+bias, GELU) -> fc2 GEMM (+bias, +residual) -> LN.  Bound: the
GEMMs at M = B*276 rows, again too short for full occupancy.

``fused_out_ln_train`` replaces ``_out_ln_train_kernel`` (K11, :505,
wrapper ``fused_out_ln_train`` :577): the train route's BERT attention
output LN(res + dropout(x W + b)); ``fused_ffn_post_ln_train`` replaces
``_ffn_post_ln_train_kernel`` (K12, :379, wrapper
``fused_ffn_post_ln_train`` :462): LN(x + dropout(fc2(GELU(fc1 x)))).
Both return the output and the bool keep mask they drew from ``seed``
(``dropout.row_keep``: the counter hash of (row, col)).  On the card K11 is
the proj GEMM (+bias) and K12 the fc1 GEMM (+bias, GELU) -> fc2 GEMM
(+bias), each followed by the row kernel ``dropout_add_ln``
(``csrc/layernorm.cu``: dropout, + residual, LN in f32, the keep mask
written as one byte per element).  Their backward is, as in JAX
(``_out_ln_bwd`` :592, ``_ffn_train_bwd`` :477), autograd of the plain
version with the saved keep mask replayed.  Bound: K11 device memory (x,
res, out, the mask), K12 the two GEMMs.

GELU is the exact erf form (the TPU kernels used a clamped polynomial in
bf16; the JAX oracles use erf).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from lavender_tpu_torch.ops import _build, dropout, layer_norm


def _mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps=1e-5):
    """Plain PyTorch version of ``fused_ln_mlp``: x [M, C] ->
    fc2(GELU(fc1(LN(x)))); w1 [HD, C], w2 [C, HD] (torch Linear)."""
    h = F.linear(layer_norm(x, ln_w, ln_b, eps), w1, b1)
    h = F.gelu(h.float()).to(x.dtype)
    return F.linear(h, w2, b2)


def _ln_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps=1e-5):
    """Plain PyTorch version of ``fused_ln_mlp_chunked``: x [M, C] ->
    x + fc2(GELU(fc1(LN(x)))); w1 [HD, C], w2 [C, HD] (torch Linear)."""
    return x + _mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)


def _ln_mlp_cuda(x, ln_w, ln_b, w1, b1, w2, b2, eps=1e-5, residual=True):
    h = _build.gemm(_build.layernorm(x, ln_w, ln_b, eps), w1, b1, gelu=True)
    return _build.gemm(h, w2, b2, residual=x if residual else None)


fused_ln_mlp_chunked = _build.KernelOp(
    "K3 fused_ln_mlp_chunked", _ln_mlp_plain, _ln_mlp_cuda)


class _MlpFn(torch.autograd.Function):
    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.eps = eps
        return _ln_mlp_cuda(x.contiguous(), ln_w, ln_b, w1, b1, w2, b2, eps,
                            residual=False)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            y = _mlp_plain(*inputs, ctx.eps)
            grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None)


def _mlp_cuda(x, ln_w, ln_b, w1, b1, w2, b2, eps=1e-5):
    if not _build.needs_grad(x, ln_w, ln_b, w1, b1, w2, b2):
        return _ln_mlp_cuda(x, ln_w, ln_b, w1, b1, w2, b2, eps,
                            residual=False)
    return _MlpFn.apply(x, ln_w, ln_b, w1, b1, w2, b2, eps)


fused_ln_mlp = _build.KernelOp("K9 fused_ln_mlp", _mlp_plain, _mlp_cuda)


def _ffn_plain(x, w1, b1, w2, b2, ln_w, ln_b, eps=1e-12):
    """Plain PyTorch version of ``fused_ffn_post_ln``: x [M, C] ->
    LN(x + fc2(GELU(fc1 x))) (BERT post-LN FFN)."""
    h = F.gelu(F.linear(x, w1, b1).float()).to(x.dtype)
    return layer_norm(x + F.linear(h, w2, b2), ln_w, ln_b, eps)


def _ffn_cuda(x, w1, b1, w2, b2, ln_w, ln_b, eps=1e-12):
    h = _build.gemm(x, w1, b1, gelu=True)
    return _build.layernorm(_build.gemm(h, w2, b2, residual=x), ln_w, ln_b,
                            eps)


fused_ffn_post_ln = _build.KernelOp(
    "K5 fused_ffn_post_ln", _ffn_plain, _ffn_cuda)


def _dropout_add_ln(o, res, ln_w, ln_b, keep, eps, rate):
    """LN(res + keep * o / (1 - rate)) in f32, in res's dtype."""
    o = o.float()
    if rate > 0.0:
        o = o * keep.float() * (1.0 / (1.0 - rate))
    return layer_norm(o + res.float(), ln_w, ln_b, eps).to(res.dtype)


def _out_ln_masked(x, res, w, b, ln_w, ln_b, keep, eps, rate):
    """``fused_out_ln_train`` with a given keep mask (its backward)."""
    return _dropout_add_ln(F.linear(x, w, b), res, ln_w, ln_b, keep, eps,
                           rate)


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
    return _build.dropout_add_ln(_build.gemm(x, w, b), res, ln_w, ln_b, eps,
                                 seed, rate)


def _out_ln_train_cuda(x, res, w, b, ln_w, ln_b, seed, eps=1e-12, rate=0.1):
    return _ReplayFn.apply(_out_ln_launch, _out_ln_masked, seed, eps, rate,
                           x, res, w, b, ln_w, ln_b)


fused_out_ln_train = _build.KernelOp(
    "K11 fused_out_ln_train", _out_ln_train_plain, _out_ln_train_cuda)


def _ffn_masked(x, w1, b1, w2, b2, ln_w, ln_b, keep, eps, rate):
    """``fused_ffn_post_ln_train`` with a given keep mask (its backward)."""
    h = F.gelu(F.linear(x, w1, b1).float()).to(x.dtype)
    return _dropout_add_ln(F.linear(h, w2, b2), x, ln_w, ln_b, keep, eps,
                           rate)


def _ffn_train_plain(x, w1, b1, w2, b2, ln_w, ln_b, seed, eps=1e-12,
                     rate=0.1):
    """Plain PyTorch version of ``fused_ffn_post_ln_train``: x [M, C] ->
    (LN(x + dropout(fc2(GELU(fc1 x)))), keep [M, C] bool), the dropout of
    (row, col) from ``seed`` (int64 [1])."""
    keep = dropout.row_keep(seed, x.shape[0], x.shape[1], rate)
    return _ffn_masked(x, w1, b1, w2, b2, ln_w, ln_b, keep, eps, rate), keep


def _ffn_train_launch(x, w1, b1, w2, b2, ln_w, ln_b, seed, eps, rate):
    h = _build.gemm(x, w1, b1, gelu=True)
    return _build.dropout_add_ln(_build.gemm(h, w2, b2), x, ln_w, ln_b, eps,
                                 seed, rate)


def _ffn_train_cuda(x, w1, b1, w2, b2, ln_w, ln_b, seed, eps=1e-12,
                    rate=0.1):
    return _ReplayFn.apply(_ffn_train_launch, _ffn_masked, seed, eps, rate,
                           x, w1, b1, w2, b2, ln_w, ln_b)


fused_ffn_post_ln_train = _build.KernelOp(
    "K12 fused_ffn_post_ln_train", _ffn_train_plain, _ffn_train_cuda)
