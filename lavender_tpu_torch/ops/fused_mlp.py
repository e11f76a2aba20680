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

GELU is the exact erf form (the TPU kernels used a clamped polynomial in
bf16; the JAX oracles use erf).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from lavender_tpu_torch.ops import _build, layer_norm


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
