"""The uint8 patch embed (port of lavender_tpu/ops/patch_embed_u8.py).

``fused_patch_embed_u8`` replaces the TPU kernel ``_pe_kernel``
(lavender_tpu/ops/patch_embed_u8.py:76, wrapper ``fused_patch_embed_u8``
:101): the Swin patch embed, Conv3d kernel (2, 4, 4) / stride (1, 4, 4)
with the temporal end pad, on raw uint8 clips [B, D, H, W, 3] -> tokens
[B, D, H/4, W/4, E] before the patch LayerNorm.  The ImageNet normalize
(u / 255 - mean) / std is affine, so it folds into the conv weights
(scale) and a per-time bias table [D, E] (shift); the end-pad frame must
contribute a NORMALIZED zero, so the table leaves out the kd = 1 tap's
shift at t = D - 1.  Both versions share that fold (``fold_weights``, a
few small tensor ops on the weights, as the JAX wrapper runs it outside
its pallas_call).

On the card ``csrc/patch_embed.cu`` reads the u8 pixels in place (no
reshape / permute / cat copies): persistent blocks (``_build.
patch_embed_plan``) walk rows of 64 patches, each row's pixel segments
brought by cp.async while the row before computes, turned into a bf16
im2col tile in shared memory and multiplied on mma.sync against weights
that each warp holds in registers for the block's life, f32 accumulation,
the bias in the epilogue, the row's tokens stored as one contiguous run
in 16-byte chunks (the TPU's 8x block-diagonal weights served its lane
layout and are not copied).  Bound: device-memory bandwidth, the clip
read once and the bf16 tokens written once.  The JAX kernel has no vjp and its module gates it on
``deterministic``; the port's gradient, where autograd records a call
(a serving model in ``eval()`` whose gradients are taken), is the plain
version's (``recompute_vjp``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from lavender_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from lavender_tpu_torch.ops import _build


def supports_fused_patch_embed(B: int, D: int, H: int, W: int, C: int,
                               patch: Sequence[int]) -> bool:
    """Geometry gate of the kernel route, copied from the JAX package
    (patch_embed_u8.py:53): kernel (2, ph, pw), RGB, no spatial pad,
    w2 % 8 == 0 and a frame of at most 2 MiB (its VMEM budget, kept as a
    routing predicate)."""
    pd, ph, pw = patch
    if pd != 2 or C != 3:
        return False
    if H % ph or W % pw:
        return False
    if (W // pw) % 8:
        return False
    return H * W * 3 <= 2 * 1024 * 1024


def fold_weights(weight: torch.Tensor, bias: torch.Tensor, D: int,
                 mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kmat f32 [pd*ph*pw*3, E], bias table f32 [D, E]) of the Conv3d
    ``weight`` [E, 3, pd, ph, pw] and ``bias`` [E] with the normalize
    folded in; kmat's rows in (kd, kh, kw, c) order."""
    E = weight.shape[0]
    kern = weight.float().permute(2, 3, 4, 1, 0)  # [pd, ph, pw, c, E]
    std_t = torch.tensor(std, device=weight.device)
    mean_t = torch.tensor(mean, device=weight.device)
    kmat = (kern / (255.0 * std_t)[:, None]).reshape(-1, E)
    shift = torch.einsum("dhwce,c->de", kern, -mean_t / std_t)  # [pd, E]
    last = (torch.arange(D, device=weight.device) < D - 1).float()
    bias_t = (bias.float() + shift[0])[None] + last[:, None] * shift[1][None]
    return kmat, bias_t


def _pe_plain(x, weight, bias, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """Plain PyTorch version of ``fused_patch_embed_u8``: x uint8
    [B, D, H, W, 3] (H, W multiples of the patch, temporal patch 2),
    ``weight`` [E, 3, 2, ph, pw] and ``bias`` [E] of the Conv3d -> tokens
    [B, D, H/ph, W/pw, E] in the weights' dtype: the (kd, kh, kw, c) im2col
    by reshape / permute / cat, one [*, 96] @ [96, E] product in that dtype,
    the bias table added in f32 (the JAX package's ``_u8_embed``)."""
    B, D, H, W, C = x.shape
    _, _, pd, ph, pw = weight.shape
    h2, w2 = H // ph, W // pw
    xs = x.reshape(B, D, h2, ph, w2, pw, C).permute(0, 1, 2, 4, 3, 5, 6)
    xs = xs.reshape(B, D, h2, w2, ph * pw * C)
    xp = torch.cat([xs, xs.new_zeros(B, 1, h2, w2, ph * pw * C)], dim=1)
    feat = torch.cat([xp[:, :D], xp[:, 1:D + 1]], dim=-1)
    kmat, bias_t = fold_weights(weight, bias, D, mean, std)
    dt = weight.dtype
    out = torch.matmul(feat.to(dt), kmat.to(dt)).float()
    return (out + bias_t[None, :, None, None, :]).to(dt)


_folded: Dict[tuple, tuple] = {}


def kernel_weights(weight: torch.Tensor, bias: torch.Tensor, D: int,
                   mean: Sequence[float] = IMAGENET_MEAN,
                   std: Sequence[float] = IMAGENET_STD
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_weights`` as the kernel takes them (kmat in bf16), kept for
    the last (weight, bias, D): the fold is a dozen small launches and two
    host-to-device copies, more than the kernel itself.  The entry holds
    the two tensors, so their identity, storage and version counter tell
    whether it is still theirs."""
    key = (D, tuple(mean), tuple(std))
    state = tuple((t.data_ptr(), t._version, t.dtype) for t in (weight, bias))
    hit = _folded.get(key)
    if hit is None or hit[0] is not weight or hit[1] is not bias or (
            hit[2] != state):
        with torch.no_grad():
            kmat, bias_t = fold_weights(weight, bias, D, mean, std)
        _folded.clear()
        _folded[key] = hit = (weight, bias, state,
                              kmat.to(torch.bfloat16).contiguous(),
                              bias_t.contiguous())
    return hit[3], hit[4]


def _pe_cuda(x, weight, bias, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """The kernel: the fold on the weights (``kernel_weights``), then one
    launch."""
    if tuple(weight.shape[1:]) != (3, 2, 4, 4):
        raise ValueError(f"fused_patch_embed_u8: the kernel takes a (2, 4, 4) "
                         f"RGB patch, got weight {tuple(weight.shape)}")
    if weight.dtype != torch.bfloat16:
        raise ValueError(f"fused_patch_embed_u8: bf16 weights, got "
                         f"{weight.dtype}")
    kmat, bias_t = kernel_weights(weight, bias, x.shape[1], mean, std)
    return _build.patch_embed_u8(x.contiguous(), kmat, bias_t)


fused_patch_embed_u8 = _build.KernelOp(
    "K17 fused_patch_embed_u8", _pe_plain, _pe_cuda, recompute_vjp=True)
