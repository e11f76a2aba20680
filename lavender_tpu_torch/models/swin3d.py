"""Video Swin Transformer 3D (port of lavender_tpu/models/swin3d.py).

Channels-last ``[B, T, H, W, C]`` throughout; each stage runs
window-major ``[B, nW, Npad, C]`` (N = wd*wh*ww tokens per window, padded
to a multiple of 8).  Serving (``eval()``) runs each block as
``fused_swin_block_wm`` and, at stage 4, ``fused_ln_mlp_chunked``.
Training (``train()``) runs the JAX package's drop-path route
(``SwinBlockWM.__call__`` with ``use_dp``): x <- drop_path_lerp(x,
K1 attention half); x <- x + drop_path(K9 ``fused_ln_mlp``), with the
rel-pos biases gathered from the tables on every forward under autograd.
The cyclic shift around every second block is ``wm_shift`` (K2) in both.
Parameter names follow the reference's torch modules
(``layers.0.blocks.1.attn.qkv.weight``), which is also what
``convert.from_flax`` produces from the JAX package's scan layout.

What runs where: the uint8 patch embed (normalize folded into the conv
weights), PatchMerging, the window partition/reverse and the final LN are
plain torch (plain XLA in JAX); the blocks and the shift are the ported
kernels.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from lavender_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from lavender_tpu_torch.ops import layer_norm
from lavender_tpu_torch.ops._build import select
from lavender_tpu_torch.ops.fused_mlp import fused_ln_mlp, fused_ln_mlp_chunked
from lavender_tpu_torch.ops.swin_block_attn import (
    fused_swin_block_wm, mlp_in_block, pad_window_mask, rel_pos_bias_wm,
    round8, wm_partition, wm_reverse, wm_shift)


def get_window_size(x_size: Sequence[int], window_size: Sequence[int],
                    shift_size: Optional[Sequence[int]] = None):
    """Shrink window/shift to the input size per axis (video_swin.py:93-106):
    an axis no longer than the window takes the input's size and no shift."""
    use_ws = list(window_size)
    use_ss = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_ws[i] = x_size[i]
            if use_ss is not None:
                use_ss[i] = 0
    if use_ss is None:
        return tuple(use_ws)
    return tuple(use_ws), tuple(use_ss)


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: Tuple[int, int, int]) -> np.ndarray:
    """int32 [N, N] index into the (2wd-1)(2wh-1)(2ww-1) bias table."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(
        np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= (2 * ww - 1)
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def compute_shift_mask(D: int, H: int, W: int,
                       window_size: Tuple[int, int, int],
                       shift_size: Tuple[int, int, int]) -> np.ndarray:
    """float32 [nW, N, N] additive mask (0 / -100) of the cyclic-shifted
    windows (video_swin.py:290-305)."""
    img_mask = np.zeros((D, H, W), dtype=np.float32)
    cnt = 0
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[d, h, w] = cnt
                cnt += 1
    ws = window_size
    m = img_mask.reshape(D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2])
    m = m.transpose(0, 2, 4, 1, 3, 5).reshape(-1, ws[0] * ws[1] * ws[2])
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _keep_coef(x: torch.Tensor, rate: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic-depth factor [B, 1, ..., 1]: bernoulli(1 -
    rate) / (1 - rate), drawn from ``generator``."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = torch.rand(shape, generator=generator, device=x.device)
    return (u < keep).to(x.dtype) / keep


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth per sample (video_swin.py:46-54): x / keep for a
    kept sample, 0 for a dropped one (JAX ``drop_path``)."""
    if rate == 0.0:
        return x
    return x * _keep_coef(x, rate, generator)


def drop_path_lerp(x: torch.Tensor, full: torch.Tensor, rate: float,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Stochastic depth on a residual-folded output ``full = x + f(x)``:
    x + coef * (full - x), the same per-sample coef as ``drop_path`` (JAX
    ``drop_path_lerp``), i.e. x + drop_path(f(x))."""
    if rate == 0.0:
        return full
    return x + _keep_coef(x, rate, generator) * (full - x)


def supports_wm(D: int, H: int, W: int, window: Sequence[int]) -> bool:
    """The window-major path needs the temporal window to cover D and H, W
    divisible by the window (as the JAX package's supports_fused_block)."""
    return D <= window[0] and H % window[1] == 0 and W % window[2] == 0


class WindowAttention3D(nn.Module):
    """Parameters of one block's window attention (the op itself is
    ``fused_swin_block_wm``)."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int],
                 num_heads: int, qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        n = ((2 * window_size[0] - 1) * (2 * window_size[1] - 1)
             * (2 * window_size[2] - 1))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(n, num_heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlockWM(nn.Module):
    """One Swin block on window-major tokens [B, nW, Npad, C].

    Serving: the whole block is ``fused_swin_block_wm``; when the MLP does
    not run inside it (``mlp_in_block``: Swin-B stage 4) the LN2 + MLP +
    residual is ``fused_ln_mlp_chunked``.  Training: the attention half
    ``fused_swin_block_wm`` under ``drop_path_lerp``, then
    x + drop_path(``fused_ln_mlp``) (the JAX ``use_dp`` route)."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[int, int, int], mlp_ratio: float = 4.0,
                 qk_scale: Optional[float] = None, eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = WindowAttention3D(dim, window_size, num_heads, qk_scale)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                mask: Optional[torch.Tensor], n_valid: int,
                dp_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, nW, Npad, C]; bias [nH, Npad, Npad] (rel_pos_bias_wm);
        mask [nW, Npad, Npad] for a shifted block, else None; ``n_valid``
        the real rows of a window; ``dp_rate`` and ``generator`` the
        drop-path rate and random stream in training."""
        Npad, C = x.shape[2:]
        nH = self.attn.num_heads
        block = select(fused_swin_block_wm)
        args = (self.norm1.weight, self.norm1.bias, self.attn.qkv.weight,
                self.attn.qkv.bias, self.attn.proj.weight,
                self.attn.proj.bias, bias, mask, nH, self.attn.scale,
                self.norm1.eps)
        mlp = (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
               self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias)
        if self.training:
            x = drop_path_lerp(x, block(x, *args, n_valid=n_valid), dp_rate,
                               generator)
            out = select(fused_ln_mlp)(x.reshape(-1, C), *mlp,
                                       self.norm2.eps).reshape(x.shape)
            return x + drop_path(out, dp_rate, generator)
        if mlp_in_block(C, self.mlp.fc1.out_features, nH, Npad):
            return block(x, *args, mlp=mlp)
        x = block(x, *args)
        return select(fused_ln_mlp_chunked)(x.reshape(-1, C), *mlp,
                                            self.norm2.eps).reshape(x.shape)


class PatchMerging(nn.Module):
    """2x spatial downsample: 2x2 neighbour concat in (pw, ph, C) channel
    order (the reference's [x0; x1; x2; x3]) + LN + linear, plain torch."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, H, W, C = x.shape
        if H % 2 == 1 or W % 2 == 1:
            x = nn.functional.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            H, W = x.shape[2], x.shape[3]
        x = x.reshape(B, D, H // 2, 2, W // 2, 2, C)
        x = x.permute(0, 1, 2, 4, 5, 3, 6).reshape(B, D, H // 2, W // 2, 4 * C)
        x = layer_norm(x, self.norm.weight, self.norm.bias, self.norm.eps)
        return self.reduction(x)


class BasicLayer(nn.Module):
    """One Swin stage on the window-major path: ``depth`` blocks as
    (no-shift, shift) pairs — the JAX package's ``_BlockPairWM``, here the
    loop in ``forward`` — then optional PatchMerging.  ``drop_path_rates``:
    one per block (training only)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: Tuple[int, int, int], mlp_ratio: float = 4.0,
                 qk_scale: Optional[float] = None, has_downsample: bool = False,
                 eps: float = 1e-5,
                 drop_path_rates: Optional[Sequence[float]] = None):
        super().__init__()
        if depth % 2 != 0:
            raise ValueError(f"stage depth must be even, got {depth}")
        self.drop_path_rates = tuple(float(r) for r in (
            drop_path_rates or (0.0,) * depth))
        self.window_size = tuple(window_size)
        self.shift = tuple(w // 2 for w in window_size)
        self.blocks = nn.ModuleList(
            SwinBlockWM(dim, num_heads, self.window_size, mlp_ratio, qk_scale,
                        eps) for _ in range(depth))
        self.downsample = PatchMerging(dim, eps) if has_downsample else None
        self._cache: Dict = {}

    def train(self, mode: bool = True):
        """Also drops the serving cache: training changes the tables."""
        self._cache = {}
        return super().train(mode)

    def _geometry(self, D: int, H: int, W: int, device, dtype):
        """Per-block rel-pos biases and the padded shift mask of one input
        geometry.  Built once by ``build_serving_cache``; a geometry (or
        device/dtype) without a cache entry is built on the fly, and in
        training always (the biases are gathered under autograd)."""
        key = (D, H, W, device, dtype)
        if key in self._cache and not self.training:
            return self._cache[key]
        window, shift = get_window_size((D, H, W), self.window_size, self.shift)
        if not supports_wm(D, H, W, window):
            raise ValueError(f"stage geometry {(D, H, W)} unsupported by the "
                             f"window-major path (window {window})")
        N = int(np.prod(window))
        Npad = round8(N)
        rel_index = relative_position_index(self.window_size)
        biases = [rel_pos_bias_wm(blk.attn.relative_position_bias_table,
                                  rel_index, N, Npad, dtype)
                  for blk in self.blocks]
        mask = None
        if any(s > 0 for s in shift):
            m = torch.as_tensor(compute_shift_mask(D, H, W, window, shift),
                                device=device)
            mask = pad_window_mask(m, Npad).to(dtype)
        return window, shift, N, Npad, biases, mask

    @torch.no_grad()
    def build_serving_cache(self, D: int, H: int, W: int):
        """Precompute this stage's biases and shift mask for inputs of
        spatial size (D, H, W) on the parameters' device and dtype.  The
        cache is a function of the weights: rebuild it after changing them."""
        p = self.blocks[0].attn.relative_position_bias_table
        self._cache = {}
        self._cache[(D, H, W, p.device, p.dtype)] = self._geometry(
            D, H, W, p.device, p.dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, D, H, W, C = x.shape
        window, shift, N, Npad, biases, mask = self._geometry(
            D, H, W, x.device, x.dtype)
        shifted = mask is not None
        dpr = self.drop_path_rates
        t = wm_partition(x, window, Npad)
        for k in range(0, len(self.blocks), 2):
            t = self.blocks[k](t, biases[k], None, N, dpr[k], generator)
            if shifted:
                t = wm_shift(t, window, D, H, W, shift)
            t = self.blocks[k + 1](t, biases[k + 1], mask, N, dpr[k + 1],
                                   generator)
            if shifted:
                t = wm_shift(t, window, D, H, W, shift, inverse=True)
        x = wm_reverse(t, window, D, H, W)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


class PatchEmbed3D(nn.Module):
    """Patch embedding, kernel (2, 4, 4), stride (1, 4, 4), temporal
    end-pad, on raw uint8 frames [B, D, H, W, 3] -> [B, D, H/4, W/4, E].

    The ImageNet normalize (u/255 - mean)/std is folded into the conv
    weights and the convolution runs as one [*, 96] @ [96, E] product
    (the JAX package's ``_u8_embed``).  The end-pad frame must contribute a
    NORMALIZED zero, so the kd=1 tap's folded shift is left out at the
    last time step through a [D, E] bias table."""

    def __init__(self, patch_size=(2, 4, 4), in_chans: int = 3,
                 embed_dim: int = 96, patch_norm: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.embed_dim = embed_dim
        self.proj = nn.Conv3d(in_chans, embed_dim, self.patch_size,
                              stride=(1,) + self.patch_size[1:])
        self.norm = nn.LayerNorm(embed_dim, eps=eps) if patch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, H, W, C = x.shape
        pd, ph, pw = self.patch_size
        if x.dtype != torch.uint8 or pd != 2 or H % ph or W % pw:
            raise ValueError("PatchEmbed3D takes uint8 frames whose H, W are "
                             "multiples of the patch (temporal patch 2), got "
                             f"{x.dtype} {tuple(x.shape)}")
        h2, w2 = H // ph, W // pw
        xs = x.reshape(B, D, h2, ph, w2, pw, C).permute(0, 1, 2, 4, 3, 5, 6)
        xs = xs.reshape(B, D, h2, w2, ph * pw * C)
        xp = torch.cat([xs, xs.new_zeros(B, 1, h2, w2, ph * pw * C)], dim=1)
        feat = torch.cat([xp[:, :D], xp[:, 1:D + 1]], dim=-1)
        # fold n = a_c * u + b_c into the kernel (f32), feat order (kd, ph, pw, c)
        kern = self.proj.weight.float().permute(2, 3, 4, 1, 0)  # [pd,ph,pw,c,E]
        std = torch.tensor(IMAGENET_STD, device=x.device)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        kmat = (kern / (255.0 * std)[:, None]).reshape(-1, self.embed_dim)
        shift = torch.einsum("dhwce,c->de", kern, -mean / std)  # [pd, E]
        last = (torch.arange(D, device=x.device) < D - 1).float()
        bias_t = (self.proj.bias.float() + shift[0])[None] \
            + last[:, None] * shift[1][None]  # [D, E]
        dt = self.proj.weight.dtype
        out = torch.matmul(feat.to(dt), kmat.to(dt)).float()
        out = (out + bias_t[None, :, None, None, :]).to(dt)
        if self.norm is not None:
            out = layer_norm(out, self.norm.weight, self.norm.bias,
                             self.norm.eps)
        return out


class VideoSwin3D(nn.Module):
    """Video Swin 3D backbone: uint8 [B, T, H, W, 3] -> [B, T, H/32, W/32, F]
    (F = embed_dim * 8), channels-last."""

    def __init__(self, config):
        super().__init__()
        cfg = config
        if not cfg.qkv_bias:
            raise ValueError("the window-major blocks need qkv_bias=True")
        self.patch_size = tuple(cfg.patch_size)
        self.patch_embed = PatchEmbed3D(cfg.patch_size, cfg.in_chans,
                                        cfg.embed_dim, cfg.patch_norm,
                                        cfg.layer_norm_eps)
        n = len(cfg.depths)
        # stochastic depth spread linearly over all blocks (swin3d.py:1443)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)).tolist()
        starts = np.cumsum((0,) + tuple(cfg.depths))
        self.layers = nn.ModuleList(
            BasicLayer(int(cfg.embed_dim * 2 ** i), cfg.depths[i],
                       cfg.num_heads[i], tuple(cfg.window_size),
                       cfg.mlp_ratio, cfg.qk_scale, i < n - 1,
                       cfg.layer_norm_eps, dpr[starts[i]:starts[i + 1]])
            for i in range(n))
        self.norm = nn.LayerNorm(cfg.num_features, eps=cfg.layer_norm_eps)

    def build_serving_cache(self, T: int, H: int, W: int):
        """Precompute every stage's biases and masks for [*, T, H, W, 3]."""
        D, h, w = T, H // self.patch_size[1], W // self.patch_size[2]
        for layer in self.layers:
            layer.build_serving_cache(D, h, w)
            if layer.downsample is not None:
                h, w = (h + 1) // 2, (w + 1) // 2

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the drop-path random stream in training."""
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x, generator)
        return layer_norm(x, self.norm.weight, self.norm.bias, self.norm.eps)
