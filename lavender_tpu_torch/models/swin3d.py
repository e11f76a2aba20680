"""Video Swin Transformer 3D (port of lavender_tpu/models/swin3d.py).

Channels-last ``[B, T, H, W, C]`` throughout.  Each stage picks its route
from ``SwinConfig`` and its geometry exactly as the JAX package's
``BasicLayer`` does (``resolve_attn_impl``, ``wm_ok``, ``fused_ok``):

- ``attn_impl`` "auto" or "wm" (the default): the window-major route, when
  the window tiles the stage (``supports_fused_block``), the depth is even,
  ``scan_blocks`` and not ``remat``: the stage runs on [B, nW, Npad, C]
  (N = wd*wh*ww tokens per window, padded to a multiple of 8).  Serving
  (``eval()``) runs each block as ``fused_swin_block_wm`` (K1) and, at
  Swin-B's stage 4, ``fused_ln_mlp_chunked`` (K3).  Training
  (``train()``) runs the JAX package's drop-path route
  (``SwinBlockWM.__call__`` with ``use_dp``): x <- drop_path_lerp(x, K1
  attention half); x <- x + drop_path(K9 ``fused_ln_mlp``).  The cyclic
  shift around every second block is ``wm_shift`` (K2).  A stage the wm
  route refuses falls back, stage by stage, to "fused".
- "fused": the spatial route (JAX ``SwinBlock3D``): where the window tiles
  the stage, the whole block ``fused_swin_block_full`` (K14) or its
  attention half ``fused_swin_block_attn`` (K14, under drop-path in
  training) + the MLP through K9 / K3 / plain torch by the JAX package's
  VMEM gates (``full_block_fits_vmem``, ``weights_fit_vmem``, kept as
  routing predicates); elsewhere the module path below, its MLP through K9
  where the weights fit.
- "pallas": the module path with the per-window attention
  ``fused_window_attention`` (K15), its MLP through K9 where the weights
  fit; the stage's shift mask and its serving cache's biases are kept in
  rows padded to 16 bytes (at N = 245 the rows' own 490 bytes would take
  K15's 4-byte copies, and their 16-byte ones halve its time).
- "xla": the module path in plain torch: LN1, zero pad to the window,
  roll, ``window_partition``, window attention, reverse, roll back, crop;
  then LN2 + MLP.  No kernel.

The non-wm stages run their blocks as (no-shift, shift) pairs (the JAX
``_BlockPair`` scan) or, under ``scan_blocks=False`` or an odd depth, one
by one, each unit under ``torch.utils.checkpoint`` with ``remat`` (the
JAX ``nn.remat``).  The drop-path coefficients of a stage are drawn from
the step's generator before any of its blocks runs and passed in, so that
a recomputation replays them.  Parameter names follow the reference's
torch modules (``layers.0.blocks.1.attn.qkv.weight``), which is also what
``convert.from_flax`` produces from the JAX package's scan layout and from
its per-block one (``layers_0/blocks_1``).

What runs where: the uint8 patch embed (normalize folded into the conv
weights; ``fused_patch_embed_u8``, K17, under ``LVT_PEK=1``), its general
path (float clips, a spatial pad or a temporal patch other than 2: the
device normalize of a uint8 clip, the temporal end pad, the spatial pad,
the conv as one product), PatchMerging,
the window partition/reverse and the final LN are plain torch (plain XLA in
JAX); the blocks and the shift are the ported kernels.

The JAX package's environment switches, read at import into module
constants that the routes read at call time (tests flip the constants):

- ``LVT_FOLDCACHE`` (default "1", ``_FOLDCACHE``): ``build_serving_cache``
  also folds each wm block's LN1 and LN2 affines into its qkv and fc1
  weights (JAX ``foldfn``); a serving forward that reads the cache passes
  them to K1, which then applies the pure normalize.  Never in training or
  under autograd, never to a K16 block, and the stage-4 MLP (K3) stays
  unfolded, as in JAX.
- ``LVT_PEK`` (default "0", ``_PEK``): the patch embed takes K17 in
  ``eval()`` on uint8 clips where ``supports_fused_patch_embed`` holds.
- ``LVT_IKS`` (default "0", ``_IKS``): a shifted wm block takes K16 (the
  shift inside the block, no ``wm_shift`` pair around it) where
  ``supports_inkernel_shift`` holds (Swin-B at 5 x 224 x 224: stage 3);
  its MLP then runs as K9 (with the residual in serving) where
  ``weights_fit_vmem``, else K3 in serving and plain torch in training.
- ``LVT_PSHIFT`` (default "1", ``_PSHIFT``): "0" runs the wm stages'
  cyclic shift as reverse -> ``torch.roll`` -> partition
  (``wm_shift_roll``) instead of K2 (JAX ops/swin_block_attn.py:73).
- ``LVT_COREBWD`` (default "1", ``_COREBWD``): "0" makes the backward of
  the wm blocks' kernels (K1's attention half, K16) recompute the
  attention half in plain torch on the valid rows instead of through K8
  (JAX ``_use_core_bwd``, ops/swin_block_attn.py:1652).

Two more are read at each call, as JAX reads them:

- ``LVT_SWINTRAIN`` (default "0"; JAX swin3d.py:655): in training the wm
  blocks' attention half is ``wm_attn_half_train``, a composition under
  autograd (LN1 + qkv in torch, the K8 core, proj in torch; with
  ``LVT_COREBWD=0`` all plain), and their MLP plain torch (JAX
  ``ln_mlp_reference``); a K16 block takes the shift around it.
- ``LVT_EMBING`` (default "0"; JAX swin3d.py:1396): in ``eval()``, on uint8
  clips whose first stage runs window-major, the patch embed writes stage
  1's [B, nW, Npad, E] layout itself (``PatchEmbed3D._u8_embed_wm``, plain
  torch, the u8 im2col composed with the window partition; K17 is not
  used, as in JAX) and stage 1 skips its ``wm_partition``.

Tensor parallelism (``parallel.mesh.tp_active()``, the weights sharded by
``mesh.shard_model``): every stage takes the tensor-parallel route
whatever its ``attn_impl``, the JAX package's ``tp_active`` gate
(swin3d.py:221).  A wm stage runs ``SwinBlock3D.wm_tp`` on its
window-major slab: LN1 (replicated) -> ``attn.qkv`` on this rank's heads
(column-parallel) -> the core ``swin_core_attn`` (K8a, its backward K8b)
at nH / tp heads with their bias rows -> ``attn.proj`` (row-parallel, its
partials summed over the model ranks, then the bias) -> drop_path_lerp;
then LN2 -> ``mlp.fc1`` + GELU (column) -> ``mlp.fc2`` (row) ->
drop_path, the shift K2 around every second block as before (K16 and the
fold are off).  Any other stage runs ``spatial_tp``, the module path with
the same split.  A block whose heads do not divide tp keeps its attention
whole on every rank (no collective) and splits its MLP.  K1, K3, K9, K14
and K16 do not run under tp: each fuses a row-parallel product with the
residual or LN after its all-reduce.

The serving cache is a function of the weights.  Each cached stage keeps
a fingerprint of its sources (sum and sum of squares of the rel-pos
tables, and of the fold's LN, qkv and fc1 weights and biases) and a
record of their ``(data_ptr, _version)``.  A forward that would read the
cache first compares the record on the host (no device work for an
unchanged model); where it moved, the fingerprints decide, and a stale
stage is rebuilt before anything runs (``VideoSwin3D.refresh_serving_cache``).
``check_serving_cache`` raises on a stale stage instead.  A write that
bypasses the version counter (``p.data.copy_``) is not seen: rebuild by
hand after one.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from lavender_tpu_torch.data.transforms import device_normalize
from lavender_tpu_torch.ops import _build, layer_norm
from lavender_tpu_torch.ops._build import select
from lavender_tpu_torch.ops.fused_mlp import (
    _mlp_plain, fused_ln_mlp, fused_ln_mlp_chunked, weights_fit_vmem)
from lavender_tpu_torch.ops.patch_embed_u8 import (
    _pe_plain, fold_weights, fused_patch_embed_u8,
    supports_fused_patch_embed, u8_im2col)
from lavender_tpu_torch.ops.swin_block_attn import (
    fused_swin_block_attn, fused_swin_block_full, fused_swin_block_wm,
    fused_swin_block_wm_shifted, mlp_in_block, pad_window_mask,
    rel_pos_bias_rows, rel_pos_bias_wm, round8, supports_inkernel_shift,
    window_msa, window_msa_core, window_partition, window_reverse,
    wm_attn_half_train, wm_partition, wm_reverse, wm_shift, wm_shift_roll)
from lavender_tpu_torch.ops.swin_core_attn import swin_core_attn
from lavender_tpu_torch.ops.window_attention import (
    fused_window_attention, window_attention_reference)
from lavender_tpu_torch.parallel import mesh

# the JAX package's switches (lavender_tpu/models/swin3d.py:36-69), same
# variables and defaults; see the module notes
_IKS = os.environ.get("LVT_IKS", "0") == "1"
_FOLDCACHE = os.environ.get("LVT_FOLDCACHE", "1") == "1"
_PEK = os.environ.get("LVT_PEK", "0") == "1"
_PSHIFT = os.environ.get("LVT_PSHIFT", "1") == "1"
_COREBWD = os.environ.get("LVT_COREBWD", "1") == "1"


def swin_train_composition() -> bool:
    """``LVT_SWINTRAIN=1``, read per call (JAX ``swin_train_composition``)."""
    return os.environ.get("LVT_SWINTRAIN", "0") == "1"


def _shift_fn():
    """The wm stages' cyclic shift: K2 (``wm_shift``) or, under
    ``LVT_PSHIFT=0``, ``wm_shift_roll``."""
    return wm_shift if _PSHIFT else wm_shift_roll


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


ATTN_IMPLS = ("auto", "wm", "fused", "pallas", "xla")


def resolve_attn_impl(impl: str) -> str:
    """"auto" -> "wm", as the JAX package resolves it on its accelerator
    (swin3d.py:201; it takes "xla" off the TPU only because its kernels
    lower there alone, while the port's run on the card and, as their
    plain versions, on the CPU).  The JAX package's other "auto" case,
    tensor parallelism (swin3d.py:221, "xla" under ``tp_active``), is a
    route of the blocks here: under ``parallel.mesh.tp_active()`` every
    ``attn_impl`` runs ``SwinBlock3D.wm_tp`` on the window-major stages and
    ``SwinBlock3D.spatial_tp`` on the others (see the module notes)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"SwinConfig.attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {impl!r}")
    return "wm" if impl == "auto" else impl


def supports_fused_block(D: int, H: int, W: int, window: Sequence[int]
                         ) -> bool:
    """Whether the window tiles the stage without a temporal shift: the
    temporal window covers D (after ``get_window_size``) and H, W are
    multiples of the window (JAX ``supports_fused_block``,
    ops/swin_block_attn.py:163).  Gates both the wm and the K14 routes."""
    return D <= window[0] and H % window[1] == 0 and W % window[2] == 0


def full_block_fits_vmem(C: int, HD: int, nH: int, window: Sequence[int]
                         ) -> bool:
    """Whether a spatial ``"fused"`` block runs whole
    (``fused_swin_block_full``) or as its attention half + a separate MLP:
    the JAX package's VMEM gate (ops/swin_block_attn.py:843) at its padded
    window Np = wd*wh*round8(ww), kept as a routing predicate."""
    return mlp_in_block(C, HD, nH, window[0] * window[1] * round8(window[2]))


class WindowAttention3D(nn.Module):
    """Parameters of one block's window attention, and the module path's
    attention over windows [B * nW, N, C] (JAX ``WindowAttention3D``).
    The window-major and K14 routes pass the parameters to their kernels
    instead."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int],
                 num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        n = ((2 * window_size[0] - 1) * (2 * window_size[1] - 1)
             * (2 * window_size[2] - 1))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(n, num_heads))

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                mask: Optional[torch.Tensor], attn_impl: str) -> torch.Tensor:
        """x [B * nW, N, C]; bias [nH, N, N]; mask [nW, N, N] or None;
        "pallas" runs K15, anything else the plain attention."""
        core = (select(fused_window_attention) if attn_impl == "pallas"
                else window_attention_reference)
        return window_msa(x, self.qkv.weight, self.qkv.bias, self.proj.weight,
                          self.proj.bias, bias, mask, self.num_heads,
                          self.scale, core)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


@dataclass
class SpatialGeometry:
    """What the spatial blocks of one stage share at one input size: the
    (shrunk) window and shift, the padded map, the route of the attention
    (K14 or the module path) and the shift mask of the shifted blocks
    ([nW, N, N] over the padded map, None where nothing shifts)."""
    window: Tuple[int, int, int]
    shift: Tuple[int, int, int]
    padded: Tuple[int, int, int]
    fused: bool
    mask: Optional[torch.Tensor]


def _scaled(t: torch.Tensor, coef: Optional[torch.Tensor]) -> torch.Tensor:
    """Drop-path of a branch by its drawn per-sample coefficient."""
    return t if coef is None else t * coef


class SwinBlock3D(nn.Module):
    """One Swin block: one parameter set, two forwards.

    ``wm``: the block on window-major tokens [B, nW, Npad, C] (JAX
    ``SwinBlockWM``).  Serving: the whole block is ``fused_swin_block_wm``;
    when the MLP does not run inside it (``mlp_in_block``: Swin-B stage 4)
    the LN2 + MLP + residual is ``fused_ln_mlp_chunked``.  Training: the
    attention half ``fused_swin_block_wm`` under ``drop_path_lerp``, then
    x + drop_path(``fused_ln_mlp``) (the JAX ``use_dp`` route).

    ``spatial``: the block on [B, D, H, W, C] (JAX ``SwinBlock3D``), see
    the module notes."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[int, int, int], mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = WindowAttention3D(dim, window_size, num_heads, qkv_bias,
                                      qk_scale)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _mlp_args(self):
        return (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias)

    def fold(self, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """The serving fold cache's tensors of this block (JAX ``foldfn``,
        swin3d.py:1073), in f32, cast to ``dtype``: (wqkv * s1[None, :],
        wqkv @ b1_ln + bqkv, w1 * s2[None, :], w1 @ b2_ln + b1) in torch
        Linear layout."""
        s1, b1_ln = self.norm1.weight.float(), self.norm1.bias.float()
        s2, b2_ln = self.norm2.weight.float(), self.norm2.bias.float()
        wq, bq = self.attn.qkv.weight.float(), self.attn.qkv.bias.float()
        w1, b1 = self.mlp.fc1.weight.float(), self.mlp.fc1.bias.float()
        return tuple(t.to(dtype).contiguous() for t in (
            wq * s1[None, :], wq @ b1_ln + bq, w1 * s2[None, :],
            w1 @ b2_ln + b1))

    def wm(self, x: torch.Tensor, bias: torch.Tensor,
           mask: Optional[torch.Tensor], n_valid: int, dp_rate: float = 0.0,
           generator: Optional[torch.Generator] = None,
           folded: Optional[Tuple[torch.Tensor, ...]] = None,
           inkernel_shift: Optional[tuple] = None) -> torch.Tensor:
        """x [B, nW, Npad, C]; bias [nH, Npad, Npad] (rel_pos_bias_wm);
        mask [nW, Npad, Npad] for a shifted block, else None; ``n_valid``
        the real rows of a window; ``dp_rate`` and ``generator`` the
        drop-path rate and random stream in training; ``folded`` the
        serving fold cache's tensors (``fold``; serving only);
        ``inkernel_shift`` ((D, H, W), window, shift) for a shifted block
        that takes K16 on the UNSHIFTED layout."""
        if mesh.tp_active():
            return self.wm_tp(x, bias, mask, dp_rate, generator)
        Npad, C = x.shape[2:]
        nH = self.attn.num_heads
        block = select(fused_swin_block_wm)
        attn = (self.norm1.weight, self.norm1.bias, self.attn.qkv.weight,
                self.attn.qkv.bias, self.attn.proj.weight,
                self.attn.proj.bias, bias, mask)
        args = (*attn, nH, self.attn.scale, self.norm1.eps)
        mlp = self._mlp_args()
        if inkernel_shift is not None:
            return self._wm_inkernel_shift(x, attn, mlp, inkernel_shift,
                                           dp_rate, generator)
        if self.training and swin_train_composition():
            full = wm_attn_half_train(x, *attn, *args[-3:], n_valid, _COREBWD)
            return self._train_plain_mlp(x, full, mlp, dp_rate, generator)
        if self.training:
            x = drop_path_lerp(x, block(x, *args, n_valid=n_valid,
                                        core_bwd=_COREBWD), dp_rate,
                               generator)
            out = select(fused_ln_mlp)(x.reshape(-1, C), *mlp,
                                       self.norm2.eps).reshape(x.shape)
            return x + drop_path(out, dp_rate, generator)
        if mlp_in_block(C, self.mlp.fc1.out_features, nH, Npad):
            return block(x, *args, mlp=mlp, folded=folded)
        x = block(x, *args, folded=folded, core_bwd=_COREBWD)
        return select(fused_ln_mlp_chunked)(x.reshape(-1, C), *mlp,
                                            self.norm2.eps).reshape(x.shape)

    def _attn_tp(self, h: torch.Tensor, core) -> torch.Tensor:
        """proj(attn(h)) of the LN1 output ``h`` [..., C] on the tensor-parallel
        route: qkv on this rank's heads, ``core(qkv, heads)``, the proj's
        partials summed over the model ranks, then its bias (the whole
        attention where the heads do not divide tp)."""
        a = self.attn
        qkv = mesh.column_parallel(h, a.qkv.weight, a.qkv.bias)
        held = qkv.shape[-1] // 3 // (a.qkv.in_features // a.num_heads)
        return mesh.row_parallel(core(qkv, held), a.proj)

    def _mlp_tp(self, x: torch.Tensor) -> torch.Tensor:
        """fc2(GELU(fc1(LN2(x)))) with fc1 column- and fc2 row-parallel
        (``_mlp_plain``'s math)."""
        fc1 = self.mlp.fc1
        h = layer_norm(x, self.norm2.weight, self.norm2.bias, self.norm2.eps)
        h = mesh.column_parallel(h, fc1.weight, fc1.bias)
        return mesh.row_parallel(F.gelu(h.float()).to(x.dtype), self.mlp.fc2)

    def wm_tp(self, x: torch.Tensor, bias: torch.Tensor,
              mask: Optional[torch.Tensor], dp_rate: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The block on window-major tokens [B, nW, Npad, C] on the
        tensor-parallel route, serving and training (see the module
        notes): K8a / K8b on this rank's heads, ``bias`` [heads held, Npad,
        Npad].  The pad rows carry finite values that the stage exit
        drops."""
        scale = self.attn.scale

        def core(qkv, held):
            return select(swin_core_attn)(qkv, bias, mask, held, scale)

        if not self.training:  # drop-path in training only
            dp_rate = 0.0
        h = layer_norm(x, self.norm1.weight, self.norm1.bias, self.norm1.eps)
        x = drop_path_lerp(x, x + self._attn_tp(h, core), dp_rate, generator)
        return x + drop_path(self._mlp_tp(x), dp_rate, generator)

    def _train_plain_mlp(self, x, full, mlp, dp_rate, generator):
        """The ``LVT_SWINTRAIN`` block's end: x <- drop_path_lerp(x, full),
        then x + drop_path(the plain LN2 + MLP) (JAX ``ln_mlp_reference``)."""
        x = drop_path_lerp(x, full, dp_rate, generator)
        out = _mlp_plain(x.reshape(-1, x.shape[-1]), *mlp, self.norm2.eps)
        return x + drop_path(out.reshape(x.shape).to(x.dtype), dp_rate,
                             generator)

    def _wm_inkernel_shift(self, x, attn, mlp, inkernel_shift, dp_rate,
                           generator):
        """The JAX ``SwinBlockWM`` ``inkernel_shift`` branch
        (swin3d.py:677-686 and the MLP after it): K16, then the MLP as a
        separate call, K9 where ``weights_fit_vmem`` (with the residual in
        serving), else K3 in serving and plain torch in training.  Under
        ``LVT_SWINTRAIN`` in training: the shift, ``wm_attn_half_train``,
        the inverse shift (JAX ``wm_attn_half_train_shifted``), then the
        plain MLP."""
        C = x.shape[-1]
        eps = self.norm1.eps
        nH, scale = self.attn.num_heads, self.attn.scale
        if self.training and swin_train_composition():
            spatial, window, shift = inkernel_shift
            shift_fn = _shift_fn()
            xs = shift_fn(x, window, *spatial, shift)
            ys = wm_attn_half_train(xs, *attn, nH, scale, eps,
                                    int(np.prod(window)), _COREBWD)
            full = shift_fn(ys, window, *spatial, shift, inverse=True)
            return self._train_plain_mlp(x, full, mlp, dp_rate, generator)
        full = select(fused_swin_block_wm_shifted)(
            x, *attn, *inkernel_shift, nH, scale, eps,
            core_bwd=_COREBWD)
        fits = weights_fit_vmem(C, self.mlp.fc1.out_features)
        if self.training:
            x = drop_path_lerp(x, full, dp_rate, generator)
            flat = x.reshape(-1, C)
            out = (select(fused_ln_mlp)(flat, *mlp, self.norm2.eps) if fits
                   else _mlp_plain(flat, *mlp, self.norm2.eps))
            return x + drop_path(out.reshape(x.shape), dp_rate, generator)
        flat = full.reshape(-1, C)
        if fits:
            out = select(fused_ln_mlp)(flat, *mlp, self.norm2.eps, True)
        else:
            out = select(fused_ln_mlp_chunked)(flat, *mlp, self.norm2.eps)
        return out.reshape(full.shape)

    def spatial(self, x: torch.Tensor, bias: torch.Tensor,
                geo: SpatialGeometry, shifted: bool, attn_impl: str,
                use_dp: bool, coef1: Optional[torch.Tensor] = None,
                coef2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, D, H, W, C]; bias [nH, N, N] (the full window's index
        sliced [:N, :N]); ``geo`` the stage's geometry, ``shifted`` whether
        this block takes its shift; ``use_dp`` the JAX block's drop-path
        switch (training: always in scanned pairs, at a rate > 0 one by
        one), which picks the attention half + separate MLP over the whole
        block; ``coef1`` / ``coef2`` the drawn drop-path coefficients of
        the attention and MLP branches (None: kept)."""
        C = x.shape[-1]
        nH, HD = self.attn.num_heads, self.mlp.fc1.out_features
        eps = self.norm1.eps
        mask = geo.mask if shifted else None
        shift = geo.shift if shifted else (0, 0, 0)
        tp = mesh.tp_active()
        mlp = self._mlp_args()
        fits = weights_fit_vmem(C, HD)
        if geo.fused and not tp:
            args = (x, self.norm1.weight, self.norm1.bias,
                    self.attn.qkv.weight, self.attn.qkv.bias,
                    self.attn.proj.weight, self.attn.proj.bias, bias, mask)
            statics = (geo.window, shift, nH, self.attn.scale, eps)
            if not use_dp and full_block_fits_vmem(C, HD, nH, geo.window):
                return select(fused_swin_block_full)(
                    *args, *mlp, *statics).to(x.dtype)
            full = select(fused_swin_block_attn)(*args, *statics).to(x.dtype)
            x = full if coef1 is None else x + coef1 * (full - x)
            flat = x.reshape(-1, C)
            if use_dp:
                out = (select(fused_ln_mlp)(flat, *mlp, eps) if fits
                       else _mlp_plain(flat, *mlp, eps))
                return x + _scaled(out.reshape(x.shape).to(x.dtype), coef2)
            if fits:
                out = select(fused_ln_mlp)(flat, *mlp, eps, True)
            else:
                out = select(fused_ln_mlp_chunked)(flat, *mlp, eps)
            return out.reshape(x.shape).to(x.dtype)
        # the module path: zero pad AFTER LN1 (pad tokens are unmasked keys)
        B, D, H, W, _ = x.shape
        Dp, Hp, Wp = geo.padded
        h = layer_norm(x, self.norm1.weight, self.norm1.bias, eps)
        if (Dp, Hp, Wp) != (D, H, W):
            h = nn.functional.pad(h, (0, 0, 0, Wp - W, 0, Hp - H, 0, Dp - D))
        if shifted:
            h = torch.roll(h, tuple(-s for s in shift), (1, 2, 3))
        h = window_partition(h, geo.window)
        if tp:  # this rank's heads; ``bias`` holds their rows
            core = (select(fused_window_attention) if attn_impl == "pallas"
                    else window_attention_reference)
            h = self._attn_tp(h, lambda qkv, held: window_msa_core(
                qkv, held, bias, mask, self.attn.scale, core))
        else:
            h = self.attn(h, bias, mask, attn_impl)
        h = window_reverse(h, geo.window, B, Dp, Hp, Wp)
        if shifted:
            h = torch.roll(h, tuple(shift), (1, 2, 3))
        x = x + _scaled(h[:, :D, :H, :W].to(x.dtype), coef1)
        flat = x.reshape(-1, C)
        if tp:
            out = self._mlp_tp(flat)
        elif attn_impl in ("pallas", "fused") and fits:
            out = select(fused_ln_mlp)(flat, *mlp, eps)
        else:
            out = _mlp_plain(flat, *mlp, eps)
        return x + _scaled(out.reshape(x.shape).to(x.dtype), coef2)


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
    """One Swin stage: ``depth`` blocks alternating no-shift / shift, then
    optional PatchMerging; the route per call from the config fields and
    the input's geometry (see the module notes).  ``drop_path_rates``: one
    per block (training only)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: Tuple[int, int, int], mlp_ratio: float = 4.0,
                 qk_scale: Optional[float] = None, has_downsample: bool = False,
                 eps: float = 1e-5,
                 drop_path_rates: Optional[Sequence[float]] = None,
                 qkv_bias: bool = True, attn_impl: str = "auto",
                 remat: bool = False, scan_blocks: bool = True):
        super().__init__()
        self.drop_path_rates = tuple(float(r) for r in (
            drop_path_rates or (0.0,) * depth))
        self.window_size = tuple(window_size)
        self.shift = tuple(w // 2 for w in window_size)
        self.qkv_bias = qkv_bias
        self.attn_impl = resolve_attn_impl(attn_impl)
        # the non-wm route: a "wm" stage the wm path refuses runs "fused"
        self.spatial_impl = ("fused" if self.attn_impl == "wm"
                             else self.attn_impl)
        self.remat = remat
        # the JAX scan over (no-shift, shift) pairs; else one block at a time
        self.paired = scan_blocks and depth % 2 == 0 and depth >= 2
        self.blocks = nn.ModuleList(
            SwinBlock3D(dim, num_heads, self.window_size, mlp_ratio, qkv_bias,
                        qk_scale, eps) for _ in range(depth))
        self.downsample = PatchMerging(dim, eps) if has_downsample else None
        self._cache: Dict = {}
        self._geometries: Dict = {}
        # the cache's spatial size, whether it holds the fold, its source
        # parameters, their fingerprint and (data_ptr, _version) record
        # (see the module notes)
        self._cache_size: Optional[Tuple[int, int, int]] = None
        self._cache_fold = False
        self._cache_sources: List[torch.Tensor] = []
        self._cache_fp: Optional[torch.Tensor] = None
        self._cache_record: tuple = ()

    def train(self, mode: bool = True):
        """Entering training also drops the serving cache: training changes
        the weights (``eval()`` keeps it)."""
        if mode:
            self._cache = {}
        return super().train(mode)

    def wm_ok(self, D: int, H: int, W: int) -> bool:
        """Whether the stage runs window-major at this input size (the JAX
        ``BasicLayer``'s ``wm_ok``, swin3d.py:1006)."""
        window, _ = get_window_size((D, H, W), self.window_size, self.shift)
        return (self.attn_impl == "wm" and self.qkv_bias and not self.remat
                and supports_fused_block(D, H, W, window) and self.paired)

    def _cached(self, key):
        """The serving cache's entry for ``key``, or None where the biases
        must be gathered from the tables under autograd (training, or a
        forward whose gradients are taken)."""
        if self.training or torch.is_grad_enabled():
            return None
        return self._cache.get(key)

    def _geometry(self, D: int, H: int, W: int, device, dtype):
        """Per-block rel-pos biases and the padded shift mask of one input
        geometry on the wm route, and each block's fold (None unless the
        cache holds it).  Built once by ``build_serving_cache``; a geometry
        (or device/dtype) without a cache entry is built on the fly, and
        always under autograd (see ``_cached``)."""
        key = (D, H, W, device, dtype)
        cached = self._cached(key)
        if cached is not None:
            return cached
        window, shift = get_window_size((D, H, W), self.window_size, self.shift)
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
        return window, shift, N, Npad, biases, mask, [None] * len(self.blocks)

    def _spatial_geometry(self, D: int, H: int, W: int, device, dtype
                          ) -> SpatialGeometry:
        """The stage's ``SpatialGeometry`` at this input size, built once
        per (size, device, dtype), outside inference mode (a training step
        saves the mask for its backward)."""
        key = (D, H, W, device, dtype)
        if key not in self._geometries:
            window, shift = get_window_size((D, H, W), self.window_size,
                                            self.shift)
            padded = tuple(-(-n // w) * w for n, w in zip((D, H, W), window))
            fused = (self.spatial_impl == "fused" and self.qkv_bias
                     and supports_fused_block(D, H, W, window))
            mask = None
            if any(s > 0 for s in shift):
                with torch.inference_mode(False):
                    mask = torch.as_tensor(
                        compute_shift_mask(*padded, window, shift),
                        device=device)
                    # "fused": K14's operand dtype (0 and -100 are exact),
                    # so that no cast copies it under autocast; K14 and K15
                    # stage its rows with the tensor-core forward's 16-byte
                    # copies
                    mask = mask.to(torch.bfloat16
                                   if self.spatial_impl == "fused" else dtype)
                    if self.spatial_impl in ("pallas", "fused"):
                        mask = _build.with_padded_rows(mask)
            self._geometries[key] = SpatialGeometry(window, shift, padded,
                                                    fused, mask)
        return self._geometries[key]

    def _spatial_biases(self, geo: SpatialGeometry, dtype
                        ) -> List[torch.Tensor]:
        """Each block's [nH, N, N] rel-pos bias: the full window's index
        sliced [:N, :N] (the reference's, JAX swin3d.py:372); on the
        "pallas" and "fused" routes in rows padded to 16 bytes
        (``rel_pos_bias_rows``: the tensor-core forward's widest copies, K15
        and K14), gathered so, not copied."""
        N = int(np.prod(geo.window))
        rel_index = relative_position_index(self.window_size)
        tables = [blk.attn.relative_position_bias_table for blk in self.blocks]
        if self.spatial_impl in ("pallas", "fused"):
            return [rel_pos_bias_rows(t, rel_index, N, dtype) for t in tables]
        return [rel_pos_bias_wm(t, rel_index, N, N, dtype) for t in tables]

    def build_serving_cache(self, D: int, H: int, W: int):
        """Precompute this stage's biases and shift mask for inputs of
        spatial size (D, H, W) on the parameters' device and dtype, on the
        wm route also each block's fold (under ``_FOLDCACHE``), with the
        fingerprints and the record of their sources.  The cache is a
        function of the weights (see ``refresh_serving_cache``)."""
        p = self.blocks[0].attn.relative_position_bias_table
        self._cache = {}  # a build that raises leaves no cache
        key = (D, H, W, p.device, p.dtype)
        fold = False
        # outside inference mode (the server may rebuild inside it), and
        # inference_mode(False) enables autograd again
        with torch.inference_mode(False), torch.no_grad():
            if self.wm_ok(D, H, W):
                # under tp the cache holds this rank's bias rows and no
                # fold: the fold feeds K1 only (JAX builds it for the wm
                # kernels that its tp gate turns off)
                fold = _FOLDCACHE and not mesh.tp_active()
                *geo, _ = self._geometry(D, H, W, p.device, p.dtype)
                folds = [blk.fold(p.dtype) if fold else None
                         for blk in self.blocks]
                cache = (*geo, folds)
            else:
                geo = self._spatial_geometry(D, H, W, p.device, p.dtype)
                cache = self._spatial_biases(geo, p.dtype)
            self._cache_fp = self.fingerprint(fold)
        self._cache_size, self._cache_fold = (D, H, W), fold
        self._cache_sources = self._sources(fold)
        self._cache_record = _record(self._cache_sources)
        self._cache = {key: cache}

    def _sources(self, fold: bool) -> List[torch.Tensor]:
        """The parameters the cache is computed from."""
        out = [blk.attn.relative_position_bias_table for blk in self.blocks]
        if fold:
            out += [t for blk in self.blocks for t in _fold_sources(blk)]
        return out

    def fingerprint(self, fold: bool) -> torch.Tensor:
        """f32 staleness fingerprint of the cache's sources on the device:
        ``bias_fingerprint`` of the (no-shift, shift) sides' tables, then
        with ``fold`` ``fold_fingerprint`` of the blocks."""
        p = self.blocks[0].attn.relative_position_bias_table
        ta, tb = ([blk.attn.relative_position_bias_table for blk in side]
                  for side in (self.blocks[0::2], self.blocks[1::2]))
        # a stage of one block has no shift side: its sums are 0
        fp = bias_fingerprint(torch.stack(ta), torch.stack(tb) if tb
                              else p.new_zeros(0))
        if fold:
            fp = torch.cat([fp, fold_fingerprint(self.blocks)])
        return fp

    def cache_is_stale(self) -> bool:
        """Whether the cache's sources no longer give its fingerprint (False
        without a cache).  Reads the fingerprint back to the host."""
        if not self._cache:
            return False
        with torch.no_grad():
            now = self.fingerprint(self._cache_fold)
        return not torch.equal(now.cpu(), self._cache_fp.cpu())

    def refresh_serving_cache(self) -> bool:
        """Where the sources' record moved since the build: rebuild a stale
        cache (True), or take the new record of a fresh one.  An unchanged
        record costs host time only."""
        if not self._cache or _record(self._cache_sources) == self._cache_record:
            return False
        if self.cache_is_stale():
            self.build_serving_cache(*self._cache_size)
            return True
        self._cache_record = _record(self._cache_sources)
        return False

    def _forward_wm(self, x: torch.Tensor,
                    generator: Optional[torch.Generator],
                    spatial: Optional[Tuple[int, int, int]] = None
                    ) -> torch.Tensor:
        """x [B, D, H, W, C], or with ``spatial`` = (D, H, W) already
        window-major [B, nW, Npad, C] (the ``LVT_EMBING`` ingress)."""
        D, H, W = x.shape[1:4] if spatial is None else spatial
        C = x.shape[-1]
        window, shift, N, Npad, biases, mask, folds = self._geometry(
            D, H, W, x.device, x.dtype)
        shifted = mask is not None
        dpr = self.drop_path_rates
        t = wm_partition(x, window, Npad) if spatial is None else x
        nW = t.shape[1]
        shift_fn = _shift_fn()
        # JAX _BlockPairWM: K16 for the shifted block where the gate holds,
        # and then no wm_shift pair around it (swin3d.py:952-965)
        iks = (shifted and _IKS and not mesh.tp_active()
               and supports_inkernel_shift(window, (D, H, W), Npad, C,
                                           self.blocks[0].attn.num_heads, nW))
        inkernel = ((D, H, W), window, shift) if iks else None
        for k in range(0, len(self.blocks), 2):
            t = self.blocks[k].wm(t, biases[k], None, N, dpr[k], generator,
                                  folds[k])
            if shifted and not iks:
                t = shift_fn(t, window, D, H, W, shift)
            t = self.blocks[k + 1].wm(t, biases[k + 1], mask, N, dpr[k + 1],
                                      generator, folds[k + 1], inkernel)
            if shifted and not iks:
                t = shift_fn(t, window, D, H, W, shift, inverse=True)
        return wm_reverse(t, window, D, H, W)

    def _forward_spatial(self, x: torch.Tensor,
                         generator: Optional[torch.Generator]
                         ) -> torch.Tensor:
        B, D, H, W, C = x.shape
        geo = self._spatial_geometry(D, H, W, x.device, x.dtype)
        # the kernels' operand dtype under autocast: the biases cast where
        # they are gathered, into rows padded to 16 bytes, not by the
        # kernels' autograd Functions (a copy at N's own pitch)
        dtype = x.dtype
        if (self.spatial_impl in ("pallas", "fused")
                and torch.is_autocast_enabled("cuda")):
            dtype = torch.get_autocast_dtype("cuda")
        biases = (self._cached((D, H, W, x.device, x.dtype))
                  or self._spatial_biases(geo, dtype))
        depth, dpr = len(self.blocks), self.drop_path_rates
        # the JAX block's drop-path switch: scanned pairs pass a rate
        # always, the per-block modules only a nonzero one
        use_dp = [self.training and (self.paired or r > 0.0) for r in dpr]
        # every coefficient drawn before any block runs, attention branch
        # then MLP branch per block, so that a recomputation replays them
        coefs = []
        for i in range(depth):
            draw = use_dp[i] and dpr[i] > 0.0
            coefs.append(tuple(_keep_coef(x, dpr[i], generator) if draw
                               else None for _ in range(2)))
        plain = _build.in_plain_path()

        def run(x, lo, hi, *unit_coefs):
            with _build.plain_path(plain):
                for i in range(lo, hi):
                    x = self.blocks[i].spatial(
                        x, biases[i], geo, i % 2 == 1, self.spatial_impl,
                        use_dp[i],
                        *unit_coefs[2 * (i - lo):2 * (i - lo) + 2])
            return x

        step = 2 if self.paired else 1
        for lo in range(0, depth, step):
            unit = [c for pair in coefs[lo:lo + step] for c in pair]
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(run, x, lo, lo + step, *unit,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = run(x, lo, lo + step, *unit)
        return x

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                spatial: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
        """x [B, D, H, W, C]; or, with ``spatial`` = (D, H, W), x already
        window-major [B, nW, Npad, C] (JAX ``pre_partitioned``) for a
        stage whose ``wm_ok`` holds at that size."""
        if spatial is not None:
            x = self._forward_wm(x, generator, spatial)
        elif self.wm_ok(*x.shape[1:4]):
            x = self._forward_wm(x, generator)
        else:
            x = self._forward_spatial(x, generator)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


def _record(sources: List[torch.Tensor]) -> tuple:
    """(data_ptr, _version) of each tensor: moves with any in-place update
    (``load_state_dict``, an optimizer step) or a new storage (``.to``)."""
    return tuple((p.data_ptr(), p._version) for p in sources)


def _fold_sources(blk: SwinBlock3D) -> Tuple[torch.Tensor, ...]:
    return (blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight,
            blk.attn.qkv.bias, blk.norm2.weight, blk.norm2.bias,
            blk.mlp.fc1.weight, blk.mlp.fc1.bias)


def _sum_sumsq(t: torch.Tensor) -> List[torch.Tensor]:
    f = t.float()
    return [f.sum(), f.square().sum()]


def bias_fingerprint(ta: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """f32 [4]: sum and sum of squares of the stacked rel-pos tables of the
    (no-shift, shift) blocks of a stage (JAX ``_bias_fingerprint``,
    swin3d.py:741)."""
    return torch.stack(_sum_sumsq(ta) + _sum_sumsq(tb))


def fold_fingerprint(blocks: Sequence[SwinBlock3D]) -> torch.Tensor:
    """f32 [32]: per side (the no-shift blocks, then the shift blocks), sum
    and sum of squares of the stacked norm1 weight and bias, qkv weight and
    bias, norm2 weight and bias, fc1 weight and bias (JAX
    ``_fold_fingerprint``, swin3d.py:751, which leaves out the qkv and fc1
    biases that the fold reads too)."""
    parts = []
    for side in (blocks[0::2], blocks[1::2]):
        for tensors in zip(*(_fold_sources(b) for b in side)):
            parts += _sum_sumsq(torch.stack(tensors))
    return torch.stack(parts)


def check_serving_cache(model: nn.Module) -> bool:
    """Staleness check of every serving cache in ``model`` (JAX
    ``check_serving_cache``, swin3d.py:789): raises ValueError naming the
    first stage whose cache was built from other weights than its current
    ones; True when a cache is present and fresh, False when none is."""
    found = False
    for name, mod in model.named_modules():
        if isinstance(mod, BasicLayer) and mod._cache:
            found = True
            if mod.cache_is_stale():
                raise ValueError(
                    f"stale serving cache at {name}: it was built from other "
                    f"weights than the current ones (rel-pos tables or the "
                    f"fold's sources).  Rebuild it with build_serving_cache.")
    return found


class PatchEmbed3D(nn.Module):
    """Patch embedding, kernel (pd, ph, pw), stride (1, ph, pw), temporal
    end-pad of one frame: [B, D, H, W, 3] -> [B, D + 2 - pd, ceil(H/ph),
    ceil(W/pw), E] (JAX ``PatchEmbed3D``, swin3d.py:1183-1275).

    Raw uint8 frames with pd = 2 and no spatial pad: the ImageNet
    normalize (u/255 - mean)/std is folded into the conv weights and the
    convolution runs as one [*, 96] @ [96, E] product (the JAX package's
    ``_u8_embed``, ``patch_embed_u8._pe_plain``).  The end-pad frame must
    contribute a NORMALIZED zero, so the kd=1 tap's folded shift is left
    out at the last time step through a [D, E] bias table.  Under ``_PEK``
    in ``eval()`` the product is K17 (``fused_patch_embed_u8``) where
    ``supports_fused_patch_embed`` holds (JAX swin3d.py:1213-1230).

    Any other input (JAX swin3d.py:1248-1275): a uint8 clip is normalized
    on the device (``device_normalize``), a float one taken as already
    normalized; then the temporal end pad of one frame, zeros to the
    patch's multiple in H and W, and the conv as one [*, pd*ph*pw*3] @
    [., E] product of the im2col, in the weights' dtype."""

    def __init__(self, patch_size=(2, 4, 4), in_chans: int = 3,
                 embed_dim: int = 96, patch_norm: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.embed_dim = embed_dim
        self.proj = nn.Conv3d(in_chans, embed_dim, self.patch_size,
                              stride=(1,) + self.patch_size[1:])
        self.norm = nn.LayerNorm(embed_dim, eps=eps) if patch_norm else None

    def forward(self, x: torch.Tensor,
                wm: Optional[Tuple[Tuple[int, int, int], int]] = None
                ) -> torch.Tensor:
        """``wm`` = (window, Npad): the ``LVT_EMBING`` ingress, which the
        caller gates; the tokens come out in stage 1's window-major layout
        [B, nW, Npad, E] (``_u8_embed_wm``)."""
        B, D, H, W, C = x.shape
        pd, ph, pw = self.patch_size
        fold = x.dtype == torch.uint8 and pd == 2 and not (H % ph or W % pw)
        if wm is not None:
            out = self._u8_embed_wm(x, *wm)
        elif (fold and _PEK and not self.training
              and supports_fused_patch_embed(B, D, H, W, C,
                                             self.patch_size)):
            out = select(fused_patch_embed_u8)(x, self.proj.weight,
                                               self.proj.bias)
        elif fold:
            out = _pe_plain(x, self.proj.weight, self.proj.bias)
        else:
            out = self._embed_general(x)
        if self.norm is not None:
            out = layer_norm(out, self.norm.weight, self.norm.bias,
                             self.norm.eps)
        return out

    def _embed_general(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX float path: device normalize of a uint8 clip, the
        temporal end pad of one frame, the spatial pad, the conv as one
        product of the (kd, kh, kw, c) im2col."""
        dt = self.proj.weight.dtype
        x = device_normalize(x, dt) if x.dtype == torch.uint8 else x.to(dt)
        B, D, H, W, C = x.shape
        pd, ph, pw = self.patch_size
        x = nn.functional.pad(x, (0, 0, 0, -W % pw, 0, -H % ph, 0, 1))
        Dp, h2, w2 = D + 1, x.shape[2] // ph, x.shape[3] // pw
        xs = x.reshape(B, Dp, h2, ph, w2, pw, C).permute(0, 1, 2, 4, 3, 5, 6)
        xs = xs.reshape(B, Dp, h2, w2, ph * pw * C)
        feat = torch.cat([xs[:, d:Dp - pd + 1 + d] for d in range(pd)], -1)
        kmat = self.proj.weight.permute(2, 3, 4, 1, 0).reshape(
            -1, self.embed_dim)
        return torch.matmul(feat, kmat) + self.proj.bias

    def _u8_embed_wm(self, x: torch.Tensor, window: Tuple[int, int, int],
                     Npad: int) -> torch.Tensor:
        """``_pe_plain`` written straight into window-major [B, nW, Npad, E]
        (JAX ``_u8_embed_wm``): the u8 im2col composed with stage 1's
        window partition, one product, each row's bias-table entry by its
        time step (pad rows take the last one; their content is dead:
        masked keys, dropped at the stage's exit)."""
        B, D, H, W, C = x.shape
        _, ph, pw = self.patch_size
        wd, wh, ww = window
        nR, nWc, N = H // ph // wh, W // pw // ww, wd * wh * ww
        feat = u8_im2col(x, ph, pw)
        feat = feat.reshape(B, D, nR, wh, nWc, ww, -1).permute(
            0, 2, 4, 1, 3, 5, 6).reshape(B, nR * nWc, N, -1)
        feat = nn.functional.pad(feat, (0, 0, 0, Npad - N))
        kmat, bias_t = fold_weights(self.proj.weight, self.proj.bias, D)
        d_row = (torch.arange(Npad, device=x.device) // (wh * ww)).clamp(
            max=D - 1)
        dt = self.proj.weight.dtype
        out = torch.matmul(feat.to(dt), kmat.to(dt)).float()
        return (out + bias_t[d_row]).to(dt)


class VideoSwin3D(nn.Module):
    """Video Swin 3D backbone: uint8 [B, T, H, W, 3] -> [B, T, H/32, W/32, F]
    (F = embed_dim * 8), channels-last.  ``attn_impl``, ``remat`` and
    ``scan_blocks`` go to every stage (JAX swin3d.py:1461-1466)."""

    def __init__(self, config):
        super().__init__()
        cfg = config
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
                       cfg.layer_norm_eps, dpr[starts[i]:starts[i + 1]],
                       cfg.qkv_bias, cfg.attn_impl, cfg.remat,
                       cfg.scan_blocks)
            for i in range(n))
        self.norm = nn.LayerNorm(cfg.num_features, eps=cfg.layer_norm_eps)

    def build_serving_cache(self, T: int, H: int, W: int):
        """Precompute every stage's biases and masks (and, on the wm route
        under ``_FOLDCACHE``, the folded weights) for [*, T, H, W, 3]."""
        pd, ph, pw = self.patch_size
        D, h, w = T + 2 - pd, -(-H // ph), -(-W // pw)
        for layer in self.layers:
            layer.build_serving_cache(D, h, w)
            if layer.downsample is not None:
                h, w = (h + 1) // 2, (w + 1) // 2

    def clear_serving_cache(self):
        for layer in self.layers:
            layer._cache = {}

    def refresh_serving_cache(self) -> List[str]:
        """The staleness guard: each stage whose sources' record moved is
        rebuilt where its fingerprint no longer matches (the names of the
        rebuilt stages are returned).  Host work only for an unchanged
        model."""
        return [f"layers.{i}" for i, layer in enumerate(self.layers)
                if layer.refresh_serving_cache()]

    def embed_wm_geometry(self, x: torch.Tensor):
        """(spatial (D, h, w), window, Npad) of stage 1 where the
        ``LVT_EMBING`` ingress applies to ``x`` (JAX swin3d.py:1396-1420: a
        read per call, in ``eval()``, on uint8 clips with pd = 2 and no
        spatial pad whose stage 1 runs window-major), else None."""
        if (os.environ.get("LVT_EMBING", "0") != "1" or self.training
                or x.dtype != torch.uint8 or self.patch_size[0] != 2):
            return None
        B, T, H, W, _ = x.shape
        ph, pw = self.patch_size[1:]
        if H % ph or W % pw:
            return None
        spatial = (T, H // ph, W // pw)
        stage = self.layers[0]
        if not stage.wm_ok(*spatial):
            return None
        window, _ = get_window_size(spatial, stage.window_size, stage.shift)
        return spatial, window, round8(int(np.prod(window)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the drop-path random stream in training.  A
        forward that reads the serving cache (``eval()``, no autograd)
        first runs the staleness guard.  x uint8 (raw) or float (already
        normalized) [B, T, H, W, 3]."""
        if not (self.training or torch.is_grad_enabled()):
            self.refresh_serving_cache()
        embing, spatial = self.embed_wm_geometry(x), None
        if embing is None:
            x = self.patch_embed(x)
        else:
            spatial, window, Npad = embing
            x = self.patch_embed(x, (window, Npad))
        x = self.layers[0](x, generator, spatial)
        for layer in self.layers[1:]:
            x = layer(x, generator)
        return layer_norm(x, self.norm.weight, self.norm.bias, self.norm.eps)
