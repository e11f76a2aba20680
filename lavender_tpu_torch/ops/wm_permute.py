"""The window-major cyclic shift as one row permutation (port of
lavender_tpu/ops/wm_permute.py).

``wm_shift_rows`` replaces the TPU kernel ``_perm_kernel``
(lavender_tpu/ops/wm_permute.py:127, wrapper ``wm_shift_pallas`` :152).
The wm layout keeps the whole temporal axis inside every window, so the
shift reverse -> roll -> partition is a static permutation of the
[nW * Npad] rows in which every real output row is one real input row and
the window tail-pad rows are zero.  The host builds that permutation once
per (geometry, shift, direction) as an int32 index (-1 for a pad row) and
keeps it on the device; on the card ``csrc/permute.cu`` gathers the rows
in one read and one write of the tensor.  Its gradient is the same gather
with the inverse index (a permutation with zeroed pads transposes to the
inverse shift), so the backward is another launch of the same kernel;
only a call that autograd records goes through that Function, a serving
call launches directly.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from lavender_tpu_torch.ops import _build


@functools.lru_cache(maxsize=128)
def shift_index(window: Tuple[int, int, int], D: int, H: int, W: int,
                Npad: int, shift: Tuple[int, int, int],
                inverse: bool) -> np.ndarray:
    """int32 [nW * Npad]: the source row of every output row of the shift
    (-1 for a window's tail-pad rows).

    The forward shift rolls the spatial map by -shift, the inverse by
    +shift; ``roll(x, sh)[c] == x[(c - sh) % size]`` per axis (the JAX
    package's ``_perm_runs``, before its merge into contiguous runs)."""
    wd, wh, ww = window
    if wd != D:
        raise ValueError(f"wm layout requires wd == D, got {wd} vs {D}")
    nR, nWc = H // wh, W // ww
    N = wd * wh * ww
    sh = [int(s) if inverse else -int(s) for s in shift]
    r, c, d, i, j = np.meshgrid(np.arange(nR), np.arange(nWc), np.arange(wd),
                                np.arange(wh), np.arange(ww), indexing="ij")
    src_d = (d - sh[0]) % D
    sr, si = np.divmod((r * wh + i - sh[1]) % H, wh)
    sc, sj = np.divmod((c * ww + j - sh[2]) % W, ww)
    src = (sr * nWc + sc) * Npad + src_d * wh * ww + si * ww + sj
    index = np.full((nR * nWc, Npad), -1, np.int32)
    index[:, :N] = src.reshape(nR * nWc, N)
    return index.reshape(-1)


_on_device: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def shift_indices(window: Sequence[int], D: int, H: int, W: int, Npad: int,
                  shift: Sequence[int], device, inverse: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index, inverse index) of the shift (of its inverse with
    ``inverse``) on ``device``: int32 [nW * Npad] each, built once per
    geometry (one dict lookup a call).  Built outside inference mode, so
    that a training step may save them for its backward after a serving
    call (under ``inference_mode``) built them."""
    key = (tuple(window), D, H, W, Npad, tuple(shift), device)
    pair = _on_device.get(key)
    if pair is None:
        geom = (tuple(int(w) for w in window), int(D), int(H), int(W),
                int(Npad), tuple(int(s) for s in shift))
        with torch.inference_mode(False):
            pair = _on_device[key] = tuple(
                torch.as_tensor(shift_index(*geom, inv), device=device)
                for inv in (False, True))
    return pair[::-1] if inverse else pair


def _permute_plain(t: torch.Tensor, index: torch.Tensor,
                   inv_index: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``wm_shift_rows``: t [B, nW, Npad, C] ->
    rows gathered by ``index`` (zero where it is < 0).  ``inv_index`` is
    the kernel's backward; autograd finds the same gradient here."""
    B, nW, Npad, C = t.shape
    rows = t.reshape(B, nW * Npad, C).index_select(
        1, index.clamp(min=0).to(torch.long))
    rows = torch.where((index >= 0)[None, :, None], rows, rows.new_zeros(()))
    return rows.reshape(B, nW, Npad, C)


class _PermuteFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, index, inv_index):
        ctx.save_for_backward(index, inv_index)
        return _build.permute_rows(t.contiguous(), index)

    @staticmethod
    def backward(ctx, g):
        index, inv_index = ctx.saved_tensors
        return wm_shift_rows(g.contiguous(), inv_index, index), None, None


def _permute_cuda(t, index, inv_index):
    if _build.needs_grad(t):  # autograd records the call: the Function
        return _PermuteFn.apply(t, index, inv_index)
    return _build.permute_rows(t.contiguous(), index)


wm_shift_rows = _build.KernelOp("K2 wm_shift_rows", _permute_plain,
                                _permute_cuda, casts=False)


def wm_shift(t: torch.Tensor, window: Sequence[int], D: int, H: int, W: int,
             shift: Sequence[int], inverse: bool = False) -> torch.Tensor:
    """Cyclic shift of window-major t [B, nW, Npad, C] (the inverse with
    ``inverse``), through ``wm_shift_rows`` (or its plain version inside
    ``plain_path()``).  Pad rows of the result are zero."""
    index, inv_index = shift_indices(window, D, H, W, t.shape[2], shift,
                                     t.device, inverse)
    return _build.select(wm_shift_rows)(t, index, inv_index)
