"""The uint8 patch embed K17 of the port against the JAX package, f32 on
the CPU.

- The plain version of ``fused_patch_embed_u8`` against the JAX kernel in
  Pallas interpret mode (as tests/test_patch_embed_kernel.py runs it) at
  that file's sizes, within 3e-2 of the largest output: the JAX kernel
  rounds its folded weights to bf16 (2^-9 relative) and sums 96 such
  products, while the port's plain version runs in the weights' dtype
  (f32 here).  Against the f32 reference semantics (device_normalize ->
  temporal zero pad -> conv) and the JAX module's own u8 route
  (``_u8_embed``), the same function in f32, within 1e-4.
- The end pad: at D=2 the last time step sees a normalized-zero frame.
- The route's gate against JAX ``supports_fused_patch_embed`` on a grid
  of geometries, w2 % 8 != 0 among them, and the module's route: K17
  only under ``_PEK``, in ``eval()``, where the gate holds.
- The card kernel's launch plan (``_build.patch_embed_plan``, pure
  arithmetic): its units tile the output once, the persistent grid fills
  the card or takes every unit, the copies are 16 bytes only where every
  pixel segment is 16-byte aligned.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                          device_normalize)
from lavender_tpu.models import swin3d as jswin
from lavender_tpu.ops import patch_embed_u8 as jpe
from lavender_tpu_torch.models import swin3d as tswin
from lavender_tpu_torch.ops import _build
from lavender_tpu_torch.ops import patch_embed_u8 as tpe


def _setup(B, D, H, W, E, seed):
    """u8 clips, the JAX conv params (DHWIO kernel, bias), the f32
    reference output and the port's Conv3d weight [E, 3, 2, 4, 4]."""
    g = np.random.RandomState(seed)
    u8 = g.randint(0, 256, (B, D, H, W, 3)).astype(np.uint8)
    kern = (g.randn(2, 4, 4, 3, E) * 0.05).astype(np.float32)
    bias = (g.randn(E) * 0.05).astype(np.float32)
    pe = jswin.PatchEmbed3D(embed_dim=E, patch_norm=False, dtype=jnp.float32)
    params = {"params": {"proj": {"kernel": jnp.asarray(kern),
                                  "bias": jnp.asarray(bias)}}}
    want = np.asarray(pe.apply(params, device_normalize(jnp.asarray(u8),
                                                        dtype=jnp.float32)))
    u8_route = np.asarray(pe.apply(params, jnp.asarray(u8)))
    weight = torch.from_numpy(kern).permute(4, 3, 0, 1, 2).contiguous()
    return u8, kern, bias, want, u8_route, weight


def _plain(u8, weight, bias):
    with torch.no_grad():
        return tpe.fused_patch_embed_u8(torch.from_numpy(u8), weight,
                                        torch.from_numpy(bias)).numpy()


def test_plain_matches_jax_kernel_and_reference():
    B, D, H, W, E = 2, 5, 32, 32, 16
    u8, kern, bias, want, u8_route, weight = _setup(B, D, H, W, E, 3)
    assert tpe.supports_fused_patch_embed(B, D, H, W, 3, (2, 4, 4))
    got = _plain(u8, weight, bias)
    assert got.shape == want.shape == (B, D, H // 4, W // 4, E)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, u8_route, atol=1e-4, rtol=1e-4)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jpe.fused_patch_embed_u8(
            jnp.asarray(u8), jnp.asarray(kern), jnp.asarray(bias),
            IMAGENET_MEAN, IMAGENET_STD, dtype=jnp.float32))
    scale = max(1.0, float(np.abs(kernel).max()))
    assert float(np.abs(got - kernel).max()) <= 3e-2 * scale


def test_end_pad_frame_is_a_normalized_zero():
    u8, _, bias, want, _, weight = _setup(1, 2, 32, 32, 8, 4)
    got = _plain(u8, weight, bias)
    np.testing.assert_allclose(got[:, -1], want[:, -1], atol=1e-4, rtol=1e-4)


_GRID = list(itertools.product((1, 2), (2, 5), (32, 30, 224), (32, 40, 224),
                               (3, 1), ((2, 4, 4), (1, 4, 4), (2, 2, 2))))


@pytest.mark.parametrize("B,D,H,W,C,patch", _GRID[::7] + [
    (1, 5, 224, 224, 3, (2, 4, 4)), (1, 5, 224, 200, 3, (2, 4, 4)),
    (1, 2, 1024, 1024, 3, (2, 4, 4))])
def test_gate_matches_jax(B, D, H, W, C, patch):
    assert tpe.supports_fused_patch_embed(B, D, H, W, C, patch) == \
        jpe.supports_fused_patch_embed(B, D, H, W, C, patch)


@pytest.mark.parametrize("pek,train,W,want", [
    (True, False, 64, 1), (False, False, 64, 0), (True, True, 64, 0),
    (True, False, 56, 0)], ids=["pek-eval", "default", "pek-train",
                                "pek-w2-not-8"])
def test_module_routes_through_the_kernel(monkeypatch, pek, train, W, want):
    """PatchEmbed3D calls K17 under _PEK in eval() where the gate holds
    (W=56: w2 = 14), and computes the same function either way."""
    calls = []
    plain = tpe.fused_patch_embed_u8.plain
    monkeypatch.setattr(tpe.fused_patch_embed_u8, "plain",
                        lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(tswin, "_PEK", pek)
    u8, _, bias, want_out, _, weight = _setup(1, 2, 32, W, 16, 5)
    pe = tswin.PatchEmbed3D(embed_dim=16, patch_norm=False).train(train)
    with torch.no_grad():
        pe.proj.weight.copy_(weight)
        pe.proj.bias.copy_(torch.from_numpy(bias))
        got = pe(torch.from_numpy(u8)).numpy()
    assert len(calls) == want
    np.testing.assert_allclose(got, want_out, atol=1e-4, rtol=1e-4)


def test_kernel_weights_follow_the_parameters():
    """The kernel's folded weights are kept for the last parameters and
    redone when those change in place (or other tensors come)."""
    _, _, bias, _, _, weight = _setup(1, 2, 32, 32, 16, 6)
    w, b = torch.nn.Parameter(weight), torch.nn.Parameter(
        torch.from_numpy(bias))
    first = tpe.kernel_weights(w, b, 2)
    assert all(x is y for x, y in zip(tpe.kernel_weights(w, b, 2), first))
    kmat, bias_t = tpe.fold_weights(w, b, 2)
    torch.testing.assert_close(first[0].float(),
                               kmat.to(torch.bfloat16).float())
    torch.testing.assert_close(first[1], bias_t)
    with torch.no_grad():
        w.mul_(2.0)
    again = tpe.kernel_weights(w, b, 2)
    torch.testing.assert_close(again[0].float(), (2 * kmat).to(
        torch.bfloat16).float())
    assert tpe.kernel_weights(w.detach().clone(), b, 2)[0] is not again[0]


@pytest.mark.parametrize("B,D,H,W,E,aligned", [
    (4, 5, 224, 224, 128, True), (8, 5, 224, 224, 128, True),  # Swin-B
    (1, 1, 32, 32, 128, True), (1, 3, 16, 288, 128, True),     # D 1, w2 72
    (2, 2, 32, 64, 192, True), (1, 2, 16, 40, 64, True),       # E 192, W 40
    (2, 5, 64, 96, 96, False)])                                # x off 16 B
def test_k17_plan_tiles_the_output_once(B, D, H, W, E, aligned):
    """K17's units (a frame's row of up to 64 patches) cover every output
    row once; the grid is the units or two blocks an SM (one above E =
    128), so it fills the card where there are units for it; 16-byte
    copies only from a 16-byte aligned clip whose rows are multiples of 16
    bytes, else 4-byte ones."""
    plan = _build.patch_embed_plan(B, D, H, W, E, aligned)
    h2, w2 = H // 4, W // 4
    chunks = [(j0, min(64, w2 - j0)) for j0 in range(0, w2, 64)]
    assert plan.units == B * D * h2 * len(chunks)
    assert sum(n for _, n in chunks) == w2 and all(n > 0 for _, n in chunks)
    per_sm = 2 if E <= 128 else 1
    assert plan.blocks == min(plan.units, per_sm * _build.H100_SMS)
    assert plan.vec == (16 if aligned and W % 16 == 0 else 4)
    if plan.vec == 16:  # each segment, 12 bytes a patch, in whole copies
        assert all(12 * j0 % 16 == 0 and 12 * n % 16 == 0
                   for j0, n in chunks)
