"""Swin-L-384's geometry (the ``large_384`` preset: window 8 x 12 x 12) in
the port against the JAX package, f32 on the CPU.

- At narrow widths with Swin-L's real window: embed 16, depths (2, 2),
  heads (1, 2), window (8, 12, 12), clips of 5 x 96 x 96.  Stage 1 is a
  24 x 24 map of 4 windows of N = Npad = 5 x 12 x 12 = 720 tokens (no tail
  pad, as at every stage of Swin-L-384) with a shifted block; stage 2 is
  one 12 x 12 window, which its map fills, so it does not shift.  On the
  same numpy-seeded weights (``convert.from_flax``):
  - serving: the port's ``eval()`` "wm" route with the LN-fold serving
    cache against the JAX "wm" route under its own fold cache
    (``build_serving_bias_cache``), the JAX kernels in Pallas interpret
    mode, within 1e-4; the port's ops (their plain versions, counted) are
    the ones the JAX routing gives: K1 in every block with the folded
    weights, K2 around the shifted one, the MLP inside K1 at these widths;
  - training: the gradient of a seeded projection of the features with
    respect to every parameter, the port's train route (K1's attention
    half, K9) against JAX's "wm" train route (its custom VJPs, interpret
    mode), drop-path 0, each within relative L2 1e-3.
- At Swin-L's full widths, pure arithmetic: ``mlp_in_block`` gives True,
  False, False, False over the four stages (and equals the JAX
  ``full_block_fits_vmem``), and ``ln_mlp_plan``, ``gemm_tc_plan`` and
  ``swin_spatial_plan`` give valid tiles, slices and scratch at C = 1536,
  HD = 6144 for the B = 4 serving and B = 8 train rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu import config as jcfg
from lavender_tpu.models import swin3d as jswin
from lavender_tpu.ops.swin_block_attn import full_block_fits_vmem
from lavender_tpu_torch.config import SWIN_PRESETS
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models import swin3d as tswin
from lavender_tpu_torch.ops import _build, fused_mlp, swin_block_attn
from lavender_tpu_torch.ops import wm_permute
from tests.test_torch_convert import port_config, random_params

WM_L = jcfg.SwinConfig(embed_dim=16, depths=(2, 2), num_heads=(1, 2),
                       window_size=(8, 12, 12), drop_path_rate=0.0,
                       scan_blocks=True, attn_impl="wm")
CLIP = (1, 5, 96, 96, 3)
OPS = {"K1": swin_block_attn.fused_swin_block_wm,
       "K2": wm_permute.wm_shift_rows, "K3": fused_mlp.fused_ln_mlp_chunked,
       "K9": fused_mlp.fused_ln_mlp}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """(clip, params, JAX serving features under the fold cache, the
    cotangent, JAX train-route gradients of <features, cotangent>)."""
    x = np.random.RandomState(0).randint(0, 256, CLIP).astype(np.uint8)
    m = jswin.VideoSwin3D(WM_L)
    params = random_params(m, jnp.asarray(x))
    old = jswin._FOLDCACHE
    jswin._FOLDCACHE = True
    try:
        with pltpu.force_tpu_interpret_mode():
            variables = jswin.build_serving_bias_cache(
                m, {"params": params}, jnp.asarray(x), use_jit=False)
            feats = np.asarray(m.apply(variables, jnp.asarray(x)))
    finally:
        jswin._FOLDCACHE = old
    cot = np.random.RandomState(1).randn(*feats.shape).astype(np.float32)

    def loss(p):
        f = m.apply({"params": p}, jnp.asarray(x), deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(f * cot)
    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss)(params)
    return x, _np(params), feats, cot, _np(grads)


def _model(params):
    model = tswin.VideoSwin3D(port_config(WM_L))
    model.load_state_dict(from_flax(params), strict=True)
    return model


def _count(monkeypatch):
    """Calls of each op's plain version; K1 also split by ``folded``."""
    counts = dict.fromkeys([*OPS, "K1 folded"], 0)
    for name, op in OPS.items():
        def counted(*a, _name=name, _plain=op.plain, **k):
            counts[_name] += 1
            if k.get("folded") is not None:
                counts["K1 folded"] += 1
            return _plain(*a, **k)
        monkeypatch.setattr(op, "plain", counted)
    return counts


def test_wm_serving_with_fold_cache_matches_jax(reference, monkeypatch):
    x, params, want, _, _ = reference
    monkeypatch.setattr(tswin, "_FOLDCACHE", True)
    model = _model(params).eval()
    model.build_serving_cache(*CLIP[1:4])
    geo = [next(iter(layer._cache.values()))[:4] for layer in model.layers]
    assert geo == [((5, 12, 12), (0, 6, 6), 720, 720),
                   ((5, 12, 12), (0, 0, 0), 720, 720)]
    counts = _count(monkeypatch)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert counts == {"K1": 4, "K2": 2, "K3": 0, "K9": 0, "K1 folded": 4}
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_wm_train_gradients_match_jax(reference, monkeypatch):
    x, params, _, cot, grads = reference
    model = _model(params).train()
    counts = _count(monkeypatch)
    feats = model(torch.from_numpy(x), generator=torch.Generator())
    (feats * torch.from_numpy(cot)).sum().backward()
    assert counts["K1"] == 4 and counts["K9"] == 4 and counts["K2"] == 2
    want = from_flax(grads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = torch.as_tensor(np.asarray(want[name]))
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert rel <= 1e-3, (name, rel)


def test_full_width_predicates_and_plans():
    """Swin-L-384 at full width: the MLP is in K1's block at stage 1 only
    (the rel-pos bias of 720 x 720 is 6-48 MB past it), and the tile
    GEMM's plans take C = 1536, HD = 6144 at the serving (B = 4) and
    train (B = 8) rows of every stage."""
    swin = SWIN_PRESETS["large_384"]
    assert swin.window_size == (8, 12, 12)
    Npad = 5 * 12 * 12  # D = 5 at T = 5; 720 is a multiple of 8
    widths = [swin.embed_dim * 2 ** i for i in range(4)]
    assert widths[-1] == 1536 <= _build.MAX_ROW_C
    fits = [swin_block_attn.mlp_in_block(C, 4 * C, nH, Npad)
            for C, nH in zip(widths, swin.num_heads)]
    assert fits == [True, False, False, False]
    assert fits == [full_block_fits_vmem(C, 4 * C, nH, Npad)
                    for C, nH in zip(widths, swin.num_heads)]
    for nW, C in zip((64, 16, 4, 1), widths):
        HD = 4 * C
        for B in (4, 8):
            M = B * nW * Npad
            for residual in (True, False):
                plan = _build.ln_mlp_plan(M, C, HD, residual)
                assert plan.fc1_bm in (64, 128, 256)
                assert plan.fc2_bm in ((64, 128) if residual
                                       else (64, 128, 256))
                assert (HD // _build.TILE_K) % plan.splits == 0
                assert plan.scratch >= M * C * 2 + M * HD * 2 + (
                    plan.splits * M * C * 4 if plan.splits > 1 else 0)
            for n, k, res in ((3 * C, C, False), (C, C, True), (HD, C, False),
                              (C, HD, True)):
                tile = _build.gemm_tc_plan(M, n, k, residual=res)
                assert tile.bm in ((64, 128) if res else (64, 128, 256))
                assert tile.blocks == -(-M // tile.bm) * -(-n // 128)
            split = _build.gemm_tc_plan(M, C, C, split=True)
            assert (C // _build.TILE_K) % split.splits == 0
            sp = _build.swin_spatial_plan(M, C, HD)
            mlp = _build.ln_mlp_plan(M, C, HD, True)
            assert (sp.fc1_bm, sp.fc2_bm, sp.splits) == (
                mlp.fc1_bm, mlp.fc2_bm, mlp.splits)
            assert sp.proj_bm in (64, 128)
            assert sp.scratch == 5 * (-(-M * C * 2 // 256) * 256) + mlp.scratch
    assert _build.ln_mlp_plan(4 * Npad, 1536, 6144, True).fc2_bm == 128
