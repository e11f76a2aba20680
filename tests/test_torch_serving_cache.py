"""The serving cache of the port: the LN fold, the fingerprints and the
staleness guard, f32 on the CPU.

- The fold: each wm block's folded qkv and fc1 weights and biases against
  the ``fold_a`` / ``fold_b`` entries of the JAX cache that
  ``build_serving_bias_cache`` builds (Pallas interpret mode) on a tiny
  ``attn_impl="wm"`` backbone (embed 8, depths (2, 2), clips 1 x 2 x 56 x
  56), within 1e-5 (the same f32 products summed in another order); the
  fingerprints against the JAX cache's ``bias_fp`` / ``fold_fp`` on the
  same params (the port's also covers the qkv and fc1 biases); a forward
  through the cached, folded blocks against the uncached, unfolded one
  within 1e-5.
- The guard, in the config of tests/test_torch_model.py (embed 16, depths
  2/2/2/2, window 8x7x7; clips 1 x 2 x 224 x 224): after ``load_state_dict``
  of new rel-pos tables (std 1), a new ``norm1.weight`` or a new
  ``qkv.bias`` (which the JAX fold fingerprint does not cover) into a
  built server, the next request equals a freshly built server's output
  (the guard rebuilds the stale stages) where it differs from the old
  one; ``check_serving_cache`` raises on the stale cache; an unchanged
  model runs no fingerprint; the cache survives ``eval()``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu import config as jcfg
from lavender_tpu.models import swin3d as jswin
from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models import swin3d as tswin
from lavender_tpu_torch.serve import LavenderServer
from tests.test_torch_convert import port_config, random_params
from tests.test_torch_model import BERT, PORT_SWIN

WM = jcfg.SwinConfig(embed_dim=8, depths=(2, 2), num_heads=(1, 2),
                     window_size=(8, 7, 7), drop_path_rate=0.0,
                     scan_blocks=True, attn_impl="wm")
FOLD_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_cache():
    """(clip, params, the JAX cache collection) of the tiny wm backbone."""
    x = np.random.RandomState(0).randint(0, 256, (1, 2, 56, 56, 3)
                                         ).astype(np.uint8)
    m = jswin.VideoSwin3D(WM)
    params = random_params(m, jnp.asarray(x))
    old = jswin._FOLDCACHE
    jswin._FOLDCACHE = True
    try:
        with pltpu.force_tpu_interpret_mode():
            cache = jswin.build_serving_bias_cache(
                m, {"params": params}, jnp.asarray(x), use_jit=False)["cache"]
    finally:
        jswin._FOLDCACHE = old
    return x, params, cache


def _port_backbone(params, monkeypatch):
    monkeypatch.setattr(tswin, "_FOLDCACHE", True)
    model = tswin.VideoSwin3D(port_config(WM)).eval()
    model.load_state_dict(from_flax(jax_tree_np(params)), strict=True)
    model.build_serving_cache(2, 56, 56)
    return model


def jax_tree_np(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_fold_matches_jax_cache(jax_cache, monkeypatch):
    x, params, cache = jax_cache
    model = _port_backbone(params, monkeypatch)
    for i, layer in enumerate(model.layers):
        folds = next(iter(layer._cache.values()))[6]
        want = cache[f"layers_{i}"]
        for k, blk_fold in enumerate(folds):
            side = want["fold_b" if k % 2 else "fold_a"]
            for got, w, transpose in zip(blk_fold, side,
                                         (True, False, True, False)):
                w = np.asarray(w[k // 2])
                np.testing.assert_allclose(
                    got.numpy(), w.T if transpose else w, **FOLD_TOL)


def test_fingerprints_match_jax(jax_cache, monkeypatch):
    """bias fingerprint = JAX's; the JAX fold fingerprint's 24 entries
    (norm1, qkv kernel, norm2, fc1 kernel per side) are the port's without
    its qkv and fc1 bias entries."""
    x, params, cache = jax_cache
    model = _port_backbone(params, monkeypatch)
    covered = [0, 1, 2, 3, 4, 5, 8, 9, 10, 11, 12, 13]  # of one side's 16
    for i, layer in enumerate(model.layers):
        fp = layer._cache_fp.numpy()
        assert fp.shape == (4 + 32,)
        np.testing.assert_allclose(fp[:4], np.asarray(
            cache[f"layers_{i}"]["bias_fp"]), rtol=1e-5)
        fold = fp[4:]
        np.testing.assert_allclose(
            np.concatenate([fold[covered], fold[16:][covered]]),
            np.asarray(cache[f"layers_{i}"]["fold_fp"]), rtol=1e-5)


def test_cached_folded_forward_matches_uncached(jax_cache, monkeypatch):
    x, params, _ = jax_cache
    model = _port_backbone(params, monkeypatch)
    img = torch.from_numpy(x)
    with torch.no_grad():
        cached = model(img)
        model.clear_serving_cache()
        uncached = model(img)
    torch.testing.assert_close(cached, uncached, **FOLD_TOL)


# ---------------------------------------------------------------- the guard

CFG = jcfg.ModelConfig(swin=PORT_SWIN, bert=BERT)
CLIP = (1, 2, 224, 224, 3)


@pytest.fixture(scope="module")
def request_and_state():
    g = np.random.RandomState(0)
    img = g.randint(0, 256, CLIP).astype(np.uint8)
    txt = g.randint(1, BERT.vocab_size, (1, 26)).astype(np.int32)
    mask = np.ones((1, 26), np.int32)
    params = random_params(JaxLavender(CFG), jnp.zeros((1, 2, 64, 64, 3),
                                                       jnp.uint8),
                           jnp.ones((1, 6), jnp.int32),
                           jnp.ones((1, 6), jnp.int32))
    return (img, txt, mask), from_flax(jax_tree_np(params))


def _server(state):
    server = LavenderServer(port_config(CFG), device="cpu",
                            dtype=torch.float32, frames=2, size=224)
    server.model.load_state_dict(state, strict=True)
    server.model.build_serving_cache(2, 224, 224)
    return server


def _changed(state, which):
    g = torch.Generator().manual_seed(1)
    new = {k: v.clone() for k, v in state.items()}
    for k, v in new.items():
        if k.startswith("enc_img.swin.layers.") and k.endswith(which):
            new[k] = torch.randn(v.shape, generator=g) + (
                1.0 if which == "norm1.weight" else 0.0)
    return new


@pytest.mark.parametrize("which", ["relative_position_bias_table",
                                   "norm1.weight", "attn.qkv.bias"])
def test_stale_cache_is_never_served(request_and_state, which):
    """F1: new weights loaded into a built server are served (or refused),
    never the old cache."""
    req, state = request_and_state
    server = _server(state)
    old = server(*req)
    new_state = _changed(state, which)
    server.model.load_state_dict(new_state, strict=True)
    with pytest.raises(ValueError, match="stale serving cache at "
                                         "enc_img.swin.layers.0"):
        tswin.check_serving_cache(server.model)
    got = server(*req)
    want = _server(new_state)(*req)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # the stale cache would have served ``old``, far outside that tolerance
    assert float((want - old).abs().max()) > 1e-3
    assert tswin.check_serving_cache(server.model)


def test_guard_costs_no_device_work_when_unchanged(request_and_state,
                                                   monkeypatch):
    req, state = request_and_state
    server = _server(state)
    calls = []
    fingerprint = tswin.BasicLayer.fingerprint
    monkeypatch.setattr(tswin.BasicLayer, "fingerprint",
                        lambda self, fold: calls.append(1)
                        or fingerprint(self, fold))
    server(*req)
    server(*req)
    assert calls == []
    with torch.no_grad():  # an in-place update moves the record
        server.model.enc_img.swin.layers[1].blocks[0].norm1.weight.mul_(1.0)
    server(*req)
    assert len(calls) == 1  # that stage's fingerprint, found fresh
    server(*req)
    assert len(calls) == 1


def test_cache_survives_eval_and_goes_in_training(request_and_state):
    server = _server(request_and_state[1])
    swin = server.model.enc_img.swin
    server.model.eval()
    assert all(len(layer._cache) == 1 for layer in swin.layers)
    server.model.train()
    assert all(not layer._cache for layer in swin.layers)
    assert not tswin.check_serving_cache(server.model)
