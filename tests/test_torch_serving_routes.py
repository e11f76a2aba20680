"""The port's serving routes of the JAX switches against the JAX package,
f32 on the CPU: the fold cache (``LVT_FOLDCACHE``, default on), the uint8
patch embed K17 (``LVT_PEK``) and the shifted block with the shift inside
K16 (``LVT_IKS``), each alone and all three together.

In the config of tests/test_torch_model.py (embed 16, depths 2/2/2/2,
window 8x7x7) on clips of 2 x 224 x 224 (one a request, two a train
batch) both new kernels apply: K17 needs
w2 % 8 == 0 (w2 = 56), and K16 takes stage 3 (14 x 14, nW = 4); stage 4
fills its window and does not shift.  Each route computes the same function
as the default, so the port's logits are held against the JAX package's
``attn_impl="xla"`` module math (1e-3) and its backbone features against
JAX's (1e-4), as tests/test_torch_model.py does; the ops each route calls
(their plain versions, counted) are the ones the JAX routing gives
(``_BlockPairWM`` / ``SwinBlockWM`` / ``PatchEmbed3D``).  The retrieval
train step under ``_IKS`` (K16's plain version under autograd, drop-path
0.3 and dropout 0.1 from one generator) against the port without it: the
same loss and gradients within 1e-5 (pad rows differ, through keys masked
at -100 only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavender_tpu import config as jcfg
from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu.models.swin3d import VideoSwin3D as JaxSwin
from lavender_tpu_torch.models import swin3d as tswin
from lavender_tpu_torch.ops import fused_mlp, patch_embed_u8
from lavender_tpu_torch.ops import swin_block_attn, wm_permute
from lavender_tpu_torch.serve import LavenderServer
from lavender_tpu_torch.tasks import retrieval
from lavender_tpu_torch.train.trainer import create_train_state
from tests.test_torch_convert import port_config, random_params
from tests.test_torch_model import BERT, SWIN

CFG = jcfg.ModelConfig(swin=SWIN, bert=BERT)
PORT_CFG = dataclasses.replace(CFG, swin=dataclasses.replace(
    SWIN, attn_impl="auto"))
CLIP = (1, 2, 224, 224, 3)
# the JAX switches in the port, per route: (_FOLDCACHE, _PEK, _IKS)
ROUTES = {"nofold": (False, False, False), "fold": (True, False, False),
          "pek": (True, True, False), "iks": (True, False, True),
          "all": (True, True, True)}
OPS = {"K1": swin_block_attn.fused_swin_block_wm,
       "K2": wm_permute.wm_shift_rows, "K3": fused_mlp.fused_ln_mlp_chunked,
       "K9": fused_mlp.fused_ln_mlp,
       "K16": swin_block_attn.fused_swin_block_wm_shifted,
       "K17": patch_embed_u8.fused_patch_embed_u8}


@pytest.fixture(scope="module")
def reference():
    """(request, params, JAX logits, JAX backbone features)."""
    g = np.random.RandomState(0)
    img = g.randint(0, 256, CLIP).astype(np.uint8)
    mask = np.ones((1, 26), np.int32)
    mask[0, 17:] = 0
    txt = g.randint(1, BERT.vocab_size, (1, 26)).astype(np.int32) * mask
    params = random_params(JaxLavender(CFG), jnp.zeros((1, 2, 64, 64, 3),
                                                       jnp.uint8),
                           jnp.ones((1, 6), jnp.int32),
                           jnp.ones((1, 6), jnp.int32))
    logits = np.asarray(jax.jit(JaxLavender(CFG).apply)(
        {"params": params}, img, txt, mask))
    feats = np.asarray(jax.jit(JaxSwin(SWIN).apply)(
        {"params": params["enc_img"]["swin"]}, img))
    params = jax.tree_util.tree_map(np.asarray, params)
    return (img, txt, mask), params, logits, feats


def _switch(monkeypatch, route):
    fold, pek, iks = ROUTES[route]
    monkeypatch.setattr(tswin, "_FOLDCACHE", fold)
    monkeypatch.setattr(tswin, "_PEK", pek)
    monkeypatch.setattr(tswin, "_IKS", iks)


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


# one forward of the tiny backbone at 2 x 224 x 224, from the JAX routing
WANT = {"nofold": {"K1": 8, "K2": 6},
        "fold": {"K1": 8, "K2": 6, "K1 folded": 8},
        "pek": {"K1": 8, "K2": 6, "K1 folded": 8, "K17": 1},
        "iks": {"K1": 7, "K2": 4, "K1 folded": 7, "K16": 1, "K9": 1},
        "all": {"K1": 7, "K2": 4, "K1 folded": 7, "K16": 1, "K9": 1,
                "K17": 1}}


@pytest.mark.parametrize("route", list(ROUTES))
def test_serving_route_matches_jax_and_calls_its_kernels(
        reference, monkeypatch, route):
    request, params, logits, feats = reference
    _switch(monkeypatch, route)
    server = LavenderServer(port_config(PORT_CFG), device="cpu",
                            params=params, dtype=torch.float32, frames=2,
                            size=224)
    folds = next(iter(server.model.enc_img.swin.layers[0]._cache.values()))[6]
    assert (folds[0] is not None) == ROUTES[route][0]
    counts = _count(monkeypatch)
    got = server(*request)
    assert counts == {k: WANT[route].get(k, 0) for k in counts}
    np.testing.assert_allclose(got.numpy(), logits, atol=1e-3, rtol=1e-3)
    with torch.inference_mode():
        f = server.model.enc_img.swin(torch.from_numpy(request[0]))
    np.testing.assert_allclose(f.numpy(), feats, atol=1e-4, rtol=1e-4)


def _step(params, iks, monkeypatch):
    monkeypatch.setattr(tswin, "_IKS", iks)
    cfg = dataclasses.replace(PORT_CFG, swin=dataclasses.replace(
        PORT_CFG.swin, drop_path_rate=0.3))
    state = create_train_state(port_config(cfg),
                               port_config(jcfg.TrainConfig()), device="cpu",
                               params=params)
    request = {"img": torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2,) + CLIP[1:]).astype(np.uint8)),
        "txt": torch.arange(2, 18).reshape(2, 8),
        "mask": torch.ones(2, 8, dtype=torch.long), "vid": torch.arange(2)}
    counts = _count(monkeypatch)
    loss = retrieval.make_loss_fn(5, 6)(state.model, request,
                                        torch.Generator().manual_seed(3))
    loss.backward()
    grads = {n: p.grad for n, p in state.model.named_parameters()
             if p.grad is not None}
    return float(loss.detach()), grads, dict(counts)


def test_train_step_under_iks_matches_default(reference, monkeypatch):
    params = reference[1]
    loss0, grads0, counts0 = _step(params, False, monkeypatch)
    loss1, grads1, counts1 = _step(params, True, monkeypatch)
    # the forward's calls (the backward of plain versions is autograd's)
    assert counts0 == {**dict.fromkeys(counts0, 0), "K1": 8, "K2": 6,
                       "K9": 8}
    assert counts1 == {**dict.fromkeys(counts1, 0), "K1": 7, "K2": 4,
                       "K9": 8, "K16": 1}
    assert loss1 == pytest.approx(loss0, rel=1e-5)
    assert grads1.keys() == grads0.keys()
    for name, g0 in grads0.items():
        err = float((grads1[name] - g0).norm() / g0.norm().clamp_min(1e-30))
        assert err <= 1e-5, (name, err)
