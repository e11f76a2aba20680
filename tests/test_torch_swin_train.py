"""The train step on the recomputing routes (``SwinConfig.remat``,
``BertConfig.remat``) of the port against the JAX package, f32 on the CPU.

- The retrieval-MLM loss and every gradient with ``SwinConfig.remat``
  (the port's "auto" falls back, under remat, to the spatial K14 route:
  the attention half + K9 in (no-shift, shift) pairs, each pair
  recomputed in the backward), dropout and drop-path 0, against JAX
  ``retrieval.make_loss_fn`` under its own remat.  Tolerances as
  tests/test_torch_train.py: loss 1e-4 relative, each gradient relative
  L2 1e-3.  The tiny config with a (8, 4, 4) window on clips of
  2 x 64 x 64: the window tiles stages of 16, 8 and 4 and shrinks in H
  and W at the 2 x 2 stage 4.
- ``BertConfig.remat``: the fusion encoder's gradients against the JAX
  encoder under remat, dropout 0, on both train routes (the module math
  and the K10 / K11 kernels' plain versions), 1e-3 as above.
- Replay: with drop-path 0.5 and dropout 0.1 the port with and without
  ``remat`` (Swin and BERT together) under one generator seed gives the
  same loss and gradients, each within relative L2 1e-5 (the same
  arithmetic, its gradients summed in another order: the differences are
  ~1e-6 of a gradient's largest entry, where coefficients drawn anew
  would differ at O(1)), and leaves the generator where it would be
  without the recomputation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavender_tpu import config as jcfg
from lavender_tpu.data.transforms import device_normalize
from lavender_tpu.models.bert import BertEncoder as JaxBertEncoder
from lavender_tpu.models.bert import extended_attention_mask as jax_ext_mask
from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu.tasks import retrieval as jretrieval
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models.bert import BertEncoder, extended_attention_mask
from lavender_tpu_torch.tasks import retrieval as tretrieval
from lavender_tpu_torch.train.trainer import create_train_state
from tests.test_torch_convert import TINY, port_config, random_params

TRUE_ID, FALSE_ID = 5, 6
_FAST = {"xla_backend_optimization_level": 0}


# the window tiles clips of 64 x 64 (K14 at every stage but the last)
SMALL = dataclasses.replace(TINY, swin=dataclasses.replace(
    TINY.swin, window_size=(8, 4, 4)))
REMAT = dataclasses.replace(
    SMALL, swin=dataclasses.replace(SMALL.swin, attn_impl="auto",
                                    remat=True),
    bert=dataclasses.replace(SMALL.bert, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0))


def _batch():
    g = np.random.RandomState(0)
    mask = np.ones((2, 8), np.int32)
    mask[1, 4:-1] = 0
    return {"img": g.randint(0, 256, (2, 2, 64, 64, 3)).astype(np.uint8),
            "txt": g.randint(1, 1024, (2, 8)).astype(np.int32) * mask,
            "mask": mask, "vid": np.array([0, 1], np.int32)}


@pytest.fixture(scope="module")
def params():
    img = jnp.zeros((1, 2, 64, 64, 3), jnp.uint8)
    txt = jnp.ones((1, 6), jnp.int32)
    return random_params(JaxLavender(SMALL), img, txt, txt)


def _grads(model):
    """{name: gradient}, zeros for a parameter the loss does not reach
    (JAX gives those a zero gradient)."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def _assert_grads(got, want, tol):
    """Each gradient within relative L2 ``tol``, its norm floored at 1e-3
    of the global gradient norm (a gradient that is zero in exact
    arithmetic is rounding noise on both sides)."""
    assert got.keys() == want.keys()
    floor = 1e-3 * float(torch.stack([w.double().norm()
                                      for w in want.values()]).norm())
    for name, w in want.items():
        rel = float((got[name].double() - w.double()).norm()) / max(
            float(w.double().norm()), floor)
        assert rel <= tol, (name, rel)


def test_swin_remat_loss_and_gradients_match_jax(params):
    batch = _batch()
    loss_fn = jretrieval.make_loss_fn(JaxLavender(REMAT), TRUE_ID, FALSE_ID)
    jbatch = dict(batch, img=device_normalize(jnp.asarray(batch["img"])))
    vg = jax.jit(jax.value_and_grad(loss_fn))
    key = jax.random.PRNGKey(1)
    want_loss, want = vg.lower(params, jbatch, key).compile(_FAST)(
        params, jbatch, key)
    want = from_flax(jax.tree_util.tree_map(np.asarray, want))
    state = create_train_state(port_config(REMAT),
                               port_config(jcfg.TrainConfig()),
                               device="cpu", params=params)
    layer = state.model.enc_img.swin.layers[0]
    assert not layer.wm_ok(2, 16, 16)  # remat: the spatial route
    loss = tretrieval.make_loss_fn(TRUE_ID, FALSE_ID)(
        state.model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    _assert_grads(_grads(state.model), want, 1e-3)


@pytest.mark.parametrize("fused", [False, True],
                         ids=["module-math", "fused"])
def test_bert_remat_gradients_match_jax(fused):
    """The encoder under remat in training (dropout 0): d(sum(out^2)) of
    the input and every parameter against JAX's."""
    cfg = dataclasses.replace(
        TINY.bert, remat=True, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, fused_attn_train=fused,
        fused_ffn_train=fused)
    g = np.random.RandomState(2)
    B, L = 2, 12
    x = g.randn(B, L, cfg.hidden_size).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    jm = JaxBertEncoder(cfg)
    bias = jax_ext_mask(jnp.asarray(mask))
    variables = {"params": random_params(jm, x, bias, seed=2)}

    def f(p, x):
        out = jm.apply({"params": p}, x, bias, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out ** 2)

    dp, dx = jax.jit(jax.grad(f, argnums=(0, 1)))(variables["params"], x)
    model = BertEncoder(port_config(cfg)).train()
    model.load_state_dict(from_flax(jax.tree_util.tree_map(
        np.asarray, variables["params"])), strict=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = model(tx, extended_attention_mask(torch.from_numpy(mask)),
                torch.Generator().manual_seed(0))
    out.square().sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), atol=1e-3,
                               rtol=1e-3)
    want = from_flax(jax.tree_util.tree_map(np.asarray, dp))
    _assert_grads(_grads(model), want, 1e-3)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_remat_replays_drop_path_and_dropout(params, impl):
    """The same loss, gradients and generator state with and without
    remat (Swin: the drop-path coefficients drawn before each checkpointed
    pair; BERT: each layer's draws from the generator state it started
    from)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(
            SMALL, swin=dataclasses.replace(SMALL.swin, attn_impl=impl,
                                            drop_path_rate=0.5, remat=remat),
            bert=dataclasses.replace(SMALL.bert, remat=remat))
        state = create_train_state(port_config(cfg),
                                   port_config(jcfg.TrainConfig()),
                                   device="cpu", params=params)
        gen = torch.Generator().manual_seed(7)
        loss = tretrieval.make_loss_fn(TRUE_ID, FALSE_ID)(state.model, batch,
                                                          gen)
        loss.backward()
        results.append((float(loss.detach()), _grads(state.model),
                        torch.rand(4, generator=gen)))
    (l0, g0, r0), (l1, g1, r1) = results
    assert l1 == pytest.approx(l0, rel=1e-6)
    torch.testing.assert_close(r1, r0, rtol=0, atol=0)
    _assert_grads(g1, g0, 1e-5)
