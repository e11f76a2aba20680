"""The retrieval-MLM train step of the port against the JAX package, f32 on
the CPU: the B x B pair loss and every gradient (JAX
``retrieval.make_loss_fn``), one AdamW update (optax ``build_optimizer``),
the LR schedule, the parameter groups, the cross-entropy, and drop-path by
statistics and by its lerp identity.

The loss test runs the PR 1 tiny config (Swin embed 16, BERT 64 wide) at
B = 2 clips of 2 x 224 x 224 (window 2x7x7: 98 tokens padded to 104) with
dropout and drop-path 0; the JAX side runs its module math
(``attn_impl="xla"``) on ``device_normalize``d clips and the float conv,
the port its train route (plain versions of K1, K2, K8 and K9, and on the
fused fusion-encoder route those of K10, K11 and K12) on the raw uint8
clips through the folded patch embed.  Tolerances:
loss 1e-4 relative, each gradient relative L2 1e-3 (f32, ~30 ops deep in
both directions, other summation orders, the normalize folded into the
conv weights on one side only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lavender_tpu import config as jcfg
from lavender_tpu.data.transforms import device_normalize
from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu.tasks import common as jcommon
from lavender_tpu.tasks import retrieval as jretrieval
from lavender_tpu.train import optimizer as jopt
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models.lavender import LavenderModel
from lavender_tpu_torch.models.swin3d import drop_path, drop_path_lerp
from lavender_tpu_torch.tasks import common as tcommon
from lavender_tpu_torch.tasks import retrieval as tretrieval
from lavender_tpu_torch.train import optimizer as topt
from lavender_tpu_torch.train.trainer import (create_train_state,
                                              make_train_step)
from tests.test_torch_convert import TINY, port_config

TRUE_ID, FALSE_ID = 5, 6
CFG = dataclasses.replace(
    TINY, bert=dataclasses.replace(TINY.bert, hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0))


@pytest.fixture(scope="module")
def params():
    """JAX params of the tiny model (CFG has the same parameter tree)."""
    img = jnp.zeros((1, 2, 64, 64, 3), jnp.uint8)
    txt = jnp.ones((1, 6), jnp.int32)
    params = jax.jit(JaxLavender(TINY).init)(jax.random.PRNGKey(0), img,
                                             txt, txt)
    return jax.tree_util.tree_map(np.asarray, params["params"])


def _batch(B=2, Lt=8):
    g = np.random.RandomState(0)
    mask = np.ones((B, Lt), np.int32)
    mask[1, 4:-1] = 0  # a padded caption; the appended [MASK] stays
    return {"img": g.randint(0, 256, (B, 2, 224, 224, 3)).astype(np.uint8),
            "txt": g.randint(1, 1024, (B, Lt)).astype(np.int32) * mask,
            "mask": mask, "vid": np.array([0, 1], np.int32)}


def _route(cfg, attn, ffn):
    """The port's ``cfg`` with the fusion encoder's train route set."""
    return dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, fused_attn_train=attn, fused_ffn_train=ffn))


@pytest.fixture(scope="module")
def jax_loss_and_grads(params):
    """The JAX loss and gradients on ``_batch()`` (its module math: the
    train kernels run on a TPU only, and at dropout 0 every route is the
    same function)."""
    loss_fn = jretrieval.make_loss_fn(JaxLavender(CFG), TRUE_ID, FALSE_ID)
    batch = _batch()
    jbatch = dict(batch, img=device_normalize(jnp.asarray(batch["img"])))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jbatch, jax.random.PRNGKey(1))
    return float(loss), from_flax(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("attn,ffn", [(False, False), (True, True)],
                         ids=["module-math", "fused"])
def test_train_loss_and_gradients_match_jax(params, jax_loss_and_grads,
                                            attn, ffn):
    """The whole loss and every gradient on both fusion-encoder routes
    against the same JAX loss (same tolerances)."""
    batch = _batch()
    want_loss, want = jax_loss_and_grads
    state = create_train_state(_route(port_config(CFG), attn, ffn),
                               port_config(jcfg.TrainConfig()),
                               device="cpu", params=params)
    model = state.model
    assert model.training
    loss = tretrieval.make_loss_fn(TRUE_ID, FALSE_ID)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
    grads = dict(model.named_parameters())
    assert grads.keys() == want.keys()
    # a gradient that is zero in exact arithmetic (the key biases: softmax
    # ignores a per-row constant) is rounding noise on both sides, so each
    # norm is floored at 1e-3 of the global gradient norm
    floor = 1e-3 * float(torch.stack([w.double().norm()
                                      for w in want.values()]).norm())
    for name, p in grads.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).double()
        w = want[name].double()
        err = float((g - w).norm())
        assert err <= 1e-3 * max(float(w.norm()), floor), (
            name, err, float(w.norm()))


def _tcfg():
    return jcfg.TrainConfig(lr=1e-3, decay=0.05, max_iter=10,
                            warmup_ratio=0.2, max_grad_norm=1.0,
                            vis_backbone_lr_mul=2.0)


def test_adamw_steps_match_optax(params):
    """Two updates (clipped gradients, the four groups, warmup) against
    optax's chain on the same params and gradients."""
    g = np.random.RandomState(3)
    grads = [jax.tree_util.tree_map(
        lambda a: (g.randn(*a.shape) * 0.05).astype(np.float32), params)
        for _ in range(2)]
    tx = jopt.build_optimizer(params, _tcfg())

    @jax.jit
    def update(gr, opt_state, p):
        updates, opt_state = tx.update(gr, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    opt_state, want = tx.init(params), params
    for gr in grads:
        want, opt_state = update(gr, opt_state, want)

    model = LavenderModel(port_config(TINY))
    model.load_state_dict(from_flax(params), strict=True)
    opt, sched = topt.build_optimizer(model, port_config(_tcfg()))
    named = dict(model.named_parameters())
    for gr in grads:
        for k, v in from_flax(gr).items():
            named[k].grad = v
        norm = topt.clip_by_global_norm(named.values(), 1.0)
        assert float(norm) > 1.0  # the clip is exercised
        opt.step()
        sched.step()
    want = from_flax(jax.tree_util.tree_map(np.asarray, want))
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_lr_schedule_matches_jax():
    cfg = _tcfg()
    jsched = jopt.warmup_linear_schedule(1e-3, 10, 0.2, 1e-8)
    tsched = topt.warmup_linear_schedule(1e-3, 10, 0.2, 1e-8)
    for step in range(13):
        np.testing.assert_allclose(tsched(step), float(jsched(step)),
                                   rtol=1e-6)
    model = LavenderModel(port_config(TINY))
    opt, sched = topt.build_optimizer(model, port_config(cfg))
    jscheds = {mul: jopt.warmup_linear_schedule(1e-3 * mul, 10, 0.2, 1e-8)
               for mul in (1.0, 2.0)}  # the Swin groups' base LR is x2
    for step in range(12):  # the groups' LR as the optimizer reads it
        for grp in opt.param_groups:
            mul = 2.0 if grp["name"].startswith("swin") else 1.0
            np.testing.assert_allclose(grp["lr"], float(jscheds[mul](step)),
                                       rtol=1e-6)
        opt.step()
        sched.step()


def test_param_group_labels_match_jax(params):
    labels = jopt.param_group_labels(params)
    ids = {name: i for i, name in enumerate(topt.GROUPS)}
    coded = jax.tree_util.tree_map(
        lambda lab, p: np.full(p.shape, ids[lab], np.float32), labels,
        params)
    want = {k: topt.GROUPS[int(v.flatten()[0])]
            for k, v in from_flax(coded).items()}
    got = topt.param_group_labels(LavenderModel(port_config(TINY)))
    assert got == want
    assert got["enc_img.swin.layers.0.blocks.1.attn."
               "relative_position_bias_table"] == "swin_nodecay"
    assert got["trsfr.layer.0.output.LayerNorm.weight"] == "other_nodecay"


def test_cross_entropy_ignore_matches_jax():
    g = np.random.RandomState(4)
    logits = g.randn(6, 3, 11).astype(np.float32)
    labels = g.randint(0, 11, (6, 3))
    labels[0] = -1
    want = jcommon.cross_entropy_ignore(jnp.asarray(logits),
                                        jnp.asarray(labels))
    got = tcommon.cross_entropy_ignore(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(tcommon.cross_entropy_ignore(
        torch.from_numpy(logits), torch.full((6, 3), -1))) == 0.0


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_drop_path_keep_rate_and_lerp_identity(rate):
    n = 20000
    x = torch.ones(n, 2, 3)
    out = drop_path(x, rate, torch.Generator().manual_seed(0))
    kept = out[:, 0, 0] != 0
    keep = 1.0 - rate
    assert abs(float(kept.float().mean()) - keep) <= 4 * (
        keep * rate / n) ** 0.5
    # whole samples are kept or dropped, kept ones scaled by 1 / keep
    assert torch.equal(out, kept[:, None, None].float() / keep
                       * torch.ones(1, 2, 3))
    # x + coef * (full - x) == x + drop_path(full - x) for the same mask
    x, full = torch.randn(64, 4, 5), torch.randn(64, 4, 5)
    a = drop_path_lerp(x, full, rate, torch.Generator().manual_seed(1))
    b = x + drop_path(full - x, rate, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)
    assert drop_path_lerp(x, full, 0.0) is full


@pytest.mark.parametrize("attn,ffn", [(False, False), (True, False),
                                      (True, True)],
                         ids=["module-math", "default", "fused-ffn"])
def test_train_step_runs_on_every_route(attn, ffn):
    """Two CPU steps through ``make_train_step`` with dropout 0.1 on each
    fusion-encoder route (the default ``ModelConfig`` route among them):
    the config builds, the losses are finite, the parameters move."""
    cfg = port_config(TINY)
    assert (cfg.bert.fused_attn_train, cfg.bert.fused_ffn_train) == (
        True, False)  # the JAX defaults
    state = create_train_state(_route(cfg, attn, ffn), port_config(_tcfg()),
                               device="cpu", seed=0)
    step = make_train_step(tretrieval.make_loss_fn(TRUE_ID, FALSE_ID), state)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    before = state.model.fc_mtm.predictions.decoder.weight.detach().clone()
    qkv = state.model.trsfr.layer[0].attention.self.query.weight
    q_before = qkv.detach().clone()
    losses = [float(step(batch)) for _ in range(2)]
    assert all(np.isfinite(losses)) and state.step == 2
    assert not torch.equal(before,
                           state.model.fc_mtm.predictions.decoder.weight)
    assert not torch.equal(q_before, qkv)  # gradients reach the encoder
