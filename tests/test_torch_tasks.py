"""The fine-tuning and pretraining tasks of the port (tasks/qamc, qaoe,
retmc, retrieval, pretrain, multi_task) and the model variants
pretraining needs (EncVideo's ``odr`` / ``vt_mask``, EncTxt's text
transformer) against the JAX package, f32 on the CPU; the task-specific
heads (tasks/task_specific, models/heads) are in
tests/test_torch_task_heads.py, on the helpers here.

The model: Swin embed 8, depths 1/1/1/1 (as tests/test_tasks.py, not
scanned: the same function, a shorter JAX trace), BERT 64 wide with 1
layer, ``attn_impl="xla"`` on both sides, uint8 clips of
2 x 64 x 64 (10 video tokens), 8 text tokens, dropout and drop-path 0 (the
task heads' own dropout too: the JAX side runs its heads through a
subclass that builds them at rate 0, the port sets ``MLPHead.p``), so that
both sides compute one function.  Params: one seeded numpy draw of the
JAX multi-head model's tree (LN scales 1 + N(0, 0.1^2), the rest
N(0, 0.05^2)), given to both through ``convert.from_flax``.  Each task's
loss within 1e-3 relative, every gradient within relative L2 1e-3 (as
tests/test_torch_captioning.py), its eval step's scores within 1e-3 and
its accuracies equal.  Pretraining's negatives cannot be the same draws
(``jax.random`` top-k against a ``torch.Generator``), so the port is given
JAX's indices for the comparison, and a separate test checks the port's
draw.  Each JAX function is compiled once, at XLA's lowest optimisation
level (the compile is most of the time at these shapes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavender_tpu import config as jcfg
from lavender_tpu.models import captioning as jcap
from lavender_tpu.models.heads import MLPHead as JaxMLPHead
from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu.tasks import common as jcommon
from lavender_tpu.tasks import pretrain as jpre
from lavender_tpu.tasks import qamc as jqamc
from lavender_tpu.tasks import qaoe as jqaoe
from lavender_tpu.tasks import retmc as jretmc
from lavender_tpu.tasks import retrieval as jret
from lavender_tpu.tasks import task_specific as jts
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models.lavender import LavenderModel
from lavender_tpu_torch.tasks import (common, multi_task, pretrain, qamc,
                                      qaoe, retmc, retrieval, task_specific)
from lavender_tpu_torch.train.trainer import create_train_state, make_train_step
from tests.test_torch_convert import port_config

CFG = jcfg.ModelConfig(
    swin=jcfg.SwinConfig(embed_dim=8, depths=(1, 1, 1, 1),
                         num_heads=(2, 2, 2, 2), window_size=(8, 7, 7),
                         drop_path_rate=0.0, attn_impl="xla",
                         scan_blocks=False),
    bert=jcfg.BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=1,
                         num_attention_heads=4, intermediate_size=128,
                         max_position_embeddings=64, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0))
HEADS = (("qamc", 3), ("tgif-action", 5))  # LavenderMultiHead's fc_<name>
TRUE_ID, FALSE_ID, MASK_ID = 5, 6, 7
DIGITS = (10, 11, 12)
LT = 8
_FAST = {"xla_backend_optimization_level": 0}


def _run(fn, *args):
    """``jax.jit(fn)(*args)``, compiled at the lowest optimisation level."""
    jitted = jax.jit(fn)
    return jitted.lower(*args).compile(_FAST)(*args)


def _t(a):
    return torch.from_numpy(np.array(a))


class JaxMultiHead(jts.LavenderMultiHead):
    """The JAX multi-head model with its heads' dropout at 0."""

    def setup(self):
        JaxLavender.setup(self)
        self.fc = JaxMLPHead(self.config.hidden_size, self.head_out,
                             dropout=0.0, name="fc")
        self.fcs = {name: JaxMLPHead(self.config.hidden_size, out,
                                     dropout=0.0,
                                     name=f"fc_{name.replace('-', '_')}")
                    for name, out in self.heads}


def _jax_model(head_out=1, cfg=CFG):
    return JaxMultiHead(cfg, head_out=head_out, heads=HEADS)


def _draw_params(module, seed=0):
    """A numpy draw of ``module``'s parameter tree (from ``eval_shape``,
    which compiles nothing)."""
    img = jnp.zeros((1, 2, 64, 64, 3), jnp.uint8)
    txt = jnp.ones((1, 6), jnp.int32)
    shapes = jax.eval_shape(
        lambda r: module.init(r, img, txt, txt,
                              method=JaxMultiHead.init_forward),
        jax.random.PRNGKey(0))["params"]
    g = np.random.RandomState(seed)

    def fill(path, leaf):
        a = g.randn(*leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * a if path[-1].key == "scale" else 0.05 * a
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _head_keys(params):
    return {k for k in params if k == "fc" or k.startswith("fc_")
            and k != "fc_mtm"}


@pytest.fixture(scope="module")
def params():
    return _draw_params(_jax_model())


def _port_model(params, cls=LavenderModel, cfg=CFG, **kw):
    """The port's model of ``cls`` with ``params`` (the task heads' keys
    dropped for the plain model), in train mode, the heads' dropout 0."""
    if cls is LavenderModel:
        params = {k: v for k, v in params.items()
                  if k not in _head_keys(params)}
    model = cls(port_config(cfg), **kw)
    model.load_state_dict(from_flax(params), strict=True)
    for mod in model.modules():
        if hasattr(mod, "p") and isinstance(mod.p, float):
            mod.p = 0.0
    return model.train()


def _clips(B, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (B, 2, 64, 64, 3)).astype(np.uint8)


def _text(B, seed, mask_at=None):
    """[CLS] words [SEP] pad ids and their mask; [MASK] at ``mask_at``."""
    g = np.random.RandomState(seed)
    txt = g.randint(100, 512, (B, LT)).astype(np.int32)
    txt[:, 0] = 1
    lens = g.randint(LT - 3, LT + 1, B)
    lens[0] = LT
    txt[np.arange(B), lens - 1] = 2
    pos = np.arange(LT)[None]
    mask = (pos < lens[:, None]).astype(np.int32)
    if mask_at is not None:
        txt[np.arange(B), np.minimum(mask_at, lens - 2)] = MASK_ID
    return txt * mask, mask


def _labels_at_mask(txt, labels):
    out = np.full(txt.shape, -1, np.int32)
    out[txt == MASK_ID] = np.broadcast_to(labels, txt.shape)[txt == MASK_ID]
    return out


def _port_batch(batch):
    return {k: _t(v) if k == "img" else _t(v).long()
            for k, v in batch.items()}


def _check_loss_and_grads(model, loss, want_loss, want_grads):
    """The port's loss (a scalar, after its backward) and its parameters'
    gradients against JAX's (grads converted with ``from_flax``)."""
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-3)
    want = from_flax(jax.tree_util.tree_map(np.asarray, want_grads))
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    floor = 1e-3 * float(torch.stack([w.double().norm()
                                      for w in want.values()]).norm())
    for name, p in got.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).double()
        w = want[name].double()
        err = float((g - w).norm())
        assert err <= 1e-3 * max(float(w.norm()), floor), (name, err)


def _task_case(name):
    """(JAX model, port model class and kwargs, JAX loss fn, port loss fn,
    JAX eval fn or None, port eval fn, batch, eval argument names)."""
    m = _jax_model()
    if name == "qamc":
        txt, mask = _text(2, 1, mask_at=5)
        batch = {"img": _clips(2, 1), "txt": txt, "mask": mask,
                 "mask_ans": _labels_at_mask(txt, np.array([[10], [12]])),
                 "ans_idx": np.array([0, 2], np.int32)}
        return (m, jqamc.make_loss_fn(m), qamc.make_loss_fn(),
                jqamc.make_eval_step(m, DIGITS), qamc.make_eval_step(DIGITS),
                batch, ("img", "txt", "mask", "mask_ans", "ans_idx"))
    if name == "qaoe":
        txt, mask = _text(3, 2, mask_at=4)
        ans = _labels_at_mask(txt, np.array([[300], [-1], [17]]))
        batch = {"img": _clips(3, 2), "txt": txt, "mask": mask,
                 "mask_ans": ans}
        return (m, jqaoe.make_loss_fn(m), qaoe.make_loss_fn(),
                jqaoe.make_eval_step(m, topk=5), qaoe.make_eval_step(topk=5),
                batch, ("img", "txt", "mask", "mask_ans"))
    if name == "retmc":
        txt, mask = _text(6, 3, mask_at=LT)
        txt, mask = txt.reshape(2, 3, LT), mask.reshape(2, 3, LT)
        right = np.array([[0], [2]])
        lab = np.where(np.arange(3)[None] == right, TRUE_ID, FALSE_ID)
        batch = {"img": _clips(2, 3), "txt": txt, "mask": mask,
                 "mask_ans": _labels_at_mask(txt, lab[..., None]),
                 "ans_idx": right[:, 0].astype(np.int32)}
        return (m, jretmc.make_loss_fn(m), retmc.make_loss_fn(),
                jretmc.make_eval_step(m, TRUE_ID, FALSE_ID),
                retmc.make_eval_step(TRUE_ID, FALSE_ID), batch,
                ("img", "txt", "mask", "mask_ans", "ans_idx"))
    if name == "retrieval+task-token":
        cfg = dataclasses.replace(CFG, enable_task_token=True)
        m = _jax_model(cfg=cfg)
        txt, mask = _text(3, 4, mask_at=LT)
        batch = {"img": _clips(3, 4), "txt": txt, "mask": mask,
                 "vid": np.array([0, 1, 0], np.int32)}
        jp = jcommon.make_pretext_fn(m, cfg, "vtm")
        tp = common.make_pretext_fn(port_config(cfg), "vtm")
        return (m, jret.make_loss_fn(m, TRUE_ID, FALSE_ID, pretext=jp),
                retrieval.make_loss_fn(TRUE_ID, FALSE_ID, pretext=tp),
                jret.make_eval_step(m, TRUE_ID, FALSE_ID, pretext=jp),
                retrieval.make_eval_step(TRUE_ID, FALSE_ID, pretext=tp),
                batch, ("img", "txt", "mask", "vid"))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["qamc", "qaoe", "retmc",
                                  "retrieval+task-token"])
def test_task_loss_gradients_and_eval_match_jax(params, name):
    jm, jloss, tloss, jeval, teval, batch, names = _task_case(name)
    base = {k: v for k, v in params.items() if k not in _head_keys(params)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def both(p, b):
        value_grads = jax.value_and_grad(jloss)(p, b, jax.random.PRNGKey(0))
        return value_grads, jeval({"params": p}, *(b[k] for k in names))

    (want_loss, want_grads), want_eval = _run(both, base, jb)
    model = _port_model(params)
    tb = _port_batch(batch)
    loss = tloss(model, tb, torch.Generator().manual_seed(0))
    loss.backward()
    _check_loss_and_grads(model, loss, float(want_loss), want_grads)
    got_eval = teval(model, *(tb[k] for k in names))
    assert model.training  # the eval step restores the mode
    for a, b in zip(got_eval, want_eval):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b, np.float64), atol=1e-3,
                                   rtol=1e-3)


def _pretrain_batch(vt_mask=False):
    txt, mask = _text(3, 5, mask_at=LT)
    masked, ans = jpre.mask_tokens(txt, (0, 1, 2, MASK_ID), MASK_ID,
                                   p_mask=0.5,
                                   rng=np.random.RandomState(5))
    batch = {"img": _clips(3, 5), "txt": masked, "mask": mask,
             "ans_mtm": ans}
    if vt_mask:
        vt = np.ones((3, 2, 1), np.int32)
        vt[1, 0] = 0
        batch["vt_mask"] = vt
    return batch


def _jax_negatives(key, B, O):
    """The negatives JAX's pretraining loss draws from its step key."""
    return np.asarray(jpre.sample_negatives(jax.random.split(key)[0], B,
                                            O - 1))


def check_pretrain(params, monkeypatch, ts):
    """ls_mtm + ls_vtm (the unified head's VTM, or with ``ts`` the scalar
    head's of the task-specific baseline) and its parts, gradients, the
    eval step's accuracies; for the unified head a visual mask on one
    frame."""
    jm = _jax_model()
    key = jax.random.PRNGKey(3)
    batch = _pretrain_batch(vt_mask=not ts)
    neg = _jax_negatives(key, 3, 2)
    if ts:
        jloss = jts.make_pretrain_ts_loss(jm, temp=0.5, vtm_batch=2)
        tloss = task_specific.make_pretrain_ts_loss(temp=0.5, vtm_batch=2)
        p = params
    else:
        jloss = jpre.make_loss_fn(jm, TRUE_ID, FALSE_ID, vtm_batch=2)
        tloss = pretrain.make_loss_fn(TRUE_ID, FALSE_ID, vtm_batch=2)
        p = {k: v for k, v in params.items() if k not in _head_keys(params)}
    jeval = jpre.make_eval_step(jm, TRUE_ID, FALSE_ID, vtm_batch=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def both(p, b):
        out = jax.value_and_grad(jloss, has_aux=True)(p, b, key)
        return out, jeval({"params": p}, b["img"], b["txt"], b["mask"],
                          b["ans_mtm"], jax.random.split(key)[0])

    ((want_loss, want_aux), want_grads), want_eval = _run(both, p, jb)
    model = (_port_model(params, task_specific.LavenderMultiHead,
                         heads=HEADS) if ts else _port_model(params))
    draws = []

    def negatives(generator, B, n):
        draws.append((B, n))
        return torch.from_numpy(neg.copy())

    # both heads draw through pretrain.batch_negatives
    monkeypatch.setattr(pretrain, "sample_negatives", negatives)
    tb = _port_batch(batch)
    loss, aux = tloss(model, tb, torch.Generator().manual_seed(0))
    loss.backward()
    _check_loss_and_grads(model, loss, float(want_loss), want_grads)
    for k in ("mtm", "vtm"):
        np.testing.assert_allclose(float(aux[k].detach()),
                                   float(want_aux[k]), rtol=1e-3)
    got_eval = pretrain.make_eval_step(TRUE_ID, FALSE_ID, vtm_batch=2)(
        model, tb["img"], tb["txt"], tb["mask"], tb["ans_mtm"])
    for a, b in zip(got_eval, want_eval):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    assert draws == [(3, 1), (3, 1)]


def test_pretrain_loss_gradients_and_eval_match_jax(params, monkeypatch):
    check_pretrain(params, monkeypatch, ts=False)


def test_pretrain_forward_matches_jax_with_the_same_negatives(params):
    """The MLM pass's logits and the VTM pass's (head at the last
    position), under a task-token pretext on the VTM pass only."""
    cfg = dataclasses.replace(CFG, enable_task_token=True)
    jm = JaxLavender(cfg)
    base = {k: v for k, v in params.items() if k not in _head_keys(params)}
    batch = _pretrain_batch()
    neg = np.array([[2, 1], [0, 2], [1, 0]], np.int32)

    def fwd(p, img, txt, mask, neg):
        v = {"params": p}
        fp, mp = jm.apply(v, "vtm", 3, method=JaxLavender.task_feat)
        mtm, vtm = jpre.pretrain_forward(jm, v, img, txt, mask, neg,
                                         feat_pre=fp, mask_pre=mp)
        return mtm, vtm

    want = _run(fwd, base, *(jnp.asarray(batch[k])
                             for k in ("img", "txt", "mask")),
                jnp.asarray(neg))
    model = _port_model(params, cfg=cfg).eval()
    tb = _port_batch(batch)
    with torch.no_grad():
        fp, mp = model.task_feat("vtm", 3)
        got = pretrain.pretrain_forward(model, tb["img"], tb["txt"],
                                        tb["mask"], _t(neg).long(),
                                        feat_pre=fp, mask_pre=mp)
    assert got[1].shape == (9, 1, CFG.bert.vocab_size)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=1e-3)


def test_sample_negatives_and_mask_tokens():
    """Negatives: distinct, never the pair's own text, from the generator
    (one seed, one draw; every other text drawn over many); masking:
    exactly the JAX package's on the same numpy stream."""
    g = torch.Generator().manual_seed(0)
    for B, n in ((2, 1), (8, 3), (8, 7)):
        idx = pretrain.sample_negatives(g, B, n)
        assert idx.shape == (B, n) and idx.dtype == torch.int64
        for i, row in enumerate(idx.tolist()):
            assert i not in row and len(set(row)) == n
    a = pretrain.sample_negatives(torch.Generator().manual_seed(1), 8, 3)
    b = pretrain.sample_negatives(torch.Generator().manual_seed(1), 8, 3)
    assert torch.equal(a, b)
    seen = torch.zeros(8, 8)
    for _ in range(200):
        idx = pretrain.sample_negatives(g, 8, 3)
        seen.scatter_(1, idx, 1.0)
    assert bool((seen + torch.eye(8) == 1).all())
    with pytest.raises(ValueError):
        pretrain.sample_negatives(g, 4, 4)
    txt = np.random.RandomState(0).randint(0, 50, (4, 30)).astype(np.int32)
    for p_mask in (0.15, 0.6):
        got = pretrain.mask_tokens(txt, (0, 1, 2), 3, p_mask,
                                   np.random.RandomState(7))
        want = jpre.mask_tokens(txt, (0, 1, 2), 3, p_mask,
                                np.random.RandomState(7))
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


def test_go_feat_variants_match_jax():
    """EncVideo under a frame order (one clip shuffled, one not) and a
    visual mask; EncTxt with its text transformer under the full and the
    seq2seq mask; ``from_flax`` carries ``enc_txt.txt_trsfr``."""
    cfg = dataclasses.replace(CFG, txt_backbone_embed_only=False)
    jm = JaxLavender(cfg)
    params = _draw_params(_jax_model(cfg=cfg), 2)
    params = {k: v for k, v in params.items() if k not in _head_keys(params)}
    assert "txt_trsfr" in params["enc_txt"]
    img, (txt, mask) = _clips(2, 7), _text(2, 7)
    odr = np.array([[1, 0], [0, 1]], np.int32)
    vt = np.array([[[1], [0]], [[1], [1]]], np.int32)

    def feats(p, img, txt, mask, odr, vt):
        return [jm.apply({"params": p}, img, txt, mask, odr, vt,
                         attn_mask_type=kind, method=JaxLavender.go_feat)
                for kind in ("full", "seq2seq")]

    want = _run(feats, params, *map(jnp.asarray, (img, txt, mask, odr, vt)))
    model = LavenderModel(port_config(cfg)).eval()
    model.load_state_dict(from_flax(params), strict=True)
    for kind, w in zip(("full", "seq2seq"), want):
        with torch.no_grad():
            got = model.go_feat(_t(img), _t(txt).long(), _t(mask).long(),
                                odr=_t(odr).long(), vt_mask=_t(vt),
                                attn_mask_type=kind)
        for a, b in zip(got, w):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                       atol=1e-4, rtol=1e-4, err_msg=kind)
    # the shuffled clip's first frame took emb_odr, the other clip emb_len
    with torch.no_grad():
        plain = model.go_feat(_t(img), _t(txt).long(), _t(mask).long())
    assert not torch.allclose(plain[0][0], got[0][0])
    torch.testing.assert_close(plain[0][1], got[0][1])


def test_norm_softmax_loss_and_recall_match_jax():
    g = np.random.RandomState(8)
    sim = g.randn(5, 5).astype(np.float32)
    want = jax.jit(jcommon.norm_softmax_loss, static_argnums=1)(
        jnp.asarray(sim), 0.05)
    np.testing.assert_allclose(float(common.norm_softmax_loss(_t(sim), 0.05)),
                               float(want), rtol=1e-6)
    score = g.randn(12, 7)
    gt = g.randint(0, 7, 12)
    assert retrieval.recall_at_k(score, gt) == jret.recall_at_k(score, gt)


def test_multi_task_steps_share_one_state(params):
    """The loss table has every task kind, each step updates the one
    shared model and optimizer; a loss with aux gives (loss, metrics)
    through ``has_aux``."""
    losses = multi_task.build_multi_task_losses(TRUE_ID, FALSE_ID)
    assert set(losses) == {"retrieval", "qamc", "qaoe", "retmc",
                           "captioning"}
    evals = multi_task.build_multi_task_evals(TRUE_ID, FALSE_ID,
                                              ans_tok_ids=DIGITS)
    assert set(evals) == set(losses) - {"captioning"}
    base = {k: v for k, v in params.items() if k not in _head_keys(params)}
    state = create_train_state(port_config(CFG),
                               port_config(jcfg.TrainConfig(
                                   lr=1e-3, warmup_ratio=0.0, max_iter=100)),
                               device="cpu", params=base)
    steps = multi_task.make_multi_task_train_steps(losses, state)
    txt, mask = _text(2, 9, mask_at=LT)
    cap, ans = jcap.caption_masking(txt, 0, MASK_ID, 0.5,
                                    np.random.RandomState(0))
    batches = {
        "retrieval": {"txt": txt, "mask": mask, "vid": np.arange(2)},
        "qamc": {"txt": txt, "mask": mask,
                 "mask_ans": _labels_at_mask(txt, np.array([[10], [11]]))},
        "qaoe": {"txt": txt, "mask": mask,
                 "mask_ans": _labels_at_mask(txt, np.array([[300], [9]]))},
        "retmc": {"txt": np.stack([txt] * 2, 1), "mask": np.stack([mask] * 2,
                                                                   1),
                  "mask_ans": np.stack([_labels_at_mask(txt, TRUE_ID),
                                        _labels_at_mask(txt, FALSE_ID)], 1)},
        "captioning": {"txt": cap, "mask": mask, "ans_mtm": ans}}
    w = state.model.trsfr.layer[0].attention.self.query.weight
    for name, step in steps.items():
        before = w.detach().clone()
        loss = step(_port_batch({"img": _clips(2, 9), **batches[name]}))
        assert loss.dim() == 0 and torch.isfinite(loss), name
        assert not torch.equal(before, w.detach()), name
    assert state.step == len(steps)
    pre = make_train_step(pretrain.make_loss_fn(TRUE_ID, FALSE_ID, 2),
                          state, has_aux=True)
    loss, aux = pre(_port_batch(_pretrain_batch()))
    assert set(aux) == {"mtm", "vtm"} and not loss.requires_grad
    torch.testing.assert_close(loss, aux["mtm"] + aux["vtm"])
