"""Captioning on the port against the JAX package, f32 on the CPU: the
kernels K6 (BERT attention sub-block under a full [B, L, L] mask) and K7
(the attention core in heads layout), the seq2seq masks and forward, the
caption loss and its gradients, the top-k / top-p filter and the caption
decoders.

K6 and K7: the port's plain versions against the JAX kernels in Pallas
interpret mode at L = 21 (the kernels pad it to 24) within 1e-4 (f32; the
TPU kernels take exp2 without a running max), and against the pure-JAX
oracles with one query row whose keys are all masked (never against the
interpret-mode kernels there: their pad keys enter such a row).  K6's vjp
against JAX's custom_vjp, within 1e-4.

The model: the tiny config of the port's other tests (Swin embed 16, BERT
64 wide, 2 layers) with dropout 0 on B = 2 uint8 clips of 2 x 224 x 224
(100 video tokens) and 7 text tokens.  The JAX side runs its module math
(``attn_impl="xla"``; its fused branches run on a TPU only), the port its
plain versions.  Masks exactly equal; the seq2seq logits within 1e-3; the
caption loss within 1e-4 relative and every gradient within relative L2
1e-3 (as tests/test_torch_train.py, whose reasons hold here); greedy
caption ids exactly equal to JAX's KV-cache decoder and to its re-encode
decoder, the mean log-prob within 1e-4.  Sampling cannot match
``jax.random`` bit for bit: each sampled token lies in the filtered
support and one generator seed gives one caption.

Every JAX output is built once, in module-scoped fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu import config as jcfg
from lavender_tpu.models import captioning as jcap
from lavender_tpu.models.bert import extended_attention_mask as jax_ext_mask
from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu.models.lavender import build_cross_mask as jax_cross_mask
from lavender_tpu.ops import encoder_attention as jatt
from lavender_tpu.tasks import common as jcommon
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models import captioning as tcap
from lavender_tpu_torch.models.bert import extended_attention_mask
from lavender_tpu_torch.models.lavender import LavenderModel, build_cross_mask
from lavender_tpu_torch.ops import encoder_attention as tatt
from lavender_tpu_torch.tasks import common as tcommon
from lavender_tpu_torch.train.trainer import create_train_state
from tests.test_torch_convert import TINY, port_config

ATOL = RTOL = 1e-4
CLS, SEP, PAD, MASK = 101, 102, 0, 103
MAX_LEN = 6
# the JAX Swin unscanned (the same function; its trace, repeated in every
# JAX decoder and loss below, is half as long)
CFG = dataclasses.replace(
    TINY, swin=dataclasses.replace(TINY.swin, scan_blocks=False),
    bert=dataclasses.replace(TINY.bert, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0))


def _t(a):
    return torch.from_numpy(np.array(a))


# XLA compiles without LLVM's optimisations: on these tiny shapes the
# compile is most of the time and the run a fraction of a second
_FAST = {"xla_backend_optimization_level": 0}


def _run(jitted, *args):
    """``jitted(*args)``, compiled with ``_FAST``."""
    return jitted.lower(*args).compile(_FAST)(*args)


# --------------------------------------------------------------- K6 / K7

C, NH = 32, 4
_ORDER = ("x", "wq", "wk", "wv", "bq", "bk", "bv", "wo", "bo", "s", "b")


def _block_params(B, L, seed):
    g = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: (g.randn(*s) * std).astype(np.float32)
    p = {"x": mk(B, L, C)}
    for k in ("wq", "wk", "wv", "wo"):
        p[k] = mk(C, C, std=C ** -0.5)
    for k in ("bq", "bk", "bv", "bo"):
        p[k] = mk(C, std=0.1)
    p["s"], p["b"] = 1 + mk(C, std=0.1), mk(C, std=0.1)
    return p


def _seq2seq_bias(B, L, n_txt, fully_masked_row=False):
    """The model's additive mask: [video | causal text] as 0 / finfo.min,
    optionally with one query row that sees no key."""
    m = np.zeros((B, L, L), np.int32)
    m[:, :, :L - n_txt] = 1
    m[:, L - n_txt:, L - n_txt:] = np.tril(np.ones((n_txt, n_txt)))
    m[1, :, 3] = 0  # a masked video key
    if fully_masked_row:
        m[0, 5] = 0
    return np.asarray(jax_ext_mask(jnp.asarray(m)))[:, 0]


def _port_block(args, mask):
    """The port's K6 on the tensors of ``_ORDER`` (weights [out, in])."""
    return tatt.fused_bert_attn_block(*args, _t(mask), NH, (C // NH) ** -0.5,
                                      1e-12)


def test_attn_block_and_vjp_match_jax_kernel_interpret():
    """The forward against the interpret-mode kernel, and the vjp of every
    input but the mask against JAX's custom_vjp (its backward is autograd
    of the oracle), from one ``jax.vjp`` of ``fused_bert_attn_block``."""
    B, L = 2, 21
    p = _block_params(B, L, seed=0)
    mask = _seq2seq_bias(B, L, n_txt=8)
    g = np.random.RandomState(2).randn(B, L, C).astype(np.float32)

    @jax.jit
    def out_and_grads(*args):
        out, vjp = jax.vjp(lambda *a: jatt.fused_bert_attn_block(
            *a, jnp.asarray(mask), NH, (C // NH) ** -0.5, 1e-12), *args)
        return out, vjp(jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        want, want_grads = out_and_grads(*(jnp.asarray(p[k])
                                           for k in _ORDER))
    ins = [_t(p[k].T if k in ("wq", "wk", "wv", "wo") else p[k])
           .requires_grad_(True) for k in _ORDER]
    out = _port_block(ins, mask)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    out.backward(_t(g))
    for k, t, w in zip(_ORDER, ins, want_grads):
        got = t.grad.numpy().T if k in ("wq", "wk", "wv", "wo") else (
            t.grad.numpy())
        np.testing.assert_allclose(got, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_attn_block_matches_jax_reference_with_a_fully_masked_row():
    """A query row that sees no key gets the oracle's softmax over its
    -1e4 scores."""
    B, L = 2, 21
    p = _block_params(B, L, seed=1)
    mask = _seq2seq_bias(B, L, n_txt=8, fully_masked_row=True)
    want = jax.jit(jatt.bert_attn_block_reference, static_argnums=(12, 13,
                                                                   14))(
        *(jnp.asarray(p[k]) for k in _ORDER), jnp.asarray(mask), NH,
        (C // NH) ** -0.5, 1e-12)
    args = [_t(p[k].T if k in ("wq", "wk", "wv", "wo") else p[k])
            for k in _ORDER]
    np.testing.assert_allclose(_port_block(args, mask).numpy(),
                               np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("oracle", [False, True],
                         ids=["kernel-interpret", "oracle-fully-masked-row"])
def test_encoder_attention_matches_jax(oracle):
    B, nH, L, hd = 2, 3, 21, 16
    g = np.random.RandomState(3)
    q, k, v = (g.randn(B, nH, L, hd).astype(np.float32) for _ in range(3))
    mask = _seq2seq_bias(B, L, n_txt=8, fully_masked_row=oracle)
    args = tuple(map(jnp.asarray, (q, k, v, mask)))
    if oracle:
        fn = jatt.encoder_attention_reference
    else:
        fn = jatt.fused_encoder_attention
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(fn, static_argnums=4)(*args, hd ** -0.5)
    got = tatt.fused_encoder_attention(_t(q), _t(k), _t(v), _t(mask),
                                       hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("L", [21, 275, 276])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_mask_copy_has_padded_rows(L, dtype):
    """The mask K7's kernel reads (``padded_clamped_mask``): the mask as the
    model passes it (0 / finfo(f32).min, a fully masked row; bf16 after an
    autocast cast, where finfo.min is -inf) clamped at -1e4 as the JAX
    wrapper clamps it, f32, its rows a multiple of 16 bytes apart (the
    pad columns are not read)."""
    B = 2
    mask = _t(_seq2seq_bias(B, L, n_txt=8, fully_masked_row=True))
    want = np.maximum(mask.to(dtype).float().numpy(), -1e4)
    got = tatt.padded_clamped_mask(mask.to(dtype))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, L, L)
    ld = got.stride(1)
    assert got.stride(2) == 1 and ld >= L and (ld * 4) % 16 == 0
    assert ld - L < 4 and got.stride(0) == L * ld
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def params():
    """Seeded random JAX params of the tiny model: its parameter tree (from
    ``eval_shape``, which compiles nothing) filled with N(0, 0.02^2), the
    LayerNorm scales with 1 + N(0, 0.1^2)."""
    img = jnp.zeros((1, 2, 64, 64, 3), jnp.uint8)
    txt = jnp.ones((1, 6), jnp.int32)
    shapes = jax.eval_shape(JaxLavender(CFG).init, jax.random.PRNGKey(0),
                            img, txt, txt)["params"]
    g = np.random.RandomState(0)

    def fill(path, leaf):
        a = g.randn(*leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * a if path[-1].key == "scale" else 0.02 * a

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def port_model(params):
    model = LavenderModel(port_config(CFG)).eval()
    model.load_state_dict(from_flax(params), strict=True)
    return model


def _clips(B=2, seed=0):
    g = np.random.RandomState(seed)
    return g.randint(0, 256, (B, 2, 224, 224, 3)).astype(np.uint8)


def _caption_batch():
    g = np.random.RandomState(1)
    B, Lt = 2, 7
    txt = g.randint(200, 1024, (B, Lt)).astype(np.int32)
    txt[:, 0] = CLS
    txt[0, 5], txt[0, 6] = SEP, PAD
    txt[1, -1] = SEP
    mask = (txt != PAD).astype(np.int32)
    masked, ans = jcap.caption_masking(txt, PAD, MASK, p_mask=0.4, rng=g)
    assert (ans >= 0).any()
    return {"img": _clips(B), "txt": masked, "mask": mask, "ans_mtm": ans}


def test_cross_masks_match_jax_exactly():
    g = np.random.RandomState(4)
    mi = (g.rand(2, 9) < 0.8).astype(np.int32)
    mt = (g.rand(2, 5) < 0.8).astype(np.int32)
    mp = np.array([[1, 1], [1, 0]], np.int32)
    for kind in ("full", "seq2seq"):
        for pre in (None, mp):
            want, want_ext = jax.jit(
                lambda *a, kind=kind: (m := jax_cross_mask(*a[:2], kind,
                                                           *a[2:]),
                                       jax_ext_mask(m)))(
                *map(jnp.asarray, (mi, mt) + (() if pre is None else (pre,))))
            got = build_cross_mask(_t(mi), _t(mt), kind,
                                   None if pre is None else _t(pre))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(
                extended_attention_mask(got).numpy(), np.asarray(want_ext))


@pytest.fixture(scope="module")
def jax_caption(params):
    """On ``_caption_batch()``: JAX's seq2seq forward (its logits), and its
    caption loss with every gradient, from one compile."""
    model = JaxLavender(CFG)
    loss_fn = jcap.make_caption_loss_fn(model, label_smoothing=0.1)

    def both(p, b, rng):
        logits = model.apply({"params": p}, b["img"], b["txt"], b["mask"],
                             attn_mask_type="seq2seq")
        return logits, jax.value_and_grad(loss_fn)(p, b, rng)

    b = {k: jnp.asarray(v) for k, v in _caption_batch().items()}
    logits, (loss, grads) = _run(jax.jit(both), params, b,
                                 jax.random.PRNGKey(1))
    return (np.asarray(logits), float(loss),
            from_flax(jax.tree_util.tree_map(np.asarray, grads)))


def test_seq2seq_forward_matches_jax(port_model, jax_caption):
    b = _caption_batch()
    want = jax_caption[0]
    with torch.no_grad():
        got = port_model(_t(b["img"]), _t(b["txt"]).long(),
                         _t(b["mask"]).long(), attn_mask_type="seq2seq")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("attn", [False, True], ids=["module-math", "fused"])
def test_caption_loss_and_gradients_match_jax(params, jax_caption, attn):
    """Train mode on both fusion-encoder routes (the train kernels' plain
    versions under the [B, L, L] seq2seq mask) against the same JAX loss."""
    _, want_loss, want = jax_caption
    cfg = port_config(CFG)
    cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, fused_attn_train=attn, fused_ffn_train=attn))
    state = create_train_state(cfg, port_config(jcfg.TrainConfig()),
                               device="cpu", params=params)
    b = {k: _t(v).long() if k != "img" else _t(v)
         for k, v in _caption_batch().items()}
    loss = tcap.make_caption_loss_fn(label_smoothing=0.1)(state.model, b)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
    grads = dict(state.model.named_parameters())
    assert grads.keys() == want.keys()
    floor = 1e-3 * float(torch.stack([w.double().norm()
                                      for w in want.values()]).norm())
    for name, p in grads.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).double()
        w = want[name].double()
        err = float((g - w).norm())
        assert err <= 1e-3 * max(float(w.norm()), floor), (
            name, err, float(w.norm()))


@pytest.mark.parametrize("kind", ["task-token", "prompt"])
def test_pretext_rides_the_text_stream(port_model, kind):
    """The pretext plumbing (``make_pretext_fn`` -> ``fused_mlm_logits`` ->
    ``pad_labels_for_pretxt``): under the "full" mask a pretext whose mask
    joins the video's (``mask_pretxt``) and one counted in the text mask
    (``feat_pretxt`` alone) give one sequence; the caption loss ignores the
    pretext positions."""
    b = _caption_batch()
    img, txt, mask = _t(b["img"]), _t(b["txt"]).long(), _t(b["mask"]).long()
    cfg = dataclasses.replace(port_config(CFG), enable_task_token=True,
                              enable_prompt=True)
    if kind == "task-token":
        pretext = tcommon.make_pretext_fn(cfg, "cap")
    else:
        pretext = tcommon.make_pretext_fn(
            dataclasses.replace(cfg, enable_task_token=False),
            prompt=(np.array([CLS, 300, 301, PAD]), np.array([1, 1, 1, 0])))
    with torch.no_grad():
        fp, mp = tcommon.apply_pretext(pretext, port_model, 2)
        got, lp = tcommon.fused_mlm_logits(port_model, img, txt, mask, fp,
                                           mp)
        fi, mi, ft, mt = port_model.go_feat(img, txt, mask)
        out = port_model.go_cross(fi, mi, ft, torch.cat([mp, mt], 1),
                                  feat_pretxt=fp)
        want = port_model.mlm_head(out[:, fi.shape[1]:])
        assert lp == fp.shape[1] == (1 if kind == "task-token" else 4)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)
        labels = tcommon.pad_labels_for_pretxt(_t(b["ans_mtm"]).long(), lp)
        assert (labels[:, :lp] == -1).all()
        logits, _ = tcommon.fused_mlm_logits(port_model, img, txt, mask, fp,
                                             mp, attn_mask_type="seq2seq")
        loss = tcap.make_caption_loss_fn(pretext=pretext)(
            port_model, {"img": img, "txt": txt, "mask": mask,
                         "ans_mtm": _t(b["ans_mtm"]).long()})
    want_loss = tcommon.label_smoothed_kl_loss(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)


@pytest.mark.parametrize("ratio", [0.0, 0.2])
def test_label_smoothed_kl_loss_matches_jax(ratio):
    g = np.random.RandomState(5)
    logits = (g.randn(20, 37) * 3).astype(np.float32)
    labels = g.randint(0, 37, 20)
    labels[[2, 7, 11]] = -1
    want = jax.jit(jcommon.label_smoothed_kl_loss, static_argnums=(2, 3))(
        jnp.asarray(logits), jnp.asarray(labels), 0.1, ratio)
    got = tcommon.label_smoothed_kl_loss(_t(logits), _t(labels), 0.1, ratio)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_top_k_top_p_filter_matches_jax():
    g = np.random.RandomState(6)
    logits = (g.randn(3, 40) * 2).astype(np.float32)
    logits[1, 5] = logits[1, 9]  # a tie
    for tk, tp, keep in [(5, 1.0, 1), (0, 0.7, 1), (4, 0.8, 1),
                         (0, 0.3, 3)]:
        want = np.asarray(jax.jit(jcap.top_k_top_p_filter,
                                  static_argnums=(1, 2, 3))(
            jnp.asarray(logits), tk, tp, keep))
        got = tcap.top_k_top_p_filter(_t(logits), tk, tp, keep).numpy()
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6)


# --------------------------------------------------------- the decoders

GREEDY = {
    "plain": (jcap.GenerateConfig(max_gen_length=MAX_LEN), False),
    "task-token": (jcap.GenerateConfig(max_gen_length=MAX_LEN), True),
    "repetition-penalty": (jcap.GenerateConfig(max_gen_length=MAX_LEN,
                                               repetition_penalty=1.2),
                           False),
}


class _JitApply:
    """A flax module whose ``apply`` is compiled per method and shapes
    (``_run``): JAX's re-encode decoder calls ``model.apply`` eagerly, op
    by op (a minute on the CPU); through this it runs the same functions
    compiled."""

    def __init__(self, module):
        self.module, self.fns = module, {}

    def apply(self, variables, *args, method=None):
        key = (method.__code__ if method.__name__ == "<lambda>" else method,
               tuple((a.shape, str(a.dtype)) for a in args))
        if key not in self.fns:
            self.fns[key] = jax.jit(lambda v, *a: self.module.apply(
                v, *a, method=method)).lower(variables, *args).compile(
                    _FAST)
        return self.fns[key](variables, *args)


@pytest.fixture(scope="module")
def jax_decodes(params):
    """JAX's KV-cache decoder on each greedy setting, and its re-encode
    decoder, on the same two clips."""
    model, variables, img = JaxLavender(CFG), {"params": params}, _clips()
    out = {}
    for name, (gen, task) in GREEDY.items():
        fn = jcap.make_generate_fn(model, CLS, SEP, PAD, MASK, gen,
                                   use_task_token=task)
        ids, logp = _run(fn, variables, jnp.asarray(img),
                         jax.random.PRNGKey(0))
        out[name] = np.asarray(ids), np.asarray(logp)
    out["rencode"] = jcap.rencode_generate_reference(
        _JitApply(model), variables, jnp.asarray(img), CLS, SEP, PAD, MASK,
        MAX_LEN)
    return out


@pytest.mark.parametrize("name", list(GREEDY))
def test_greedy_decode_matches_jax(port_model, jax_decodes, name):
    gen, task = GREEDY[name]
    fn = tcap.make_generate_fn(port_model, CLS, SEP, PAD, MASK,
                               tcap.GenerateConfig(*gen),
                               use_task_token=task)
    ids, logp = fn(_clips())
    want_ids, want_logp = jax_decodes[name]
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(logp.numpy(), want_logp, atol=1e-4, rtol=0)
    if name == "plain":
        np.testing.assert_array_equal(ids.numpy(), jax_decodes["rencode"])
        ref = tcap.rencode_generate_reference(port_model, _clips(), CLS, SEP,
                                              PAD, MASK, MAX_LEN)
        np.testing.assert_array_equal(ref.numpy(), jax_decodes["rencode"])


def test_sampling_stays_in_the_filtered_support(port_model):
    gen = tcap.GenerateConfig(max_gen_length=MAX_LEN, do_sample=True,
                              temperature=0.7, top_k=5, top_p=0.9,
                              repetition_penalty=1.2)
    fn = tcap.make_generate_fn(port_model, CLS, SEP, PAD, MASK, gen)
    step_logits = []
    hook = port_model.fc_mtm.register_forward_hook(
        lambda mod, inp, out: step_logits.append(out[:, 0].float()))
    try:
        ids, logp = fn(_clips(), torch.Generator().manual_seed(7))
    finally:
        hook.remove()
    assert len(step_logits) == MAX_LEN - 1
    assert torch.isfinite(logp).all()
    seen = torch.zeros_like(step_logits[0], dtype=torch.bool)
    seen[:, CLS] = True
    unfinished = torch.ones(ids.shape[0], dtype=torch.bool)
    for t, logits in enumerate(step_logits, start=1):
        pen = torch.where(logits < 0, logits * 1.2, logits / 1.2)
        logits = torch.where(seen, pen, logits)
        allowed = torch.isfinite(tcap.top_k_top_p_filter(
            logits / 0.7, gen.top_k, gen.top_p))
        tok = ids[:, t]
        rows = torch.arange(ids.shape[0])
        if t < MAX_LEN - 1:  # the last token may be the forced [SEP]
            assert bool((allowed[rows, tok] | ~unfinished).all()), t
        assert bool((tok[~unfinished] == PAD).all()), t
        seen[rows, tok] = True
        unfinished &= tok != SEP
    again, _ = fn(_clips(), torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(again.numpy(), ids.numpy())
