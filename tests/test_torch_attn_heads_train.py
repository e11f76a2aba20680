"""The heads-layout train attention K13a / K13b of the port (its plain
PyTorch versions) against the JAX package, f32 on the CPU, and the routes
that choose it: ``LVT_ATTNLANES`` (K13 or K10 in the fusion encoder's
train forward) and ``LVT_KMASK`` (K4 or K6 for a key-padding bias in
serving).

Pallas interpret mode stubs the TPU's random bits to zero (rate > 0 drops
everything there), so at rate 0 the port goes against the JAX kernel
``fused_encoder_attention_train`` in interpret mode (4 heads of 16, L = 29,
which the JAX kernel pads to 32; also L = 65 and 130, across the 64-row
tiles of the CUDA backward, whose plain version is checked there) and its
custom_vjp, dmask included; at
rate 0.3 against a JAX oracle fed the port's own keep mask, forward and
vjp.  Tolerance 1e-4: f32, but the JAX kernel runs an exp2 softmax without
max-subtraction.  K13 and K10 on the same q, k, v (heads views and the
[B, L, C] tensors they view) and the same seed draw the same keep mask,
exactly, and agree within 1e-6.  The module route against JAX's under
``LVT_ATTNLANES=0`` runs as the JAX package's own route test does, in
bf16 (JAX takes its kernel for bf16 only), so within 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu import config as jcfg
from lavender_tpu.models.bert import BertAttention as JaxBertAttention
from lavender_tpu.ops import encoder_attention as jatt
from lavender_tpu_torch.models import bert as tbert
from lavender_tpu_torch.ops import dropout
from lavender_tpu_torch.ops import encoder_attention as tatt
from tests.test_torch_convert import port_config

TOL = 1e-4
B, NH, L, HD = 2, 4, 29, 16
C = NH * HD
SCALE = HD ** -0.5
SEED = torch.tensor([2024])


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, n_tok=L):
    g = np.random.RandomState(seed)
    return [g.randn(B, NH, n_tok, HD).astype(np.float32) for _ in range(4)]


def _mask(kind, seed, n_tok=L):
    """Additive [B, n_tok, n_tok]: key padding at finfo(f32).min, or a
    random full mask at exactly -1e4 (the clamp's edge), each row keeping
    its diagonal key."""
    g = np.random.RandomState(seed)
    if kind == "padding":
        keep = np.ones((B, n_tok), bool)
        keep[1, 20:] = False
        keep[0, 4] = False
        m = np.where(keep, 0.0, np.finfo(np.float32).min)[:, None, :]
        return np.broadcast_to(m, (B, n_tok, n_tok)).astype(np.float32)
    m = np.where(g.rand(B, n_tok, n_tok) < 0.3, -1e4,
                 g.randn(B, n_tok, n_tok))
    m[:, np.arange(n_tok), np.arange(n_tok)] = 0.0
    return m.astype(np.float32)


def _port(q, k, v, mask, g, rate):
    """Output and (dq, dk, dv, dmask) of K13a under autograd; K13b called
    alone gives the same gradients."""
    ins = [_t(a).requires_grad_(True) for a in (q, k, v, mask)]
    o = tatt.fused_encoder_attention_train(*ins[:3], ins[3], SEED, SCALE,
                                           rate)
    grads = torch.autograd.grad(o, ins, _t(g))
    alone = tatt.encoder_attention_train_bwd(
        _t(q), _t(k), _t(v), _t(mask), SEED, _t(g), SCALE, rate, dmask=True)
    for a, b in zip(grads, alone):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tatt.encoder_attention_train_bwd(
        _t(q), _t(k), _t(v), _t(mask), SEED, _t(g), SCALE, rate)[3] is None
    return o.detach().numpy(), [d.numpy() for d in grads]


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol,
                               err_msg=name)


@pytest.mark.parametrize("kind,n_tok", [
    pytest.param("padding", L, id="padding"), pytest.param("full", L, id="full"),
    pytest.param("padding", 65, id="padding-L65"),
    pytest.param("full", 130, id="full-L130")])
def test_rate0_matches_jax_kernel_and_vjp_interpret(kind, n_tok):
    """Output, dq, dk, dv and dmask (the JAX backward's sum over heads,
    zeroed where the mask is <= -1e4) against the interpret-mode kernel
    and its custom_vjp."""
    q, k, v, g = _inputs(0, n_tok)
    mask = _mask(kind, 1, n_tok)

    @jax.jit
    def out_and_grads(*a):
        out, vjp = jax.vjp(lambda q, k, v, m: jatt.fused_encoder_attention_train(
            q, k, v, m, jnp.int32(7), SCALE, 0.0), *a)
        return out, vjp(jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        want, dwant = out_and_grads(*map(jnp.asarray, (q, k, v, mask)))
    got, dgot = _port(q, k, v, mask, g, 0.0)
    _close(got, want)
    for name, a, b in zip(("dq", "dk", "dv", "dmask"), dgot, dwant):
        _close(a, b, name=name)
    if kind == "full":  # the clamp's edge gets no gradient, as in JAX
        assert not dgot[3][mask <= -1e4].any()
        assert np.abs(dgot[3]).max() > 1e-3


def test_dropout_matches_jax_oracle_with_the_same_mask():
    """Rate 0.3: the port's hash mask m fed to the JAX oracle
    softmax(q k^T * scale + mask~) * m @ v, mask~ = mask above -1e4 and
    -1e4 below (the kernel's clamp, its gradient only above): forward and
    vjp, dmask included."""
    rate = 0.3
    q, k, v, g = _inputs(2)
    mask = _mask("full", 3)
    keep = dropout.attention_keep(SEED, B, NH, L, rate).numpy()
    m = jnp.asarray(keep.astype(np.float32) / (1.0 - rate))

    def oracle(q, k, v, mask):
        s = jnp.einsum("bhnd,bhmd->bhnm", q, k) * SCALE
        mask = jnp.where(mask > -1e4, mask, -1e4)
        p = jax.nn.softmax(s + mask[:, None], axis=-1) * m
        return jnp.einsum("bhnm,bhmd->bhnd", p, v)

    want, vjp = jax.vjp(oracle, *map(jnp.asarray, (q, k, v, mask)))
    got, dgot = _port(q, k, v, mask, g, rate)
    _close(got, want)
    for a, b in zip(dgot, vjp(jnp.asarray(g))):
        _close(a, b)
    assert 0.6 < keep.mean() < 0.8  # the mask really drops


def test_heads_and_lanes_draw_the_same_mask():
    """Rate 0.3, one seed: K13 on heads views of q, k, v and K10 on the
    [B, L, C] tensors they view drop the same probabilities (the keep
    masks are one function of the logical (sequence, head, row, key)) and
    agree within 1e-6, forward and gradients."""
    rate = 0.3
    g = np.random.RandomState(4)
    slab = _t(g.randn(B, L, 3 * C).astype(np.float32)).requires_grad_(True)
    mask = _t(_mask("padding", 5))
    cot = _t(g.randn(B, L, C).astype(np.float32))
    q, k, v = slab.split(C, dim=-1)
    lanes = tatt.fused_encoder_attention_train_lanes(q, k, v, mask, SEED,
                                                     SCALE, rate, NH)
    qh, kh, vh = slab.view(B, L, 3, NH, HD).permute(2, 0, 3, 1, 4)
    heads = tatt.fused_encoder_attention_train(qh, kh, vh, mask, SEED,
                                               SCALE, rate)
    heads = heads.transpose(1, 2).reshape(B, L, C)
    _close(heads.detach().numpy(), lanes.detach().numpy(), 1e-6)
    d_lanes, = torch.autograd.grad(lanes, slab, cot)
    d_heads, = torch.autograd.grad(heads, slab, cot)
    _close(d_heads.numpy(), d_lanes.numpy(), 1e-6)
    # the one keep mask both plain versions draw, and its counter
    keep = dropout.attention_keep(SEED, B, NH, L, rate)
    idx = torch.arange(L * L).view(L, L)
    for b, h in ((0, 0), (1, 3)):
        want = dropout.keep_mask(SEED, torch.tensor(b * NH + h), idx, rate)
        assert torch.equal(keep[b, h], want)
    # a dropped probability moves the output: the masks are not vacuous
    other = tatt.fused_encoder_attention_train(qh, kh, vh, mask, SEED + 1,
                                               SCALE, rate)
    assert (other.transpose(1, 2).reshape(B, L, C) - heads).abs().max() > 0.1


BERT = jcfg.BertConfig(vocab_size=64, hidden_size=C, num_hidden_layers=1,
                       num_attention_heads=NH, intermediate_size=128,
                       max_position_embeddings=64, fused_attn_train=True,
                       attention_probs_dropout_prob=0.0,
                       hidden_dropout_prob=0.0)


def _attention_params(seed):
    g = np.random.RandomState(seed)
    dense = lambda: {"kernel": (g.randn(C, C) * C ** -0.5).astype(
        np.float32), "bias": (g.randn(C) * 0.1).astype(np.float32)}
    return {"self": {"query": dense(), "key": dense(), "value": dense()},
            "output": {"dense": dense(), "LayerNorm": {
                "scale": (1 + 0.1 * g.randn(C)).astype(np.float32),
                "bias": (0.1 * g.randn(C)).astype(np.float32)}}}


def test_heads_route_module_matches_jax_heads_kernel(monkeypatch):
    """``BertAttention`` in train mode under ``LVT_ATTNLANES=0`` (q, k, v as
    heads views of one product -> K13 -> K11) against the JAX module under
    ``LVT_ATTNLANES=0`` and ``LVT_FORCE_FUSED=1`` (its heads-layout train
    kernel and K11, interpret mode), rate 0, a padded key tail, in bf16 on
    both sides."""
    params = _attention_params(6)
    g = np.random.RandomState(7)
    x = g.randn(B, L, C).astype(np.float32)
    keep = np.ones((B, L), np.float32)
    keep[1, 22:] = 0.0
    bias = ((1.0 - keep) * np.finfo(np.float32).min)[:, None, None, :]
    monkeypatch.setenv("LVT_FORCE_FUSED", "1")
    monkeypatch.setenv("LVT_ATTNLANES", "0")
    mod = JaxBertAttention(BERT, dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, x, b: mod.apply(
            {"params": p}, x, b, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(5)}))(
            params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(bias))
    port = tbert.BertAttention(port_config(BERT))
    sd = {}
    for path in ("self.query", "self.key", "self.value", "output.dense"):
        a, b_ = path.split(".")
        sd[f"{path}.weight"] = _t(params[a][b_]["kernel"].T)
        sd[f"{path}.bias"] = _t(params[a][b_]["bias"])
    sd["output.LayerNorm.weight"] = _t(params["output"]["LayerNorm"]["scale"])
    sd["output.LayerNorm.bias"] = _t(params["output"]["LayerNorm"]["bias"])
    port.load_state_dict(sd)
    port = port.to(torch.bfloat16).train()
    with torch.no_grad():
        got = port(_t(x).to(torch.bfloat16), _t(bias),
                   torch.Generator().manual_seed(0))
    _close(got.float().numpy(), np.asarray(want, np.float32), 2e-2)


OPS = {"K4": tatt.fused_bert_attn_block_kmask, "K6": tatt.fused_bert_attn_block,
       "K10a": tatt.fused_encoder_attention_train_lanes,
       "K13a": tatt.fused_encoder_attention_train}


def _count(monkeypatch):
    counts = dict.fromkeys(OPS, 0)
    for name, op in OPS.items():
        def counted(*a, _name=name, _plain=op.plain, **k):
            counts[_name] += 1
            return _plain(*a, **k)
        monkeypatch.setattr(op, "plain", counted)
    return counts


@pytest.mark.parametrize("lanes", [True, False], ids=["lanes", "heads"])
def test_train_route_calls_k13_or_k10(monkeypatch, lanes):
    """A 12-layer encoder's train pass calls K10 12 times and K13 never
    (default), or the reverse (``LVT_ATTNLANES=0``), with the same loss
    and gradients (the same keep masks) at dropout 0.1."""
    cfg = port_config(dataclasses.replace(
        BERT, num_hidden_layers=12, attention_probs_dropout_prob=0.1))
    torch.manual_seed(0)
    enc = tbert.BertEncoder(cfg).train()
    x = torch.randn(B, L, C, generator=torch.Generator().manual_seed(1))
    bias = tbert.extended_attention_mask(torch.ones(B, L))

    def run():
        enc.zero_grad()
        out = enc(x, bias, torch.Generator().manual_seed(2))
        out.square().mean().backward()
        return out.detach(), [p.grad.clone() for p in enc.parameters()]

    monkeypatch.setenv("LVT_ATTNLANES", "1" if lanes else "0")
    counts = _count(monkeypatch)
    out, grads = run()
    assert counts == {"K4": 0, "K6": 0, "K10a": 12 * lanes,
                      "K13a": 12 * (not lanes)}
    monkeypatch.setenv("LVT_ATTNLANES", "0" if lanes else "1")
    out2, grads2 = run()
    _close(out.numpy(), out2.numpy(), 1e-5)
    for a, b in zip(grads, grads2):
        _close(a.numpy(), b.numpy(), 1e-5)


@pytest.mark.parametrize("kmask", [True, False])
def test_serving_key_padding_bias_takes_k4_or_k6(monkeypatch, kmask):
    """Serving under a [B, 1, 1, L] key-padding bias: K4 (default) or,
    under ``LVT_KMASK=0``, K6 on the bias broadcast to [B, L, L] (JAX
    bert.py:283-309); the same output (1e-5), no other attention op."""
    cfg = port_config(dataclasses.replace(BERT, num_hidden_layers=2))
    torch.manual_seed(0)
    enc = tbert.BertEncoder(cfg).eval()
    x = torch.randn(B, L, C, generator=torch.Generator().manual_seed(1))
    keep = torch.ones(B, L)
    keep[1, 20:] = 0
    bias = tbert.extended_attention_mask(keep)
    with torch.no_grad():
        want = enc(x, bias)
    monkeypatch.setenv("LVT_KMASK", "1" if kmask else "0")
    counts = _count(monkeypatch)
    with torch.no_grad():
        got = enc(x, bias)
    assert counts == {"K4": 2 * kmask, "K6": 2 * (not kmask), "K10a": 0,
                      "K13a": 0}
    _close(got[keep.bool()].numpy(), want[keep.bool()].numpy(), 1e-5)


def test_switches_are_read_per_call(monkeypatch):
    """``LVT_ATTNLANES`` and ``LVT_KMASK`` set after the port's bert module
    was imported choose the route of the next call, as the JAX package
    reads them each time it traces (its own test flips ``LVT_ATTNLANES``
    between two applies): one train forward takes K10 or K13, one serving
    forward K4 or K6, call by call in one process."""
    cfg = port_config(dataclasses.replace(BERT, num_hidden_layers=1))
    torch.manual_seed(0)
    enc = tbert.BertEncoder(cfg)
    x = torch.randn(B, L, C, generator=torch.Generator().manual_seed(1))
    bias = tbert.extended_attention_mask(torch.ones(B, L))
    counts = _count(monkeypatch)
    for lanes, kmask in (("1", "0"), ("0", "1"), ("1", "1"), ("0", "0")):
        monkeypatch.setenv("LVT_ATTNLANES", lanes)
        monkeypatch.setenv("LVT_KMASK", kmask)
        for k in counts:
            counts[k] = 0
        with torch.no_grad():
            enc.train()(x, bias, torch.Generator().manual_seed(2))
            enc.eval()(x, bias)
        assert counts == {"K4": int(kmask == "1"), "K6": int(kmask == "0"),
                          "K10a": int(lanes == "1"),
                          "K13a": int(lanes == "0")}, (lanes, kmask, counts)
