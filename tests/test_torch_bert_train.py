"""The fusion encoder's train kernels (K10a/K10b lanes attention with
dropout, K11 out-proj + dropout + LN, K12 FFN + dropout + LN): the port's
plain PyTorch versions against the JAX package, f32 on the CPU, and the
counter-based dropout hash they share with the CUDA kernels.

Pallas interpret mode stubs the TPU's random bits to zero (rate > 0 drops
everything there), so at rate 0 the port goes against the JAX kernels in
interpret mode (C = 64, 4 heads, L = 29, which the JAX kernel pads to 32),
and at rate > 0 against the JAX oracles fed the port's own keep mask: the
softmax-dropout-PV oracle of ``tests/test_encoder_attention.py`` for K10,
``_out_ln_reference_masked`` and ``_ffn_reference_masked`` for K11 and K12,
forward and vjp.  Tolerance 1e-4: f32, but the JAX kernels run an exp2
softmax without max-subtraction and an E[x^2] - mean^2 LN variance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu.ops import encoder_attention as jatt
from lavender_tpu.ops import fused_mlp as jmlp
from lavender_tpu_torch.ops import dropout
from lavender_tpu_torch.ops.encoder_attention import (
    encoder_attention_train_lanes_bwd, fused_encoder_attention_train_lanes)
from lavender_tpu_torch.ops.fused_mlp import (
    fused_ffn_post_ln_train, fused_out_ln_train)

TOL = 1e-4
B, L, C, NH = 2, 29, 64, 4
SCALE = (C // NH) ** -0.5
SEED = torch.tensor([12345])


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(seed):
    g = np.random.RandomState(seed)
    return [g.randn(B, L, C).astype(np.float32) for _ in range(4)]


def _mask(kind, seed):
    """Additive [B, L, L]: a key-padding mask at finfo(f32).min, or a
    random full mask at -1e4 (every row keeps its diagonal key)."""
    g = np.random.RandomState(seed)
    if kind == "padding":
        keep = np.ones((B, L), bool)
        keep[1, 17:] = False
        keep[0, 3] = False
        m = np.where(keep, 0.0, np.finfo(np.float32).min)[:, None, :]
        return np.broadcast_to(m, (B, L, L)).astype(np.float32)
    m = np.where(g.rand(B, L, L) < 0.3, -1e4, 0.0)
    m[:, np.arange(L), np.arange(L)] = 0.0
    return m.astype(np.float32)


def _port_attention(q, k, v, mask, g, rate):
    """Forward and (dq, dk, dv) of the port's K10a, and K10b called alone."""
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    o = fused_encoder_attention_train_lanes(*ins, _t(mask), SEED, SCALE,
                                            rate, NH)
    grads = torch.autograd.grad(o, ins, _t(g))
    alone = encoder_attention_train_lanes_bwd(
        _t(q), _t(k), _t(v), _t(mask), SEED, _t(g), SCALE, rate, NH)
    for a, b in zip(grads, alone):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    return o.detach().numpy(), [d.numpy() for d in grads]


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["padding", "full"])
def test_attention_rate0_matches_jax_kernel_interpret(kind):
    q, k, v, g = _qkv(0)
    mask = _mask(kind, 1)
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda a, b, c: jatt.fused_encoder_attention_train_lanes(
                a, b, c, jm, jnp.int32(7), SCALE, 0.0, NH), jq, jk, jv)
        dwant = vjp(jnp.asarray(g))
    got, dgot = _port_attention(q, k, v, mask, g, 0.0)
    _close(got, want)
    for a, b in zip(dgot, dwant):
        _close(a, b)


def test_attention_dropout_matches_jax_oracle_with_the_same_mask():
    """Rate 0.3: the port's hash mask m fed to the JAX oracle
    softmax(s + max(mask, -1e4)) * m @ v (m in {0, 1 / (1 - rate)})."""
    rate = 0.3
    q, k, v, g = _qkv(2)
    mask = _mask("full", 3)
    keep = dropout.attention_keep(SEED, B, NH, L, rate).numpy()
    m = jnp.asarray(keep.astype(np.float32) / (1.0 - rate))
    hd = C // NH

    def oracle(q, k, v):
        qh, kh, vh = (t.reshape(B, L, NH, hd).transpose(0, 2, 1, 3)
                      for t in (q, k, v))
        s = jnp.einsum("bhnd,bhmd->bhnm", qh, kh) * SCALE
        p = jax.nn.softmax(s + jnp.maximum(jnp.asarray(mask), -1e4)[:, None],
                           axis=-1) * m
        return jnp.einsum("bhnm,bhmd->bhnd", p, vh).transpose(
            0, 2, 1, 3).reshape(B, L, C)

    want, vjp = jax.vjp(oracle, *map(jnp.asarray, (q, k, v)))
    got, dgot = _port_attention(q, k, v, mask, g, rate)
    _close(got, want)
    for a, b in zip(dgot, vjp(jnp.asarray(g))):
        _close(a, b)
    assert 0.5 < keep.mean() < 0.9  # the mask really drops


M, HD = 58, 128  # not a multiple of the JAX kernels' row tiles


def _rows(seed):
    g = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: (g.randn(*s) * std).astype(np.float32)
    return dict(x=mk(M, C), res=mk(M, C), w=mk(C, C, std=C ** -0.5),
                b=mk(C, std=0.1), w1=mk(C, HD, std=C ** -0.5),
                b1=mk(HD, std=0.1), w2=mk(HD, C, std=HD ** -0.5),
                b2=mk(C, std=0.1), s=1 + mk(C, std=0.1), lb=mk(C, std=0.1),
                g=mk(M, C))


_OUT_LN = ("x", "res", "w", "b", "s", "lb")
_FFN = ("x", "w1", "b1", "w2", "b2", "s", "lb")


def _port_rows(op, names, p, rate):
    """(out, keep, grads) of the port's K11 / K12 (weights transposed to
    the torch Linear layout)."""
    ins = [_t(p[n].T if n in ("w", "w1", "w2") else p[n]).requires_grad_(
        True) for n in names]
    out, keep = op(*ins, SEED, 1e-12, rate)
    grads = torch.autograd.grad(out, ins, _t(p["g"]))
    grads = [d.T if n in ("w", "w1", "w2") else d
             for n, d in zip(names, grads)]
    return out.detach().numpy(), keep, [d.numpy() for d in grads]


@pytest.mark.parametrize("which", ["K11", "K12"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_out_ln_and_ffn_match_jax(which, rate):
    """Rate 0: against the JAX kernel in interpret mode (its custom_vjp
    for the vjp); rate 0.1: against the JAX masked reference fed the
    port's keep mask."""
    p = _rows(4)
    op, names = ((fused_out_ln_train, _OUT_LN) if which == "K11"
                 else (fused_ffn_post_ln_train, _FFN))
    got, keep, dgot = _port_rows(op, names, p, rate)
    assert keep.dtype == torch.bool and keep.shape == (M, C)
    jin = [jnp.asarray(p[n]) for n in names]
    if rate == 0.0:
        assert bool(keep.all())
        kernel = (jmlp.fused_out_ln_train if which == "K11"
                  else jmlp.fused_ffn_post_ln_train)
        with pltpu.force_tpu_interpret_mode():
            want, vjp = jax.vjp(lambda *a: kernel(*a, jnp.int32(3), 1e-12,
                                                  0.0), *jin)
            dwant = vjp(jnp.asarray(p["g"]))
    else:
        assert 0.8 < float(keep.float().mean()) < 0.97
        ref = (jmlp._out_ln_reference_masked if which == "K11"
               else jmlp._ffn_reference_masked)
        jkeep = jnp.asarray(keep.numpy().astype(np.float32))
        want, vjp = jax.vjp(lambda *a: ref(*a, jkeep, 1e-12, rate), *jin)
        dwant = vjp(jnp.asarray(p["g"]))
    _close(got, want)
    for a, b in zip(dgot, dwant):
        _close(a, b)


def _fmix32_np(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 2])
def test_hash_matches_numpy_uint32(seed):
    """The int64 torch hash equals a uint32 numpy one (wrap-around defined
    for arrays) on streams and indices up to 2^32 - 1."""
    streams = np.array([0, 1, 2, 767, 65535, 2 ** 31, 2 ** 32 - 1],
                       np.uint32)[:, None]
    index = np.concatenate([np.arange(4000), [2 ** 20, 2 ** 32 - 1]]).astype(
        np.uint32)[None]
    s = np.full((1, 1), seed, np.uint32)
    key = _fmix32_np(_fmix32_np(s ^ np.uint32(dropout.SEED_SALT))
                     ^ (streams * np.uint32(dropout.STREAM_MUL)))
    want = _fmix32_np(key ^ (index * np.uint32(dropout.INDEX_MUL)))
    got = dropout.bits(torch.tensor([seed]),
                       torch.from_numpy(streams.astype(np.int64)),
                       torch.from_numpy(index.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_and_independence(rate):
    """Over ~1.2e6 draws the keep rate is within 4 sigma of 1 - rate; the
    masks of other seeds, sequences and heads differ (agree on about
    keep^2 + rate^2 of the entries, as independent draws do)."""
    keep = dropout.attention_keep(torch.tensor([99]), 4, 12, 160, rate)
    n, want = keep.numel(), 1.0 - rate
    assert abs(float(keep.float().mean()) - want) <= 4 * (
        want * rate / n) ** 0.5
    other = dropout.attention_keep(torch.tensor([100]), 4, 12, 160, rate)
    agree = want ** 2 + rate ** 2
    pairs = [(keep, other), (keep[0], keep[1]), (keep[:, 0], keep[:, 1])]
    for a, b in pairs:
        frac = float((a == b).float().mean())
        assert abs(frac - agree) < 0.01, frac
    rows = dropout.row_keep(torch.tensor([99]), 200, 768, rate)
    assert abs(float(rows.float().mean()) - want) <= 4 * (
        want * rate / rows.numel()) ** 0.5
    assert bool(dropout.row_keep(torch.tensor([99]), 3, 5, 0.0).all())
    assert dropout.threshold(rate) == int(rate * 2 ** 32)
    assert dropout.threshold(1 - 2 ** -40) == 2 ** 32 - 1
