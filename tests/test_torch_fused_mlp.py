"""K3 (Swin stage-4 LN + MLP + residual), K9 (Swin LN + MLP, the train
route) and K5 (BERT post-LN FFN): the port's plain PyTorch versions (and
for K9 its gradient) against the JAX package, f32 on the CPU; and K5's
launch plan on the card (``ffn_plan``).

The JAX kernels run in Pallas interpret mode (K3 with its HD axis split into
4 chunks and a token count that is not a multiple of its tile), and against
their pure-JAX references.  Tolerance 1e-4: f32, but the JAX kernels take LN
variance as E[x^2] - mean^2 and an erf polynomial (|err| < 1.5e-7), and sum
the fc2 chunks in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu.ops import fused_mlp as jmlp
from lavender_tpu_torch.ops import _build, fused_mlp as tmlp

ATOL = RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(M, C, HD, seed):
    g = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: (g.randn(*s) * std).astype(np.float32)
    return dict(x=mk(M, C), s=1 + mk(C, std=0.1), b=mk(C, std=0.1),
                w1=mk(C, HD, std=C ** -0.5), b1=mk(HD, std=0.1),
                w2=mk(HD, C, std=HD ** -0.5), b2=mk(C, std=0.1))


def _port_ln_mlp(p):
    return tmlp.fused_ln_mlp_chunked(
        _t(p["x"]), _t(p["s"]), _t(p["b"]), _t(p["w1"].T), _t(p["b1"]),
        _t(p["w2"].T), _t(p["b2"]), 1e-5).numpy()


@pytest.mark.parametrize("M", [40, 64])
def test_ln_mlp_chunked_matches_jax_kernel_interpret(M):
    p = _params(M, 32, 128, seed=0)
    with pltpu.force_tpu_interpret_mode():
        want = jmlp.fused_ln_mlp_chunked(
            *(jnp.asarray(p[k]) for k in ("x", "s", "b", "w1", "b1", "w2",
                                          "b2")),
            1e-5, add_residual=True, hd_chunk=32, tm=16)
    np.testing.assert_allclose(_port_ln_mlp(p), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_ln_mlp_matches_jax_reference():
    p = _params(24, 64, 256, seed=1)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    want = j["x"] + jmlp.ln_mlp_reference(j["x"], j["s"], j["b"], j["w1"],
                                          j["b1"], j["w2"], j["b2"], 1e-5)
    np.testing.assert_allclose(_port_ln_mlp(p), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _port_ffn(p):
    return tmlp.fused_ffn_post_ln(
        _t(p["x"]), _t(p["w1"].T), _t(p["b1"]), _t(p["w2"].T), _t(p["b2"]),
        _t(p["s"]), _t(p["b"]), 1e-12).numpy()


@pytest.mark.parametrize("M", [8, 40, 300])  # 8: the KV decoder's step
def test_ffn_post_ln_matches_jax_kernel_interpret(M):
    p = _params(M, 32, 128, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = jmlp.fused_ffn_post_ln(
            *(jnp.asarray(p[k]) for k in ("x", "w1", "b1", "w2", "b2", "s",
                                          "b")), 1e-12)
    np.testing.assert_allclose(_port_ffn(p), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_ffn_post_ln_matches_jax_reference():
    p = _params(24, 64, 256, seed=3)
    want = jmlp._ffn_reference(
        *(jnp.asarray(p[k]) for k in ("x", "w1", "b1", "w2", "b2", "s", "b")),
        1e-12)
    np.testing.assert_allclose(_port_ffn(p), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("M", [1, 7, 8, 16, 17, 64, 65, 250, 1000, 1104,
                               4416])
def test_ffn_plan_covers_k_and_fills_the_card(M):
    """K5's launch plan at BERT-base's widths: the regime by M, every one
    of fc2's K-steps taken exactly once (the kernels' assignment: slice s
    of ``splits``, warp w of 4 takes the slice's 32-wide chunks w, w + 4,
    ...; a long-M tile block its whole slice of tile steps), every output
    covered, and
    at the decoder's step (8 rows), the prefill (1000) and serving (1104)
    a block for each of the H100's 132 SMs in both products."""
    C, HD = 768, 3072
    plan = tmlp.ffn_plan(M, C, HD)
    assert plan.short == (M <= 64)
    unit = 32 if plan.short else _build.TILE_K
    per = HD // plan.splits // unit  # whole K-steps a slice
    assert per * plan.splits * unit == HD
    warps = range(4) if plan.short else range(1)
    taken = sorted(s * per + c for s in range(plan.splits) for w in warps
                   for c in range(w, per, len(warps)))
    assert taken == list(range(HD // unit))
    rows = 1 if plan.short else -(-M // 128)
    side = 16 if plan.short else 128
    assert plan.fc1_blocks * side == rows * HD
    assert plan.fc2_blocks * side == rows * C * plan.splits
    if M in (8, 1000, 1104):
        assert min(plan.fc1_blocks, plan.fc2_blocks) >= tmlp.H100_SMS


def _k9_args(p):
    return (p["x"], p["s"], p["b"], p["w1"], p["b1"], p["w2"], p["b2"])


def _port_k9(p):
    """K9 on the port side: inputs requiring grad, weights in torch
    Linear layout."""
    ins = [_t(p[k]) for k in ("x", "s", "b", "w1", "b1", "w2", "b2")]
    ins[3], ins[5] = ins[3].t().contiguous(), ins[5].t().contiguous()
    ins = [t.requires_grad_(True) for t in ins]
    return ins, tmlp.fused_ln_mlp(*ins, 1e-5)


@pytest.mark.parametrize("M", [40, 300])
def test_ln_mlp_without_residual_matches_jax_kernel_interpret(M):
    """K9 forward (no residual) against the Pallas kernel, f32 (the
    kernel's precise erf path), M off its 256-row tile."""
    p = _params(M, 32, 128, seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = jmlp.fused_ln_mlp(*(jnp.asarray(a) for a in _k9_args(p)),
                                 1e-5)
    _, got = _port_k9(p)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_ln_mlp_gradient_matches_jax_vjp():
    """K9's gradient (x, LN and both Linear layers) against the JAX
    custom_vjp (the ln_mlp_reference recompute)."""
    p = _params(48, 32, 128, seed=5)
    w = np.random.RandomState(6).randn(48, 32).astype(np.float32)

    def f(*a):
        return jnp.sum(jmlp.fused_ln_mlp(*a, 1e-5) * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=tuple(range(7)))(
            *(jnp.asarray(a) for a in _k9_args(p)))
    ins, out = _port_k9(p)
    got = [g.numpy() for g in torch.autograd.grad(out, ins, _t(w))]
    got[3], got[5] = got[3].T, got[5].T
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(g, wnt, rtol=RTOL,
                                   atol=ATOL * float(np.abs(wnt).max()))
