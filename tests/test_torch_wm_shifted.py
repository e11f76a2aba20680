"""The shifted window-major block K16 of the port against the JAX package,
f32 on the CPU.

The port's plain version of ``fused_swin_block_wm_shifted`` (the shift,
the wm attention half, the inverse shift) against the JAX kernel in Pallas
interpret mode (as tests/test_swin_block_fused.py runs it) and against
its oracle ``_wm_shifted_ref``, at that file's two geometries (Npad > N
and Npad == N), values and the vjp of x, wqkv, wproj and the bias, within
1e-4 (one op in f32; the TPU kernel takes exp2 and LN variance as
E[x^2] - mean^2).  The output's window pad rows are exactly zero.  The
recomputation that the card's backward differentiates (K2 -> the attention
half through the K8 core -> K2^-1) equals the plain version on the valid
rows, with the same gradients.  The route's gate against JAX
``supports_inkernel_shift``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu.models.swin3d import compute_shift_mask_jnp
from lavender_tpu.ops import swin_block_attn as jops
from lavender_tpu_torch.models.swin3d import compute_shift_mask
from lavender_tpu_torch.ops import swin_block_attn as tops

ATOL = RTOL = 1e-4
SHIFT, NH, C, B = (0, 1, 1), 2, 16, 2
GEOMETRIES = [((2, 2, 3), (2, 4, 6)), ((2, 2, 4), (2, 4, 8))]


def _inputs(window, spatial):
    g = np.random.RandomState(0)
    D, H, W = spatial
    nW = (H // window[1]) * (W // window[2])
    N = int(np.prod(window))
    Npad = tops.round8(N)
    mk = lambda *s, std=1.0: (g.randn(*s) * std).astype(np.float32)
    x = mk(B, nW, Npad, C)
    x[:, :, N:] = 0.0
    p = dict(x=x, ln_s=1 + mk(C, std=0.1), ln_b=mk(C, std=0.1),
             wqkv=mk(C, 3 * C, std=0.1), bqkv=mk(3 * C, std=0.1),
             wproj=mk(C, C, std=0.1), bproj=mk(C, std=0.1),
             bias=mk(NH, Npad, Npad, std=0.1))
    p["bias"][:, :, N:] = -100.0
    return p, nW, N, Npad


def _jax_fn(fn, p, window, spatial):
    mask = compute_shift_mask_jnp(*spatial, window, SHIFT)
    statics = (spatial, window, SHIFT, NH, (C // NH) ** -0.5, 1e-5)

    def f(x, wqkv, wproj, bias):
        return fn(x, jnp.asarray(p["ln_s"]), jnp.asarray(p["ln_b"]), wqkv,
                  jnp.asarray(p["bqkv"]), wproj, jnp.asarray(p["bproj"]),
                  bias, mask, *statics)
    return f


def _port_args(p, window, spatial, Npad):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    mask = tops.pad_window_mask(torch.from_numpy(compute_shift_mask(
        *spatial, window, SHIFT)), Npad)
    return [t["x"], t["ln_s"], t["ln_b"], t["wqkv"].t().contiguous(),
            t["bqkv"], t["wproj"].t().contiguous(), t["bproj"], t["bias"],
            mask, spatial, window, SHIFT, NH, (C // NH) ** -0.5, 1e-5]


@pytest.mark.parametrize("window,spatial", GEOMETRIES,
                         ids=["npad-gt-n", "npad-eq-n"])
def test_plain_and_vjp_match_jax(window, spatial):
    p, nW, N, Npad = _inputs(window, spatial)
    assert tops.supports_inkernel_shift(window, spatial, Npad, C, NH, nW)
    diff = (jnp.asarray(p["x"]), jnp.asarray(p["wqkv"]),
            jnp.asarray(p["wproj"]), jnp.asarray(p["bias"]))
    f_ref = _jax_fn(jops._wm_shifted_ref, p, window, spatial)
    f_ker = _jax_fn(jops.fused_swin_block_wm_shifted, p, window, spatial)
    loss = lambda f: lambda *a: jnp.sum(f(*a)[:, :, :N] ** 2)
    with pltpu.force_tpu_interpret_mode():
        want_k = np.asarray(f_ker(*diff))
        grads_k = jax.grad(loss(f_ker), argnums=(0, 1, 2, 3))(*diff)
    want_r = np.asarray(f_ref(*diff))

    args = _port_args(p, window, spatial, Npad)
    for i in (0, 3, 5, 7):
        args[i].requires_grad_(True)
    got = tops.fused_swin_block_wm_shifted(*args)
    np.testing.assert_allclose(got.detach().numpy(), want_r, atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got.detach().numpy(), want_k, atol=ATOL,
                               rtol=RTOL)
    if Npad > N:
        assert float(got.detach()[:, :, N:].abs().max()) == 0.0
    got[:, :, :N].square().sum().backward()
    port_grads = (args[0].grad, args[3].grad.t(), args[5].grad.t(),
                  args[7].grad)
    for name, a, b in zip(("x", "wqkv", "wproj", "bias"), port_grads,
                          grads_k):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("window,spatial", GEOMETRIES,
                         ids=["npad-gt-n", "npad-eq-n"])
def test_backward_recompute_equals_plain(window, spatial):
    """The card's backward differentiates ``_shifted_recompute``: the same
    valid rows and gradients as the plain version."""
    p, nW, N, Npad = _inputs(window, spatial)
    results = []
    for fn in (tops._shifted_plain, tops._shifted_recompute):
        args = _port_args(p, window, spatial, Npad)
        leaves = [args[i].requires_grad_(True) for i in range(8)]
        y = fn(*args)
        y[:, :, :N].square().sum().backward()
        results.append((y.detach()[:, :, :N], [t.grad for t in leaves]))
    (y0, g0), (y1, g1) = results
    torch.testing.assert_close(y1, y0, atol=ATOL, rtol=RTOL)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window,spatial,C_,nH,nW", [
    g for g in itertools.product(
        ((5, 7, 7), (2, 7, 7), (5, 4, 4)),
        ((5, 14, 14), (2, 14, 14), (5, 28, 28), (5, 7, 7), (5, 12, 12)),
        (128, 512, 1024), (4, 16), (1, 4, 16))][::5])
def test_gate_matches_jax(window, spatial, C_, nH, nW):
    Npad = tops.round8(int(np.prod(window)))
    assert tops.supports_inkernel_shift(window, spatial, Npad, C_, nH, nW) \
        == jops.supports_inkernel_shift(window, spatial, Npad, C_, nH, nW)
