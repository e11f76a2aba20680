"""K15, the per-window attention, against the JAX package, f32 on the CPU.

The port's plain version of ``fused_window_attention`` against the JAX
kernel in Pallas interpret mode (as tests/test_pallas_attention.py runs
it), with and without the per-window shift mask, on a window count that is
a multiple of the mask's (window w takes mask[w % nW]) and at N = 98 (a
(2, 7, 7) window, not a multiple of 8); its vjp (q, k, v and the bias)
against the JAX custom_vjp.  Tolerance 1e-4: f32 on both sides, the same
max-subtracted softmax, other summation orders.  And the serving logits
of the whole model under ``attn_impl="pallas"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu.ops import window_attention as jwa
from lavender_tpu_torch.ops import window_attention as twa
from lavender_tpu_torch.serve import LavenderServer
from tests.test_torch_convert import TINY, port_config, random_params

ATOL = RTOL = 1e-4


def _inputs(with_mask, seed=0):
    """q, k, v [W=6, nH=2, N=98, hd=8], bias [2, 98, 98], a -100 / 0 mask
    over nW = 3 windows (or None) and the output cotangent."""
    g = np.random.RandomState(seed)
    W, nH, N, hd, nW = 6, 2, 98, 8, 3
    mk = lambda *s, std=1.0: (g.randn(*s) * std).astype(np.float32)
    q, k, v = (mk(W, nH, N, hd) for _ in range(3))
    bias = mk(nH, N, N, std=0.5)
    mask = None
    if with_mask:
        mask = np.where(g.rand(nW, N, N) > 0.7, -100.0, 0.0).astype(
            np.float32)
    return q, k, v, bias, mask, mk(W, nH, N, hd), hd ** -0.5


@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_matches_jax_kernel_interpret(with_mask):
    q, k, v, bias, mask, _, scale = _inputs(with_mask)
    jmask = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        want = jwa.fused_window_attention(
            *(jnp.asarray(a) for a in (q, k, v, bias)), jmask, scale)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = twa.fused_window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), tmask, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_vjp_matches_jax(with_mask):
    """d(q, k, v, bias) of <out, g> against the JAX custom_vjp's."""
    q, k, v, bias, mask, g, scale = _inputs(with_mask, seed=1)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q, k, v, b):
        return jwa.fused_window_attention(q, k, v, b, jmask, scale)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v, bias)))
        want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (q, k, v, bias)]
    out = twa.fused_window_attention(
        *leaves, None if mask is None else torch.from_numpy(mask), scale)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


def test_serving_logits_pallas_match_jax():
    """The serving slice under ``attn_impl="pallas"``: LavenderServer (K15
    and K9 in their plain versions) against the JAX model with its kernels
    in interpret mode, on the tiny config of the port's other tests with a
    (8, 4, 4) window; clips of 2 x 64 x 64 (stages of 16, 8, 4 and, the
    window shrunk in H and W, 2); MLM logits within 1e-3 (as
    tests/test_torch_model.py)."""
    cfg = dataclasses.replace(TINY, swin=dataclasses.replace(
        TINY.swin, attn_impl="pallas", window_size=(8, 4, 4)))
    g = np.random.RandomState(0)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    img = g.randint(0, 256, (2, 2, 64, 64, 3)).astype(np.uint8)
    txt = g.randint(1, 1024, (2, 8)).astype(np.int32) * mask
    jm = JaxLavender(cfg)
    variables = {"params": random_params(jm, img[:1], txt[:1], mask[:1])}
    apply = jax.jit(jm.apply)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(apply.lower(variables, img, txt, mask).compile(
            {"xla_backend_optimization_level": 0})(variables, img, txt,
                                                   mask))
    server = LavenderServer(
        port_config(cfg), device="cpu", dtype=torch.float32, frames=2,
        size=64, params=jax.tree_util.tree_map(np.asarray,
                                                variables["params"]))
    got = server(img, txt, mask).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
