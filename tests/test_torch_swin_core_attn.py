"""K8 (window-attention core forward and backward) and the K1 attention
half's gradient: the port's plain versions against the JAX package's
Pallas kernels in interpret mode (as tests/test_swin_core_attn.py runs
them), f32 on the CPU.

Tolerance 1e-4 relative (to the largest magnitude of the JAX result): f32
on both sides, but the JAX kernels take exp2 of log2e-prescaled scores
without max-subtraction and sum in another order.  The block gradient is
also held at 1e-4: the JAX vjp recomputes through the same core kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu.models import swin3d as jswin
from lavender_tpu.ops import swin_block_attn as jblock
from lavender_tpu.ops import swin_core_attn as jcore
from lavender_tpu_torch.ops import swin_block_attn as tblock
from lavender_tpu_torch.ops import swin_core_attn as tcore

RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _core_inputs(seed, B=2, nW=4, N=12, Npad=16, C=16, nH=2):
    g = np.random.RandomState(seed)
    qkv = g.randn(B, nW, Npad, 3 * C).astype(np.float32)
    bias = (g.randn(nH, Npad, Npad) * 0.5).astype(np.float32)
    bias[:, :, N:] = -100.0  # pad keys dead, as rel_pos_bias_wm writes
    mask = ((g.rand(nW, N, N) > 0.8) * -100.0).astype(np.float32)
    mask_pad = np.zeros((nW, Npad, Npad), np.float32)
    mask_pad[:, :N, :N] = mask
    return qkv, bias, mask, mask_pad, (C // nH) ** -0.5, nH, N


@pytest.mark.parametrize("use_mask", [False, True])
def test_core_forward_matches_jax_kernel(use_mask):
    qkv, bias, mask, mask_pad, scale, nH, N = _core_inputs(0)
    with pltpu.force_tpu_interpret_mode():
        want = jcore._core_fwd_call(jnp.asarray(qkv), jnp.asarray(bias),
                                    jnp.asarray(mask) if use_mask else None,
                                    nH, scale)
    got = tcore.swin_core_attn(_t(qkv), _t(bias),
                               _t(mask_pad) if use_mask else None, nH, scale)
    _close(got[:, :, :N], np.asarray(want)[:, :, :N])


@pytest.mark.parametrize("use_mask", [False, True])
def test_core_backward_matches_jax_kernel(use_mask):
    """dqkv and dbias of the plain K8b against the Pallas backward, with a
    cotangent on the valid rows only (the caller's pad rows carry none),
    given the forward's output as the autograd Function passes it."""
    qkv, bias, mask, mask_pad, scale, nH, N = _core_inputs(1)
    do = np.random.RandomState(2).randn(*qkv.shape[:3], qkv.shape[3] // 3)
    do = do.astype(np.float32)
    do[:, :, N:] = 0.0
    m = mask if use_mask else np.zeros((1, 16, 16), np.float32)

    def f(q, b):
        return jnp.sum(jcore.swin_core_attn(q, b, jnp.asarray(m), use_mask,
                                            nH, scale) * do)

    with pltpu.force_tpu_interpret_mode():
        dq_want, db_want = jax.grad(f, argnums=(0, 1))(jnp.asarray(qkv),
                                                       jnp.asarray(bias))
    mask_t = _t(mask_pad) if use_mask else None
    out = tcore.swin_core_attn(_t(qkv), _t(bias), mask_t, nH, scale)
    dq, db = tcore.swin_core_attn_bwd(_t(qkv), None, _t(do), _t(bias), mask_t,
                                      nH, scale, out=out)
    _close(dq[:, :, :N], np.asarray(dq_want)[:, :, :N])
    _close(db[:, :N, :N], np.asarray(db_want)[:, :N, :N])
    assert float(db[:, :, N:].abs().max()) < 1e-6  # pad keys: ~e^-100


def _block_inputs(seed):
    """B=2, spatial (5, 14, 14) -> window (5, 7, 7), N = 245 padded to
    248, 4 windows, C = 16, 2 heads (JAX layout)."""
    g = np.random.RandomState(seed)
    spatial, window, C, nH = (5, 14, 14), (5, 7, 7), 16, 2
    mk = lambda *s, std=1.0: (g.randn(*s) * std).astype(np.float32)
    p = dict(x=mk(2, 4, 248, C), ln_s=1 + mk(C, std=0.1), ln_b=mk(C, std=0.1),
             wqkv=mk(C, 3 * C, std=C ** -0.5), bqkv=mk(3 * C, std=0.1),
             wproj=mk(C, C, std=C ** -0.5), bproj=mk(C, std=0.1))
    p["bias"] = np.asarray(jblock.rel_pos_bias_wm(
        jnp.asarray(mk(15 * 13 * 13, nH, std=0.5)), (8, 7, 7), window, 248,
        jnp.float32))
    return p, spatial, window, C, nH


@pytest.mark.parametrize("shifted", [False, True])
def test_block_gradient_matches_jax_vjp(shifted):
    """The K1 attention half's gradient: the recompute that the port's
    autograd Function differentiates on the card (through K8), and
    autograd of the plain block, against the JAX custom_vjp of
    ``fused_swin_block_wm`` (LVT_COREBWD at its default: recompute through
    the Pallas core)."""
    p, spatial, window, C, nH = _block_inputs(3)
    N, scale = 245, (C // nH) ** -0.5
    mask = mask_pad = None
    if shifted:
        mask = jswin.compute_shift_mask_jnp(*spatial, window, (0, 3, 3))
        mask_pad = tblock.pad_window_mask(_t(mask), 248)
    w = np.random.RandomState(4).randn(*p["x"].shape).astype(np.float32)
    w[:, :, N:] = 0.0
    keys = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj", "bias")

    def f(*a):
        y = jblock.fused_swin_block_wm(*a, mask, spatial, window, nH, scale,
                                       1e-5)
        return jnp.sum(y * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=tuple(range(8)))(
            *(jnp.asarray(p[k]) for k in keys))
    want = [np.asarray(g) for g in want]
    want[0] = want[0][:, :, :N]

    def port_inputs():
        ins = [_t(p[k]) for k in keys]
        for i in (3, 5):  # torch Linear layout
            ins[i] = ins[i].t().contiguous()
        return [t.requires_grad_(True) for t in ins]

    for fn in (lambda *a: tblock._block_attn_recompute(
                   *a, mask_pad, nH, scale, 1e-5, N),
               lambda *a: tblock.fused_swin_block_wm(
                   *a[:7], a[7], mask_pad, nH, scale, 1e-5, n_valid=N)):
        ins = port_inputs()
        got = torch.autograd.grad(fn(*ins), ins, _t(w))
        got = [g.numpy() for g in got]
        got[0] = got[0][:, :, :N]
        got[3], got[5] = got[3].T, got[5].T
        for g, wnt in zip(got, want):
            _close(g, wnt)
