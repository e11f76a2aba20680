"""The Swin backbone's spatial block K14 of the port against the JAX
package, f32 on the CPU, and the routes the port's backbone takes.

K14: the port's plain versions of ``fused_swin_block_attn`` and
``fused_swin_block_full`` against the JAX kernel in Pallas interpret mode
(as tests/test_swin_block_fused.py runs it), shifted and unshifted, at a
window shrunk in D to (2, 7, 7) on a 14 x 14 map, and their vjps against
the JAX custom_vjps, within 1e-4 (f32; the TPU kernel takes exp2 without
a running max and LN variance as E[x^2] - mean^2).  The recomputation that
the card's backward differentiates (through K8) equals the plain version.

The routes: which ops one backbone forward calls (their plain versions
counted on the CPU, as ``chip_smoke.py`` counts the launches on the card)
for each ``attn_impl``, ``remat`` and ``scan_blocks``, in serving and in
training, as the JAX ``BasicLayer`` / ``SwinBlock3D`` route them.  The
backbone against JAX's is in tests/test_torch_swin_backbone.py, the train
step in tests/test_torch_swin_train.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu import config as jcfg
from lavender_tpu.models import swin3d as jswin
from lavender_tpu.ops import swin_block_attn as jops
from lavender_tpu_torch.models import swin3d as tswin
from lavender_tpu_torch.ops import swin_block_attn as tops
from tests.test_torch_convert import port_config

ATOL = RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------- K14

SPATIAL, WINDOW, C, NH = (2, 14, 14), (2, 7, 7), 16, 2


def _block_inputs(seed):
    """Block params in JAX layout, x [1, 2, 14, 14, 16], the output
    cotangent, the rel-pos table of the full (8, 7, 7) window."""
    g = np.random.RandomState(seed)
    mk = lambda *s, std=1.0: (g.randn(*s) * std).astype(np.float32)
    p = dict(ln_s=1 + mk(C, std=0.1), ln_b=mk(C, std=0.1),
             wqkv=mk(C, 3 * C, std=C ** -0.5), bqkv=mk(3 * C, std=0.1),
             wproj=mk(C, C, std=C ** -0.5), bproj=mk(C, std=0.1),
             n2s=1 + mk(C, std=0.1), n2b=mk(C, std=0.1),
             w1=mk(C, 4 * C, std=C ** -0.5), b1=mk(4 * C, std=0.1),
             w2=mk(4 * C, C, std=(4 * C) ** -0.5), b2=mk(C, std=0.1))
    table = mk(15 * 13 * 13, NH, std=0.5)
    return p, table, mk(1, *SPATIAL, C), mk(1, *SPATIAL, C)


_ATTN = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj")
_MLP = ("n2s", "n2b", "w1", "b1", "w2", "b2")
_TRANSPOSED = ("wqkv", "wproj", "w1", "w2")  # JAX [in, out] -> torch


def _jax_block(full, shift, table):
    """The JAX entry as a function of (x, params..., padded bias)."""
    N = int(np.prod(WINDOW))
    rpi = jswin.relative_position_index((8, 7, 7))[:N, :N]
    bias = jops.rel_pos_bias_padded(jnp.asarray(table), rpi, *WINDOW,
                                    jops._round8(WINDOW[2]), jnp.float32)
    statics = (WINDOW, shift, NH, (C // NH) ** -0.5, 1e-5)
    if full:
        return lambda *a: jops.fused_swin_block_full(
            *a[:7], bias, *a[7:], *statics)
    return lambda *a: jops.fused_swin_block_attn(*a, bias, *statics)


def _port_block(full, shift, table):
    """The port's entry as a function of (x, params...) in torch layout."""
    N = int(np.prod(WINDOW))
    bias = tops.rel_pos_bias_wm(_t(table), tswin.relative_position_index(
        (8, 7, 7)), N, N, torch.float32)
    mask = None
    if any(shift):
        mask = _t(tswin.compute_shift_mask(*SPATIAL, WINDOW, shift))
    statics = (WINDOW, shift, NH, (C // NH) ** -0.5, 1e-5)
    if full:
        return lambda *a: tops.fused_swin_block_full(
            *a[:7], bias, mask, *a[7:], *statics)
    return lambda *a: tops.fused_swin_block_attn(*a, bias, mask, *statics)


def _port_args(p, x):
    names = _ATTN[1:]
    return [_t(x)] + [_t(p[k].T if k in _TRANSPOSED else p[k])
                      for k in names]


@pytest.mark.parametrize("full", [False, True], ids=["attn", "full"])
@pytest.mark.parametrize("shift", [(0, 0, 0), (0, 3, 3)],
                         ids=["unshifted", "shifted"])
def test_block_and_vjp_match_jax_kernel_interpret(full, shift):
    """The forward against the interpret-mode kernel and the vjp of x and
    every parameter against JAX's custom_vjp (one ``jax.vjp``)."""
    p, table, x, g = _block_inputs(seed=0 if full else 1)
    names = _ATTN + (_MLP if full else ())
    jargs = [jnp.asarray(x if k == "x" else p[k]) for k in names]
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(_jax_block(full, shift, table), *jargs)
        want_grads = vjp(jnp.asarray(g))
    leaves = _port_args(p, x) + [_t(p[k].T if k in _TRANSPOSED else p[k])
                                 for k in (_MLP if full else ())]
    leaves = [t.requires_grad_(True) for t in leaves]
    got = _port_block(full, shift, table)(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    grads = torch.autograd.grad(got, leaves, _t(g))
    for name, a, b in zip(names, grads, want_grads):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b.T if name in _TRANSPOSED
                                   else b, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_attention_half_recompute_equals_plain():
    """What the card's backward of K14's attention half differentiates
    (gather -> LN1 -> qkv -> ``swin_core_attn`` -> proj -> scatter) is
    the plain version, value and gradients, bias included."""
    p, table, x, g = _block_inputs(seed=2)
    shift = (0, 3, 3)
    N = int(np.prod(WINDOW))
    bias = tops.rel_pos_bias_wm(_t(table), tswin.relative_position_index(
        (8, 7, 7)), N, N, torch.float32)
    mask = _t(tswin.compute_shift_mask(*SPATIAL, WINDOW, shift))
    statics = (WINDOW, shift, NH, (C // NH) ** -0.5, 1e-5)
    outs = []
    for fn in (tops._attn_plain, tops._spatial_attn_recompute):
        leaves = [t.requires_grad_(True) for t in _port_args(p, x)]
        b = bias.clone().requires_grad_(True)
        y = fn(*leaves, b, mask, *statics)
        outs.append((y.detach(), torch.autograd.grad(y, leaves + [b],
                                                     _t(g))))
    (y0, g0), (y1, g1) = outs
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), atol=1e-5, rtol=1e-5)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_window_rows_is_the_rolled_partition():
    """K14's row index: spatial rows in the order of window_partition of
    the map rolled by -shift (exact), for two clips."""
    D, H, W = 2, 14, 21
    shift = (0, 3, 3)
    x = torch.arange(2 * D * H * W).reshape(2, D, H, W, 1)
    want = tops.window_partition(torch.roll(x, (0, -3, -3), (1, 2, 3)),
                                 WINDOW).reshape(-1)
    rows, inv = tops._device_rows(2, D, H, W, WINDOW, shift, "cpu")
    np.testing.assert_array_equal(rows.numpy(), want.numpy())
    np.testing.assert_array_equal(inv.numpy()[rows.long().numpy()],
                                  np.arange(rows.numel()))


# ---------------------------------------------------------------- routes

SWIN = jcfg.SwinConfig(embed_dim=16, depths=(2, 2, 2, 2),
                       num_heads=(1, 2, 2, 4), window_size=(8, 7, 7),
                       drop_path_rate=0.0)


def _count_calls(monkeypatch):
    """Count the calls of every Swin op (its plain version runs on the
    CPU), as ``chip_smoke.py`` counts the launches on the card."""
    from lavender_tpu_torch.ops import fused_mlp, window_attention
    ops = {"K1": tops.fused_swin_block_wm, "K2": tops.wm_shift,
           "K14": tops.fused_swin_block_attn,
           "K14-full": tops.fused_swin_block_full,
           "K15": window_attention.fused_window_attention,
           "K9": fused_mlp.fused_ln_mlp, "K3": fused_mlp.fused_ln_mlp_chunked}
    counts = dict.fromkeys(ops, 0)
    for name, op in ops.items():
        if name == "K2":
            continue

        def counted(*a, _name=name, _plain=op.plain, **k):
            counts[_name] += 1
            return _plain(*a, **k)
        monkeypatch.setattr(op, "plain", counted)
    return counts


@pytest.mark.parametrize("impl,kw,train,want", [
    ("auto", {}, False, {"K1": 8}),
    ("fused", {}, False, {"K14-full": 8}),
    ("pallas", {}, False, {"K15": 8, "K9": 8}),
    ("xla", {}, False, {}),
    ("auto", {"remat": True}, False, {"K14-full": 8}),
    # training: scanned pairs take the attention half under drop-path;
    # remat runs each pair's forward twice
    ("auto", {"remat": True}, True, {"K14": 16, "K9": 16}),
    ("fused", {}, True, {"K14": 8, "K9": 8}),
    # one block at a time: drop-path only where its rate is nonzero
    ("auto", {"scan_blocks": False}, True, {"K14-full": 1, "K14": 7,
                                             "K9": 7}),
], ids=["auto", "fused", "pallas", "xla", "auto-remat-eval",
        "auto-remat-train", "fused-train", "auto-no-scan-train"])
def test_routes_call_the_kernels_jax_calls(monkeypatch, impl, kw, train,
                                           want):
    """The ops each route calls in one forward of the 4-stage backbone on a
    clip of 2 x 56 x 56 (the window tiles every stage; at these widths every
    stage passes the JAX package's VMEM gates), as the JAX BasicLayer and
    SwinBlock3D route them."""
    counts = _count_calls(monkeypatch)
    cfg = dataclasses.replace(SWIN, attn_impl=impl, drop_path_rate=0.1,
                              **kw)
    model = tswin.VideoSwin3D(port_config(cfg)).train(train)
    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (1, 2, 56, 56, 3)).astype(np.uint8))
    with torch.set_grad_enabled(train):
        out = model(img, torch.Generator().manual_seed(0))
    if train:
        out.square().mean().backward()
    assert counts == {k: want.get(k, 0) for k in counts}
