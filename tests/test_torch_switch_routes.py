"""The last four JAX Swin route switches of the port, on the CPU:
``LVT_PSHIFT=0`` (the cyclic shift as torch.roll, no K2), ``LVT_COREBWD=0``
(the wm kernels' backward recomputes without K8), ``LVT_SWINTRAIN=1`` (the
train attention half as a composition around the K8 core, the MLP plain)
and ``LVT_EMBING=1`` (the patch embed writes stage 1's window-major layout,
stage 1 skips its partition).  Each route computes the default route's
function, so CPU parity cannot see a misrouted stage: every test counts
the ops each route calls (their plain versions, a recorder as in
tests/test_torch_serving_routes.py) and holds the output and gradients to
the default route's, 1e-5 relative L2 (f32; the plain composition of
``LVT_SWINTRAIN`` + ``LVT_COREBWD=0`` drops the pad keys that the default
masks at -100 and sums in another order, so a gradient whose norm is below
1e-6 is held to 1e-6 instead of to its own norm).

The tiny backbone of tests/test_torch_model.py on clips of 2 x 112 x 112:
every stage window-major (stages 3 and 4 fill or shrink the window and do
not shift), so 2 shifted block pairs (K2 4x), 8 K1 blocks.
"""
import dataclasses

import pytest
import torch

from lavender_tpu_torch.models import swin3d as tswin
from lavender_tpu_torch.models.swin3d import VideoSwin3D
from lavender_tpu_torch.ops import fused_mlp, swin_block_attn, wm_permute
from lavender_tpu_torch.ops.swin_core_attn import swin_core_attn
from tests.test_torch_convert import port_config
from tests.test_torch_model import PORT_SWIN

OPS = {"K1": swin_block_attn.fused_swin_block_wm,
       "K2": wm_permute.wm_shift_rows, "K3": fused_mlp.fused_ln_mlp_chunked,
       "K8a": swin_core_attn, "K9": fused_mlp.fused_ln_mlp}


def _count(monkeypatch):
    """Calls of each op's plain version (K1 with ``core_bwd=False`` apart)
    and of ``wm_partition``."""
    counts = dict.fromkeys([*OPS, "K1 plain bwd", "wm_partition"], 0)
    for name, op in OPS.items():
        def counted(*a, _name=name, _plain=op.plain, **k):
            counts[_name] += 1
            if k.get("core_bwd") is False:
                counts["K1 plain bwd"] += 1
            return _plain(*a, **k)
        monkeypatch.setattr(op, "plain", counted)
    partition = tswin.wm_partition

    def counted_partition(*a):
        counts["wm_partition"] += 1
        return partition(*a)
    monkeypatch.setattr(tswin, "wm_partition", counted_partition)
    return counts


@pytest.fixture(scope="module")
def model():
    cfg = port_config(PORT_SWIN)
    m = VideoSwin3D(dataclasses.replace(cfg, drop_path_rate=0.3))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    clip = torch.randint(0, 256, (2, 2, 112, 112, 3), generator=gen,
                         dtype=torch.uint8)
    return m, clip


def _serve(model, monkeypatch):
    m, clip = model
    m.eval()
    counts = _count(monkeypatch)
    with torch.inference_mode():
        out = m(clip)
    return out, dict(counts)


def _train(model, monkeypatch):
    """Loss and gradients of one train-mode forward (drop-path 0.3 from a
    fixed generator)."""
    m, clip = model
    m.train()
    m.zero_grad(set_to_none=True)
    counts = _count(monkeypatch)
    out = m(clip, torch.Generator().manual_seed(5))
    loss = out.square().mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    return float(loss.detach()), grads, dict(counts)


def _close(got, want):
    """Relative L2 within 1e-5; a gradient of norm below 1e-6 (stage 2-3's
    rel-pos tables: ~3e-9, their sums cancel) against 1e-6."""
    err = float((got - want).norm() / want.norm().clamp_min(1e-6))
    assert err <= 1e-5, err


SERVE = {"K1": 8, "K2": 4, "wm_partition": 4}
TRAIN = {"K1": 8, "K2": 4, "K9": 8, "wm_partition": 4}


def _want(base, **changes):
    out = dict.fromkeys([*OPS, "K1 plain bwd", "wm_partition"], 0)
    out.update(base)
    out.update(changes)
    return out


@pytest.mark.parametrize("mode", ["serve", "train"])
def test_pshift_0_rolls_instead_of_k2(model, monkeypatch, mode):
    run = _serve if mode == "serve" else _train
    base = SERVE if mode == "serve" else TRAIN
    want = run(model, monkeypatch)
    monkeypatch.setattr(tswin, "_PSHIFT", False)
    got = run(model, monkeypatch)
    assert want[-1] == _want(base) and got[-1] == _want(base, K2=0)
    if mode == "serve":
        _close(got[0], want[0])
        return
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    for n, g in want[1].items():
        _close(got[1][n], g)


def test_corebwd_0_routes_the_wm_blocks_plain(model, monkeypatch):
    want = _train(model, monkeypatch)
    monkeypatch.setattr(tswin, "_COREBWD", False)
    got = _train(model, monkeypatch)
    assert got[-1] == _want(TRAIN, **{"K1 plain bwd": 8})
    assert got[0] == want[0]
    for n, g in want[1].items():
        assert torch.equal(got[1][n], g), n


@pytest.mark.parametrize("core_bwd", [True, False])
def test_swintrain_composition(model, monkeypatch, core_bwd):
    want = _train(model, monkeypatch)
    monkeypatch.setenv("LVT_SWINTRAIN", "1")
    monkeypatch.setattr(tswin, "_COREBWD", core_bwd)
    got = _train(model, monkeypatch)
    assert got[-1] == _want(TRAIN, K1=0, K9=0, K8a=8 if core_bwd else 0)
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    for n, g in want[1].items():
        _close(got[1][n], g)


def test_embing_skips_stage1_partition(model, monkeypatch):
    want = _serve(model, monkeypatch)
    monkeypatch.setenv("LVT_EMBING", "1")
    calls = []
    wm = tswin.PatchEmbed3D._u8_embed_wm
    monkeypatch.setattr(tswin.PatchEmbed3D, "_u8_embed_wm",
                        lambda self, *a: calls.append(1) or wm(self, *a))
    got = _serve(model, monkeypatch)
    assert got[-1] == _want(SERVE, wm_partition=3) and len(calls) == 1
    _close(got[0], want[0])
    _train(model, monkeypatch)  # serving only: training partitions
    assert len(calls) == 1


def _block_inputs(B=2, nW=4, N=18, Npad=24, C=16, nH=2, seed=0):
    """A wm block's operands: x [B, nW, Npad, C], LN, qkv, proj, the bias
    with pad keys at -100, a 0/-100 shift mask."""
    g = torch.Generator().manual_seed(seed)

    def r(*s, std=0.2):
        return (torch.randn(*s, generator=g) * std).requires_grad_(True)
    bias = torch.randn(nH, Npad, Npad, generator=g) * 0.5
    bias[:, :, N:] = -100.0
    mask = torch.where(torch.rand(nW, Npad, Npad, generator=g) < 0.3,
                       -100.0, 0.0)
    return (r(B, nW, Npad, C, std=1.0), r(C) + 1.0, r(C), r(3 * C, C),
            r(3 * C), r(C, C), r(C), bias.requires_grad_(True), mask), \
        (nH, (C // nH) ** -0.5, 1e-5, N)


@pytest.mark.parametrize("core_bwd", [True, False])
def test_k1_backward_recompute_route(monkeypatch, core_bwd):
    """The K1 attention half's autograd Function on the CPU (its launch
    replaced by the plain version): the backward recomputes through the K8
    core (one call) or, under ``core_bwd=False``, plain on the valid rows
    (none); the gradients are autograd's of the plain half on the valid
    rows either way (pad rows identity)."""
    monkeypatch.setattr(swin_block_attn, "_block_cuda",
                        lambda *a, **k: swin_block_attn._block_plain(*a))
    counts = _count(monkeypatch)
    tensors, (nH, scale, eps, N) = _block_inputs()
    y = swin_block_attn._block_launch(*tensors, nH, scale, eps, n_valid=N,
                                      core_bwd=core_bwd)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad(y, tensors[:8], g)
    assert counts["K8a"] == int(core_bwd)
    ref = [t.detach().requires_grad_(True) for t in tensors[:8]]
    y2 = swin_block_attn._block_attn_recompute(*ref, tensors[8], nH, scale,
                                               eps, N, core=None)
    want = torch.autograd.grad(y2, ref, g)
    for a, b in zip(grads, want):
        _close(a, b)


@pytest.mark.parametrize("core_bwd", [True, False])
def test_k16_backward_recompute_route(monkeypatch, core_bwd):
    """The same for K16 (the shift inside; spatial 2 x 6 x 6, window
    2 x 3 x 3, N = 18 padded to 24, shift 1 x 1 x 1): its backward shifts
    by K2 around the recomputed half, through K8 or plain."""
    monkeypatch.setattr(swin_block_attn, "_shifted_cuda",
                        lambda *a: swin_block_attn._shifted_plain(*a))
    counts = _count(monkeypatch)
    tensors, (nH, scale, eps, N) = _block_inputs()
    spatial, window, shift = (2, 6, 6), (2, 3, 3), (1, 1, 1)
    mask = swin_block_attn.pad_window_mask(torch.as_tensor(
        tswin.compute_shift_mask(*spatial, window, shift)), 24)
    tensors = (*tensors[:8], mask)
    y = swin_block_attn._shifted_launch(*tensors, spatial, window, shift, nH,
                                        scale, eps, core_bwd=core_bwd)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad(y, tensors[:8], g)
    assert counts["K8a"] == int(core_bwd) and counts["K2"] == 2
    ref = [t.detach().requires_grad_(True) for t in tensors[:8]]
    y2 = swin_block_attn._shifted_plain(*ref, mask, spatial, window, shift,
                                        nH, scale, eps)
    want = torch.autograd.grad(y2, ref, g)
    for a, b in zip(grads, want):
        _close(a, b)
