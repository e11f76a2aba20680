"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes the main paths do not reach (M and N off the
128-row tiles, odd token counts, head dims 16/32/64, query-row tiles,
fully masked sequences, strided GEMM outputs, odd shift geometries, 1 to
600 sequences in the attention backward), and the gradients of the train
route's autograd Functions against autograd of the plain versions; the
BERT train kernels (K10a/K10b, K11, K12) with dropout on, where kernel and
plain version draw the same mask from the same seed (K11/K12's keep masks
exactly equal), and the kernels' dropout hash against the PyTorch one bit
for bit; the full-mask sub-block K6 and the heads-layout core K7 at odd
lengths, head dims 32 and 64, finfo(f32).min masks (clamped) with a fully
masked row, transposed (non-contiguous) heads-layout views for K7, their
recompute-vjp gradients, and the raise on a CPU / CUDA mix; the GEMM's
row scatter and the LN's row gather, the spatial Swin block K14 (whole
and attention half, shifted, on windows that are not multiples of 8) and
its gradients (the attention half's through K8), the per-window attention
K15 on strided views and its gradient, and K1's whole block under
autograd; the LN without its affine (the serving fold's pure normalize)
and K1's folded mode, the LN gather's and the GEMM scatter's negative
(pad) rows, the uint8 patch embed K17 (ragged w2, two column tiles,
E = 192) and its eval-mode gradient, and the shifted wm block K16 (Npad >
N, Npad == N, the Swin-B stage-3 window) with its pad rows exactly zero
and its gradients through K2 and K8.

Needs a CUDA device and nvcc; skipped elsewhere.  This file imports no JAX,
so on a machine without it run it without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance, as in chip_smoke.py: bf16 on both sides, rounded at different
points, so max|kernel - plain| <= 2e-2 * max(1, max|plain|); gradients,
which sum over many more bf16 terms, also within relative L2 5e-2 (a
wrong head, window or transposition gives O(1)).  The row permutation is
exact.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lavender_tpu_torch.ops import _build, dropout, layer_norm
from lavender_tpu_torch.ops.encoder_attention import (
    encoder_attention_train_lanes_bwd, fused_bert_attn_block,
    fused_bert_attn_block_kmask, fused_encoder_attention,
    fused_encoder_attention_train_lanes)
from lavender_tpu_torch.ops.fused_mlp import (
    fused_ffn_post_ln, fused_ffn_post_ln_train, fused_ln_mlp,
    fused_ln_mlp_chunked, fused_out_ln_train)
from lavender_tpu_torch.models.swin3d import compute_shift_mask
from lavender_tpu_torch.ops.patch_embed_u8 import fused_patch_embed_u8
from lavender_tpu_torch.ops.swin_block_attn import (
    fused_swin_block_attn, fused_swin_block_full, fused_swin_block_wm,
    fused_swin_block_wm_shifted, pad_window_mask, round8)
from lavender_tpu_torch.ops.swin_core_attn import (
    swin_core_attn, swin_core_attn_bwd)
from lavender_tpu_torch.ops.window_attention import fused_window_attention
from lavender_tpu_torch.ops.wm_permute import shift_index, wm_shift_rows

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.library()  # builds on first use; raises without nvcc
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(g, *shape, std=1.0):
    return (torch.randn(*shape, generator=g, device="cuda") * std).to(
        torch.bfloat16)


def _close(got, want, rel_l2=None):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err
    if rel_l2 is not None:
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert rel <= rel_l2, rel


@pytest.mark.parametrize("M,N,K", [(1, 8, 32), (130, 136, 64),
                                   (257, 392, 96)])
@pytest.mark.parametrize("epi", ["bias", "gelu", "residual", "nobias"])
def test_gemm_matches_plain(gen, M, N, K, epi):
    a, w = _rnd(gen, M, K), _rnd(gen, N, K, std=K ** -0.5)
    b = None if epi == "nobias" else _rnd(gen, N)
    r = _rnd(gen, M, N) if epi == "residual" else None
    want = F.linear(a.float(), w.float(), None if b is None else b.float())
    if epi == "gelu":
        want = F.gelu(want)
    if r is not None:
        want = want + r.float()
    _close(_build.gemm(a, w, b, gelu=epi == "gelu", residual=r), want)


def test_gemm_writes_a_column_slice(gen):
    a, w, b = _rnd(gen, 70, 64), _rnd(gen, 24, 64, std=0.125), _rnd(gen, 24)
    out = torch.zeros(70, 72, dtype=torch.bfloat16, device="cuda")
    _build.gemm(a, w, b, out=out[:, 24:48])
    _close(out[:, 24:48], F.linear(a.float(), w.float(), b.float()))
    assert not out[:, :24].any() and not out[:, 48:].any()


@pytest.mark.parametrize("M,C", [(1, 8), (37, 96), (300, 1000), (5, 1024)])
def test_layernorm_matches_plain(gen, M, C):
    x, w, b = _rnd(gen, M, C, std=3.0), _rnd(gen, C), _rnd(gen, C)
    _close(_build.layernorm(x, w, b, 1e-5), layer_norm(x, w, b, 1e-5))


def _attention_plain(qkv, n_seq, N, nH, scale, bias, mask, keep):
    C = qkv.shape[1] // 3
    q, k, v = qkv.float().view(n_seq, N, 3, nH, C // nH).permute(2, 0, 3, 1, 4)
    s = (q * scale) @ k.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.view(n_seq // nW, nW, nH, N, N)
             + mask.float()[None, :, None]).view(n_seq, nH, N, N)
    if keep is not None:
        s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return (p @ v).transpose(1, 2).reshape(n_seq * N, C)


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("n_seq,N,nH,extras", [
    (1, 5, 1, ()), (2, 49, 2, ("bias",)), (4, 248, 2, ("bias", "mask")),
    (3, 276, 4, ("keep",)), (8, 33, 3, ("bias", "mask", "keep"))])
def test_attention_matches_plain(gen, hd, n_seq, N, nH, extras):
    qkv = _rnd(gen, n_seq * N, 3 * nH * hd)
    bias = _rnd(gen, nH, N, N) if "bias" in extras else None
    mask = None
    if "mask" in extras:  # 0 / -100 per window, 2 windows
        mask = (torch.rand(2, N, N, generator=gen, device="cuda") < 0.3)
        mask = (mask.float() * -100.0).to(torch.bfloat16)
    keep = None
    if "keep" in extras:
        keep = torch.rand(n_seq, N, generator=gen, device="cuda") < 0.7
        keep[0] = False  # a sequence with every key masked attends to nothing
    scale = hd ** -0.5
    got = _build.attention(qkv, n_seq, N, nH, scale, bias, mask, keep)
    _close(got, _attention_plain(qkv, n_seq, N, nH, scale, bias, mask, keep))


def test_kernel_ops_match_plain_and_count_launches(gen):
    B, nW, Npad, C, nH, HD = 2, 4, 56, 64, 2, 256
    x = _rnd(gen, B, nW, Npad, C)
    lin = lambda o, i: (_rnd(gen, o, i, std=i ** -0.5), _rnd(gen, o))
    ln = lambda c: (1 + _rnd(gen, c, std=0.1), _rnd(gen, c, std=0.1))
    (wqkv, bqkv), (wp, bp), (w1, b1), (w2, b2) = (
        lin(3 * C, C), lin(C, C), lin(HD, C), lin(C, HD))
    (n1w, n1b), (n2w, n2b) = ln(C), ln(C)
    bias = _rnd(gen, nH, Npad, Npad, std=0.5)
    mask = ((torch.rand(nW, Npad, Npad, generator=gen, device="cuda") < 0.2)
            .float() * -100.0).to(torch.bfloat16)
    mlp = (n2w, n2b, w1, b1, w2, b2)
    cases = [
        (fused_swin_block_wm, (x, n1w, n1b, wqkv, bqkv, wp, bp, bias, mask,
                               nH, (C // nH) ** -0.5, 1e-5), {"mlp": mlp}),
        (fused_ln_mlp_chunked, (x.view(-1, C), *mlp, 1e-5), {}),
        (fused_ffn_post_ln, (x.view(-1, C), w1, b1, w2, b2, n2w, n2b, 1e-12),
         {}),
    ]
    xb = _rnd(gen, B, 45, C)
    keep = torch.ones(B, 45, dtype=torch.bool, device="cuda")
    keep[1, 30:] = False
    (wq, bq), (wk, bk), (wv, bv) = lin(C, C), lin(C, C), lin(C, C)
    cases.append((fused_bert_attn_block_kmask,
                  (xb, wq, wk, wv, bq, bk, bv, wp, bp, n1w, n1b, keep, 4,
                   (C // 4) ** -0.5, 1e-12), {}))
    for op, args, kw in cases:
        before = op.launches
        got = op(*args, **kw)
        assert op.launches == before + 1, op.name
        _close(got, op.plain(*args, **kw))


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    a = _rnd(gen, 16, 40)  # K % 32 != 0
    with pytest.raises(ValueError):
        _build.gemm(a, _rnd(gen, 8, 40))
    with pytest.raises(ValueError):  # float32 operands
        _build.gemm(a.float()[:, :32], _rnd(gen, 8, 32).float())
    with pytest.raises(ValueError):  # head dim 48
        _build.attention(_rnd(gen, 10, 3 * 96), 1, 10, 2, 1.0)


@pytest.mark.parametrize("geom", [
    # window, D, H, W, Npad, shift: Swin-B stages, a d-shift, no tail pad,
    # a non-square map
    ((5, 7, 7), 5, 56, 56, 248, (0, 3, 3)), ((5, 7, 7), 5, 14, 14, 248,
                                              (0, 3, 3)),
    ((2, 7, 7), 2, 14, 21, 104, (1, 3, 3)), ((1, 12, 12), 1, 24, 24, 144,
                                              (0, 6, 6)),
    ((3, 5, 5), 3, 10, 15, 80, (1, 2, 2))])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wm_shift_rows_matches_plain(gen, geom, inverse, dtype):
    window, D, H, W, Npad, shift = geom
    nW = (H // window[1]) * (W // window[2])
    N = int(np.prod(window))
    idx = torch.as_tensor(shift_index(window, D, H, W, Npad, shift, inverse),
                          device="cuda")
    inv = torch.as_tensor(shift_index(window, D, H, W, Npad, shift,
                                      not inverse), device="cuda")
    t = torch.randn(3, nW, Npad, 24, generator=gen, device="cuda").to(dtype)
    t.requires_grad_(True)
    before = wm_shift_rows.launches
    got = wm_shift_rows(t, idx, inv)
    want = wm_shift_rows.plain(t, idx, inv)
    assert torch.equal(got, want) and not got[:, :, N:].any()
    w = torch.randn(got.shape, generator=gen, device="cuda").to(dtype)
    (g_got,) = torch.autograd.grad(got, t, w)
    (g_want,) = torch.autograd.grad(want, t, w)
    assert torch.equal(g_got, g_want)
    assert wm_shift_rows.launches == before + 2  # forward + backward


def _core_inputs(g, B, nW, N, Npad, nH, hd, all_masked=False):
    C = nH * hd
    qkv = _rnd(g, B, nW, Npad, 3 * C)
    bias = _rnd(g, nH, Npad, Npad)
    bias[:, :, N:] = -100.0  # pad keys dead, as rel_pos_bias_wm writes
    mask = (torch.rand(nW, Npad, Npad, generator=g, device="cuda") < 0.3)
    mask = (mask.float() * -100.0).to(torch.bfloat16)
    if all_masked:
        mask[0] = -100.0  # a window whose every key is masked
    return qkv, bias, mask, hd ** -0.5


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("B,nW,N,Npad,nH,masked", [
    (1, 1, 5, 8, 1, False), (2, 4, 49, 56, 2, True), (1, 3, 245, 248, 2,
                                                         True),
    (150, 4, 27, 32, 3, True), (600, 1, 12, 16, 2, False)])
def test_core_backward_matches_plain(gen, hd, B, nW, N, Npad, nH, masked):
    """K8a + K8b through the autograd Function vs autograd of the plain
    core: dq, dk, dv and dbias separately (1 to 600 sequences)."""
    qkv, bias, mask, scale = _core_inputs(gen, B, nW, N, Npad, nH, hd,
                                          all_masked=masked)
    mask = mask if masked else None
    dout = _rnd(gen, B, nW, Npad, nH * hd)
    dout[:, :, N:] = 0.0  # the caller's pad rows carry no cotangent
    got, dgot = [], []
    # as in training: an f32 bias leaf, cast to bf16 by autocast
    for f in (swin_core_attn, swin_core_attn.plain_as_launched):
        q = qkv.clone().requires_grad_(True)
        b = bias.float().requires_grad_(True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            o = f(q, b, mask, nH, scale)
        dq, db = torch.autograd.grad(o, (q, b), dout)
        got.append(o)
        dgot.append((dq, db))
    C = nH * hd
    _close(got[0][:, :, :N], got[1][:, :, :N])
    (dq_k, db_k), (dq_p, db_p) = dgot
    for part in range(3):  # dq, dk, dv
        sl = slice(part * C, (part + 1) * C)
        _close(dq_k[:, :, :N, sl], dq_p[:, :, :N, sl], rel_l2=5e-2)
    _close(db_k[:, :N, :N], db_p[:, :N, :N], rel_l2=5e-2)


def test_core_dbias_sum_matches_f64(gen):
    """dbias, summed over 64 sequences by chunks, against an f64 sum of the
    plain per-sequence gradients."""
    B, nW, N, Npad, nH, hd = 16, 4, 49, 56, 2, 32
    qkv, bias, mask, scale = _core_inputs(gen, B, nW, N, Npad, nH, hd)
    dout = _rnd(gen, B, nW, Npad, nH * hd)
    lse = torch.empty(B * nW, nH, Npad, device="cuda")
    _build.attention(qkv.view(-1, 3 * nH * hd), B * nW, Npad, nH, scale,
                     bias=bias, mask=mask, lse=lse)
    before = swin_core_attn_bwd.launches
    _, dbias = swin_core_attn_bwd(qkv, lse, dout, bias, mask, nH, scale)
    assert swin_core_attn_bwd.launches == before + 1
    want = torch.zeros(nH, Npad, Npad, dtype=torch.float64, device="cuda")
    for b in range(B):  # each batch row separately, summed in f64
        _, db = swin_core_attn_bwd.plain(qkv[b:b + 1], lse, dout[b:b + 1],
                                         bias, mask, nH, scale)
        want += db.double()
    err = (dbias.double() - want).abs().max()
    assert float(err) <= 1e-2 * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("M", [1, 130, 1984, 7937])
def test_ln_mlp_forward_and_backward_match_plain(gen, M):
    C, HD = 128, 512
    x = _rnd(gen, M, C, std=2.0)
    args = [1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1),
            _rnd(gen, HD, C, std=C ** -0.5), _rnd(gen, HD),
            _rnd(gen, C, HD, std=HD ** -0.5), _rnd(gen, C)]
    w = _rnd(gen, M, C)
    outs, grads = [], []
    for f in (fused_ln_mlp, fused_ln_mlp.plain):
        ins = [t.clone().requires_grad_(True) for t in [x] + args]
        y = f(*ins, 1e-5)
        outs.append(y)
        grads.append(torch.autograd.grad(y, ins, w))
    _close(outs[0], outs[1])
    for gk, gp in zip(*grads):
        _close(gk, gp, rel_l2=5e-2)


@pytest.mark.parametrize("masked", [False, True])
def test_block_attention_half_gradient_matches_plain(gen, masked):
    """K1's attention half under autograd (backward through K8) vs
    autograd of the plain block, on the valid rows."""
    B, nW, N, Npad, C, nH = 2, 4, 49, 56, 64, 2
    x = _rnd(gen, B, nW, Npad, C)
    ln = [1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1)]
    lin = [_rnd(gen, 3 * C, C, std=C ** -0.5), _rnd(gen, 3 * C),
           _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C)]
    bias = _rnd(gen, nH, Npad, Npad)
    bias[:, :, N:] = -100.0
    mask = None
    if masked:
        mask = ((torch.rand(nW, Npad, Npad, generator=gen, device="cuda")
                 < 0.3).float() * -100.0).to(torch.bfloat16)
    w = _rnd(gen, B, nW, Npad, C)
    w[:, :, N:] = 0.0
    grads = []
    before = swin_core_attn.launches, swin_core_attn_bwd.launches
    for f in (fused_swin_block_wm, fused_swin_block_wm.plain):
        ins = [t.clone().requires_grad_(True) for t in [x, *ln, *lin, bias]]
        y = f(*ins[:7], ins[7], mask, nH, (C // nH) ** -0.5, 1e-5,
              n_valid=N)
        grads.append(torch.autograd.grad(y, ins, w))
    assert (swin_core_attn.launches, swin_core_attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for i, (gk, gp) in enumerate(zip(*grads)):
        if i == 0:
            gk, gp = gk[:, :, :N], gp[:, :, :N]
        _close(gk, gp, rel_l2=5e-2)


def test_dropout_hash_matches_torch(gen):
    """The kernels' bits (probe entry) equal ``dropout.bits`` bit for bit."""
    for seed in (0, 7, 2 ** 31 - 2):
        t = torch.tensor([seed], device="cuda")
        got = _build.dropout_bits(t, 768, 276 * 5)
        want = dropout.bits(t, torch.arange(768, device="cuda")[:, None],
                            torch.arange(276 * 5, device="cuda")[None])
        assert torch.equal(got, want)


@pytest.mark.parametrize("L", [29, 276])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_train_attention_matches_plain(gen, L, rate):
    """K10a + K10b through the autograd Function under bf16 autocast (f32
    leaves, as in training) vs autograd of the plain version with the same
    seed: a padded key tail at finfo(f32).min and one fully masked row."""
    B, nH, hd = 3, 4, 64
    C = nH * hd
    q, k, v = (torch.randn(B, L, C, generator=gen, device="cuda")
               for _ in range(3))
    mask = torch.zeros(B, L, L, device="cuda")
    mask[1, :, L - 7:] = torch.finfo(torch.float32).min
    mask[2, 5, :] = torch.finfo(torch.float32).min  # every key masked
    seed = torch.tensor([4321], device="cuda")
    w = torch.randn(B, L, C, generator=gen, device="cuda")
    outs, grads = [], []
    before = (fused_encoder_attention_train_lanes.launches,
              encoder_attention_train_lanes_bwd.launches)
    for f in (fused_encoder_attention_train_lanes,
              fused_encoder_attention_train_lanes.plain_as_launched):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with torch.autocast("cuda", dtype=torch.bfloat16):
            o = f(*ins, mask, seed, hd ** -0.5, rate, nH)
        outs.append(o)
        grads.append(torch.autograd.grad(o, ins, w))
    assert (fused_encoder_attention_train_lanes.launches,
            encoder_attention_train_lanes_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _close(outs[0], outs[1], rel_l2=1e-2)
    for gk, gp in zip(*grads):
        _close(gk, gp, rel_l2=5e-2)


@pytest.mark.parametrize("which", ["K11", "K12"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_out_ln_and_ffn_train_match_plain(gen, which, rate):
    """K11 / K12 vs plain under the same seed: keep masks exactly equal,
    outputs and gradients (the mask-replay backward) within tolerance."""
    M, C, HD = 1000, 768, 3072
    x = _rnd(gen, M, C)
    ln = [1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1)]
    if which == "K11":
        op = fused_out_ln_train
        args = [x, _rnd(gen, M, C), _rnd(gen, C, C, std=C ** -0.5),
                _rnd(gen, C), *ln]
    else:
        op = fused_ffn_post_ln_train
        args = [x, _rnd(gen, HD, C, std=C ** -0.5), _rnd(gen, HD),
                _rnd(gen, C, HD, std=HD ** -0.5), _rnd(gen, C), *ln]
    seed = torch.tensor([99], device="cuda")
    w = _rnd(gen, M, C)
    res = []
    before = op.launches
    for f in (op, op.plain):
        ins = [t.clone().requires_grad_(True) for t in args]
        out, keep = f(*ins, seed, 1e-12, rate)
        res.append((out, keep, torch.autograd.grad(out, ins, w)))
    assert op.launches == before + 1
    (ok, kk, gk), (op_, kp, gp) = res
    assert kk.dtype == torch.bool and torch.equal(kk, kp)
    assert bool(kk.all()) if rate == 0.0 else 0.85 < kk.float().mean() < 0.95
    _close(ok, op_, rel_l2=1e-2)
    for a, b in zip(gk, gp):
        _close(a, b, rel_l2=5e-2)


def test_train_wrappers_reject_what_the_kernels_do_not_take(gen):
    x, seed = _rnd(gen, 16, 64), torch.tensor([1], device="cuda")
    ln = (_rnd(gen, 64), _rnd(gen, 64))
    with pytest.raises(ValueError):  # float32 operands
        fused_out_ln_train(x.float(), x.float(), _rnd(gen, 64, 64).float(),
                           _rnd(gen, 64).float(), *ln, seed, 1e-12, 0.1)
    with pytest.raises(ValueError):  # a non-contiguous residual
        _build.dropout_add_ln(x, _rnd(gen, 64, 16).t(), *ln, 1e-12, seed,
                              0.1)
    with pytest.raises(ValueError):  # a seed that is not int64 [1]
        _build.dropout_add_ln(x, x, *ln, 1e-12, seed.int(), 0.1)
    with pytest.raises(ValueError):  # a rate outside [0, 1)
        _build.dropout_add_ln(x, x, *ln, 1e-12, seed, 1.0)
    q = _rnd(gen, 2, 8, 64)
    with pytest.raises(ValueError):  # a mask of the wrong shape
        fused_encoder_attention_train_lanes(q, q, q, _rnd(gen, 2, 8, 9),
                                            seed, 0.25, 0.1, 1)
    with pytest.raises(ValueError):  # head dim 48
        fused_encoder_attention_train_lanes(
            _rnd(gen, 2, 8, 96), _rnd(gen, 2, 8, 96), _rnd(gen, 2, 8, 96),
            _rnd(gen, 2, 8, 8), seed, 0.25, 0.1, 2)
    with pytest.raises(ValueError):  # the backward needs the forward's lse
        encoder_attention_train_lanes_bwd(q, q, q, _rnd(gen, 2, 8, 8), seed,
                                          q, 0.25, 0.1, 1)


def _full_mask(gen, B, L):
    """An additive [B, L, L] f32 mask at 0 / finfo(f32).min (the model's,
    before the wrappers' clamp): a seq2seq-like block structure, random
    holes, one row that sees no key."""
    keep = torch.rand(B, L, L, generator=gen, device="cuda") < 0.7
    keep[:, :, :L // 2] = True
    keep[:, L // 2:, L // 2:] &= torch.ones(L - L // 2, L - L // 2,
                                            dtype=torch.bool,
                                            device="cuda").tril()
    keep[0, 1] = False
    return torch.where(keep, 0.0, torch.finfo(torch.float32).min)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("B,L,nH", [(1, 7, 2), (3, 33, 4), (2, 275, 12)])
@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_encoder_attention_matches_plain(gen, hd, B, L, nH, layout):
    """K7 on [B, nH, L, hd] tensors or on transposed views of
    [B, L, nH, hd] (read in place), forward and gradients."""
    def heads():
        if layout == "transposed":
            return _rnd(gen, B, L, nH, hd).transpose(1, 2)
        return _rnd(gen, B, nH, L, hd)

    q, k, v = heads(), heads(), heads()
    mask = _full_mask(gen, B, L)
    w = _rnd(gen, B, nH, L, hd)
    before = fused_encoder_attention.launches
    res = []
    for f in (fused_encoder_attention, fused_encoder_attention.plain):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = f(*ins, mask, hd ** -0.5)
        res.append((o, torch.autograd.grad(o, ins, w)))
    assert fused_encoder_attention.launches == before + 1
    (ok, gk), (op_, gp) = res
    assert ok.shape == (B, nH, L, hd) and ok.dtype == torch.bfloat16
    _close(ok, op_, rel_l2=1e-2)
    for a, b in zip(gk, gp):
        _close(a, b, rel_l2=5e-2)


@pytest.mark.parametrize("B,L,nH,C", [(1, 9, 2, 64), (2, 33, 4, 256),
                                      (4, 275, 12, 768)])
def test_full_mask_block_matches_plain(gen, B, L, nH, C):
    """K6 under a [B, L, L] mask at finfo(f32).min, forward and the
    recompute-vjp gradients of every input but the mask."""
    lin = lambda o, i: (_rnd(gen, o, i, std=i ** -0.5), _rnd(gen, o))
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (lin(C, C) for _ in range(4))
    args = [_rnd(gen, B, L, C), wq, wk, wv, bq, bk, bv, wo, bo,
            1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1)]
    mask = _full_mask(gen, B, L)
    w = _rnd(gen, B, L, C)
    before = fused_bert_attn_block.launches
    res = []
    for f in (fused_bert_attn_block, fused_bert_attn_block.plain):
        ins = [t.clone().requires_grad_(True) for t in args]
        o = f(*ins, mask, nH, (C // nH) ** -0.5, 1e-12)
        res.append((o, torch.autograd.grad(o, ins, w)))
    assert fused_bert_attn_block.launches == before + 1
    (ok, gk), (op_, gp) = res
    _close(ok, op_, rel_l2=1e-2)
    for a, b in zip(gk, gp):
        _close(a, b, rel_l2=5e-2)


def test_full_mask_wrappers_reject_a_device_mix(gen):
    B, L, nH, hd = 2, 9, 2, 32
    q = _rnd(gen, B, nH, L, hd)
    cpu_mask = torch.zeros(B, L, L)
    with pytest.raises(ValueError):  # the mask on the CPU
        fused_encoder_attention(q, q, q, cpu_mask, 0.25)
    with pytest.raises(ValueError):  # head dim 48
        q48 = _rnd(gen, B, nH, L, 48)
        fused_encoder_attention(q48, q48, q48, cpu_mask.cuda(), 0.25)
    with pytest.raises(ValueError):  # a misaligned row stride
        q_odd = _rnd(gen, B, nH, L, hd + 4)[..., :hd]
        fused_encoder_attention(q_odd, q_odd, q_odd, cpu_mask.cuda(), 0.25)
    C = nH * hd
    x, w, b = _rnd(gen, B, L, C), _rnd(gen, C, C), _rnd(gen, C)
    with pytest.raises(ValueError):
        fused_bert_attn_block(x, w, w, w, b, b, b, w, b, b, b, cpu_mask, nH,
                              0.25, 1e-12)
    with pytest.raises(ValueError):  # a mask of the wrong shape
        fused_bert_attn_block(x, w, w, w, b, b, b, w, b, b, b,
                              cpu_mask.cuda()[:, :, :5], nH, 0.25, 1e-12)


def test_gemm_row_scatter_and_layernorm_row_gather(gen):
    """K14's two layout primitives against their plain meaning."""
    M, K, N = 300, 64, 96
    perm = torch.randperm(M, generator=gen, device="cuda").to(torch.int32)
    a, w, b = _rnd(gen, M, K), _rnd(gen, N, K, std=K ** -0.5), _rnd(gen, N)
    r = _rnd(gen, M, N)
    out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
    _build.gemm(a, w, b, residual=r, rows=perm, out=out)
    want = torch.empty_like(out)
    p = perm.long()
    want[p] = (F.linear(a.float(), w.float(), b.float())
               + r[p].float()).to(torch.bfloat16)
    _close(out, want)
    x = _rnd(gen, M, 96, std=2.0)
    lw, lb = 1 + _rnd(gen, 96, std=0.1), _rnd(gen, 96, std=0.1)
    rows = perm[: M // 2].contiguous()
    got = _build.layernorm(x, lw, lb, 1e-5, rows=rows)
    _close(got, layer_norm(x[rows.long()], lw, lb, 1e-5))


def _spatial_args(gen, B, D, H, W, C, nH, window, shift):
    N = window[0] * window[1] * window[2]
    nW = (D // window[0]) * (H // window[1]) * (W // window[2])
    x = _rnd(gen, B, D, H, W, C)
    params = [1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1),
              _rnd(gen, 3 * C, C, std=C ** -0.5), _rnd(gen, 3 * C),
              _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C),
              _rnd(gen, nH, N, N)]
    mask = None
    if any(shift):
        mask = torch.as_tensor(compute_shift_mask(D, H, W, window, shift),
                               device="cuda").to(torch.bfloat16)
        assert mask.shape[0] == nW
    mlp = [1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1),
           _rnd(gen, 4 * C, C, std=C ** -0.5), _rnd(gen, 4 * C),
           _rnd(gen, C, 4 * C, std=(4 * C) ** -0.5), _rnd(gen, C)]
    return x, params, mask, mlp


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("geom", [
    # B, D, H, W, window, shift: odd windows (N = 40, 45), a non-square map
    (2, 2, 8, 10, (2, 4, 5), (0, 2, 2)), (1, 3, 15, 9, (3, 5, 3), (0, 2, 1)),
    (2, 5, 14, 14, (5, 7, 7), (0, 0, 0))])
def test_spatial_block_and_gradients_match_plain(gen, full, geom):
    """K14 forward vs plain, and under autograd its gradients (attention
    half: backward through K8; whole block: the plain recompute)."""
    B, D, H, W, window, shift = geom
    C, nH = 64, 2
    x, params, mask, mlp = _spatial_args(gen, B, D, H, W, C, nH, window,
                                         shift)
    op = fused_swin_block_full if full else fused_swin_block_attn
    statics = (window, shift, nH, (C // nH) ** -0.5, 1e-5)
    w = _rnd(gen, *x.shape)
    outs, grads = [], []
    before = swin_core_attn.launches, swin_core_attn_bwd.launches
    for f in (op, op.plain):
        ins = [t.clone().requires_grad_(True)
               for t in [x, *params] + (mlp if full else [])]
        y = f(*ins[:8], mask, *ins[8:], *statics)
        outs.append(y)
        grads.append(torch.autograd.grad(y, ins, w))
    through_k8 = 0 if full else 1
    assert (swin_core_attn.launches, swin_core_attn_bwd.launches) == (
        before[0] + through_k8, before[1] + through_k8)
    _close(outs[0], outs[1])
    _close((outs[0] - x).float(), (outs[1] - x).float(), rel_l2=5e-2)
    for gk, gp in zip(*grads):
        _close(gk, gp, rel_l2=5e-2)


@pytest.mark.parametrize("N,masked", [(45, True), (98, False), (245, True)])
def test_window_attention_and_gradient_match_plain(gen, N, masked):
    """K15 on the strided q, k, v views of one qkv product (the module
    path's), 6 windows, mask over 3; gradients through the recompute."""
    W, nH, hd, nW = 6, 2, 32, 3
    qkv = _rnd(gen, W, N, 3, nH, hd)
    bias = _rnd(gen, nH, N, N)
    mask = None
    if masked:
        mask = (torch.rand(nW, N, N, generator=gen, device="cuda")
                < 0.3).float() * -100.0
    g = _rnd(gen, W, nH, N, hd)
    outs, grads = [], []
    for f in (fused_window_attention, fused_window_attention.plain):
        qkv_l = qkv.clone().requires_grad_(True)
        b = bias.clone().requires_grad_(True)
        q, k, v = qkv_l.permute(2, 0, 3, 1, 4)
        y = f(q, k, v, b, mask, hd ** -0.5)
        outs.append(y)
        grads.append(torch.autograd.grad(y, (qkv_l, b), g))
    _close(outs[0], outs[1], rel_l2=1e-2)
    for gk, gp in zip(*grads):
        _close(gk, gp, rel_l2=5e-2)


def test_window_block_full_gradient_matches_plain(gen):
    """K1's whole block (serving) under autograd: the recompute vjp."""
    B, nW, N, Npad, C, nH = 2, 4, 49, 56, 64, 2
    x = _rnd(gen, B, nW, Npad, C)
    ln = [1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1)]
    lin = [_rnd(gen, 3 * C, C, std=C ** -0.5), _rnd(gen, 3 * C),
           _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C)]
    mlp = [1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1),
           _rnd(gen, 4 * C, C, std=C ** -0.5), _rnd(gen, 4 * C),
           _rnd(gen, C, 4 * C, std=(4 * C) ** -0.5), _rnd(gen, C)]
    bias = _rnd(gen, nH, Npad, Npad)
    bias[:, :, N:] = -100.0
    w = _rnd(gen, B, nW, Npad, C)
    w[:, :, N:] = 0.0
    grads = []
    for f in (fused_swin_block_wm, fused_swin_block_wm.plain):
        ins = [t.clone().requires_grad_(True)
               for t in [x, *ln, *lin, bias, *mlp]]
        y = f(*ins[:8], None, nH, (C // nH) ** -0.5, 1e-5,
              mlp=tuple(ins[8:]))
        grads.append(torch.autograd.grad(y, ins, w))
    for i, (gk, gp) in enumerate(zip(*grads)):
        if i == 0:
            gk, gp = gk[:, :, :N], gp[:, :, :N]
        _close(gk, gp, rel_l2=5e-2)


def test_layernorm_pure_normalize_and_pad_rows(gen):
    """No affine: the pure normalize (the kernel reads no null pointer);
    a negative gather row gives a zero row; a half-given affine raises, as
    does a missing one for dropout_add_ln."""
    x = _rnd(gen, 37, 96, std=2.0)
    _close(_build.layernorm(x, None, None, 1e-5),
           layer_norm(x, None, None, 1e-5))
    rows = torch.tensor([3, -1, 0, -1, 36], dtype=torch.int32, device="cuda")
    lw, lb = 1 + _rnd(gen, 96, std=0.1), _rnd(gen, 96, std=0.1)
    for w, b in ((lw, lb), (None, None)):
        got = _build.layernorm(x, w, b, 1e-5, rows=rows)
        _close(got[[0, 2, 4]], layer_norm(x[[3, 0, 36]], w, b, 1e-5))
        assert float(got[[1, 3]].abs().max()) == 0.0
    with pytest.raises(ValueError, match="both"):
        _build.layernorm(x, lw, None, 1e-5)
    with pytest.raises(ValueError, match="required"):
        _build.dropout_add_ln(x, x, None, lb, 1e-5, None, 0.0)


def test_gemm_scatter_drops_negative_rows(gen):
    M, K, N = 130, 64, 72
    a, w, b = _rnd(gen, M, K), _rnd(gen, N, K, std=K ** -0.5), _rnd(gen, N)
    r = _rnd(gen, M, N)
    rows = torch.randperm(M, generator=gen, device="cuda").to(torch.int32)
    rows[::3] = -1
    out = torch.full((M, N), 7.0, dtype=torch.bfloat16, device="cuda")
    _build.gemm(a, w, b, residual=r, rows=rows, out=out)
    keep = rows >= 0
    dst = rows[keep].long()
    want = out.clone()
    want[dst] = (F.linear(a[keep].float(), w.float(), b.float())
                 + r[dst].float()).to(torch.bfloat16)
    untouched = torch.ones(M, dtype=torch.bool, device="cuda")
    untouched[dst] = False
    assert bool((want[untouched] == 7.0).all())
    _close(out, want)


def test_block_folded_mode_matches_plain(gen):
    """K1 with the serving fold (pure-normalize LNs, folded qkv and fc1),
    whole block and attention half, against its plain version and against
    the unfolded block; under autograd the fold raises."""
    B, nW, N, Npad, C, nH = 2, 4, 49, 56, 64, 2
    x = _rnd(gen, B, nW, Npad, C)
    ln = [1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1)]
    lin = [_rnd(gen, 3 * C, C, std=C ** -0.5), _rnd(gen, 3 * C),
           _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C)]
    mlp = [1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1),
           _rnd(gen, 4 * C, C, std=C ** -0.5), _rnd(gen, 4 * C),
           _rnd(gen, C, 4 * C, std=(4 * C) ** -0.5), _rnd(gen, C)]
    bias = _rnd(gen, nH, Npad, Npad)
    bias[:, :, N:] = -100.0
    f32 = [t.float() for t in (*ln, lin[0], lin[1], *mlp[:4])]
    s1, b1, wq, bq, s2, b2, w1, bb1 = f32
    folded = tuple(t.to(torch.bfloat16) for t in (
        wq * s1[None], wq @ b1 + bq, w1 * s2[None], w1 @ b2 + bb1))
    args = (x, *ln, *lin, bias, None, nH, (C // nH) ** -0.5, 1e-5)
    for kw in ({"mlp": tuple(mlp)}, {}):
        got = fused_swin_block_wm(*args, folded=folded, **kw)
        want = fused_swin_block_wm.plain(*args, folded=folded, **kw)
        _close(got[:, :, :N], want[:, :, :N], rel_l2=1e-2)
        _close(got[:, :, :N], fused_swin_block_wm.plain(*args, **kw)
               [:, :, :N], rel_l2=2e-2)
    with pytest.raises(ValueError, match="serving-only"):
        fused_swin_block_wm(x.clone().requires_grad_(True), *args[1:],
                            folded=folded)


@pytest.mark.parametrize("B,D,H,W,E", [(1, 2, 32, 32, 16),
                                       (2, 5, 64, 96, 96),
                                       (1, 3, 16, 288, 128),
                                       (2, 2, 32, 64, 192)])
def test_patch_embed_matches_plain_and_gradient(gen, B, D, H, W, E):
    """K17 at w2 = 8, 24, 72 (two column tiles) and E = 192 (dynamic shared
    memory above 48 KB); in eval() under autograd the plain gradient."""
    x = torch.randint(0, 256, (B, D, H, W, 3), generator=gen, device="cuda",
                      dtype=torch.uint8)
    weight, bias = _rnd(gen, E, 3, 2, 4, 4, std=0.05), _rnd(gen, E, std=0.05)
    before = fused_patch_embed_u8.launches
    got = fused_patch_embed_u8(x, weight, bias)
    assert fused_patch_embed_u8.launches == before + 1
    assert got.shape == (B, D, H // 4, W // 4, E)
    _close(got, fused_patch_embed_u8.plain(x, weight, bias), rel_l2=1e-2)
    weight.mul_(-0.5)  # the kernel's folded weights follow the change
    _close(fused_patch_embed_u8(x, weight, bias),
           fused_patch_embed_u8.plain(x, weight, bias), rel_l2=1e-2)
    g = _rnd(gen, *got.shape)
    grads = []
    for f in (fused_patch_embed_u8, fused_patch_embed_u8.plain):
        w, b = (t.clone().requires_grad_(True) for t in (weight, bias))
        grads.append(torch.autograd.grad(f(x, w, b), (w, b), g))
    for gk, gp in zip(*grads):
        _close(gk, gp, rel_l2=5e-2)


@pytest.mark.parametrize("window,spatial,C,nH", [
    ((2, 2, 3), (2, 4, 6), 64, 2), ((2, 2, 4), (2, 4, 8), 64, 2),
    ((5, 7, 7), (5, 14, 14), 128, 4)], ids=["npad-gt-n", "npad-eq-n",
                                             "stage3-window"])
def test_wm_shifted_block_and_gradients_match_plain(gen, window, spatial, C,
                                                    nH):
    """K16: forward vs plain (also minus the residual), pad rows exactly
    zero, and under autograd every gradient, the backward through K2 (two
    shifts and their two transposes) and K8."""
    from lavender_tpu_torch.ops.wm_permute import wm_shift_rows
    D, H, W = spatial
    N = window[0] * window[1] * window[2]
    Npad, nW, B = round8(N), (H // window[1]) * (W // window[2]), 2
    x = _rnd(gen, B, nW, Npad, C)
    x[:, :, N:] = 0.0
    params = [1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1),
              _rnd(gen, 3 * C, C, std=C ** -0.5), _rnd(gen, 3 * C),
              _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C),
              _rnd(gen, nH, Npad, Npad)]
    params[-1][:, :, N:] = -100.0
    shift = (0, window[1] // 2, window[2] // 2)
    mask = pad_window_mask(torch.as_tensor(compute_shift_mask(
        D, H, W, window, shift), device="cuda"), Npad).to(torch.bfloat16)
    statics = (spatial, window, shift, nH, (C // nH) ** -0.5, 1e-5)
    g = _rnd(gen, B, nW, Npad, C)
    g[:, :, N:] = 0.0
    ops = (fused_swin_block_wm_shifted, wm_shift_rows, swin_core_attn,
           swin_core_attn_bwd)
    outs, grads = [], []
    for f in (fused_swin_block_wm_shifted, fused_swin_block_wm_shifted.plain):
        before = [op.launches for op in ops]
        ins = [t.clone().requires_grad_(True) for t in [x, *params]]
        y = f(*ins, mask, *statics)
        outs.append(y)
        grads.append(torch.autograd.grad(y, ins, g))
        if f is fused_swin_block_wm_shifted:
            assert [op.launches - n for op, n in zip(ops, before)] == [
                1, 4, 1, 1]
    if Npad > N:
        assert float(outs[0].detach()[:, :, N:].abs().max()) == 0.0
    v = (slice(None), slice(None), slice(0, N))
    _close(outs[0][v], outs[1][v], rel_l2=1e-2)
    _close((outs[0] - x)[v].float(), (outs[1] - x)[v].float(), rel_l2=5e-2)
    for gk, gp in zip(*grads):
        _close(gk, gp, rel_l2=5e-2)
