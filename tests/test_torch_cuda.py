"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes the main paths do not reach (M and N off the
128-row tiles, odd token counts, head dims 16/32/64, query-row tiles,
fully masked sequences, strided GEMM outputs, odd shift geometries, 1 to
600 sequences in the attention backward), and the gradients of the train
route's autograd Functions against autograd of the plain versions; the
BERT train kernels (K10a/K10b, K11, K12) with dropout on, where kernel and
plain version draw the same mask from the same seed (K11/K12's keep masks
exactly equal), and the kernels' dropout hash against the PyTorch one bit
for bit.

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
    encoder_attention_train_lanes_bwd, fused_bert_attn_block_kmask,
    fused_encoder_attention_train_lanes)
from lavender_tpu_torch.ops.fused_mlp import (
    fused_ffn_post_ln, fused_ffn_post_ln_train, fused_ln_mlp,
    fused_ln_mlp_chunked, fused_out_ln_train)
from lavender_tpu_torch.ops.swin_block_attn import fused_swin_block_wm
from lavender_tpu_torch.ops.swin_core_attn import (
    swin_core_attn, swin_core_attn_bwd)
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
