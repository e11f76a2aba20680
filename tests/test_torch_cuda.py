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
recompute-vjp gradients, and the raise on a CPU / CUDA mix; K7 (the
tensor-core forward without lse) at L = 275 and 276 under the seq2seq
mask with a fully masked row, a second call bitwise equal; the tile
GEMM's row scatter and the LN's row gather, the spatial Swin block K14 (whole
and attention half, shifted, on windows that are not multiples of 8) and
its gradients (the attention half's through K8), the per-window attention
K15 on strided views (head dims 16/32/64, N = 45/98/245, a bf16, an f32
or no mask, bias and mask in rows padded to 16 bytes, a second call
bitwise equal) and its gradient, and K1's whole block under
autograd; the LN without its affine (the serving fold's pure normalize)
and K1's folded mode, the LN gather's and the scatter epilogue's
negative (pad) rows (dropped, or zeroed by K16's instance), the uint8
patch embed K17 (ragged w2, two 64-patch units a row, E = 16 to 256,
D = 1, more than one wave of its persistent grid, 4-byte copies) a second
call bitwise equal, and its eval-mode gradient, and the shifted wm block
K16 (Npad > N, Npad == N, the Swin-B stage-3 window; at stage 3, B = 4
and 8) with random input pad rows, its output's pad rows exactly zero, a
second call bitwise equal, and its gradients through K2 and K8; the heads-layout train attention K13a /
K13b (strided heads views of one qkv slab and contiguous tensors, L = 29
and 276, dropout on and off, the mask's gradient dmask where the mask
requires it), the keep masks K13a and K10a draw, read back from the
kernels and equal to ``dropout.attention_keep`` bit for bit, and the raise
on what the K13 kernels do not take (and K7 at L = 1000); K1 launched
outside autograd under bf16 autocast on f32 inputs (a model in ``eval()``
mode over f32 weights), cast as its autograd Function casts; the
tensor-core backward of K10b / K13b at lengths across its 64-row tiles
(1 to 276), head dims 16/32/64, the packed slab, heads views and
contiguous heads, rates 0 / 0.1 / 0.5, padded-key and seq2seq masks with
a fully masked row, each call repeated and bitwise equal; the same for
the tensor-core forward of K10a / K13a (1 to 1000 tokens), its output,
its lse against an f64 logsumexp and its keep masks at rates 0.1 and 0.5;
and the tensor-core Swin window core K8a / K8b (per-head bias, dbias) at
Npad 8 to 248 and the unpadded N = 245, 1 to 600 sequences, each call
repeated and bitwise equal, its lse against an f64 logsumexp and dbias
against an f64 sum over up to 512 windows; K2 at Swin-B's three shifted
stages (bf16 and f32, both directions, with and without autograd, exact,
pad rows 0); K5 at BERT-base's widths over 1 to 1104 rows (both regimes
of its plan), a second call bitwise equal, and its gradients; the wgmma +
TMA tile GEMM at each tile height of its plan, M, N and K off the tile,
each epilogue, three weights into a column slice of a wider slab, its
K-slices + row LN, each a second call bitwise equal; the packed core on
the tensor cores where the caller selects them (bias and mask, the
key-keep vector with rows off 4-byte boundaries, a sequence with every
key dropped); K1 at Swin-B's stages (B = 4 with the MLP, B = 8 the
attention half) and K4 at L = 276 and 250 against their plain versions,
a second call bitwise equal; K9 (with and without its residual) at
Swin-B's four stages and K3 at its stage 4 (and its residual-free part)
against their plain versions, a second call bitwise equal, K9's
gradients through the recompute, their one C call at every tile and
K-slice option of its plan (the row kernel's sum without LN, with and
without the residual) and the raise on what it does not take; K6 (K4's C
call under a bf16 mask) at B = 4, L = 275, 252 and 270 under the seq2seq
mask, a random 0/1 mask, a query row whose every key is masked and the
stride-0 expansion of a key-padding bias, a second call bitwise equal;
the tile GEMM's K-slices into the row kernel's dropout mode off the tile
and at several slices, and K11 at the caption step's 2,200 rows and the
default step's 17,664 at rates 0, 0.1 and 0.5, keep masks exactly equal,
its gradients through the mask replay, a second call bitwise equal; and
by kernel name that K1, K3, K4, K6, K9, K11, K12, K14 and K16 run the
tile GEMM (K1, K4, K6, K14 and K16 the tensor-core forward too, K11 and
K12 the row kernel, K14 and K16 the 16-byte-chunk LN) and none of them
the wmma GEMM, the f32-pipe core (both gone) or, K1 aside, the scalar LN;
the packed core refusing a call that selects no core; the tile GEMM's
scatter epilogue and the chunk LN's
gather (pad rows dropped, zero rows); K14's one C call at Swin-B's four
stages against its plain version (shifted and unshifted, with and
without its MLP, the bias and a bf16 or f32 mask in rows padded to 16
bytes or at N's own pitch), a second call bitwise equal; K12's one C
call off the tile and at the step's rows, rates 0, 0.1 and 0.5, its
keep mask exactly ``dropout.row_keep``, a second call bitwise equal.

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
    encoder_attention_train_bwd, encoder_attention_train_lanes_bwd,
    fused_bert_attn_block, fused_bert_attn_block_kmask,
    fused_encoder_attention, fused_encoder_attention_train,
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
from lavender_tpu_torch.ops.wm_permute import (
    shift_index, shift_indices, wm_shift, wm_shift_rows)

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
    a = _rnd(gen, 16, 40)  # K % 8 == 0 but N % 8 != 0
    with pytest.raises(ValueError):
        _build.gemm_tc(a, _rnd(gen, 12, 40))
    with pytest.raises(ValueError):  # float32 operands
        _build.gemm_tc(a.float(), _rnd(gen, 8, 40).float())
    with pytest.raises(ValueError):  # head dim 48
        _build.attention(_rnd(gen, 10, 3 * 96), 1, 10, 2, 1.0,
                         tensor_cores=True)
    with pytest.raises(ValueError, match="select them"):  # no core chosen
        _build.attention(_rnd(gen, 10, 3 * 64), 1, 10, 2, 1.0)


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


@pytest.mark.parametrize("stage", [1, 2, 3])  # Swin-B's shifted stages
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grad", [False, True])
def test_wm_shift_swin_b_stages_exact(gen, stage, inverse, dtype, grad):
    """K2 through ``wm_shift`` at Swin-B's stage maps and widths (T=5,
    window (5, 7, 7), Npad 248): exact, its pad rows 0 whatever the input's
    hold, launched directly outside autograd and through its Function (the
    backward the same gather with the inverse index) under it."""
    side, C = {1: (56, 128), 2: (28, 256), 3: (14, 512)}[stage]
    window, Npad, shift, N = (5, 7, 7), 248, (0, 3, 3), 245
    nW = (side // 7) ** 2
    t = torch.randn(2, nW, Npad, C, generator=gen, device="cuda").to(dtype)
    t.requires_grad_(grad)
    before = wm_shift_rows.launches
    got = wm_shift(t, window, 5, side, side, shift, inverse)
    idx, inv = shift_indices(window, 5, side, side, Npad, shift, t.device,
                             inverse)
    want = wm_shift_rows.plain(t, idx, inv)
    assert torch.equal(got, want) and not got[:, :, N:].any()
    assert got.requires_grad == grad
    if grad:
        w = torch.randn(got.shape, generator=gen, device="cuda").to(dtype)
        (g_got,) = torch.autograd.grad(got, t, w)
        (g_want,) = torch.autograd.grad(want, t, w)
        assert torch.equal(g_got, g_want) and not g_got[:, :, N:].any()
    assert wm_shift_rows.launches == before + 1 + grad


@pytest.mark.parametrize("M", [1, 7, 8, 16, 17, 64, 65, 250, 1000, 1104])
def test_ffn_post_ln_matches_plain(gen, M):
    """K5 at BERT-base's widths, across both regimes of ``ffn_plan`` (the
    decoder's 8 rows, the prefill's 1000, serving's 1104): within the
    kernel gate, a second call bitwise equal, and under autograd the
    gradients of every input equal to the plain version's (its backward
    recomputes through it)."""
    C, HD = 768, 3072
    args = (_rnd(gen, M, C), _rnd(gen, HD, C, std=C ** -0.5),
            _rnd(gen, HD, std=0.02), _rnd(gen, C, HD, std=HD ** -0.5),
            _rnd(gen, C, std=0.02), 1 + _rnd(gen, C, std=0.1),
            _rnd(gen, C, std=0.1))
    before = fused_ffn_post_ln.launches
    got = fused_ffn_post_ln(*args, 1e-12)
    _close(got, fused_ffn_post_ln.plain(*args, 1e-12), rel_l2=1e-2)
    assert torch.equal(got, fused_ffn_post_ln(*args, 1e-12))
    assert fused_ffn_post_ln.launches == before + 2
    leaves = [t.detach().requires_grad_(True) for t in args]
    cot = _rnd(gen, M, C)
    got_g = torch.autograd.grad(fused_ffn_post_ln(*leaves, 1e-12), leaves,
                                cot)
    want_g = torch.autograd.grad(fused_ffn_post_ln.plain(*leaves, 1e-12),
                                 leaves, cot)
    for a, b in zip(got_g, want_g):
        _close(a, b, rel_l2=5e-2)


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
    (2, 4, 245, 245, 2, True), (150, 4, 27, 32, 3, True),
    (600, 1, 12, 16, 2, False)])
def test_core_backward_matches_plain(gen, hd, B, nW, N, Npad, nH, masked):
    """K8a + K8b (the tensor cores) through the autograd Function vs
    autograd of the plain core: o, dq, dk, dv and dbias separately (1 to
    600 sequences; Npad = N = 245 is the spatial route's unpadded window,
    whose bf16 rows have a 490-byte pitch), and a second call of the kernel
    path bitwise equal in each."""
    qkv, bias, mask, scale = _core_inputs(gen, B, nW, N, Npad, nH, hd,
                                          all_masked=masked)
    mask = mask if masked else None
    dout = _rnd(gen, B, nW, Npad, nH * hd)
    dout[:, :, N:] = 0.0  # the caller's pad rows carry no cotangent
    got, dgot = [], []
    # as in training: an f32 bias leaf, cast to bf16 by autocast
    for f in (swin_core_attn, swin_core_attn,
              swin_core_attn.plain_as_launched):
        q = qkv.clone().requires_grad_(True)
        b = bias.float().requires_grad_(True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            o = f(q, b, mask, nH, scale)
        dq, db = torch.autograd.grad(o, (q, b), dout)
        got.append(o)
        dgot.append((dq, db))
    C = nH * hd
    assert torch.equal(got[0], got[1])
    assert all(torch.equal(x, y) for x, y in zip(dgot[0], dgot[1]))
    _close(got[0][:, :, :N], got[2][:, :, :N], rel_l2=1e-2)
    (dq_k, db_k), _, (dq_p, db_p) = dgot
    for part in range(3):  # dq, dk, dv
        sl = slice(part * C, (part + 1) * C)
        _close(dq_k[:, :, :N, sl], dq_p[:, :, :N, sl], rel_l2=5e-2)
    _close(db_k[:, :N, :N], db_p[:, :N, :N], rel_l2=5e-2)


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("B,nW,N,Npad,nH,masked", [
    (1, 1, 5, 8, 1, False), (2, 4, 49, 56, 2, True), (2, 4, 245, 248, 4,
                                                         True),
    (2, 4, 245, 245, 2, True), (600, 1, 12, 16, 2, False)])
def test_core_forward_lse_matches_f64(gen, hd, B, nW, N, Npad, nH, masked):
    """The row log-sum-exp K8a writes for K8b against torch.logsumexp of the
    plain scores (q k^T * scale + bias + mask) in f64, within 1e-3, and a
    second call bitwise equal."""
    qkv, bias, mask, scale = _core_inputs(gen, B, nW, N, Npad, nH, hd,
                                          all_masked=masked)
    mask = mask if masked else None
    n_seq = B * nW
    q, k, _ = qkv.view(B, nW, Npad, 3, nH, hd).permute(3, 0, 1, 4, 2, 5)
    s = (q.double() @ k.double().transpose(-1, -2)) * scale + bias.double()
    if mask is not None:
        s = s + mask.double()[None, :, None]
    want = torch.logsumexp(s, dim=-1).reshape(n_seq, nH, Npad)
    got = [torch.empty(n_seq, nH, Npad, device="cuda") for _ in range(2)]
    for lse in got:
        _build.attention(qkv.view(-1, 3 * nH * hd), n_seq, Npad, nH, scale,
                         bias=bias, mask=mask, lse=lse)
    assert torch.equal(got[0], got[1])
    err = float((got[0].double() - want).abs().max())
    assert err <= 1e-3, err


@pytest.mark.parametrize("B,nW,N,Npad,nH,hd", [
    (16, 4, 49, 56, 2, 32), (8, 64, 245, 248, 4, 32)])
def test_core_dbias_sum_matches_f64(gen, B, nW, N, Npad, nH, hd):
    """dbias, summed by chunks over 64 sequences and over Swin-B stage 1's
    512 windows at B = 8 (shifted), against an f64 sum of the plain
    per-batch gradients."""
    qkv, bias, mask, scale = _core_inputs(gen, B, nW, N, Npad, nH, hd)
    dout = _rnd(gen, B, nW, Npad, nH * hd)
    lse = torch.empty(B * nW, nH, Npad, device="cuda")
    out = _build.attention(qkv.view(-1, 3 * nH * hd), B * nW, Npad, nH,
                           scale, bias=bias, mask=mask, lse=lse)
    before = swin_core_attn_bwd.launches
    _, dbias = swin_core_attn_bwd(qkv, lse, dout, bias, mask, nH, scale,
                                  out=out)
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
    ffn = (_rnd(gen, 256, 64), _rnd(gen, 256), _rnd(gen, 64, 256),
           _rnd(gen, 64))
    with pytest.raises(ValueError):  # a non-contiguous input
        _build.ffn_dropout_ln(_rnd(gen, 64, 16).t(), *ffn, *ln, 1e-12, seed,
                              0.1, 1)
    with pytest.raises(ValueError):  # a seed that is not int64 [1]
        _build.ffn_dropout_ln(x, *ffn, *ln, 1e-12, seed.int(), 0.1, 1)
    with pytest.raises(ValueError):  # a rate outside [0, 1)
        _build.ffn_dropout_ln(x, *ffn, *ln, 1e-12, seed, 1.0, 1)
    with pytest.raises(ValueError):  # K-slices that are not whole steps
        _build.ffn_dropout_ln(x, *ffn, *ln, 1e-12, seed, 0.1, 3)
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


@pytest.mark.parametrize("L", [275, 276])
@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_encoder_attention_seq2seq_masked_row(gen, L, layout):
    """K7 at the seq2seq lengths under the seq2seq mask at finfo(f32).min
    with one fully masked row (clamped at -1e4 by the wrapper: that row's
    softmax is over finite scores), 12 heads of 64, forward within the
    gate of its plain version and a second call bitwise equal."""
    B, nH, hd = 2, 12, 64

    def heads():
        if layout == "transposed":
            return _rnd(gen, B, L, nH, hd).transpose(1, 2)
        return _rnd(gen, B, nH, L, hd)

    q, k, v = heads(), heads(), heads()
    mask = _train_bwd_masks(B, L)["seq2seq"]
    got = [fused_encoder_attention(q, k, v, mask, hd ** -0.5)
           for _ in range(2)]
    assert torch.equal(*got)
    _close(got[0], fused_encoder_attention.plain(q, k, v, mask, hd ** -0.5),
           rel_l2=1e-2)


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
    """The tile GEMM's row scatter (K14's and K16's proj) and the scalar
    LN's row gather against their plain meaning."""
    M, K, N = 300, 64, 96
    perm = torch.randperm(M, generator=gen, device="cuda").to(torch.int32)
    a, w, b = _rnd(gen, M, K), _rnd(gen, N, K, std=K ** -0.5), _rnd(gen, N)
    r = _rnd(gen, M, N)
    out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
    _build.gemm_tc(a, w, b, residual=r, rows=perm, out=out)
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


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("N", [45, 98, 245])
@pytest.mark.parametrize("masked", ["bf16", "f32", "none", "padded rows"])
def test_window_attention_and_gradient_match_plain(gen, hd, N, masked):
    """K15 (the tensor-core forward without lse) on the strided q, k, v
    views of one qkv product (the module path's), 6 windows, the shift
    mask (0 / -100) over 3 read in bf16 or f32, or none, or both bias and
    mask in rows padded to 16 bytes; a second call bitwise equal;
    gradients through the recompute."""
    W, nH, nW = 6, 2, 3
    qkv = _rnd(gen, W, N, 3, nH, hd)
    bias = _rnd(gen, nH, N, N)
    mask = None
    if masked != "none":
        mask = (torch.rand(nW, N, N, generator=gen, device="cuda")
                < 0.3).float() * -100.0
        if masked == "bf16":
            mask = mask.to(torch.bfloat16)
    if masked == "padded rows":
        bias, mask = map(_build.with_padded_rows, (bias, mask))
    g = _rnd(gen, W, nH, N, hd)
    outs, grads = [], []
    for f in (fused_window_attention, fused_window_attention.plain):
        qkv_l = qkv.clone().requires_grad_(True)
        b = bias.detach().clone().requires_grad_(True)
        q, k, v = qkv_l.permute(2, 0, 3, 1, 4)
        y = f(q, k, v, b, mask, hd ** -0.5)
        outs.append(y)
        grads.append(torch.autograd.grad(y, (qkv_l, b), g))
    _close(outs[0], outs[1], rel_l2=1e-2)
    for gk, gp in zip(*grads):
        _close(gk, gp, rel_l2=5e-2)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    again = [fused_window_attention(q, k, v, bias, mask, hd ** -0.5)
             for _ in range(2)]
    assert torch.equal(*again)
    _close(again[0], outs[1], rel_l2=1e-2)


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
    a negative gather row gives a zero row; a half-given affine raises;
    the same for the 16-byte-chunk LN (K14's)."""
    x = _rnd(gen, 37, 96, std=2.0)
    rows = torch.tensor([3, -1, 0, -1, 36], dtype=torch.int32, device="cuda")
    lw, lb = 1 + _rnd(gen, 96, std=0.1), _rnd(gen, 96, std=0.1)
    for ln in (_build.layernorm, _build.layernorm_rows):
        _close(ln(x, None, None, 1e-5), layer_norm(x, None, None, 1e-5))
        for w, b in ((lw, lb), (None, None)):
            got = ln(x, w, b, 1e-5, rows=rows)
            _close(got[[0, 2, 4]], layer_norm(x[[3, 0, 36]], w, b, 1e-5))
            assert float(got[[1, 3]].abs().max()) == 0.0
        with pytest.raises(ValueError, match="both"):
            ln(x, lw, None, 1e-5)


@pytest.mark.parametrize("pad_zero", [False, True])
def test_gemm_scatter_drops_negative_rows(gen, pad_zero):
    """The tile GEMM's scatter epilogue with rows below 0: K14's instance
    leaves out[m] as it was, K16's zeroing instance (``pad_zero``) writes
    zeros there; the rows below 0 are the ones no index names, as K16's
    pad rows are."""
    M, K, N = 130, 64, 72
    a, w, b = _rnd(gen, M, K), _rnd(gen, N, K, std=K ** -0.5), _rnd(gen, N)
    r = _rnd(gen, M, N)
    pad = torch.zeros(M, dtype=torch.bool, device="cuda")
    pad[::3] = True
    live = (~pad).nonzero().flatten()
    rows = torch.full((M,), -1, dtype=torch.int32, device="cuda")
    rows[live] = live[torch.randperm(live.numel(), generator=gen,
                                     device="cuda")].to(torch.int32)
    out = torch.full((M, N), 7.0, dtype=torch.bfloat16, device="cuda")
    _build.gemm_tc(a, w, b, residual=r, rows=rows, out=out,
                   pad_zero=pad_zero)
    dst = rows[~pad].long()
    want = torch.full_like(out, 0.0 if pad_zero else 7.0)
    want[dst] = (F.linear(a[~pad].float(), w.float(), b.float())
                 + r[dst].float()).to(torch.bfloat16)
    assert bool((out[pad] == (0.0 if pad_zero else 7.0)).all())
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


def test_block_outside_autograd_takes_f32_inputs_under_autocast(gen):
    """K1 (whole block and attention half) launched outside autograd under
    bf16 autocast on f32 inputs, as a model in ``eval()`` mode over f32
    weights calls it: cast as its autograd Function casts, equal to the
    plain version on the cast inputs."""
    B, nW, N, Npad, C, nH = 2, 4, 49, 56, 64, 2
    f = lambda *shape, std=1.0: torch.randn(
        *shape, generator=gen, device="cuda") * std
    x = f(B, nW, Npad, C)
    ln = [1 + f(C, std=0.1), f(C, std=0.1)]
    lin = [f(3 * C, C, std=C ** -0.5), f(3 * C), f(C, C, std=C ** -0.5),
           f(C)]
    mlp = (1 + f(C, std=0.1), f(C, std=0.1), f(4 * C, C, std=C ** -0.5),
           f(4 * C), f(C, 4 * C, std=(4 * C) ** -0.5), f(C))
    bias = f(nH, Npad, Npad)
    args = (x, *ln, *lin, bias, None, nH, (C // nH) ** -0.5, 1e-5)
    for kw in ({"mlp": mlp}, {}):
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            got = fused_swin_block_wm(*args, **kw)
            want = fused_swin_block_wm.plain_as_launched(*args, **kw)
        assert got.dtype == torch.bfloat16
        _close(got[:, :, :N], want[:, :, :N], rel_l2=1e-2)


@pytest.mark.parametrize("B,D,H,W,E,offset", [
    (1, 2, 32, 32, 16, 0), (2, 5, 64, 96, 96, 0), (1, 3, 16, 288, 128, 0),
    (2, 2, 32, 64, 192, 0), (1, 1, 32, 32, 128, 0), (2, 5, 224, 224, 128, 0),
    (1, 2, 16, 40, 64, 0), (1, 3, 32, 64, 256, 4)])
def test_patch_embed_matches_plain_and_gradient(gen, B, D, H, W, E, offset):
    """K17 at w2 = 8, 24, 72 (two 64-patch units a row), E = 16 to 256 (E
    = 192 and 256: one block an SM, dynamic shared memory above 48 KB), D
    = 1 (the kd = 1 tap all pad), 560 units at 224 x 224 (more than one
    wave of the persistent grid), W = 40 (4-byte copies) and a clip 4
    bytes off a 16-byte boundary (4-byte copies); a second call bitwise
    equal; in eval() under autograd the plain gradient."""
    n = B * D * H * W * 3
    x = torch.randint(0, 256, (n + offset,), generator=gen, device="cuda",
                      dtype=torch.uint8)[offset:].view(B, D, H, W, 3)
    weight, bias = _rnd(gen, E, 3, 2, 4, 4, std=0.05), _rnd(gen, E, std=0.05)
    before = fused_patch_embed_u8.launches
    got = fused_patch_embed_u8(x, weight, bias)
    assert fused_patch_embed_u8.launches == before + 1
    assert got.shape == (B, D, H // 4, W // 4, E)
    _close(got, fused_patch_embed_u8.plain(x, weight, bias), rel_l2=1e-2)
    assert torch.equal(got, fused_patch_embed_u8(x, weight, bias))
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
    """K16: forward vs plain (also minus the residual), the input's pad
    rows random (the kernel reads none of them), the output's exactly
    zero, a second call bitwise equal, and under autograd every gradient,
    the backward through K2 (two shifts and their two transposes) and
    K8."""
    from lavender_tpu_torch.ops.wm_permute import wm_shift_rows
    D, H, W = spatial
    N = window[0] * window[1] * window[2]
    Npad, nW, B = round8(N), (H // window[1]) * (W // window[2]), 2
    x = _rnd(gen, B, nW, Npad, C)
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
    assert torch.equal(outs[0].detach(),
                       fused_swin_block_wm_shifted(x, *params, mask, *statics))
    v = (slice(None), slice(None), slice(0, N))
    _close(outs[0][v], outs[1][v], rel_l2=1e-2)
    _close((outs[0] - x)[v].float(), (outs[1] - x)[v].float(), rel_l2=5e-2)
    for gk, gp in zip(*grads):
        _close(gk, gp, rel_l2=5e-2)


@pytest.mark.parametrize("B", [4, 8])
def test_k16_at_swin_b_stage_3_matches_plain_bitwise(gen, B):
    """K16 at Swin-B's stage 3 (window (5, 7, 7) on 5 x 14 x 14: 4 windows
    of N = 245 in Npad = 248 rows, C = 512, 16 heads), B = 4 and 8, the
    input's pad rows random: the valid rows within the gate (and minus the
    residual within rel_l2 5e-2), the pad rows exactly 0, a second call
    bitwise equal."""
    window, spatial, shift, C, nH = (5, 7, 7), (5, 14, 14), (0, 3, 3), 512, 16
    N, Npad, nW = 245, 248, 4
    x = _rnd(gen, B, nW, Npad, C)
    bias = _rnd(gen, nH, Npad, Npad)
    bias[:, :, N:] = -100.0
    mask = pad_window_mask(torch.as_tensor(compute_shift_mask(
        *spatial, window, shift), device="cuda"), Npad).to(torch.bfloat16)
    args = (x, 1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1),
            _rnd(gen, 3 * C, C, std=C ** -0.5), _rnd(gen, 3 * C, std=0.02),
            _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C, std=0.02), bias,
            mask, spatial, window, shift, nH, (C // nH) ** -0.5, 1e-5)
    got = fused_swin_block_wm_shifted(*args)
    want = fused_swin_block_wm_shifted.plain(*args)
    v = (slice(None), slice(None), slice(0, N))
    _close(got[v], want[v], rel_l2=1e-2)
    _close((got - x)[v].float(), (want - x)[v].float(), rel_l2=5e-2)
    assert float(got[:, :, N:].float().abs().max()) == 0.0
    assert torch.equal(got, fused_swin_block_wm_shifted(*args))


def _heads_train_inputs(gen, B, L, nH, hd, layout):
    """q, k, v [B, nH, L, hd] in f32: heads views of one [B, L, 3C] slab
    (the model's) or three contiguous tensors."""
    if layout == "slab":
        slab = torch.randn(B, L, 3 * nH * hd, generator=gen, device="cuda")
        return list(slab.view(B, L, 3, nH, hd).permute(2, 0, 3, 1, 4))
    return [torch.randn(B, nH, L, hd, generator=gen, device="cuda")
            for _ in range(3)]


@pytest.mark.parametrize("L", [29, 276])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["slab", "contiguous"])
def test_heads_train_attention_matches_plain(gen, L, rate, layout):
    """K13a + K13b through the autograd Function under bf16 autocast (f32
    leaves, as in training) vs autograd of the plain version with the same
    seed: a padded key tail at finfo(f32).min, one fully masked row, and a
    mask that requires grad (dmask: the sum over heads, zero where the mask
    is <= -1e4)."""
    B, nH, hd = 3, 4, 64
    q, k, v = _heads_train_inputs(gen, B, L, nH, hd, layout)
    mask = torch.randn(B, L, L, generator=gen, device="cuda")
    mask[1, :, L - 7:] = torch.finfo(torch.float32).min
    mask[2, 5, :] = torch.finfo(torch.float32).min  # every key masked
    seed = torch.tensor([4321], device="cuda")
    w = torch.randn(B, nH, L, hd, generator=gen, device="cuda")
    outs, grads = [], []
    before = (fused_encoder_attention_train.launches,
              encoder_attention_train_bwd.launches)
    for f in (fused_encoder_attention_train,
              fused_encoder_attention_train.plain_as_launched):
        ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v,
                                                                mask)]
        with torch.autocast("cuda", dtype=torch.bfloat16):
            o = f(*ins, seed, hd ** -0.5, rate)
        outs.append(o)
        grads.append(torch.autograd.grad(o, ins, w))
    assert (fused_encoder_attention_train.launches,
            encoder_attention_train_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert outs[0].dtype == torch.bfloat16
    _close(outs[0], outs[1], rel_l2=1e-2)
    for gk, gp in zip(*grads):
        _close(gk, gp, rel_l2=5e-2)
    dmask = grads[0][3]
    assert not dmask[mask <= -1e4].any()


def _probe_keep(run, B, nH, L, hd):
    """The keep mask [B, nH, L, L] a train attention kernel drew, read back
    exactly: with q = k = 0 every probability is 1 / L, and v one-hot in
    key j = offset + d puts probability (i, j), 0 where dropped, at output
    column d.  ``run(q, k, v)`` takes [B, nH, L, hd] bf16 heads views and
    returns [B, nH, L, hd]."""
    keep = torch.zeros(B, nH, L, L, dtype=torch.bool, device="cuda")
    slab = torch.zeros(B, L, 3, nH, hd, dtype=torch.bfloat16, device="cuda")
    q, k, v = slab.permute(2, 0, 3, 1, 4)
    for off in range(0, L, hd):
        n = min(hd, L - off)
        v.zero_()
        v[:, :, off:off + n].copy_(torch.eye(n, hd, device="cuda"))
        keep[..., off:off + n] = run(q, k, v)[..., :n] > 0
    return keep


def test_heads_and_lanes_kernels_draw_the_same_mask(gen):
    """At the logical (sequence, head, row, key): the keep masks of K13a on
    heads views and of K10a on the [B, L, C] slab they view, read back from
    the kernels, equal ``dropout.attention_keep`` bit for bit; on random
    inputs the two kernels agree to bf16 rounding."""
    B, nH, L, hd, rate = 3, 4, 276, 64, 0.1
    seed = torch.tensor([77], device="cuda")
    mask = torch.zeros(B, L, L, device="cuda")

    def heads(q, k, v):
        return fused_encoder_attention_train(q, k, v, mask, seed, 1.0, rate)

    def lanes(q, k, v):
        t = [x.transpose(1, 2).reshape(B, L, nH * hd) for x in (q, k, v)]
        o = fused_encoder_attention_train_lanes(*t, mask.bfloat16(), seed,
                                                1.0, rate, nH)
        return o.view(B, L, nH, hd).transpose(1, 2)

    want = dropout.attention_keep(seed, B, nH, L, rate)
    for run in (heads, lanes):
        assert torch.equal(_probe_keep(run, B, nH, L, hd), want)
    slab = _rnd(gen, B, L, 3 * nH * hd)
    q, k, v = slab.view(B, L, 3, nH, hd).permute(2, 0, 3, 1, 4)
    _close(heads(q, k, v), lanes(q, k, v), rel_l2=1e-2)


def test_heads_train_wrappers_raise(gen):
    """What the K13 kernels do not take raises before a launch, nothing
    falls back; K7 at L = 1000, which its former f32-pipe core refused (K
    and V of a (sequence, head) did not fit in shared memory), runs on the
    tensor-core forward, which streams them, and matches its plain
    version."""
    B, nH, L, hd = 2, 2, 16, 64
    q, seed = _rnd(gen, B, nH, L, hd), torch.tensor([1], device="cuda")
    mask = torch.zeros(B, L, L, device="cuda")
    with pytest.raises(ValueError):  # a mask of the wrong shape
        fused_encoder_attention_train(q, q, q, mask[:, :, :5], seed, 0.25,
                                      0.1)
    with pytest.raises(ValueError):  # head dim 48
        q48 = _rnd(gen, B, nH, L, 48)
        fused_encoder_attention_train(q48, q48, q48, mask, seed, 0.25, 0.1)
    with pytest.raises(ValueError):  # a seed that is not int64 [1]
        fused_encoder_attention_train(q, q, q, mask, seed.int(), 0.25, 0.1)
    with pytest.raises(ValueError):  # the backward needs the forward's lse
        encoder_attention_train_bwd(q, q, q, mask, seed, q, 0.25, 0.1)
    long_q = _rnd(gen, 1, 1, 1000, hd)
    long_mask = _train_bwd_masks(1, 1000)["seq2seq"]
    _close(fused_encoder_attention(long_q, long_q, long_q, long_mask, 0.25),
           fused_encoder_attention.plain(long_q, long_q, long_q, long_mask,
                                         0.25), rel_l2=1e-2)


def _train_bwd_masks(B, L):
    """{kind: f32 [B, L, L] additive mask at finfo(f32).min}: padded keys
    (sequence 1 loses its last third of keys) and the seq2seq mask (every
    row sees the first ~2/3 "video" keys, the rest causally) with one
    fully masked row."""
    big_neg = torch.finfo(torch.float32).min
    pad = torch.zeros(B, L, L, device="cuda")
    pad[1 % B, :, L - L // 3:] = big_neg
    n_vid = L - L // 3
    keep = torch.zeros(L, L, dtype=torch.bool, device="cuda")
    keep[:, :n_vid] = True
    keep[n_vid:, n_vid:] = torch.ones(L - n_vid, L - n_vid, dtype=torch.bool,
                                      device="cuda").tril()
    s2s = torch.where(keep, 0.0, big_neg).expand(B, L, L).contiguous()
    s2s[0, L // 2] = big_neg  # every key masked
    return {"padded keys": pad, "seq2seq": s2s}


@pytest.mark.parametrize("L", [1, 17, 63, 64, 65, 275, 276])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("layout", ["packed", "heads views", "heads"])
def test_train_attention_bwd_tensor_cores_match_plain(gen, L, hd, layout):
    """K10b (the packed slab, bf16 mask) and K13b without dmask (heads
    views of a slab or contiguous heads, f32 mask) on the tensor-core
    kernels: at lengths that cross the 64-row tiles' edges, each head dim,
    rates 0, 0.1 and 0.5, a padded-key and a seq2seq mask with a fully
    masked row: dq, dk and dv each against the plain version, and a second
    call bitwise equal (no atomics).  At L = 1 dq and dk are exactly 0 (a
    softmax over one key has no gradient), both sides round to ~1e-8, and
    only their largest error is held to the bound."""
    B, nH = 3, 2
    C = nH * hd
    scale = hd ** -0.5
    slab = _rnd(gen, B, L, 3 * C)
    g = _rnd(gen, B, L, C)
    seed = torch.tensor([8642], device="cuda")
    if layout == "packed":
        q, k, v = slab.split(C, dim=-1)
    elif layout == "heads views":
        q, k, v = slab.view(B, L, 3, nH, hd).permute(2, 0, 3, 1, 4)
        g = g.view(B, L, nH, hd).transpose(1, 2).contiguous()
    else:
        q, k, v = (t.view(B, L, nH, hd).transpose(1, 2).contiguous()
                   for t in slab.split(C, dim=-1))
        g = g.view(B, L, nH, hd).transpose(1, 2).contiguous()
    for kind, mask in _train_bwd_masks(B, L).items():
        for rate in (0.0, 0.1, 0.5):
            lse = torch.empty(B, nH, L, device="cuda")
            if layout == "packed":
                m = mask.clamp_min(-1e4).to(torch.bfloat16)
                o = _build.attention(slab.view(B * L, 3 * C), B, L, nH, scale,
                                     mask=m, lse=lse, seed=seed, rate=rate)
                op, args = encoder_attention_train_lanes_bwd, (
                    q, k, v, m, seed, g, scale, rate, nH)
                o = o.view(B, L, C)
            else:
                o = _build.attention_heads(q, k, v, mask.clamp_min(-1e4),
                                           scale, lse=lse, seed=seed,
                                           rate=rate)
                op, args = encoder_attention_train_bwd, (
                    q, k, v, mask, seed, g, scale, rate)
            before = op.launches
            got = op(*args, lse=lse, o=o)[:3]
            again = op(*args, lse=lse, o=o)[:3]
            assert op.launches == before + 2
            want = op.plain(*args, lse=lse, o=o)[:3]
            for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
                assert torch.equal(a, b), (kind, rate, name)
                _close(a, c, rel_l2=5e-2 if L > 1 or name == "dv" else None)


def _train_fwd_operands(gen, B, L, nH, hd, layout):
    """A bf16 [B, L, 3C] qkv slab and q, k, v as the K10a / K13a Functions
    take them: column slices of the slab ("packed"), its [B, nH, L, hd]
    views ("heads views") or contiguous heads copies ("heads")."""
    C = nH * hd
    slab = _rnd(gen, B, L, 3 * C)
    if layout == "packed":
        return slab, slab.split(C, dim=-1)
    if layout == "heads views":
        return slab, slab.view(B, L, 3, nH, hd).permute(2, 0, 3, 1, 4)
    return slab, [t.view(B, L, nH, hd).transpose(1, 2).contiguous()
                  for t in slab.split(C, dim=-1)]


@pytest.mark.parametrize("L", [1, 17, 63, 64, 65, 275, 276, 1000])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("layout", ["packed", "heads views", "heads"])
def test_train_attention_fwd_tensor_cores_match_plain(gen, L, hd, layout):
    """K10a (the packed slab, bf16 mask) and K13a (heads views of a slab or
    contiguous heads, f32 mask) on the tensor-core forward: at lengths that
    cross the 64-row tiles' edges and L = 1000 (more than the f32-pipe core
    held in shared memory), each head dim, rates 0, 0.1 and 0.5, a
    padded-key and a seq2seq mask with a fully masked row: o against the
    plain version (same seed, so a misplaced dropout bit is an O(1)
    error); lse against the logsumexp of the plain scores in f64, within
    1e-3 + 1e-6 |lse| (the fully masked row's lse lies near -1e4, where
    f32 resolves 2^-10); a second call bitwise equal (no atomics)."""
    B, nH = 3, 2
    scale = hd ** -0.5
    slab, (q, k, v) = _train_fwd_operands(gen, B, L, nH, hd, layout)
    qh, kh = (slab.double().view(B, L, 3, nH, hd)[:, :, i].transpose(1, 2)
              for i in range(2))
    seed = torch.tensor([2468], device="cuda")
    for kind, mask in _train_bwd_masks(B, L).items():
        m = mask.clamp_min(-1e4)
        if layout == "packed":
            m = m.to(torch.bfloat16)
        s = (qh @ kh.transpose(-1, -2)) * scale + m.double()[:, None]
        want_lse = torch.logsumexp(s, dim=-1)
        for rate in (0.0, 0.1, 0.5):
            got = []
            for _ in range(2):
                lse = torch.empty(B, nH, L, device="cuda")
                if layout == "packed":
                    o = _build.attention(slab.view(B * L, -1), B, L, nH,
                                         scale, mask=m, lse=lse, seed=seed,
                                         rate=rate).view(B, L, -1)
                else:
                    o = _build.attention_heads(q, k, v, m, scale, lse=lse,
                                               seed=seed, rate=rate)
                got.append((o, lse))
            (o, lse), (o2, lse2) = got
            assert torch.equal(o, o2) and torch.equal(lse, lse2), (kind, rate)
            if layout == "packed":
                want = fused_encoder_attention_train_lanes.plain(
                    q, k, v, m, seed, scale, rate, nH)
            else:
                want = fused_encoder_attention_train.plain(
                    q, k, v, mask, seed, scale, rate)
            _close(o, want, rel_l2=1e-2)
            err = (lse.double() - want_lse).abs()
            assert (err <= 1e-3 + 1e-6 * want_lse.abs()).all(), (
                kind, rate, float(err.max()))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_train_attention_fwd_keep_masks_read_back(gen, rate):
    """The keep masks the tensor-core forward draws for K13a (heads views)
    and K10a (the slab they view), read back from the kernels across two
    key tiles and a ragged edge, equal ``dropout.attention_keep`` bit for
    bit at rates 0.1 and 0.5 (a wrong fragment-to-(row, key) mapping
    passes at rate 0 only)."""
    B, nH, L, hd = 2, 3, 77, 32
    seed = torch.tensor([13579], device="cuda")
    mask = torch.zeros(B, L, L, device="cuda")

    def heads(q, k, v):
        return fused_encoder_attention_train(q, k, v, mask, seed, 1.0, rate)

    def lanes(q, k, v):
        t = [x.transpose(1, 2).reshape(B, L, nH * hd) for x in (q, k, v)]
        o = fused_encoder_attention_train_lanes(*t, mask.bfloat16(), seed,
                                                1.0, rate, nH)
        return o.view(B, L, nH, hd).transpose(1, 2)

    want = dropout.attention_keep(seed, B, nH, L, rate)
    for run in (heads, lanes):
        assert torch.equal(_probe_keep(run, B, nH, L, hd), want)


# --------------------------------------------------------------------------
# The wgmma + TMA tile GEMM (csrc/gemm_tc.cu) and the tensor-core core of
# K1 and K4.
# --------------------------------------------------------------------------


def _linear_f32(a, w, b, epi, r=None):
    want = F.linear(a.float(), w.float(), None if b is None else b.float())
    if epi == "gelu":
        want = F.gelu(want)
    return want if r is None else want + r.float()


@pytest.mark.parametrize("M,N,K", [
    (1, 8, 8), (130, 136, 72), (257, 392, 96), (1104, 768, 768),
    (4096, 1024, 128), (3968, 1536, 512)])
@pytest.mark.parametrize("epi", ["bias", "gelu", "residual", "nobias"])
def test_gemm_tc_matches_plain(gen, M, N, K, epi):
    """The tile GEMM on both tiles of its plan (64 rows below 132 tiles,
    128 above), M, N and K off the tile (zero-filled by the copies), each
    epilogue; a second call bitwise equal."""
    a, w = _rnd(gen, M, K), _rnd(gen, N, K, std=K ** -0.5)
    b = None if epi == "nobias" else _rnd(gen, N)
    r = _rnd(gen, M, N) if epi == "residual" else None
    got = _build.gemm_tc(a, w, b, gelu=epi == "gelu", residual=r)
    _close(got, _linear_f32(a, w, b, epi, r), rel_l2=1e-2)
    assert torch.equal(got, _build.gemm_tc(a, w, b, gelu=epi == "gelu",
                                           residual=r))


@pytest.mark.parametrize("M,C", [(45, 64), (1104, 768)])
def test_gemm_tc_three_weights_into_a_slab(gen, M, C):
    """K4's q | k | v: three weights in one launch into column blocks of a
    slice of a wider slab (its row pitch passed through), a bias missing
    on one; the columns around the slice untouched."""
    a = _rnd(gen, M, C)
    ws = [_rnd(gen, C, C, std=C ** -0.5) for _ in range(3)]
    bs = [_rnd(gen, C), None, _rnd(gen, C)]
    slab = torch.zeros(M, 3 * C + 16, dtype=torch.bfloat16, device="cuda")
    out = slab[:, 8:8 + 3 * C]
    _build.gemm_tc(a, ws, bs, out=out)
    for i, (w, b) in enumerate(zip(ws, bs)):
        _close(out[:, i * C:(i + 1) * C], _linear_f32(a, w, b, "bias"),
               rel_l2=1e-2)
    assert not slab[:, :8].any() and not slab[:, 8 + 3 * C:].any()


@pytest.mark.parametrize("M,C,K", [(37, 64, 192), (1000, 768, 768),
                                   (1104, 768, 768), (300, 1024, 4096)])
def test_gemm_tc_ln_matches_plain(gen, M, C, K):
    """K4's proj: the product as f32 K-slices of the plan, summed in order
    by the row kernel with bias and residual, then the LN; a second call
    bitwise equal."""
    a, w, b = _rnd(gen, M, K), _rnd(gen, C, K, std=K ** -0.5), _rnd(gen, C)
    x = _rnd(gen, M, C)
    lw, lb = 1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1)
    got = _build.gemm_tc_ln(a, w, b, x, lw, lb, 1e-12)
    want = layer_norm(x.float() + _linear_f32(a, w, b, "bias"), lw.float(),
                      lb.float(), 1e-12)
    _close(got, want, rel_l2=1e-2)
    assert torch.equal(got, _build.gemm_tc_ln(a, w, b, x, lw, lb, 1e-12))


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("n_seq,N,nH,extras", [
    (1, 5, 1, ()), (2, 49, 2, ("bias",)), (4, 248, 2, ("bias", "mask")),
    (3, 276, 4, ("keep",)), (5, 250, 3, ("keep",)),
    (8, 33, 3, ("keep", "mask")), (2, 130, 2, ("keep",))])
def test_attention_tensor_cores_match_plain(gen, hd, n_seq, N, nH, extras):
    """The packed-slab core on the tensor cores where the caller selects
    them (K1: bias and shift mask; K4: the key-keep vector, whose rows at
    N = 250 and 33 start off 4-byte boundaries), a sequence with every key
    dropped giving 0, a key tile with no key kept; a second call bitwise
    equal."""
    qkv = _rnd(gen, n_seq * N, 3 * nH * hd)
    bias = _rnd(gen, nH, N, N) if "bias" in extras else None
    mask = None
    if "mask" in extras:
        mask = (torch.rand(2, N, N, generator=gen, device="cuda") < 0.3)
        mask = (mask.float() * -100.0).to(torch.bfloat16)
    keep = None
    if "keep" in extras:
        keep = torch.rand(n_seq, N, generator=gen, device="cuda") < 0.7
        keep[0] = False
        if N > 128:
            keep[-1, 64:128] = False  # the second key tile: nothing kept
    scale = hd ** -0.5
    got = _build.attention(qkv, n_seq, N, nH, scale, bias, mask, keep,
                           tensor_cores=True)
    _close(got, _attention_plain(qkv, n_seq, N, nH, scale, bias, mask, keep))
    if keep is not None:
        assert not got[:N].any()  # every key of sequence 0 dropped
    assert torch.equal(got, _build.attention(qkv, n_seq, N, nH, scale, bias,
                                             mask, keep, tensor_cores=True))


def _k1_case(gen, B, stage, shifted, mlp):
    """K1's inputs at a Swin-B stage (window 5 x 7 x 7, Npad 248)."""
    from lavender_tpu_torch.models.swin3d import relative_position_index
    from lavender_tpu_torch.ops.swin_block_attn import rel_pos_bias_wm

    nW, C, nH, side = {1: (64, 128, 4, 56), 2: (16, 256, 8, 28),
                       3: (4, 512, 16, 14), 4: (1, 1024, 32, 7)}[stage]
    N, Npad = 245, 248
    lin = lambda o, i: (_rnd(gen, o, i, std=i ** -0.5), _rnd(gen, o, std=0.02))
    ln = lambda c: (1 + _rnd(gen, c, std=0.1), _rnd(gen, c, std=0.1))
    bias = rel_pos_bias_wm(_rnd(gen, 15 * 13 * 13, nH),
                           relative_position_index((8, 7, 7)), N, Npad,
                           torch.bfloat16)
    mask = None
    if shifted:
        m = compute_shift_mask(5, side, side, (5, 7, 7), (0, 3, 3))
        mask = pad_window_mask(torch.as_tensor(m, device="cuda"),
                               Npad).to(torch.bfloat16)
    args = (_rnd(gen, B, nW, Npad, C), *ln(C), *lin(3 * C, C), *lin(C, C),
            bias, mask, nH, (C // nH) ** -0.5, 1e-5)
    kw = {"mlp": (*ln(C), *lin(4 * C, C), *lin(C, 4 * C))} if mlp else {}
    return args, kw


@pytest.mark.parametrize("B,stage,shifted,mlp", [
    (4, 1, True, True), (4, 1, False, True), (4, 2, True, True),
    (4, 3, True, True), (4, 3, False, True), (4, 4, False, False),
    (8, 1, True, False), (8, 3, False, False)])
def test_k1_at_swin_b_shapes_matches_plain_bitwise(gen, B, stage, shifted,
                                                   mlp):
    """K1 at the serving (B = 4, + MLP at stages 1-3) and train (B = 8,
    attention half) shapes: the valid rows within the gate, their
    residual-free part within 5e-2, a second call bitwise equal."""
    args, kw = _k1_case(gen, B, stage, shifted, mlp)
    got = fused_swin_block_wm(*args, **kw)
    want = fused_swin_block_wm.plain(*args, **kw)
    v = (slice(None), slice(None), slice(0, 245))
    _close(got[v], want[v], rel_l2=1e-2)
    x = args[0][v].float()
    d = (got[v].float() - x) - (want[v].float() - x)
    assert float(d.norm() / (want[v].float() - x).norm()) <= 5e-2
    assert torch.equal(got, fused_swin_block_wm(*args, **kw))


@pytest.mark.parametrize("L,padded", [(276, True), (250, True),
                                      (250, False)])
def test_k4_at_serving_and_prefill_shapes_matches_plain_bitwise(gen, L,
                                                                padded):
    """K4 at B = 4, L = 276 (serving) and the KV prefill's 250, keys
    padded at the captions' tails (a sequence with one key left) or all
    open; a second call bitwise equal."""
    B, C, nH = 4, 768, 12
    lin = lambda: (_rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C, std=0.02))
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (lin() for _ in range(4))
    keep = torch.ones(B, L, dtype=torch.bool, device="cuda")
    if padded:
        for i, n in enumerate((0, 6, 14, L - 1)):
            keep[i, L - n:] = False
    args = (_rnd(gen, B, L, C), wq, wk, wv, bq, bk, bv, wo, bo,
            1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1), keep, nH,
            (C // nH) ** -0.5, 1e-12)
    got = fused_bert_attn_block_kmask(*args)
    _close(got, fused_bert_attn_block_kmask.plain(*args), rel_l2=1e-2)
    assert torch.equal(got, fused_bert_attn_block_kmask(*args))


def _device_kernels(fn):
    """Names of the device kernels one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def test_cores_and_gemms_each_kernel_runs(gen):
    """K1, K4, K6, K14 and K16 launch the tile GEMM and the tensor-core
    forward (K14 and K16 also the chunk LN, and no scalar LN); the wmma
    GEMM and the f32-pipe core are gone."""
    def has(names, part):
        return any(part in n for n in names)

    args, kw = _k1_case(gen, 1, 2, True, True)
    k1 = _device_kernels(lambda: fused_swin_block_wm(*args, **kw))
    C, L, nH = 64, 45, 4
    lin = lambda: (_rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C))
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (lin() for _ in range(4))
    x = _rnd(gen, 2, L, C)
    lw, lb = 1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1)
    keep = torch.ones(2, L, dtype=torch.bool, device="cuda")
    keep[1, 30:] = False
    k4 = _device_kernels(lambda: fused_bert_attn_block_kmask(
        x, wq, wk, wv, bq, bk, bv, wo, bo, lw, lb, keep, nH, 0.25, 1e-12))
    mask = torch.zeros(2, L, L, device="cuda")
    mask[1, :, 30:] = torch.finfo(torch.float32).min
    k6 = _device_kernels(lambda: fused_bert_attn_block(
        x, wq, wk, wv, bq, bk, bv, wo, bo, lw, lb, mask, nH, 0.25, 1e-12))
    (xs, n1w, n1b, wqkv, bqkv, wp, bp, bias, m, nHs, scale, eps) = args
    xs = xs[:, :4, :245].reshape(1, 5, 14, 14, 256)  # one shifted clip
    k14 = _device_kernels(lambda: fused_swin_block_attn(
        xs, n1w, n1b, wqkv, bqkv, wp, bp, bias[:, :245, :245].contiguous(),
        m[:4, :245, :245].contiguous(), (5, 7, 7), (0, 3, 3), nHs, scale,
        eps))
    k16 = _device_kernels(lambda: fused_swin_block_wm_shifted(
        args[0][:, :4].contiguous(), n1w, n1b, wqkv, bqkv, wp, bp, bias,
        m[:4].contiguous(), (5, 14, 14), (5, 7, 7), (0, 3, 3), nHs, scale,
        eps))
    for names in (k1, k4, k6, k14, k16):
        assert has(names, "tile_kernel") and has(names, "fwd_kernel"), names
        assert not has(names, "gemm_bf16_kernel"), names
        assert not has(names, "attention_kernel"), names
    for names in (k14, k16):
        assert has(names, "layernorm_rows_kernel"), names
        assert not has(names, "layernorm_bf16_kernel"), names


_SWIN_B = {1: (64, 128), 2: (16, 256), 3: (4, 512), 4: (1, 1024)}


def _mlp_case(gen, M, C):
    """x [M, C] and the MLP's (ln_w, ln_b, w1, b1, w2, b2) at width C."""
    return _rnd(gen, M, C), (
        1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1),
        _rnd(gen, 4 * C, C, std=C ** -0.5), _rnd(gen, 4 * C, std=0.02),
        _rnd(gen, C, 4 * C, std=(4 * C) ** -0.5), _rnd(gen, C, std=0.02))


def _residual_free(got, want, x):
    """The MLP's own part (output - x) of kernel and plain version within
    rel_l2 5e-2."""
    d_got, d_want = got.float() - x.float(), want.float() - x.float()
    assert float((d_got - d_want).norm() / d_want.norm()) <= 5e-2


@pytest.mark.parametrize("B,stage", [(2, 1), (2, 2), (2, 3), (2, 4),
                                     (8, 3)])
@pytest.mark.parametrize("residual", [False, True])
def test_k9_at_swin_b_stages_matches_plain_bitwise(gen, B, stage, residual):
    """K9 at Swin-B's stages (M = B * nW * 248 rows; without the residual
    on the train step, with it on the "pallas" forward): within the gate
    and rel_l2 1e-2, the residual-free part within 5e-2, a second call
    bitwise equal."""
    nW, C = _SWIN_B[stage]
    x, mlp = _mlp_case(gen, B * nW * 248, C)
    got = fused_ln_mlp(x, *mlp, 1e-5, residual)
    want = fused_ln_mlp.plain(x, *mlp, 1e-5, residual)
    _close(got, want, rel_l2=1e-2)
    if residual:
        _residual_free(got, want, x)
    assert torch.equal(got, fused_ln_mlp(x, *mlp, 1e-5, residual))


def test_k3_at_serving_stage_4_matches_plain_bitwise(gen):
    """K3 at B = 4 serving's stage 4 (M = 992, C = 1024: fc2 on the
    plan's K-slices): within the gate and rel_l2 1e-2, its residual-free
    part within 5e-2, a second call bitwise equal."""
    x, mlp = _mlp_case(gen, 4 * 248, 1024)
    got = fused_ln_mlp_chunked(x, *mlp, 1e-5)
    want = fused_ln_mlp_chunked.plain(x, *mlp, 1e-5)
    _close(got, want, rel_l2=1e-2)
    _residual_free(got, want, x)
    assert torch.equal(got, fused_ln_mlp_chunked(x, *mlp, 1e-5))


@pytest.mark.parametrize("stage", [3, 4])
def test_k9_gradients_at_swin_b_stages_match_plain(gen, stage):
    """K9 under autograd (``RecomputeVjp``: the C call forward, autograd
    of the plain version backward) against autograd of the plain
    version, at B = 2: the output within the gate, every gradient within
    rel_l2 5e-2."""
    nW, C = _SWIN_B[stage]
    x, mlp = _mlp_case(gen, 2 * nW * 248, C)
    w = _rnd(gen, *x.shape)
    outs, grads = [], []
    for f in (fused_ln_mlp, fused_ln_mlp.plain):
        ins = [t.clone().requires_grad_(True) for t in (x, *mlp)]
        y = f(*ins, 1e-5)
        outs.append(y)
        grads.append(torch.autograd.grad(y, ins, w))
    _close(outs[0], outs[1], rel_l2=1e-2)
    for gk, gp in zip(*grads):
        _close(gk, gp, rel_l2=5e-2)


@pytest.mark.parametrize("M,C", [(992, 1024), (300, 64)])
@pytest.mark.parametrize("bm2,S", [(64, 1), (128, 1), (256, 1), (128, 2),
                                   (128, 4), (64, 4)])
@pytest.mark.parametrize("residual", [False, True])
def test_ln_mlp_at_each_tile_and_slice_option(gen, M, C, bm2, S, residual):
    """The one C call at every fc2 (tile rows, K-slices) its plan may pick,
    the slices summed by the row kernel without LN (with and without the
    residual), affine and pure-normalize LN: within the gate of the plain
    version, a second call bitwise equal; the C entry's scratch size is
    the plan's."""
    x, mlp = _mlp_case(gen, M, C)
    HD = 4 * C
    nbytes = _build.library().lvt_ln_mlp_scratch(M, C, HD, S)
    plan = _build.LnMlpPlan(256, bm2, S, nbytes)
    for ln in (mlp[:2], (None, None)):
        args = (x, *ln, *mlp[2:], 1e-5, residual)
        got = _build.ln_mlp(*args, plan=plan)
        _close(got, fused_ln_mlp.plain(*args), rel_l2=1e-2)
        assert torch.equal(got, _build.ln_mlp(*args, plan=plan))
    auto = _build.ln_mlp_plan(M, C, HD, residual)
    assert auto.scratch == _build.library().lvt_ln_mlp_scratch(
        M, C, HD, auto.splits)


def test_ln_mlp_rejects_what_it_does_not_take(gen):
    x, mlp = _mlp_case(gen, 64, 64)
    for bad in (
            lambda: _build.ln_mlp(x.float(), *mlp, 1e-5, True),
            lambda: _build.ln_mlp(x.t(), *mlp, 1e-5, True),
            lambda: _build.ln_mlp(x, None, *mlp[1:], 1e-5, True),
            lambda: _build.ln_mlp(x, *mlp[:2], mlp[2][:, :32], *mlp[3:],
                                  1e-5, True),
            lambda: _build.ln_mlp(_rnd(gen, 8, 1032), *mlp, 1e-5, True)):
        with pytest.raises(ValueError):
            bad()
    small = _build.LnMlpPlan(128, 128, 2, 1024)  # scratch too small
    with pytest.raises(RuntimeError):
        _build.ln_mlp(x, *mlp, 1e-5, True, plan=small)


def test_k3_k9_run_the_tile_gemm_and_k14f_the_wmma_gemm(gen):
    """By kernel name: K3 and K9 launch the 16-byte-chunk LN and the tile
    GEMM (and, where the plan cuts fc2, the row kernel) and not the wmma
    GEMM; so does K14's whole block (its MLP K3's path), with the
    tensor-core forward, and no wmma GEMM, f32-pipe core or scalar LN."""
    def has(names, part):
        return any(part in n for n in names)

    x, mlp = _mlp_case(gen, 4 * 248, 1024)
    for fn in (lambda: fused_ln_mlp_chunked(x, *mlp, 1e-5),
               lambda: fused_ln_mlp(x, *mlp, 1e-5)):
        names = _device_kernels(fn)
        assert has(names, "tile_kernel"), names
        assert has(names, "layernorm_rows_kernel"), names
        assert not has(names, "gemm_bf16_kernel"), names
    args, _ = _k1_case(gen, 1, 2, True, False)
    (xs, n1w, n1b, wqkv, bqkv, wp, bp, bias, m, nH, scale, eps) = args
    C = 256
    xs = xs[:, :4, :245].reshape(1, 5, 14, 14, C)  # one shifted clip
    _, mlp = _mlp_case(gen, 1, C)
    names = _device_kernels(lambda: fused_swin_block_full(
        xs, n1w, n1b, wqkv, bqkv, wp, bp, bias[:, :245, :245].contiguous(),
        m[:4, :245, :245].contiguous(), *mlp, (5, 7, 7), (0, 3, 3), nH,
        scale, eps))
    for part in ("tile_kernel", "layernorm_rows_kernel", "fwd_kernel"):
        assert has(names, part), names
    for part in ("gemm_bf16_kernel", "attention_kernel",
                 "layernorm_bf16_kernel"):
        assert not has(names, part), names


def _k6_mask(gen, B, L, kind, n_video=250):
    """K6's f32 [B, L, L] mask at 0 / finfo(f32).min, as the model passes
    it: the seq2seq mask (every row sees the video, the text rows the
    text causally), that mask with one query row whose every key is
    masked, a random 0/1 mask (at least one open key a row), or the
    stride-0 expansion of a key-padding bias (``LVT_KMASK=0``: the
    captions' tails padded, one sequence keeping one key)."""
    big_neg = torch.finfo(torch.float32).min
    if kind == "key padding":
        pad = torch.zeros(B, 1, L, device="cuda")
        for i, n in enumerate((0, 6, 14, L - 1)[:B]):
            pad[i, :, L - n:] = big_neg
        return pad.expand(B, L, L)
    if kind == "random":
        keep = torch.rand(B, L, L, generator=gen, device="cuda") < 0.5
        keep[:, :, 0] = True
    else:
        keep = torch.zeros(B, L, L, dtype=torch.bool, device="cuda")
        keep[:, :, :n_video] = True
        keep[:, n_video:, n_video:] = torch.ones(
            L - n_video, L - n_video, dtype=torch.bool, device="cuda").tril()
        if kind == "masked row":
            keep[1, L - 3] = False
    return torch.where(keep, 0.0, big_neg)


@pytest.mark.parametrize("L,kind", [
    (275, "seq2seq"), (252, "seq2seq"), (270, "seq2seq"), (275, "random"),
    (275, "masked row"), (275, "key padding")])
def test_k6_at_seq2seq_shapes_matches_plain_bitwise(gen, L, kind):
    """K6 (K4's C call under the clamped bf16 mask) at the seq2seq
    forward's B = 4, L = 275 and the re-encode decoder's 252 and 270:
    within the gate of its plain version, a fully masked query row taking
    the softmax over its -1e4 scores as the plain version does, the
    stride-0 mask of ``LVT_KMASK=0`` taken as it is; a second call
    bitwise equal."""
    B, C, nH = 4, 768, 12
    lin = lambda: (_rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C, std=0.02))
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (lin() for _ in range(4))
    mask = _k6_mask(gen, B, L, kind)
    args = (_rnd(gen, B, L, C), wq, wk, wv, bq, bk, bv, wo, bo,
            1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1), mask, nH,
            (C // nH) ** -0.5, 1e-12)
    before = fused_bert_attn_block.launches
    got = fused_bert_attn_block(*args)
    assert fused_bert_attn_block.launches == before + 1
    want = fused_bert_attn_block.plain(*args)
    _close(got, want, rel_l2=1e-2)
    if kind == "masked row":
        _close(got[1, L - 3], want[1, L - 3], rel_l2=1e-2)
    assert torch.equal(got, fused_bert_attn_block(*args))


def test_bert_attn_block_takes_a_keep_vector_or_a_mask(gen):
    """The launcher raises on both or neither, and on a mask the kernel
    does not take (f32, or rows not contiguous)."""
    B, L, C, nH = 2, 9, 64, 2
    x, w, b = _rnd(gen, B * L, C), _rnd(gen, C, C), _rnd(gen, C)
    keep = torch.ones(B, L, dtype=torch.bool, device="cuda")
    mask = _build.padded_rows(B, L, torch.bfloat16, "cuda").zero_()
    ws = (x, w, w, w, b, b, b, w, b, b, b)
    for kw in ({"keep": keep, "mask": mask}, {"keep": None, "mask": None},
               {"keep": None, "mask": mask.float()},
               {"keep": None, "mask": mask.transpose(1, 2)}):
        k = kw.pop("keep")
        with pytest.raises(ValueError):
            _build.bert_attn_block(*ws, k, B, L, nH, 0.25, 1e-12, **kw)


@pytest.mark.parametrize("M,C,K", [(37, 64, 192), (300, 1024, 4096),
                                   (2200, 768, 768)])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_gemm_tc_dropout_ln_matches_plain(gen, M, C, K, rate):
    """K11's C call: the product as the split plan's f32 K-slices (3 at M =
    37, 2 at 300 x 4096, 1 at 2,200), summed in order by the row kernel's
    dropout mode with the bias, dropped by the counter hash (keep mask
    exactly ``dropout.row_keep``), + residual, LN; against the same in
    f32; a second call bitwise equal."""
    a, w, b = _rnd(gen, M, K), _rnd(gen, C, K, std=K ** -0.5), _rnd(gen, C)
    x = _rnd(gen, M, C)
    lw, lb = 1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1)
    seed = torch.tensor([12345], device="cuda")
    got, keep = _build.gemm_tc_dropout_ln(a, w, b, x, lw, lb, 1e-12, seed,
                                          rate)
    want_keep = dropout.row_keep(seed, M, C, rate)
    assert keep.dtype == torch.bool and torch.equal(keep, want_keep)
    y = _linear_f32(a, w, b, "bias")
    if rate > 0.0:
        y = y * want_keep.float() / (1.0 - rate)
    want = layer_norm(x.float() + y, lw.float(), lb.float(), 1e-12)
    _close(got, want, rel_l2=1e-2)
    again = _build.gemm_tc_dropout_ln(a, w, b, x, lw, lb, 1e-12, seed, rate)
    assert torch.equal(got, again[0]) and torch.equal(keep, again[1])


@pytest.mark.parametrize("M", [8 * 275, 64 * 276])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_k11_at_step_shapes_matches_plain_bitwise(gen, M, rate):
    """K11 at the caption step's 8 x 275 rows and the default step's 64 x
    276, C = 768: keep masks exactly the plain version's, the output
    within the gate, the gradients of every input through the mask
    replay (``_ReplayFn``) against autograd of the plain version; a
    second call bitwise equal."""
    C = 768
    args = [_rnd(gen, M, C), _rnd(gen, M, C), _rnd(gen, C, C, std=C ** -0.5),
            _rnd(gen, C, std=0.02), 1 + _rnd(gen, C, std=0.1),
            _rnd(gen, C, std=0.1)]
    seed = torch.tensor([4242], device="cuda")
    dy = _rnd(gen, M, C)
    before = fused_out_ln_train.launches
    res = []
    for f in (fused_out_ln_train, fused_out_ln_train.plain):
        ins = [t.clone().requires_grad_(True) for t in args]
        out, keep = f(*ins, seed, 1e-12, rate)
        res.append((out, keep, torch.autograd.grad(out, ins, dy)))
    assert fused_out_ln_train.launches == before + 1
    (ok, kk, gk), (op_, kp, gp) = res
    assert kk.dtype == torch.bool and torch.equal(kk, kp)
    if rate == 0.0:
        assert bool(kk.all())
    else:
        assert abs(float(kk.float().mean()) - (1.0 - rate)) < 0.01
    _close(ok, op_, rel_l2=1e-2)
    for a, b in zip(gk, gp):
        _close(a, b, rel_l2=5e-2)
    again = fused_out_ln_train(*args, seed, 1e-12, rate)
    assert torch.equal(ok, again[0]) and torch.equal(kk, again[1])


def test_k11_runs_the_tile_gemm_and_k12_the_wmma_gemm(gen):
    """By kernel name: K11 and K12 launch the tile GEMM and its row kernel,
    and neither the wmma GEMM nor a scalar LN."""
    def has(names, part):
        return any(part in n for n in names)

    M, C = 300, 768
    x = _rnd(gen, M, C)
    ln = (1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1))
    seed = torch.tensor([5], device="cuda")
    k11 = _device_kernels(lambda: fused_out_ln_train(
        x, x, _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C), *ln, seed, 1e-12,
        0.1))
    assert has(k11, "tile_kernel") and has(k11, "rows_kernel"), k11
    k12 = _device_kernels(lambda: fused_ffn_post_ln_train(
        x, _rnd(gen, 4 * C, C, std=C ** -0.5), _rnd(gen, 4 * C),
        _rnd(gen, C, 4 * C, std=(4 * C) ** -0.5), _rnd(gen, C), *ln, seed,
        1e-12, 0.1))
    for names in (k11, k12):
        assert has(names, "tile_kernel") and has(names, "rows_kernel"), names
        assert not has(names, "gemm_bf16_kernel"), names
        assert not has(names, "layernorm_bf16_kernel"), names


@pytest.mark.parametrize("M,N,K", [(300, 96, 64), (1000, 256, 256),
                                   (4096, 128, 128)])
def test_gemm_tc_scatter_and_layernorm_rows_gather(gen, M, N, K):
    """K14's two layout primitives on the tile GEMM and the chunk LN
    against their plain meaning: the scatter epilogue writes row m of the
    product + residual[rows[m]] to out[rows[m]] and drops a row below 0
    (its out row untouched); the chunk LN gathers x[rows[m]] (a zero row
    below 0); a second call bitwise equal."""
    rows = torch.randperm(M, generator=gen, device="cuda").to(torch.int32)
    rows[::7] = -1
    a, w, b = _rnd(gen, M, K), _rnd(gen, N, K, std=K ** -0.5), _rnd(gen, N)
    r = _rnd(gen, M, N)
    out = torch.full((M, N), 7.0, dtype=torch.bfloat16, device="cuda")
    _build.gemm_tc(a, w, b, residual=r, rows=rows, out=out)
    keep = rows >= 0
    dst = rows[keep].long()
    want = out.clone()
    want[dst] = (_linear_f32(a[keep], w, b, "bias") + r[dst].float()).to(
        torch.bfloat16)
    untouched = torch.ones(M, dtype=torch.bool, device="cuda")
    untouched[dst] = False
    assert bool((out[untouched] == 7.0).all())
    _close(out, want)
    again = out.clone()
    _build.gemm_tc(a, w, b, residual=r, rows=rows, out=again)
    assert torch.equal(out, again)
    x = _rnd(gen, M, N, std=2.0)
    lw, lb = 1 + _rnd(gen, N, std=0.1), _rnd(gen, N, std=0.1)
    got = _build.layernorm_rows(x, lw, lb, 1e-5, rows=rows)
    _close(got[keep], layer_norm(x[dst], lw, lb, 1e-5))
    assert float(got[~keep].float().abs().max()) == 0.0
    assert torch.equal(got, _build.layernorm_rows(x, lw, lb, 1e-5, rows=rows))


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("pitch", ["own", "padded", "f32 mask"])
def test_k14_at_swin_b_stages_matches_plain_bitwise(gen, stage, full, pitch):
    """K14's one C call on one clip of a Swin-B stage (T = 5, N = 245),
    shifted at stages 1-3 (unshifted at 4), with and without its MLP, the
    bias and a bf16 mask at N's own pitch or in rows padded to 16 bytes,
    or an f32 mask: within the gate of its plain version, its
    residual-free part too; a second call bitwise equal."""
    from lavender_tpu_torch.models.swin3d import relative_position_index
    from lavender_tpu_torch.ops.swin_block_attn import rel_pos_bias_wm

    nW, C = _SWIN_B[stage]
    side, nH = {1: 56, 2: 28, 3: 14, 4: 7}[stage], C // 32
    window, N = (5, 7, 7), 245
    shift = (0, 3, 3) if stage < 4 else (0, 0, 0)
    x, params, mask, mlp = _spatial_args(gen, 1, 5, side, side, C, nH,
                                         window, shift)
    params[6] = rel_pos_bias_wm(_rnd(gen, 15 * 13 * 13, nH),
                                relative_position_index((8, 7, 7)), N, N,
                                torch.bfloat16)
    bias = params[6]
    if pitch == "padded":
        bias = _build.with_padded_rows(bias)
        mask = None if mask is None else _build.with_padded_rows(mask)
    elif pitch == "f32 mask" and mask is not None:
        mask = mask.float()
    op = fused_swin_block_full if full else fused_swin_block_attn
    args = (x, *params[:6], bias, mask, *(mlp if full else ()), window,
            shift, nH, 32 ** -0.5, 1e-5)
    got = op(*args)
    want = op.plain(*args)
    _close(got, want, rel_l2=1e-2)
    _close((got - x).float(), (want - x).float(), rel_l2=5e-2)
    assert torch.equal(got, op(*args))


@pytest.mark.parametrize("M,C,HD", [(37, 64, 256), (300, 768, 3072),
                                    (64 * 276, 768, 3072)])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_ffn_dropout_ln_matches_plain(gen, M, C, HD, rate):
    """K12's C call: fc1 + GELU and fc2's f32 K-slices on the tile GEMM,
    summed in order by the row kernel's dropout mode with b2, dropped by
    the counter hash (keep mask exactly ``dropout.row_keep``), + residual,
    LN; against the same in f32 (fc2 unrounded before the dropout, as the
    kernel keeps it); a second call bitwise equal."""
    from lavender_tpu_torch.ops.fused_mlp import ffn_plan

    x = _rnd(gen, M, C)
    w1, b1 = _rnd(gen, HD, C, std=C ** -0.5), _rnd(gen, HD, std=0.02)
    w2, b2 = _rnd(gen, C, HD, std=HD ** -0.5), _rnd(gen, C, std=0.02)
    lw, lb = 1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1)
    seed = torch.tensor([777], device="cuda")
    S = ffn_plan(M, C, HD, long_m=True).splits
    got, keep = _build.ffn_dropout_ln(x, w1, b1, w2, b2, lw, lb, 1e-12, seed,
                                      rate, S)
    want_keep = dropout.row_keep(seed, M, C, rate)
    assert keep.dtype == torch.bool and torch.equal(keep, want_keep)
    h = _linear_f32(x, w1, b1, "gelu").to(torch.bfloat16)
    y = _linear_f32(h, w2, b2, "bias")
    if rate > 0.0:
        y = y * want_keep.float() / (1.0 - rate)
    want = layer_norm(x.float() + y, lw.float(), lb.float(), 1e-12)
    _close(got, want, rel_l2=1e-2)
    again = _build.ffn_dropout_ln(x, w1, b1, w2, b2, lw, lb, 1e-12, seed,
                                  rate, S)
    assert torch.equal(got, again[0]) and torch.equal(keep, again[1])
