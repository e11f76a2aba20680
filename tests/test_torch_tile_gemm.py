"""The wgmma + TMA tile GEMM's launch plans (``_build.gemm_tc_plan``, its
split plan at K11's rows too, ``_build.ln_mlp_plan`` of K3's and K9's
LN + MLP, ``_build.swin_spatial_plan`` of K14 and K12's ``ffn_plan``) and
its row-pitch rule (``_build.tile_rows_ok``), the packed attention core's
selection (``_build.attention_route``), K6's mask as its C call takes it
(``padded_clamped_mask``), K14's row index (a permutation whose inverse
undoes the roll) and its bias and mask in rows padded to 16 bytes, K16's
row index (its -1 entries exactly the slab's pad rows), and which
primitives the kernels' card paths call: K1, K3, K4, K6 (under its mask,
no keep vector), K9, K14 (shifted and unshifted, with and without its
MLP) and K16 (K14's call on the window-major slab) their one C call each
(``csrc/blocks.cu``: the tile GEMM and the tensor-core core), K11 and K12
their one C call (the tile GEMM's K-slices into the row kernel's dropout
mode).  Pure functions, or the card paths run on CPU tensors with the
primitives replaced by recorders; no kernel runs here."""
import numpy as np
import pytest
import torch

from lavender_tpu_torch.ops import (_build, encoder_attention, fused_mlp,
                                   swin_block_attn)
from lavender_tpu_torch.ops.wm_permute import shift_index

SMS = _build.H100_SMS
# Swin-B at T = 5, 224 x 224 (windows a clip, C): rows = B * nW * 248
SWIN_B = ((64, 128), (16, 256), (4, 512), (1, 1024))


def _products():
    """(M, N, K, G, residual) of every K1, K4 and K5 product at B = 4
    serving and B = 8 training (K4 and K5 at serving's 1104 rows and the
    prefill's 1000)."""
    out = []
    for B in (4, 8):
        for nW, C in SWIN_B:
            M = B * nW * 248
            out += [(M, 3 * C, C, 1, False), (M, C, C, 1, True),
                    (M, 4 * C, C, 1, False), (M, C, 4 * C, 1, True)]
    for M in (1104, 1000):
        out += [(M, 768, 768, 3, False), (M, 3072, 768, 1, False)]
    return out


def _cost(M, N, G, bm):
    tiles = -(-M // bm) * -(-N // 128) * G
    blocks = _build._TC_BLOCKS[bm]
    return -(-tiles // (SMS * blocks)) * bm * blocks / _build._TC_RATE[bm]


@pytest.mark.parametrize("M,N,K,G,residual", _products())
def test_gemm_tc_plan_fills_the_card(M, N, K, G, residual):
    """The tile height of the least waves x rows a wave / rate (at most
    128 rows under the residual epilogue); its tiles cover the output
    once and either give every SM one or run in one wave."""
    plan = _build.gemm_tc_plan(M, N, K, G, residual=residual)
    heights = (128, 64) if residual else (256, 128, 64)
    assert plan.splits == 1 and plan.bm in heights
    assert plan.blocks == -(-M // plan.bm) * -(-N // 128) * G
    assert _cost(M, N, G, plan.bm) == min(_cost(M, N, G, b) for b in heights)
    assert (plan.blocks >= SMS
            or plan.blocks <= SMS * _build._TC_BLOCKS[plan.bm])


@pytest.mark.parametrize("M,N,K", [(1104, 768, 768), (1000, 768, 768),
                                   (1104, 768, 3072), (1000, 768, 3072),
                                   (37, 64, 192), (8, 768, 3072),
                                   (63488, 128, 512)])
def test_gemm_tc_split_plan_takes_each_k_step_once(M, N, K):
    """The K-slices of the partial epilogue (K4's proj): whole 64-deep
    steps each, every step of K in exactly one slice, and at BERT-base's
    1104 and 1000 rows the fewest slices that keep half the SMs busy (one:
    64-row tiles give 96-108 blocks)."""
    plan = _build.gemm_tc_plan(M, N, K, split=True)
    steps = -(-K // _build.TILE_K)
    per = steps // plan.splits
    assert plan.bm in (128, 64) and per * plan.splits == steps
    taken = sorted(s * per + c for s in range(plan.splits)
                   for c in range(per))
    assert taken == list(range(steps))
    assert plan.blocks == -(-M // plan.bm) * -(-N // 128) * plan.splits
    if M in (1104, 1000):
        assert plan.splits == 1 and 2 * plan.blocks >= SMS


def _ln_mlps():
    """(M, C, residual) of K9 at the B = 8 train step's stages 1-4 (no
    residual), K3 at B = 4 serving's stage 4 and K9 at the B = 4 "pallas"
    forward's stages 1-3 (+ residual)."""
    return ([(8 * nW * 248, C, False) for nW, C in SWIN_B]
            + [(4 * 248, 1024, True)]
            + [(4 * nW * 248, C, True) for nW, C in SWIN_B[:3]])


@pytest.mark.parametrize("M,C,residual", _ln_mlps())
def test_ln_mlp_plan_takes_each_k_step_once_and_fills_the_card(M, C,
                                                               residual):
    """K3's and K9's plan: fc1 on ``gemm_tc_plan``'s tile, fc2 on its tile
    or as K-slices of whole 64-deep steps that take every step of HD
    exactly once (at most 128 rows under the residual epilogue), each
    product's tiles at least half the 132 SMs, and the scratch that
    ``csrc/blocks.cu`` lays out: LN(x) and the hidden layer in bf16, the
    f32 slices, each rounded up to 256 bytes."""
    HD = 4 * C
    plan = _build.ln_mlp_plan(M, C, HD, residual)
    assert plan.fc1_bm == _build.gemm_tc_plan(M, HD, C).bm
    assert plan.fc2_bm in ((128, 64) if residual else (256, 128, 64))
    steps = HD // _build.TILE_K
    per = steps // plan.splits
    assert per * plan.splits == steps
    taken = sorted(s * per + c for s in range(plan.splits)
                   for c in range(per))
    assert taken == list(range(steps))
    if plan.splits == 1:
        assert plan.fc2_bm == _build.gemm_tc_plan(M, C, HD,
                                                  residual=residual).bm
    fc1_tiles = -(-M // plan.fc1_bm) * HD // 128
    fc2_tiles = -(-M // plan.fc2_bm) * C // 128 * plan.splits
    assert 2 * fc1_tiles >= SMS and 2 * fc2_tiles >= SMS
    r = lambda n: -(-n // 256) * 256
    assert plan.scratch == r(M * C * 2) + r(M * HD * 2) + (
        r(plan.splits * M * C * 4) if plan.splits > 1 else 0)


@pytest.mark.parametrize("col,pitch,ok", [
    (0, 3 * 768, True), (768, 3 * 768, True), (1536, 3 * 768, True),
    (8, 3 * 768 + 16, True), (4, 3 * 768, False), (0, 3 * 768 + 4, False),
    (0, 700, False)])
def test_tile_rows_take_column_slices(col, pitch, ok):
    """A [M, 768] column slice of a wider slab as the tile GEMM's operand
    or output: rows contiguous, their pitch a multiple of 8 elements (a
    tensor map's 16-byte row stride) and at least the width, the first
    element 16-byte aligned (column 4 is 8 bytes off)."""
    base = 1 << 20
    assert _build.tile_rows_ok((1104, 768), (pitch, 1), base + 2 * col,
                               1104, 768) is ok


@pytest.mark.parametrize("kw,route", [
    ({"tensor_cores": True, "bias": True}, "tensor_cores"),   # K1
    ({"tensor_cores": True, "keep": True}, "tensor_cores"),   # K4
    ({"lse": True, "bias": True}, "tensor_cores"),            # K8a
    ({"lse": True, "dropout": True}, "tensor_cores"),         # K10a
    ({"bias": True}, None),               # K14's and K16's old call
    ({}, None),                                 # nothing selected
    ({"keep": True, "bias": True}, None)])
def test_attention_route(kw, route):
    """The caller selects the tensor cores (or asks for lse); a bias, a
    mask or a keep vector alone never does, and since the f32-pipe core is
    gone such a call raises (route None) instead of running elsewhere."""
    if route is None:
        with pytest.raises(ValueError, match="select them"):
            _build.attention_route(**kw)
    else:
        assert _build.attention_route(**kw) == route


@pytest.mark.parametrize("kw", [
    {"dropout": True}, {"lse": True, "dropout": True, "bias": True},
    {"tensor_cores": True, "keep": True, "bias": True},
    {"lse": True, "keep": True}, {"tensor_cores": True, "dropout": True}])
def test_attention_route_refuses(kw):
    with pytest.raises(ValueError):
        _build.attention_route(**kw)


class _Log(list):
    """The recorded calls; ``rows``: the row index K14's call was given."""
    rows = None


@pytest.fixture
def calls(monkeypatch):
    """Replace the primitives by recorders of (name, tensor_cores) that
    return zeros of their outputs' shapes."""
    log = _Log()

    def gemm_tc(a, w, bias=None, *, gelu=False, residual=None, out=None):
        ws = w if isinstance(w, (tuple, list)) else (w,)
        log.append(("gemm_tc", len(ws)))
        return a.new_zeros(a.shape[0], len(ws) * ws[0].shape[0])

    def gemm_tc_ln(a, w, *args):
        log.append(("gemm_tc_ln", None))
        return a.new_zeros(a.shape[0], w.shape[0])

    def layernorm(x, w, b, eps, rows=None):
        log.append(("layernorm", None))
        return x.new_zeros(x.shape[0] if rows is None else rows.shape[0],
                           x.shape[1])

    def attention(qkv, n_seq, n_tok, n_heads, scale, bias=None, mask=None,
                  keep=None, lse=None, seed=None, rate=0.0,
                  tensor_cores=False):
        log.append(("attention", tensor_cores))
        return qkv.new_zeros(qkv.shape[0], qkv.shape[1] // 3)

    def swin_block_wm(x, *args):  # the last: mlp
        log.append(("swin_block_wm", args[-1] is not None))
        return torch.zeros_like(x)

    def bert_attn_block(x, *args, mask=None):  # args[10]: the keep vector
        log.append(("bert_attn_block", None if mask is None else
                    "mask" if args[10] is None else "keep and mask"))
        return torch.zeros_like(x)

    def gemm_tc_dropout_ln(a, w, *args):
        log.append(("gemm_tc_dropout_ln", None))
        out = a.new_zeros(a.shape[0], w.shape[0])
        return out, out.bool()

    def ffn_dropout_ln(x, w1, b1, w2, b2, ln_w, ln_b, eps, seed, rate,
                       splits):
        log.append(("ffn_dropout_ln", splits))
        return torch.zeros_like(x), torch.zeros_like(x, dtype=torch.bool)

    def swin_block_spatial(x, rows, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                           bias, mask, n_seq, n_tok, n_heads, scale, eps,
                           mlp=None, pad_zero=False):
        log.append(("swin_block_spatial", mlp is not None))
        log.rows, log.pad_zero = rows, pad_zero
        log.windows = (n_seq, n_tok, n_heads)
        return torch.zeros_like(x)

    def ln_mlp(x, ln_w, ln_b, w1, b1, w2, b2, eps, residual, plan=None):
        log.append(("ln_mlp", residual))
        return torch.zeros_like(x)

    for name, fn in (("gemm_tc", gemm_tc),
                     ("gemm_tc_ln", gemm_tc_ln),
                     ("gemm_tc_dropout_ln", gemm_tc_dropout_ln),
                     ("ffn_dropout_ln", ffn_dropout_ln),
                     ("swin_block_spatial", swin_block_spatial),
                     ("layernorm", layernorm),
                     ("attention", attention),
                     ("swin_block_wm", swin_block_wm),
                     ("bert_attn_block", bert_attn_block),
                     ("ln_mlp", ln_mlp)):
        monkeypatch.setattr(_build, name, fn)
    return log


def _swin_args(B=1, nW=4, Npad=56, C=32, nH=2):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    return (r(B, nW, Npad, C), r(C), r(C), r(3 * C, C), r(3 * C), r(C, C),
            r(C), r(nH, Npad, Npad), r(nW, Npad, Npad), nH, 0.25, 1e-5)


@pytest.mark.parametrize("with_mlp", [False, True])
def test_k1_runs_its_block_in_one_call(calls, with_mlp):
    """K1's card path is the one C call of ``_build.swin_block_wm`` (the
    tile GEMM and the tensor-core core inside it, ``csrc/blocks.cu``),
    nothing else."""
    C = 32
    mlp = (torch.ones(C), torch.zeros(C), torch.zeros(4 * C, C),
           torch.zeros(4 * C), torch.zeros(C, 4 * C), torch.zeros(C))
    swin_block_attn._block_cuda(*_swin_args(C=C),
                                mlp=mlp if with_mlp else None)
    assert calls == [("swin_block_wm", with_mlp)]


def _mlp_args(C=32):
    return (torch.ones(C), torch.zeros(C), torch.zeros(4 * C, C),
            torch.zeros(4 * C), torch.zeros(C, 4 * C), torch.zeros(C))


@pytest.mark.parametrize("kernel,residual", [("K9", False), ("K9", True),
                                             ("K3", True)])
def test_k3_k9_run_their_mlp_in_one_call(calls, kernel, residual):
    """K9's card path (with and without its residual) and K3's are the one
    C call of ``_build.ln_mlp`` (LN, fc1 + GELU and fc2 on the tile GEMM
    inside it, ``csrc/blocks.cu``), nothing else."""
    x = torch.zeros(2 * 56, 32)
    if kernel == "K9":
        fused_mlp._mlp_cuda(x, *_mlp_args(), 1e-5, residual)
    else:
        fused_mlp._ln_mlp_cuda(x, *_mlp_args(), 1e-5)
    assert calls == [("ln_mlp", residual)]


def _bert_args(last):
    B, L, C = 2, 9, 32
    w = torch.zeros(C, C)
    b = torch.zeros(C)
    return (torch.zeros(B, L, C), w, w, w, b, b, b, w, b, b + 1, b, last, 2,
            0.25, 1e-12)


def test_k4_runs_its_block_in_one_call(calls):
    encoder_attention._attn_block_cuda(
        *_bert_args(torch.ones(2, 9, dtype=torch.bool)))
    assert calls == [("bert_attn_block", None)]


@pytest.mark.parametrize("expand", [False, True])
def test_k6_runs_its_block_in_one_call_under_a_mask(calls, expand):
    """K6's card path is K4's one C call (``_build.bert_attn_block``) with
    the [B, L, L] mask and no keep vector, also for the stride-0 expansion
    of a key-padding bias (``LVT_KMASK=0``)."""
    mask = torch.zeros(2, 9, 9)
    if expand:
        mask = torch.zeros(2, 1, 9).expand(2, 9, 9)
    encoder_attention._attn_block_mask_cuda(*_bert_args(mask))
    assert calls == [("bert_attn_block", "mask")]


@pytest.mark.parametrize("L", [9, 252, 270, 275])
def test_k6_mask_is_clamped_bf16_in_padded_rows(L):
    """The mask K6's C call reads: the plain version's clamp at -1e4 and
    bf16 cast, bit for bit, in rows padded to 16 bytes (L = 275 -> 280),
    from a finfo(f32).min mask and from a stride-0 expansion."""
    B = 2
    g = torch.Generator().manual_seed(L)
    full = torch.where(torch.rand(B, L, L, generator=g) < 0.5, 0.0,
                       torch.finfo(torch.float32).min)
    full += torch.randn(B, L, L, generator=g) * 4e3  # values near -1e4 too
    for mask in (full, full[:, :1].expand(B, L, L)):
        m = encoder_attention.padded_clamped_mask(mask, torch.bfloat16)
        ld = -(-L // 8) * 8
        assert m.dtype == torch.bfloat16 and m.stride() == (L * ld, ld, 1)
        assert torch.equal(m, mask.clamp_min(-1e4).to(torch.bfloat16))


def _out_ln_args(M=18, C=32):
    x = torch.zeros(M, C)
    return (x, x, torch.zeros(C, C), torch.zeros(C), torch.ones(C),
            torch.zeros(C), torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k11_runs_in_one_call_and_k12_on_the_wmma_gemm(calls, rate):
    """K11's card path is the one C call of ``_build.gemm_tc_dropout_ln``
    (the proj's K-slices on the tile GEMM, the row kernel's dropout mode),
    nothing else; so is K12's that of ``_build.ffn_dropout_ln`` (K5's
    long-M products into that dropout mode), with ``ffn_plan``'s long-M
    K-slices, no longer ``gemm.cu``'s wmma GEMM and a scalar row kernel."""
    out, keep = fused_mlp._out_ln_train_cuda(*_out_ln_args(), 1e-12, rate)
    assert calls == [("gemm_tc_dropout_ln", None)]
    assert out.shape == keep.shape == (18, 32)
    calls.clear()
    C = 32
    x, *_ = _out_ln_args(C=C)
    fused_mlp._ffn_train_cuda(x, torch.zeros(4 * C, C), torch.zeros(4 * C),
                              torch.zeros(C, 4 * C), torch.zeros(C),
                              torch.ones(C), torch.zeros(C),
                              torch.zeros(1, dtype=torch.int64), 1e-12, rate)
    assert calls == [("ffn_dropout_ln",
                      fused_mlp.ffn_plan(18, C, 4 * C, long_m=True).splits)]


@pytest.mark.parametrize("M", [64 * 276, 40 * 276, 8 * 275])
def test_k11_split_plan_takes_each_k_step_once_and_fills_the_card(M):
    """K11's proj plan (``gemm_tc_plan(M, C, C, split=True)``) at the
    default step's 64 pairs, RetMC's 40 and the caption step's 8 clips of
    275 tokens: whole 64-deep K-slices that take every step of C = 768
    once, tiles for at least half the 132 SMs, and one slice wherever
    128-row tiles alone give half the SMs a tile."""
    C = 768
    plan = _build.gemm_tc_plan(M, C, C, split=True)
    steps = C // _build.TILE_K
    per = steps // plan.splits
    assert plan.bm in (128, 64) and per * plan.splits == steps
    taken = sorted(s * per + c for s in range(plan.splits)
                   for c in range(per))
    assert taken == list(range(steps))
    assert plan.blocks == -(-M // plan.bm) * (C // 128) * plan.splits
    assert 2 * plan.blocks >= SMS
    if 2 * -(-M // 128) * (C // 128) >= SMS:
        assert (plan.bm, plan.splits) == (128, 1)


def _spatial_run(C=32, nH=2, window=(2, 3, 3), shift=(1, 1, 1), mlp=None):
    """K14's card path on a [1, 2, 6, 6, C] map (4 windows of N = 18)."""
    N = int(np.prod(window))
    swin_block_attn._spatial_cuda(
        torch.zeros(1, 2, 6, 6, C), *_swin_args(C=C)[1:7],
        torch.zeros(nH, N, N), torch.zeros(4, N, N) if any(shift) else None,
        window, shift, nH, 0.25, 1e-5, mlp=mlp)


def test_k14_k16_run_their_block_in_one_call(calls):
    """K14's card path is its one C call (``_build.swin_block_spatial``);
    so is K16's, on the window-major slab: B * nW windows of n_tok = Npad
    rows, the wm shift's row index over the batch (-1 at the pad rows) and
    the zeroing scatter (``pad_zero``), no MLP."""
    C, nH, window, shift = 32, 2, (2, 3, 3), (1, 1, 1)
    _spatial_run(C, nH, window, shift)
    assert calls == [("swin_block_spatial", False)]
    assert not calls.pad_zero
    calls.clear()
    B, nW, N, Npad = 2, 4, 18, 24
    swin_block_attn._shifted_cuda(
        *_swin_args(B=B, nW=nW, Npad=Npad, C=C)[:7],
        torch.zeros(nH, Npad, Npad), torch.zeros(nW, Npad, Npad), (2, 6, 6),
        window, shift, nH, 0.25, 1e-5)
    assert calls == [("swin_block_spatial", False)] and calls.pad_zero
    assert calls.windows == (B * nW, Npad, nH)
    fwd = shift_index(window, 2, 6, 6, Npad, shift, False)
    want = np.where(fwd >= 0, np.arange(B)[:, None] * nW * Npad + fwd, -1)
    assert calls.rows.dtype == torch.int32
    assert np.array_equal(calls.rows.numpy(), want.reshape(-1))
    assert (calls.rows.numpy().reshape(B, nW, Npad)[:, :, N:] == -1).all()


# (window, spatial (D, H, W), Npad, shift): Swin-B stage 3 (window (5, 7, 7)
# on 5 x 14 x 14) and the card test's geometries
_K16_GEOMS = [((5, 7, 7), (5, 14, 14), 248, (0, 3, 3)),
              ((2, 2, 3), (2, 4, 6), 16, (0, 1, 1)),
              ((2, 2, 4), (2, 4, 8), 16, (0, 1, 2))]


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("window,spatial,Npad,shift", _K16_GEOMS)
def test_k16_rows_below_0_are_exactly_the_pad_rows(B, window, spatial, Npad,
                                                   shift):
    """K16's row index over a batch (``_batch_shift_rows`` of the forward
    wm shift): its -1 entries are exactly the slab's pad rows (w * Npad +
    r, r >= N), and the others name every valid row once.  The zeroing
    scatter relies on it: the rows whose index is -1 are the output rows
    that no index names, so zeros written there are the output's pad
    rows."""
    N = int(np.prod(window))
    nW = (spatial[1] // window[1]) * (spatial[2] // window[2])
    fwd, _ = swin_block_attn.shift_indices(window, *spatial, Npad, shift,
                                           "cpu")
    rows = swin_block_attn._batch_shift_rows(B, fwd).numpy()
    pos = np.arange(B * nW * Npad)
    pad = pos % Npad >= N
    assert rows.shape == pos.shape and rows.dtype == np.int32
    assert np.array_equal(rows < 0, pad)
    assert np.array_equal(np.sort(rows[~pad]), pos[~pad])


def test_k14f_keeps_its_mlp_on_the_wmma_gemm(calls):
    """K14's whole block (the "fused" route's full variant) runs its MLP
    inside its one C call (K3's path after the attention half), not as
    separate launches."""
    _spatial_run(mlp=_mlp_args(32))
    assert calls == [("swin_block_spatial", True)]


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 1, 1)])
@pytest.mark.parametrize("with_mlp", [False, True])
def test_k14_runs_its_block_in_one_call(calls, shift, with_mlp):
    """K14, shifted and unshifted, with and without its MLP: one C call,
    given the row index of ``window_rows`` over the batch."""
    _spatial_run(shift=shift, mlp=_mlp_args(32) if with_mlp else None)
    assert calls == [("swin_block_spatial", with_mlp)]
    want = swin_block_attn.window_rows(2, 6, 6, (2, 3, 3), shift)
    assert calls.rows.dtype == torch.int32
    assert np.array_equal(calls.rows.numpy(), want)


@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("side,C", [(56, 128), (28, 256), (14, 512),
                                    (7, 1024)])
@pytest.mark.parametrize("with_mlp", [False, True])
def test_k14_plan_at_swin_b_stages(B, side, C, with_mlp):
    """K14's plan at Swin-B's four stages (T = 5, 224 x 224: M = B * 5 *
    side^2 spatial rows), B = 4 and 8: the qkv tile of ``gemm_tc_plan``,
    the proj's under its residual rule (at most 128 rows), the MLP's as
    ``ln_mlp_plan`` with the residual (K3's path), and the scratch that
    ``csrc/blocks.cu`` lays out: LN1's output, the qkv slab and the core's
    output, bf16 [M, C] each rounded up to 256 bytes, + the MLP's."""
    M, HD = B * 5 * side * side, 4 * C if with_mlp else 0
    plan = _build.swin_spatial_plan(M, C, HD)
    assert plan.qkv_bm == _build.gemm_tc_plan(M, 3 * C, C).bm
    assert plan.proj_bm == _build.gemm_tc_plan(M, C, C, residual=True).bm
    assert plan.proj_bm in (128, 64)
    r = lambda n: -(-n // 256) * 256
    if not with_mlp:
        assert (plan.fc1_bm, plan.fc2_bm, plan.splits) == (0, 0, 1)
        assert plan.scratch == 5 * r(M * C * 2)
        return
    mlp = _build.ln_mlp_plan(M, C, HD, True)
    assert (plan.fc1_bm, plan.fc2_bm, plan.splits) == (
        mlp.fc1_bm, mlp.fc2_bm, mlp.splits)
    assert plan.scratch == 6 * r(M * C * 2) + r(M * HD * 2) + (
        r(plan.splits * M * C * 4) if plan.splits > 1 else 0)


@pytest.mark.parametrize("B,side,shift", [
    (2, 14, (0, 3, 3)), (1, 14, (0, 0, 0)), (2, 7, (0, 0, 0)),
    (1, 28, (2, 3, 3))])
def test_k14_rows_permute_and_their_inverse_undoes_the_roll(B, side, shift):
    """The row index K14's C call takes (``_device_rows``): a permutation of
    the batch's B * D * H * W spatial rows, in the windows of
    ``window_partition`` of the map rolled by -shift, so that gathering by
    it is the roll and the partition, and scattering back (its inverse)
    undoes both."""
    D, window = 5, (5, 7, 7)
    C = 8
    x = torch.randn(B, D, side, side, C, generator=torch.Generator()
                    .manual_seed(side))
    rows, inv = swin_block_attn._device_rows(B, D, side, side, window, shift,
                                             torch.device("cpu"))
    L = D * side * side
    assert rows.dtype == torch.int32 and inv.dtype == torch.int64
    assert torch.equal(torch.sort(rows.long()).values, torch.arange(B * L))
    one = swin_block_attn.window_rows(D, side, side, window, shift)
    assert np.array_equal(rows.numpy()[:L], one)
    assert np.array_equal(rows.numpy()[L:], one + L) or B == 1
    rolled = torch.roll(x, tuple(-s for s in shift), (1, 2, 3))
    windows = swin_block_attn.window_partition(rolled, window)
    flat = x.reshape(-1, C)
    gathered = flat[rows.long()]
    assert torch.equal(gathered, windows.reshape(-1, C))
    assert torch.equal(gathered[inv], flat)
    back = torch.empty_like(flat)
    back[rows.long()] = gathered  # the scatter epilogue's write
    assert torch.equal(back, flat)


@pytest.mark.parametrize("impl", ["fused", "pallas"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k14_padded_bias_and_mask_rows_equal_the_unpadded(impl, dtype):
    """A spatial stage on the routes whose core is the tensor-core forward
    ("fused": K14, "pallas": K15) gathers its rel-pos biases in rows
    padded to 16 bytes (``rel_pos_bias_rows``; N = 18: 20 elements in f32,
    24 in bf16), under autograd and in the serving cache, and keeps its
    shift mask so (the stage's geometry): the valid columns equal the
    unpadded bias (``rel_pos_bias_wm``, the reference's [:N, :N] slice)
    and mask, the bias's gradient reaches the table, and the cached
    forward equals the uncached one."""
    from lavender_tpu_torch.models import swin3d

    torch.manual_seed(0)
    layer = swin3d.BasicLayer(16, 2, 2, (2, 3, 3), attn_impl=impl).to(dtype)
    for blk in layer.blocks:
        torch.nn.init.normal_(blk.attn.relative_position_bias_table)
    D, H, W = 2, 6, 6
    x = torch.randn(2, D, H, W, 16).to(dtype)
    geo = layer._spatial_geometry(D, H, W, x.device, x.dtype)
    assert geo.fused == (impl == "fused")
    ld = 20 if dtype == torch.float32 else 24
    N = 18
    rel = swin3d.relative_position_index((2, 3, 3))
    trained = layer._spatial_biases(geo, dtype)
    for blk, got in zip(layer.blocks, trained):
        table = blk.attn.relative_position_bias_table
        want = swin_block_attn.rel_pos_bias_wm(table, rel, N, N, dtype)
        assert got.stride() == (N * ld, ld, 1) and torch.equal(got, want)
        (g,) = torch.autograd.grad(got.float().sum(), table)
        (w,) = torch.autograd.grad(want.float().sum(), table)
        assert torch.equal(g, w)
    full = torch.as_tensor(swin3d.compute_shift_mask(D, H, W, geo.window,
                                                     geo.shift))
    # "fused": in K14's bf16 whatever the stage's dtype (0 / -100 exact)
    mdt = torch.bfloat16 if impl == "fused" else dtype
    mld = 8 if mdt == torch.bfloat16 else 4
    assert geo.mask.dtype == mdt and torch.equal(geo.mask.float(), full)
    assert geo.mask.stride()[1:] == (-(-N // mld) * mld, 1)
    layer.eval()
    with torch.no_grad():
        uncached = layer(x)
        layer.build_serving_cache(D, H, W)
        cached_biases = layer._cache[(D, H, W, x.device, x.dtype)]
        cached = layer(x)
    for got, want in zip(cached_biases, trained):
        assert got.stride() == (N * ld, ld, 1) and torch.equal(got, want)
    assert torch.equal(cached, uncached)


def test_k12_plan_takes_the_long_m_regime():
    """K12's one C call runs only the long-M products: its K-slices are
    ``ffn_plan``'s long-M ones at every M (the train step's 64 x 276 rows,
    and 37 rows, where K5 would take mma.sync's short regime), whole
    64-deep steps of HD = 3072."""
    for M in (64 * 276, 37):
        plan = fused_mlp.ffn_plan(M, 768, 3072, long_m=True)
        assert not plan.short
        assert (3072 // _build.TILE_K) % plan.splits == 0
    assert fused_mlp.ffn_plan(37, 768, 3072).short
    assert fused_mlp.ffn_plan(64 * 276, 768, 3072, long_m=True) == \
        fused_mlp.ffn_plan(64 * 276, 768, 3072)
