"""The wgmma + TMA tile GEMM's launch plans (``_build.gemm_tc_plan``, its
split plan at K11's rows too, and ``_build.ln_mlp_plan`` of K3's and K9's
LN + MLP) and its row-pitch rule (``_build.tile_rows_ok``), the packed
attention core's selection (``_build.attention_route``), K6's mask as its
C call takes it (``padded_clamped_mask``), and which primitives the
kernels' card paths call: K1, K3, K4, K6 (under its mask, no keep
vector) and K9 their one C call each (``csrc/blocks.cu``: the tile GEMM
and the tensor-core core), K11 its one C call (the tile GEMM's K-slices
into the row kernel's dropout mode), K12 the wmma GEMM and the scalar
``dropout_add_ln``, K14 and K16 the wmma GEMM and the f32-pipe core.
Pure functions, or the card paths run on CPU tensors with the primitives
replaced by recorders; no kernel runs here."""
import numpy as np
import pytest
import torch

from lavender_tpu_torch.ops import (_build, encoder_attention, fused_mlp,
                                   swin_block_attn)

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
    ({"bias": True}, "f32"),                                  # K14, K16
    ({}, "f32"),                                # nothing selected
    ({"keep": True, "bias": True}, "f32")])
def test_attention_route(kw, route):
    """The caller selects the tensor cores (or asks for lse); a bias, a
    mask or a keep vector alone never does."""
    assert _build.attention_route(**kw) == route


@pytest.mark.parametrize("kw", [
    {"dropout": True}, {"lse": True, "dropout": True, "bias": True},
    {"tensor_cores": True, "keep": True, "bias": True},
    {"lse": True, "keep": True}, {"tensor_cores": True, "dropout": True}])
def test_attention_route_refuses(kw):
    with pytest.raises(ValueError):
        _build.attention_route(**kw)


@pytest.fixture
def calls(monkeypatch):
    """Replace the primitives by recorders of (name, tensor_cores) that
    return zeros of their outputs' shapes."""
    log = []

    def gemm(a, w, b=None, *, gelu=False, residual=None, out=None,
             rows=None):
        log.append(("gemm", None))
        return out if out is not None else a.new_zeros(a.shape[0],
                                                       w.shape[0])

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

    def dropout_add_ln(x, *args):
        log.append(("dropout_add_ln", None))
        return torch.zeros_like(x), torch.zeros_like(x, dtype=torch.bool)

    def ln_mlp(x, ln_w, ln_b, w1, b1, w2, b2, eps, residual, plan=None):
        log.append(("ln_mlp", residual))
        return torch.zeros_like(x)

    for name, fn in (("gemm", gemm), ("gemm_tc", gemm_tc),
                     ("gemm_tc_ln", gemm_tc_ln),
                     ("gemm_tc_dropout_ln", gemm_tc_dropout_ln),
                     ("dropout_add_ln", dropout_add_ln),
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
    nothing else; K12 still runs fc1 and fc2 on ``gemm.cu`` and the scalar
    ``dropout_add_ln``."""
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
    assert calls == [("gemm", None), ("gemm", None), ("dropout_add_ln", None)]


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


def test_k14_k16_stay_on_the_wmma_gemm_and_the_f32_core(calls):
    """K14's and K16's card paths still record the LN, the wmma GEMM, the
    f32-pipe core and the wmma GEMM."""
    C, nH, window, shift = 32, 2, (2, 3, 3), (1, 1, 1)
    N = int(np.prod(window))
    for run in (
            lambda: swin_block_attn._spatial_cuda(
                torch.zeros(1, 2, 6, 6, C), *_swin_args(C=C)[1:7],
                torch.zeros(nH, N, N), torch.zeros(4, N, N), window, shift,
                nH, 0.25, 1e-5),
            lambda: swin_block_attn._shifted_cuda(
                *_swin_args(nW=4, Npad=24, C=C)[:7], torch.zeros(nH, 24, 24),
                torch.zeros(4, 24, 24), (2, 6, 6), window, shift, nH, 0.25,
                1e-5)):
        calls.clear()
        run()
        assert calls == [("layernorm", None), ("gemm", None),
                         ("attention", False), ("gemm", None)]


def test_k14f_keeps_its_mlp_on_the_wmma_gemm(calls):
    """K14's whole block (the "fused" route's full variant) runs its MLP
    as the LN and two ``gemm.cu`` launches after its attention half, not
    as K3's and K9's ``ln_mlp``."""
    C, nH, window, shift = 32, 2, (2, 3, 3), (1, 1, 1)
    N = int(np.prod(window))
    swin_block_attn._spatial_cuda(
        torch.zeros(1, 2, 6, 6, C), *_swin_args(C=C)[1:7],
        torch.zeros(nH, N, N), torch.zeros(4, N, N), window, shift, nH, 0.25,
        1e-5, mlp=_mlp_args(C))
    assert calls == [("layernorm", None), ("gemm", None),
                     ("attention", False), ("gemm", None),
                     ("layernorm", None), ("gemm", None), ("gemm", None)]
