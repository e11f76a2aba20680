"""The launch plan of the fusion encoder's wgmma + TMA attention backward
(K10b, K13b; ``_build.attention_bwd_plan`` for ``csrc/attention_bwd_wgmma.cu``)
at the model's shapes and its refusals.  Pure arithmetic on shapes,
strides and addresses; no kernel runs here."""
import pytest
import torch

from lavender_tpu_torch.ops import _build

PAIRS = 64  # the default train step's B = 8 clips x 8 texts
HD = 64


def _slab_operands(L, nH):
    """The element strides and addresses K10b's wrapper hands the plan:
    q, k, v, dq, dk, dv column slices of [PAIRS * L, 3C] slabs, g [PAIRS *
    L, C]."""
    C = nH * HD
    qkv = torch.empty(PAIRS * L, 3 * C, dtype=torch.bfloat16)
    g = torch.empty(PAIRS * L, C, dtype=torch.bfloat16)
    slab, cols = (L * 3 * C, HD, 3 * C), (L * C, HD, C)
    ptrs = [qkv.data_ptr() + i * C * 2 for i in range(3)] + [g.data_ptr()]
    return _build._stepped((PAIRS, nH, L), slab, cols), tuple(ptrs)


@pytest.mark.parametrize("L", [275, 276, 751])
@pytest.mark.parametrize("nH", [12, 6, 3])
@pytest.mark.parametrize("mask_f32", [False, True], ids=["K10b", "K13b"])
def test_plan_at_model_shapes(L, nH, mask_f32):
    """64-row key tiles (as many query tiles), a CTA a (key tile, pair,
    head), 2 ring stages, two CTAs' shared memory on one SM, and the dQ
    sums and turn counters one a (pair, head, query tile)."""
    strides, ptrs = _slab_operands(L, nH)
    plan = _build.attention_bwd_plan(PAIRS, L, nH, HD, mask_f32, strides,
                                     ptrs)
    tiles = -(-L // 64)
    assert plan.tiles == tiles == {275: 5, 276: 5, 751: 12}[L]
    assert plan.ctas == PAIRS * nH * tiles
    assert plan.stages == 2
    # K, V, each stage's Q and G (8 KB tiles), dS^T (8 KB), dQ_t's f32
    # hand-off (16 KB), each stage's mask tile (64 rows of 64 elements + 16
    # bytes) and lse / D rows, 1 KB of alignment
    mask_tile = 64 * (64 * (4 if mask_f32 else 2) + 16)
    assert plan.smem == (6 * 8192 + 8192 + 16384 + 2 * (mask_tile + 512)
                         + 1024)
    assert plan.smem == (110592 if mask_f32 else 94208)
    assert 2 * (plan.smem + 1024) <= 228 * 1024  # two CTAs an SM
    assert plan.acc_bytes == PAIRS * nH * tiles * 64 * HD * 4
    assert plan.sems == PAIRS * nH * tiles


def test_plan_scratch_at_the_default_and_swin_l_steps():
    """The dQ sums' scratch: 60 MiB at the default step (L = 276), 144
    MiB at Swin-L's L = 751."""
    assert _build.attention_bwd_plan(PAIRS, 276, 12, HD, False).acc_bytes \
        == 60 * 2 ** 20
    assert _build.attention_bwd_plan(PAIRS, 751, 12, HD, False).acc_bytes \
        == 144 * 2 ** 20


@pytest.mark.parametrize("L", [1, 17, 64])
def test_plan_one_tile_needs_no_scratch(L):
    """At one key tile the CTA writes dq itself: no sums, no counters."""
    plan = _build.attention_bwd_plan(3, L, 2, HD, True)
    assert (plan.tiles, plan.ctas, plan.acc_bytes, plan.sems) == (
        1, 6, 0, 0)


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_plan_head_dims(hd):
    """The tiles of Q, K, V and G are 64 rows of hd and dQ_t's hand-off 64
    x hd f32: their shared memory scales with hd, the dS^T tile and the
    masks do not."""
    plan = _build.attention_bwd_plan(3, 129, 2, hd, False)
    assert plan.tiles == 3
    assert plan.smem == (6 * 64 * 2 * hd + 8192 + 64 * hd * 4
                         + 2 * (64 * 144 + 512) + 1024)
    assert plan.acc_bytes == 3 * 2 * 3 * 64 * hd * 4


def test_plan_heads_views_and_contiguous_heads():
    """K13b's heads views of a qkv slab and contiguous [B, nH, L, hd]
    tensors pass; an extent-1 dimension's stride is not stepped."""
    B, nH, L = 4, 3, 276
    slab = torch.empty(B, L, 3 * nH * HD, dtype=torch.bfloat16)
    q, k, v = slab.view(B, L, 3, nH, HD).permute(2, 0, 3, 1, 4)
    heads = torch.empty(B, nH, L, HD, dtype=torch.bfloat16)
    ts = (q, k, v, heads)
    plan = _build.attention_bwd_plan(
        B, L, nH, HD, True,
        _build._stepped((B, nH, L), *(t.stride()[:3] for t in ts)),
        tuple(t.data_ptr() for t in ts))
    assert plan.ctas == B * nH * 5
    assert _build._stepped((1, 2, 3), (7, 16, 24), (9, 8, 1)) == (
        16, 24, 8, 1)


@pytest.mark.parametrize("hd", [8, 48, 96, 128])
def test_plan_refuses_head_dims(hd):
    with pytest.raises(ValueError, match="head dim"):
        _build.attention_bwd_plan(PAIRS, 276, 12, hd, False)


@pytest.mark.parametrize("bad", [4, 12, 3 * 768 + 4])
def test_plan_refuses_strides_off_16_bytes(bad):
    strides, ptrs = _slab_operands(276, 12)
    with pytest.raises(ValueError, match="multiples of 8"):
        _build.attention_bwd_plan(PAIRS, 276, 12, HD, False,
                                  strides + (bad,), ptrs)


@pytest.mark.parametrize("off", [2, 8, 14])
def test_plan_refuses_unaligned_pointers(off):
    strides, ptrs = _slab_operands(276, 12)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.attention_bwd_plan(PAIRS, 276, 12, HD, False, strides,
                                  ptrs + (ptrs[0] + off,))


def test_plan_refuses_more_key_tiles_than_resident_ctas():
    """A key tile's CTA waits on the next one's: all of a (pair, head)'s
    must be resident at once (two an SM)."""
    L = 2 * _build.H100_SMS * 64
    assert _build.attention_bwd_plan(1, L, 1, HD, False).tiles == L // 64
    with pytest.raises(ValueError, match="key tiles"):
        _build.attention_bwd_plan(1, L + 1, 1, HD, False)
    with pytest.raises(ValueError, match="key tiles"):
        _build.attention_bwd_plan(1, 1000, 1, HD, False, sms=7)
