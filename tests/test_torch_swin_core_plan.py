"""The launch plans of the Swin window core's Hopper kernels: K8a's wgmma +
TMA forward (``_build.attention_fwd_plan`` for
``csrc/attention_fwd_wgmma.cu``) and K8b's backward with the bias and its
dbias kernel (``_build.attention_bwd_plan(..., bias=True)`` for
``csrc/attention_bwd_wgmma.cu``) at every shape the model paths give them,
and their refusals.  Pure arithmetic on shapes, strides and addresses; no
kernel runs here."""
import pytest
import torch

from lavender_tpu_torch.ops import _build

B, HD = 8, 32  # the train step's clips; every Swin stage's head dim
SMEM_SM = 228 * 1024  # an H100 SM's shared memory, 1 KB of it a CTA's
# (name, windows of the B=8 step, heads, N): Swin-B stages 1-4 at Npad
# 248, the spatial route's N = 245 (stages 1 and 3), Swin-L-384 stages 1-4
# at 720, and the tensor-parallel route's heads / 2 and / 4 of Swin-B
SHAPES = (
    [(f"Swin-B stage {s}", B * nW, nH, 248)
     for s, nW, nH in ((1, 64, 4), (2, 16, 8), (3, 4, 16), (4, 1, 32))]
    + [(f"spatial stage {s}", B * nW, nH, 245)
       for s, nW, nH in ((1, 64, 4), (3, 4, 16))]
    + [(f"Swin-L stage {s}", B * nW, nH, 720)
       for s, nW, nH in ((1, 64, 6), (2, 16, 12), (3, 4, 24), (4, 1, 48))]
    + [(f"tp {tp} stage {s}", B * nW, nH // tp, 248)
       for tp in (2, 4)
       for s, nW, nH in ((1, 64, 4), (2, 16, 8), (3, 4, 16), (4, 1, 32))])
IDS = [s[0] for s in SHAPES]


def _slab(n_seq, n_tok, nH, hd=HD):
    """The strides and addresses the wrappers hand the plans: q, k, v
    (and dq, dk, dv) column slices of a [n_seq * N, 3C] slab, o and g [n_seq
    * N, C], the bias [nH, N, N] and the mask, each 16-byte aligned."""
    C = nH * hd
    slab, cols = (n_tok * 3 * C, hd, 3 * C), (n_tok * C, hd, C)
    strides = _build._stepped((n_seq, nH, n_tok), slab, cols)
    base = 1 << 20
    ptrs = (base, base + 2 * C, base + 4 * C, 1 << 24, 1 << 25, 1 << 26)
    return strides, ptrs


@pytest.mark.parametrize("name,n_seq,nH,N", SHAPES, ids=IDS)
def test_forward_plan_at_model_shapes(name, n_seq, nH, N):
    """A CTA a (window, head), its two warpgroups taking alternate 64-row
    query tiles; one block of 256 keys up to 256 tokens (the softmax
    exact), else blocks of 128 (Swin-L's 720: six, the online rescale);
    each warpgroup's Q, bias and mask tiles and the window's K and V whole
    in shared memory: 169 KB at hd 32 for Swin-B and for Swin-L alike
    (the tiles by TMA), 173 KB at the spatial route's N = 245 (by cp.async,
    its 490-byte rows padded for their lead), one CTA an SM."""
    strides, ptrs = _slab(n_seq, N, nH)
    plan = _build.attention_fwd_plan(n_seq, N, nH, HD, strides, ptrs)
    q_tiles = -(-N // 64)
    assert plan.q_tiles == q_tiles == {245: 4, 248: 4, 720: 12}[N]
    keys = 256 if N <= 256 else 128
    assert (plan.keys, plan.key_blocks) == (keys, {245: 1, 248: 1,
                                                    720: 6}[N])
    assert plan.ctas == n_seq * nH
    assert plan.tma_tiles == (N != 245)
    tile, wide = 64 * 2 * HD, 64 * (2 * keys + (0 if N % 8 == 0 else 16))
    assert plan.smem == (2 * (tile + 2 * wide) + 2 * q_tiles * tile
                         + 1024) == (173056 if N % 8 == 0 else 177152)
    assert plan.smem + 1024 <= SMEM_SM


@pytest.mark.parametrize("name,n_seq,nH,N", SHAPES, ids=IDS)
def test_backward_bias_plan_at_model_shapes(name, n_seq, nH, N):
    """The backward with the bias: K10b's CTAs and ring plus a bias tile a
    stage (two CTAs an SM), every key tile of a window resident at once,
    the dQ sums and turn counters a (window, head, tile); the dbias kernel
    a CTA a (query tile, key tile, head, chunk of windows), enough chunks
    for eight CTAs an SM, and its f32 partial sums [chunks, heads, N, N];
    the bias and mask tiles by TMA (64 x 64 boxes) where N % 8 == 0, else
    by cp.async (the spatial route's N = 245: rows padded by 16 bytes)."""
    strides, ptrs = _slab(n_seq, N, nH)
    plan = _build.attention_bwd_plan(n_seq, N, nH, HD, False, strides, ptrs,
                                     bias=True)
    tiles = -(-N // 64)
    tma = N % 8 == 0
    assert plan.tma_tiles == tma
    tile, rows = 64 * 2 * HD, 2 * 64 * 4
    mask_tile = 64 * (64 * 2 + (0 if tma else 16))
    assert (plan.tiles, plan.ctas, plan.stages) == (
        tiles, n_seq * nH * tiles, 2)
    # K, V, each stage's Q and G, dS^T, dQ_t's hand-off, each stage's mask
    # tile, lse / D rows and bias tile, 1 KB of alignment
    assert plan.smem == (6 * tile + 64 * 128 + 64 * HD * 4
                         + 2 * (2 * mask_tile + rows) + 1024) == (
                             75776 if tma else 79872)
    assert 2 * (plan.smem + 1024) <= SMEM_SM
    assert tiles <= 2 * _build.H100_SMS
    assert plan.acc_bytes == n_seq * nH * tiles * 64 * HD * 4
    assert plan.sems == n_seq * nH * tiles
    base = tiles * tiles * nH
    chunks = min(n_seq, -(-8 * _build.H100_SMS // base))
    assert plan.dbias_chunks == chunks >= 1
    assert plan.dbias_ctas == base * chunks
    assert plan.dbias_smem == (2 * (4 * tile + mask_tile + rows) + mask_tile
                               + 1024) == (59392 if tma else 62464)
    assert plan.part_bytes == chunks * nH * N * N * 4


def test_backward_bias_plan_chunks_at_swin_b_stage_1():
    """Stage 1's 512 windows of 4 heads: 16 tile pairs x 4 heads x 17
    chunks of 30-31 windows = 1088 dbias CTAs (about eight an SM), 16.7 MB
    of partial sums; Swin-L's stage 1 (144 tile pairs x 6 heads) needs two
    chunks."""
    plan = _build.attention_bwd_plan(512, 248, 4, HD, False, bias=True)
    assert (plan.dbias_chunks, plan.dbias_ctas) == (17, 1088)
    assert plan.part_bytes == 17 * 4 * 248 * 248 * 4
    swin_l = _build.attention_bwd_plan(512, 720, 6, HD, False, bias=True)
    assert (swin_l.dbias_chunks, swin_l.dbias_ctas) == (2, 1728)


def test_plans_without_the_bias_keep_their_launch():
    """K10b's / K13b's plan is as before: no dbias scratch, no bias tiles,
    the mask by cp.async (also at an L that is a multiple of 8)."""
    for L in (276, 272):
        plan = _build.attention_bwd_plan(64, L, 12, 64, False)
        assert (plan.smem, plan.dbias_chunks, plan.dbias_ctas,
                plan.part_bytes, plan.tma_tiles) == (94208, 0, 0, 0, False)


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_forward_plan_head_dims(hd):
    """Q, K and V tiles scale with hd, the bias and mask tiles do not (at N
    = 100, by cp.async: 100 is no multiple of 8)."""
    plan = _build.attention_fwd_plan(3, 100, 2, hd)
    assert not plan.tma_tiles
    assert plan.smem == 2 * (64 * 2 * hd + 2 * 64 * 528) + 4 * 64 * 2 * hd \
        + 1024
    assert (plan.q_tiles, plan.keys, plan.key_blocks, plan.ctas) == (
        2, 256, 1, 6)


@pytest.mark.parametrize("n_tok,keys,blocks", [(1, 256, 1), (256, 256, 1),
                                               (257, 128, 3), (720, 128, 6),
                                               (1152, 128, 9)])
def test_forward_plan_key_blocks(n_tok, keys, blocks):
    plan = _build.attention_fwd_plan(1, n_tok, 1, HD)
    assert (plan.keys, plan.key_blocks) == (keys, blocks)


@pytest.mark.parametrize("hd,longest", [(16, 2432), (32, 1152), (64, 512)])
def test_forward_plan_refuses_what_does_not_fit(hd, longest):
    """The window's K and V stay in shared memory beside both warpgroups'
    tiles: 1152 tokens at hd 32 (Swin-L's 720 fit), 512 at hd 64 (one more
    token also takes the cp.async tiles' padded rows)."""
    assert _build.attention_fwd_plan(1, longest, 1, hd).smem <= 227 * 1024
    with pytest.raises(ValueError, match="do not fit"):
        _build.attention_fwd_plan(1, longest + 1, 1, hd)


@pytest.mark.parametrize("hd", [8, 48, 96, 128])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_plans_refuse_head_dims(hd, which):
    with pytest.raises(ValueError, match="head dim"):
        if which == "forward":
            _build.attention_fwd_plan(B * 64, 248, 4, hd)
        else:
            _build.attention_bwd_plan(B * 64, 248, 4, hd, False, bias=True)


@pytest.mark.parametrize("bad", [4, 12, 3 * 128 + 2])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_plans_refuse_strides_off_16_bytes(bad, which):
    strides, ptrs = _slab(B * 64, 248, 4)
    with pytest.raises(ValueError, match="multiples of 8"):
        if which == "forward":
            _build.attention_fwd_plan(B * 64, 248, 4, HD, strides + (bad,),
                                      ptrs)
        else:
            _build.attention_bwd_plan(B * 64, 248, 4, HD, False,
                                      strides + (bad,), ptrs, bias=True)


@pytest.mark.parametrize("off", [2, 8, 14])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_plans_refuse_unaligned_pointers(off, which):
    """Also the bias's and the mask's: the kernels copy their rows in
    aligned 16-byte chunks (a [nH, 245, 245] bf16 slice of heads starts
    off 16 bytes)."""
    strides, ptrs = _slab(B * 64, 245, 4)
    bias = torch.empty(8, 245, 245, dtype=torch.bfloat16)[1:5]
    assert bias.is_contiguous() and bias.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        if which == "forward":
            _build.attention_fwd_plan(B * 64, 245, 4, HD, strides,
                                      ptrs + (ptrs[0] + off,))
        else:
            _build.attention_bwd_plan(B * 64, 245, 4, HD, False, strides,
                                      ptrs + (bias.data_ptr(),), bias=True)


@pytest.mark.parametrize("n_tok", [0, 65536])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_plans_refuse_lengths(n_tok, which):
    with pytest.raises(ValueError, match="tokens"):
        if which == "forward":
            _build.attention_fwd_plan(1, n_tok, 1, HD)
        else:
            _build.attention_bwd_plan(1, n_tok, 1, HD, False, bias=True)


def test_backward_bias_plan_refuses_more_key_tiles_than_resident_ctas():
    """Every key tile of a window must be resident at once (two CTAs an
    SM): 264 tiles on 132 SMs, fewer on fewer."""
    L = 2 * _build.H100_SMS * 64
    assert _build.attention_bwd_plan(1, L, 1, HD, False,
                                     bias=True).tiles == L // 64
    with pytest.raises(ValueError, match="key tiles"):
        _build.attention_bwd_plan(1, L + 1, 1, HD, False, bias=True)
    with pytest.raises(ValueError, match="key tiles"):
        _build.attention_bwd_plan(8, 720, 6, HD, False, sms=5, bias=True)


def test_backward_bias_plan_refuses_an_f32_mask():
    with pytest.raises(ValueError, match="bf16 mask"):
        _build.attention_bwd_plan(B * 64, 248, 4, HD, True, bias=True)
