#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lavender_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises (exit code != 0) and
nothing is ever run on the CPU instead:

1. device: a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the kernels from ``lavender_tpu_torch/csrc/`` into
   ``build/`` (skipped when the library for these sources exists);
3. kernels: every ported kernel against its plain PyTorch version on
   random inputs at the shapes the two main paths give it: the Swin-B +
   BERT-base serving forward (B=4 clips of 5 x 224 x 224, 26 text tokens,
   bf16) and the retrieval-MLM train step (B=8 clips, 64 pairs, bf16
   autocast over f32 weights); with times of the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call; for the blocks that end in a residual (K1, K3) also the block's
   output minus its input, so that an error in the attention or MLP is
   not hidden under the O(1) residual; for K8b dq, dk, dv and dbias each;
   the BERT train kernels with dropout on and the same seed on both sides
   (K10a at rate 0.1 and 0.5, K10b's dq, dk and dv each, K11's and K12's
   keep masks exactly equal), on a key mask with padded captions; K6 (the
   sub-block under a full mask) and K7 (the heads-layout core) at the
   seq2seq forward's B=4, L=275 under the seq2seq mask and a random 0/1
   mask, K6 also at the re-encode decoder's first and last L (252, 270);
   K4 and K5 at the KV decoder's prefill (L=250) and K5 at its step (M=8
   rows); K8b's and K7's one-call counterparts are
   scaled_dot_product_attention's backward with a bias that requires
   grad and its forward with the additive mask; K14 (the spatial Swin
   block, whole and attention half, also minus its residual) and K15
   (the per-window attention, its yardstick SDPA with bias + shift mask
   as one additive mask) at the four Swin-B stages at B=4 and B=8,
   shifted and unshifted; K17 (the uint8 patch embed) on the B=4 and
   B=8 clips, its yardstick F.conv3d on the padded normalized bf16 clip;
   K16 (the shifted wm block with the shift inside) at Swin-B stage 3,
   B=4 and B=8, also minus its residual, its output's pad rows exactly 0;
4. serving slice: Swin-B + BERT-base with seeded random weights answers 3
   requests of 4 uint8 clips; checks the logits' shape and finiteness,
   that each kernel was launched the expected number of times, and the
   kernel path's logits against the plain path's (the same server inside
   ``plain_path()``); prints clips/s; then the same model in eval() mode
   under autograd: one request's loss and every gradient, kernel path
   against plain path (K1, K2, K3, K4, K5 pass their gradients on);
5. train slice: ``create_train_state`` + ``make_train_step`` on the
   default ``ModelConfig()`` (Swin-B + BERT-base, the fusion encoder on
   its default train route ``fused_attn_train=True``: K10a/K10b + K11),
   B=8 clips and 26 tokens: (a) one step's loss and gradients through the
   kernels against the plain path under the same dropout and drop-path
   masks; (b) the launch counts of one step; (c) ten steps on one batch at
   a constant LR of 1e-4 on both paths, each loss finite and the loss down
   by at least 1 nat; (d) step time, train clips/s and peak memory of both
   paths and of the module-math route (``fused_attn_train=False``), in
   turns; (e) ``fused_ffn_train=True``: one step's loss and gradients,
   kernels vs plain, and the launch counts of one step (K12 12 times);
   (f) dropout and drop-path 0 on the same weights: the default route
   against the module-math route, loss and gradients;
6. captioning, on the phase-4 server and on ModelConfig(): (a) the
   seq2seq serving forward (B=4 clips, 25 text tokens) against the plain
   path, K6 in every layer and no K4; (b) ``make_generate_fn``, greedy,
   20 tokens, its logits at each of the 19 steps against the re-encode
   decoder teacher-forced on its tokens (kernel and plain path), its
   tokens against the plain re-encode decoder's wherever the top-1/top-2
   gap is more than twice the gate, the launches of the KV decode (K4 and
   K5 in the prefill, K5 per step) and of the re-encode (K6 per step), ms
   per generated token of both decoders; (c) the caption train step
   (``make_caption_loss_fn``, B=8, ``caption_masking``): loss and gradients
   kernels vs plain, launches (K10a/K10b/K11 under the seq2seq mask), ten
   steps on one batch lowering the loss >= 1 nat on both paths, step time;
7. the spatial Swin routes: (b) serving under ``attn_impl="fused"`` (K14)
   and ``"pallas"`` (K15), 3 requests of B=4 each against the plain path,
   the launch counts, clips/s beside the window-major route's, in turns;
   (c) the ``remat=True`` train step on ModelConfig() (Swin-B + remat:
   the wm route falls back to K14 everywhere, each block pair recomputed),
   B=8: loss and gradients kernels vs plain, launches, ten steps lowering
   the loss >= 1 nat, step time and peak memory beside the default
   step's and beside remat with ``BertConfig.remat`` too; each serving
   route's device-busy share under torch.profiler;
8. the JAX switches' routes (the port's ``_FOLDCACHE`` / ``_PEK`` /
   ``_IKS``): (a) the fold cache's logits (the default, phase 4's route)
   against the uncached, unfolded ones; no fingerprint on an unchanged
   model; ``load_state_dict`` of new weights into the built server, whose
   next request must equal a fresh server's; (b) serving under ``_PEK``
   (K17 once a forward) and ``_IKS`` (K16 9x, K1 15x, K2 4x, K9 9x), 3
   requests of B=4 each against the plain path, launches, clips/s beside
   the default route in turns, each route's device-busy share; (c) the
   ``_IKS`` train step on ModelConfig(): loss and gradients kernels vs
   plain, launches, ten steps lowering the loss >= 1 nat, step time beside
   the default step's; (d) K16 against the K2 + K1 attention half + K2^-1
   composition it replaces, at stage 3, B=4 and B=8, in turns.

The last lines: the card's name and power limit, then a JSON line of the
kernels (per kernel: launches in the phase-4, phase-5 (b), the checked
phase-6, phase-7 and phase-8 runs, K12's in 5 (e); its largest error in
phase 3;
``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms``, each the time per
call x its calls in one serving forward plus one train step plus one
seq2seq forward (K7: as if in each of its 12 layers) plus the text part
of one KV decode (K4 and K5 in the prefill, K5 in the 19 steps) plus one
"fused" and one "pallas" serving forward and one remat train step (K14,
K15) plus one ``_PEK`` serving forward (K17) and one ``_IKS`` serving
forward and train step (K16), summed over the shapes;
``bound_ms`` is the larger of the bytes over 3.35 TB/s and the FLOPs over
989 TFLOP/s), then the device line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

BATCH, FRAMES, SIZE, TXT_LEN = 4, 5, 224, 26
TRAIN_BATCH = 8
# captioning: 25 text tokens (L = 250 + 25), GenerateConfig()'s 20 (its
# re-encode decoder runs L = 250 + 2 .. 250 + 20), and
# the BERT-base uncased vocabulary's special tokens
CAP_LEN = 25
GEN_LEN = 20
CLS_ID, SEP_ID, PAD_ID, MASK_ID = 101, 102, 0, 103
N_REQUESTS = 3
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its FLOPs over the bf16
# tensor-core rate, each input read once and each output written once
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
# bf16 kernel vs plain version: both round to bf16, at different points
# (the kernels keep the GEMM epilogues and the softmax in f32).  A residual
# sum that cancels keeps the rounding error of its summands, so the bound
# scales with the tensor's magnitude rather than the element's:
#   max|k - p| <= TOL * max(1, max|p|)  and  ||k - p|| / ||p|| <= REL_L2
TOL, REL_L2 = 2e-2, 1e-2
# the residual-free part (block output - input) of K1 and K3: the output's
# bf16 rounding (~2^-9 of an O(1) residual) is now measured against the
# smaller branch, so the bound is looser; a dropped or misplaced rel-pos
# bias, mask or head gives O(1) relative errors here
DELTA_REL_L2 = 5e-2
# K8b's and K10b's gradients sum N = 248 / 276 bf16-rounded products per
# entry (dbias over up to 512 sequences more), and both sides round P and
# dS to bf16 at other points: relative L2 per gradient
GRAD_REL_L2 = 5e-2
# the whole forward: 24 Swin blocks + 12 BERT layers of such differences
SLICE_TOL, SLICE_REL_L2 = 5e-2, 5e-2
# one train step, kernel vs plain path under the same masks: the backward
# doubles the depth of bf16 rounding of the forward (logits rel_l2 ~1.3e-2
# in phase 4)
LOSS_TOL, STEP_GRAD_REL_L2 = 2e-2, 1e-1
TRAIN_STEPS, TRAIN_LR, MIN_LOSS_DROP = 10, 1e-4, 1.0
TRUE_ID, FALSE_ID = 2081, 6270  # bench.py --train's "true" / "false" ids
# Swin-B at T=5, 224 x 224: (stage, windows nW, C, heads, map side, block
# pairs); the window (5, 7, 7) holds N = 245 tokens, padded to Npad = 248
SWIN_STAGES = ((1, 64, 128, 4, 56, 1), (2, 16, 256, 8, 28, 1),
               (3, 4, 512, 16, 14, 9), (4, 1, 1024, 32, 7, 1))


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _compare(got, want, tol, rel_l2_max):
    """(max_abs_err, rel_l2, within tolerance) of got against want."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = max(1.0, float(want.abs().max()))
    rel_l2 = float(err.norm() / want.norm().clamp_min(1e-30))
    max_err = float(err.max())
    ok = (bool(torch.isfinite(got).all()) and max_err <= tol * scale
          and rel_l2 <= rel_l2_max)
    return max_err, rel_l2, ok


@dataclasses.dataclass
class Case:
    """One shape of one kernel: called ``count`` times in one serving
    forward, one train step, one seq2seq forward, one KV decode, one
    "fused" and one "pallas" serving forward and one remat train step
    together (0: checked only); ``flops`` and ``bytes`` of one call."""
    op: object
    name: str
    count: int
    args: tuple
    flops: float
    bytes: float
    kw: dict = dataclasses.field(default_factory=dict)
    valid: tuple = ()
    residual: Optional[torch.Tensor] = None
    library: Optional[Callable] = None
    compare: Optional[Callable] = None


def _rnd(g, *shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)


def _core_compare(C):
    """K8b: dq, dk, dv and dbias each against the plain version's."""
    def compare(got, want):
        (dq_k, db_k), (dq_p, db_p) = got, want
        rows, parts = slice(0, 245), []
        for i, nm in enumerate(("dq", "dk", "dv")):
            sl = slice(i * C, (i + 1) * C)
            parts.append((nm, dq_k[:, :, rows, sl], dq_p[:, :, rows, sl]))
        parts.append(("dbias", db_k[:, :245, :245], db_p[:, :245, :245]))
        results = [(nm, *_compare(a, b, TOL, GRAD_REL_L2))
                   for nm, a, b in parts]
        detail = ", ".join(f"{nm} {e:.3g}/{r:.3g}"
                           for nm, e, r, _ in results)
        return (max(e for _, e, _, _ in results),
                max(r for _, _, r, _ in results),
                all(ok for *_, ok in results),
                f" (max_abs/rel_l2: {detail}; rel_l2 <= {GRAD_REL_L2})")
    return compare


def _sdpa_bias_backward(qkv_heads, bias, mask, dout, B, nW, nH, hd):
    """K8b's one-call counterpart: the backward of
    scaled_dot_product_attention with a float attn_mask built from the
    rel-pos bias [nH, N, N] (+ the shift mask per window) that requires
    grad, giving dq, dk, dv and the bias gradient summed over sequences."""
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_(True) for t in (*qkv_heads, bias)]
    full = leaves[3][None].expand(B * nW, -1, -1, -1)
    if mask is not None:
        full = (full.reshape(B, nW, nH, *bias.shape[1:])
                + mask[None, :, None]).reshape(B * nW, nH, *bias.shape[1:])
    o = F.scaled_dot_product_attention(*leaves[:3],
                                       attn_mask=full.contiguous(),
                                       scale=hd ** -0.5)
    d_heads = dout.view(B * nW, -1, nH, hd).transpose(1, 2)
    return lambda: torch.autograd.grad(o, leaves, d_heads,
                                       retain_graph=True)


def _seq2seq_keep(batch: int, n_video: int, n_txt: int):
    """The captioning mask [B, L, L] (1 = attend): every row sees the
    video, the text rows see the text causally."""
    L = n_video + n_txt
    keep = torch.zeros(batch, L, L, dtype=torch.bool, device="cuda")
    keep[:, :, :n_video] = True
    keep[:, n_video:, n_video:] = torch.ones(
        n_txt, n_txt, dtype=torch.bool, device="cuda").tril()
    return keep


def _full_mask_cases(g, lin, ln):
    """K6 and K7 at the seq2seq serving forward's shapes (B=4, L = 250 +
    25): the seq2seq mask as the model passes it (f32, 0 / finfo.min) and
    a random 0/1 mask with at least one open key per row; inputs std 1.
    K6 runs 12 times per seq2seq forward; K7 lies on no model path and is
    counted as if it ran in each of the 12 layers."""
    import torch.nn.functional as F

    from lavender_tpu_torch.ops.encoder_attention import (
        fused_bert_attn_block, fused_encoder_attention)

    C, nH, n_txt = 768, 12, CAP_LEN
    hd, L = C // nH, FRAMES * 50 + n_txt
    x = _rnd(g, BATCH, L, C)
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (lin(C, C) for _ in range(4))
    lw, lb = ln(C)
    q, k, v = (_rnd(g, BATCH, nH, L, hd) for _ in range(3))
    random_keep = torch.rand(BATCH, L, L, generator=g, device="cuda") < 0.5
    random_keep[:, :, 0] = True  # at least one open key per row
    cases = []
    n_video = L - n_txt

    def block_case(x, mask, kind, count):
        B, Lx, _ = x.shape
        return Case(
            fused_bert_attn_block, f"B={B} L={Lx} C={C} nH={nH}, {kind}",
            count, (x, wq, wk, wv, bq, bk, bv, wo, bo, lw, lb, mask, nH,
                    hd ** -0.5, 1e-12),
            8.0 * B * Lx * C * C + 4.0 * B * Lx * Lx * C,
            2 * B * Lx * C * 2 + 4 * C * C * 2 + mask.numel() * 4)

    for kind, keep, count in (
            ("seq2seq mask", _seq2seq_keep(BATCH, n_video, n_txt), 12),
            ("random 0/1 mask", random_keep, 0)):
        mask = torch.where(keep, 0.0, torch.finfo(torch.float32).min)
        mask_bytes = mask.numel() * 4
        cases.append(block_case(x, mask, kind, count))
        sdpa_mask = mask.clamp_min(-1e4)[:, None].to(torch.bfloat16)
        cases.append(Case(
            fused_encoder_attention, f"B={BATCH} nH={nH} L={L} hd={hd}, "
            f"{kind}", count, (q, k, v, mask, hd ** -0.5),
            4.0 * BATCH * nH * L * L * hd, 4 * q.numel() * 2 + mask_bytes,
            library=lambda m=sdpa_mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, scale=hd ** -0.5)))
    # the re-encode decoder's first and last steps: [video; text; MASK] of
    # 2 and GEN_LEN tokens, neither a multiple of 8 long (checked, not
    # timed into the kernels line)
    for n in (2, GEN_LEN):
        keep = _seq2seq_keep(BATCH, n_video, n)
        mask = torch.where(keep, 0.0, torch.finfo(torch.float32).min)
        cases.append(block_case(_rnd(g, BATCH, n_video + n, C), mask,
                                "seq2seq mask, re-encode step", 0))
    return cases


def _kernel_cases(g):
    """Every distinct shape the serving forward (B=4), the train step
    (B=8), the seq2seq forward and the caption decoders (B=4) give the
    kernels."""
    import torch.nn.functional as F

    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.encoder_attention import (
        fused_bert_attn_block_kmask)
    from lavender_tpu_torch.ops.fused_mlp import (
        fused_ffn_post_ln, fused_ln_mlp, fused_ln_mlp_chunked)
    from lavender_tpu_torch.ops.swin_block_attn import (
        fused_swin_block_wm, pad_window_mask, rel_pos_bias_wm)
    from lavender_tpu_torch.ops.swin_core_attn import (
        swin_core_attn, swin_core_attn_bwd)
    from lavender_tpu_torch.ops.wm_permute import shift_index, wm_shift_rows

    window, shift, N, Npad = (5, 7, 7), (0, 3, 3), 245, 248

    def lin(n_out, n_in):  # fan-in scaled weight + small bias
        return _rnd(g, n_out, n_in, std=n_in ** -0.5), _rnd(g, n_out, std=0.02)

    def ln(c):
        return 1.0 + _rnd(g, c, std=0.1), _rnd(g, c, std=0.1)

    x_rows = (slice(None), slice(None), slice(0, N))  # valid rows only
    cases = []
    for stage, nW, C, nH, side, n_blocks in SWIN_STAGES:
        hd = C // nH
        # std 1: a bias the size of the q.k scores, so that a kernel that
        # drops it or reads another head's fails the comparison
        table = _rnd(g, 15 * 13 * 13, nH, std=1.0)
        bias = rel_pos_bias_wm(table, relative_position_index((8, 7, 7)), N,
                               Npad, torch.bfloat16)
        wqkv, bqkv = lin(3 * C, C)
        wproj, bproj = lin(C, C)
        n1w, n1b = ln(C)
        n2w, n2b = ln(C)
        w1, b1 = lin(4 * C, C)
        w2, b2 = lin(C, 4 * C)
        mlp = (n2w, n2b, w1, b1, w2, b2)
        shifted = stage < 4  # 7x7 stage-4 windows cover the map: no shift
        masks = [None]
        if shifted:
            m = compute_shift_mask(5, side, side, window, shift)
            masks.append(pad_window_mask(torch.as_tensor(m, device="cuda"),
                                         Npad).to(torch.bfloat16))
        w_bytes = (4 * C * C + 4 * C) * 2
        mlp_bytes = (8 * C * C + 7 * C) * 2
        for B, train in ((BATCH, False), (TRAIN_BATCH, True)):
            M = B * nW * Npad
            x = _rnd(g, B, nW, Npad, C)
            core_flops = 4.0 * B * nW * nH * Npad * Npad * hd
            for mask in masks:
                blocks = n_blocks if shifted else 2 * n_blocks
                mask_bytes = 0 if mask is None else mask.numel() * 2
                kind = "shifted" if mask is not None else "unshifted"
                # K1: the whole block in serving (stages 1-3), the
                # attention half in training and at serving stage 4
                with_mlp = stage < 4 and not train
                args = (x, n1w, n1b, wqkv, bqkv, wproj, bproj, bias, mask, nH,
                        hd ** -0.5, 1e-5)
                flops = 2.0 * M * C * 4 * C + core_flops + (
                    16.0 * M * C * C if with_mlp else 0.0)
                nbytes = 2 * M * C * 2 + w_bytes + bias.numel() * 2 + (
                    mask_bytes + (mlp_bytes if with_mlp else 0))
                cases.append(Case(
                    fused_swin_block_wm, f"B={B} stage {stage} C={C} nH={nH} "
                    f"{kind}" + (" +MLP" if with_mlp else " attention half"),
                    blocks, args, flops, nbytes,
                    kw={"mlp": mlp} if with_mlp else {}, valid=x_rows,
                    residual=x))
                if not train:
                    continue
                # K8a / K8b on the qkv slab of the backward's recompute
                qkv = _rnd(g, B, nW, Npad, 3 * C)
                qkv_bytes = qkv.numel() * 2
                sdpa_q, sdpa_k, sdpa_v = qkv.view(B * nW, Npad, 3, nH, hd
                                                  ).permute(2, 0, 3, 1, 4)
                full_mask = bias[None].expand(B * nW, nH, Npad, Npad)
                if mask is not None:
                    full_mask = (full_mask.view(B, nW, nH, Npad, Npad)
                                 + mask[None, :, None]).view_as(full_mask)
                full_mask = full_mask.contiguous()
                cases.append(Case(
                    swin_core_attn, f"B={B} stage {stage} C={C} nH={nH} "
                    f"{kind}", blocks, (qkv, bias, mask, nH, hd ** -0.5),
                    core_flops, qkv_bytes * 4 // 3 + bias.numel() * 2
                    + mask_bytes + M * nH * 4, valid=x_rows,
                    library=lambda q=sdpa_q, k=sdpa_k, v=sdpa_v, m=full_mask,
                    s=hd ** -0.5: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=m, scale=s)))
                lse = torch.empty(B * nW, nH, Npad, device="cuda")
                _build.attention(qkv.view(-1, 3 * C), B * nW, Npad, nH,
                                 hd ** -0.5, bias=bias, mask=mask, lse=lse)
                dout = _rnd(g, B, nW, Npad, C)
                dout[:, :, N:] = 0.0  # the recompute's pad rows: identity
                cases.append(Case(
                    swin_core_attn_bwd, f"B={B} stage {stage} C={C} nH={nH} "
                    f"{kind}", blocks, (qkv, lse, dout, bias, mask, nH,
                                        hd ** -0.5),
                    2.5 * core_flops, 2 * qkv_bytes + M * C * 2
                    + M * nH * 4 + bias.numel() * 6 + mask_bytes,
                    compare=_core_compare(C),
                    library=_sdpa_bias_backward(
                        (sdpa_q, sdpa_k, sdpa_v), bias, mask, dout, B, nW,
                        nH, hd)))
            rows = x.reshape(-1, C)
            if train:  # K9: the MLP of every train block, no residual
                cases.append(Case(
                    fused_ln_mlp, f"B={B} stage {stage} M={M} C={C} "
                    f"HD={4 * C}", 2 * n_blocks, (rows, *mlp, 1e-5),
                    16.0 * M * C * C, 2 * M * C * 2 + mlp_bytes))
            elif stage == 4:  # K3: the stage-4 serving MLP + residual
                cases.append(Case(
                    fused_ln_mlp_chunked, f"B={B} stage 4 M={M} C={C} "
                    f"HD={4 * C}", 2, (rows, *mlp, 1e-5), 16.0 * M * C * C,
                    2 * M * C * 2 + mlp_bytes, residual=rows))
            if not shifted:
                continue
            # K2: serving shifts a bf16 stream; training an f32 one (the
            # residual stream under autocast) in both directions of the
            # forward and again in the backward
            dt = torch.float32 if train else torch.bfloat16
            t = _rnd(g, B, nW, Npad, C, dtype=dt)
            for inverse in (False, True):
                idx = torch.as_tensor(shift_index(
                    window, 5, side, side, Npad, shift, inverse),
                    device="cuda")
                inv = torch.as_tensor(shift_index(
                    window, 5, side, side, Npad, shift, not inverse),
                    device="cuda")
                rows_idx = idx.clamp(min=0).long()
                src = t.view(B, nW * Npad, C)
                cases.append(Case(
                    wm_shift_rows, f"B={B} stage {stage} C={C} {dt} "
                    + ("inverse" if inverse else "forward"),
                    n_blocks * (2 if train else 1), (t, idx, inv),
                    0.0, 2 * t.numel() * t.element_size() + idx.numel() * 4,
                    library=lambda s=src, i=rows_idx: s.index_select(1, i)))

    C, nH, L = 768, 12, FRAMES * 50 + TXT_LEN
    x = _rnd(g, BATCH, L, C)
    keep = torch.ones(BATCH, L, dtype=torch.bool, device="cuda")
    for i, n_txt in zip(range(BATCH), (26, 20, 12, 5)):  # padded tails
        keep[i, L - TXT_LEN + n_txt:] = False
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (lin(C, C) for _ in range(4))
    lw, lb = ln(C)
    M = BATCH * L
    cases.append(Case(
        fused_bert_attn_block_kmask, f"B={BATCH} L={L} C={C} nH={nH}, padded "
        "keys", 12, (x, wq, wk, wv, bq, bk, bv, wo, bo, lw, lb, keep, nH,
                     (C // nH) ** -0.5, 1e-12),
        8.0 * M * C * C + 4.0 * BATCH * L * L * C,
        2 * M * C * 2 + 4 * C * C * 2 + BATCH * L))
    w1, b1 = lin(3072, C)
    w2, b2 = lin(C, 3072)
    cases.append(Case(
        fused_ffn_post_ln, f"M={M} C={C} HD=3072", 12,
        (x.reshape(-1, C), w1, b1, w2, b2, lw, lb, 1e-12),
        4.0 * M * C * 3072, 2 * M * C * 2 + 2 * C * 3072 * 2))
    # the KV decoder of 4 clips (phase 6 (b)): the prefill runs K4 and K5
    # over the 250 video tokens (every key open), each of the 19 steps K5
    # over 2 rows a clip
    Lp, n_steps = FRAMES * 50, GEN_LEN - 1
    xp = _rnd(g, BATCH, Lp, C)
    cases.append(Case(
        fused_bert_attn_block_kmask, f"B={BATCH} L={Lp} C={C} nH={nH}, "
        "prefill (all keys open)", 12,
        (xp, wq, wk, wv, bq, bk, bv, wo, bo, lw, lb,
         torch.ones(BATCH, Lp, dtype=torch.bool, device="cuda"), nH,
         (C // nH) ** -0.5, 1e-12),
        8.0 * BATCH * Lp * C * C + 4.0 * BATCH * Lp * Lp * C,
        2 * BATCH * Lp * C * 2 + 4 * C * C * 2 + BATCH * Lp))
    for rows, count, what in ((BATCH * Lp, 12, "prefill"),
                              (2 * BATCH, 12 * n_steps, "decode step")):
        xr = _rnd(g, rows, C)
        cases.append(Case(
            fused_ffn_post_ln, f"M={rows} C={C} HD=3072, {what}", count,
            (xr, w1, b1, w2, b2, lw, lb, 1e-12), 4.0 * rows * C * 3072,
            2 * rows * C * 2 + 2 * C * 3072 * 2))
    cases += _full_mask_cases(g, lin, ln)
    cases += _bert_train_cases(g, lin, ln)
    cases += _spatial_cases(g, lin, ln)
    cases += _route_cases(g, lin, ln)
    return cases


def _shifted_compare(x, N):
    """K16: the valid rows within the kernel gate, their residual-free part
    within DELTA_REL_L2, and the kernel's pad rows exactly 0."""
    def compare(got, want):
        v = (slice(None), slice(None), slice(0, N))
        err, rel, ok = _compare(got[v], want[v], TOL, REL_L2)
        r = x[v].float()
        d_got, d_want = got[v].float() - r, want[v].float() - r
        d_rel = float((d_got - d_want).norm() / d_want.norm())
        pad = float(got[:, :, N:].float().abs().max())
        ok = ok and d_rel <= DELTA_REL_L2 and pad == 0.0
        return err, rel, ok, (f", minus residual rel_l2 {d_rel:.3g} (<= "
                              f"{DELTA_REL_L2}), pad rows max|k| {pad} (== 0)")
    return compare


def _stage3_block(g, lin, ln):
    """Swin-B stage 3's shifted-block operands: x [B, 4, 248, 512] per
    batch size, the block's parameters, rel-pos bias and padded shift mask,
    and the statics."""
    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops.swin_block_attn import (
        pad_window_mask, rel_pos_bias_wm)

    _, nW, C, nH, side, n_blocks = SWIN_STAGES[2]
    window, shift, N, Npad = (5, 7, 7), (0, 3, 3), 245, 248
    table = _rnd(g, 15 * 13 * 13, nH, std=1.0)
    bias = rel_pos_bias_wm(table, relative_position_index((8, 7, 7)), N,
                           Npad, torch.bfloat16)
    mask = pad_window_mask(torch.as_tensor(compute_shift_mask(
        FRAMES, side, side, window, shift), device="cuda"), Npad).to(
        torch.bfloat16)
    (wqkv, bqkv), (wproj, bproj), (n1w, n1b) = lin(3 * C, C), lin(C, C), ln(C)
    params = (n1w, n1b, wqkv, bqkv, wproj, bproj, bias, mask)
    statics = ((FRAMES, side, side), window, shift, nH, (C // nH) ** -0.5,
               1e-5)
    return params, statics, (nW, C, nH, N, Npad, n_blocks)


def _route_cases(g, lin, ln):
    """K17 on the serving clips (B=4, once in a ``_PEK`` serving forward)
    and the train step's (B=8, checked only), its yardstick F.conv3d on the
    padded, normalized bf16 clip (the normalize left out of its time); K16
    at Swin-B stage 3, B=4 and B=8 (9 blocks in a ``_IKS`` serving forward
    and in a ``_IKS`` train step), its input's pad rows random (the
    kernel reads none of them)."""
    import torch.nn.functional as F

    from lavender_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
    from lavender_tpu_torch.ops.patch_embed_u8 import fused_patch_embed_u8
    from lavender_tpu_torch.ops.swin_block_attn import (
        fused_swin_block_wm_shifted)

    cases = []
    E = 128
    weight, bias = _rnd(g, E, 3, 2, 4, 4, std=0.05), _rnd(g, E, std=0.05)
    mean = torch.tensor(IMAGENET_MEAN, device="cuda")
    std = torch.tensor(IMAGENET_STD, device="cuda")
    for B, count in ((BATCH, 1), (TRAIN_BATCH, 0)):
        x = torch.randint(0, 256, (B, FRAMES, SIZE, SIZE, 3), generator=g,
                          device="cuda", dtype=torch.uint8)
        xn = F.pad((x.float() / 255.0 - mean) / std, (0, 0, 0, 0, 0, 0, 0, 1))
        xn = xn.permute(0, 4, 1, 2, 3).contiguous().to(torch.bfloat16)
        n_out = B * FRAMES * (SIZE // 4) ** 2
        cases.append(Case(
            fused_patch_embed_u8, f"B={B} D={FRAMES} {SIZE}x{SIZE} E={E}",
            count, (x, weight, bias), 2.0 * n_out * 96 * E,
            x.numel() + n_out * E * 2 + 96 * E * 2 + FRAMES * E * 4,
            library=lambda xn=xn: F.conv3d(xn, weight, bias,
                                           stride=(1, 4, 4))))
    params, statics, (nW, C, nH, N, Npad, n_blocks) = _stage3_block(g, lin,
                                                                     ln)
    hd = C // nH
    for B in (BATCH, TRAIN_BATCH):
        x = _rnd(g, B, nW, Npad, C)
        M = B * nW * Npad
        cases.append(Case(
            fused_swin_block_wm_shifted, f"B={B} stage 3 C={C} nH={nH} "
            "shifted, shift inside", n_blocks, (x, *params, *statics),
            2.0 * M * C * 4 * C + 4.0 * B * nW * nH * Npad * Npad * hd,
            2 * M * C * 2 + (4 * C * C + 4 * C) * 2
            + (nH + nW) * Npad * Npad * 2,
            compare=_shifted_compare(x, N)))
    return cases


def _spatial_cases(g, lin, ln):
    """K14 (both variants) and K15 at the four Swin-B stages' shapes on the
    spatial layout [B, 5, side, side, C], B=4 and B=8, unshifted and (at
    stages 1-3) shifted.  Counted: the "fused" serving forward (B=4: the
    whole block at stages 1-3, the attention half at stage 4), the remat
    train step (B=8: the attention half of every block, once in the
    forward and once in its recomputation) and the "pallas" serving
    forward (B=4: K15 in every block); the other cases are checked only.
    K15's q, k, v are the strided views of one qkv product that the module
    path passes; its library yardstick is scaled_dot_product_attention
    with bias + shift mask as one additive [W, nH, N, N] mask."""
    import torch.nn.functional as F

    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops.swin_block_attn import (
        fused_swin_block_attn, fused_swin_block_full, rel_pos_bias_wm)
    from lavender_tpu_torch.ops.window_attention import (
        fused_window_attention)

    window, shift, N = (5, 7, 7), (0, 3, 3), 245
    cases = []
    for stage, nW, C, nH, side, n_pairs in SWIN_STAGES:
        hd, HD = C // nH, 4 * C
        table = _rnd(g, 15 * 13 * 13, nH, std=1.0)
        bias = rel_pos_bias_wm(table, relative_position_index((8, 7, 7)), N,
                               N, torch.bfloat16)
        (wqkv, bqkv), (wproj, bproj) = lin(3 * C, C), lin(C, C)
        (n1w, n1b), (n2w, n2b) = ln(C), ln(C)
        (w1, b1), (w2, b2) = lin(HD, C), lin(C, HD)
        mlp = (n2w, n2b, w1, b1, w2, b2)
        masks = [None]
        if stage < 4:  # stage 4's 7 x 7 map fills its window: no shift
            masks.append(torch.as_tensor(compute_shift_mask(
                5, side, side, window, shift), device="cuda"))
        w_bytes, mlp_bytes = (4 * C * C + 4 * C) * 2, (8 * C * C + 7 * C) * 2
        for B, train in ((BATCH, False), (TRAIN_BATCH, True)):
            M = B * 5 * side * side
            x = _rnd(g, B, 5, side, side, C)
            core_flops = 4.0 * B * nW * nH * N * N * hd
            qkv = _rnd(g, B * nW, N, 3, nH, hd)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)  # [B * nW, nH, N, hd] views
            for mask in masks:
                kind = "shifted" if mask is not None else "unshifted"
                # blocks of this kind in one forward
                n_kind = n_pairs if stage < 4 else 2 * n_pairs
                mask_b = None if mask is None else mask.to(torch.bfloat16)
                mask_bytes = 0 if mask is None else mask.numel() * 2
                args = (x, n1w, n1b, wqkv, bqkv, wproj, bproj, bias, mask_b)
                statics = (window, shift if mask is not None else (0, 0, 0),
                           nH, hd ** -0.5, 1e-5)
                flops = 2.0 * M * C * 4 * C + core_flops
                nbytes = 2 * M * C * 2 + w_bytes + bias.numel() * 2 + (
                    mask_bytes)
                name = f"B={B} stage {stage} C={C} nH={nH} {kind}"
                cases.append(Case(
                    fused_swin_block_full, name + " +MLP",
                    n_kind if not train and stage < 4 else 0,
                    (*args, *mlp, *statics), flops + 16.0 * M * C * C,
                    nbytes + mlp_bytes, residual=x))
                cases.append(Case(
                    fused_swin_block_attn, name + " attention half",
                    2 * n_kind if train else (n_kind if stage == 4 else 0),
                    (*args, *statics), flops, nbytes, residual=x))
                full = bias.float()[None].expand(B * nW, nH, N, N)
                if mask is not None:
                    full = (full.reshape(B, nW, nH, N, N)
                            + mask[None, :, None]).reshape(B * nW, nH, N, N)
                lib_mask = full.to(torch.bfloat16).contiguous()
                cases.append(Case(
                    fused_window_attention, f"W={B * nW} nH={nH} N={N} "
                    f"hd={hd} {kind} (B={B} stage {stage})",
                    0 if train else n_kind,
                    (q, k, v, bias, mask, hd ** -0.5), core_flops,
                    4 * B * nW * nH * N * hd * 2 + bias.numel() * 2
                    + (0 if mask is None else mask.numel() * 4),
                    library=lambda q=q, k=k, v=v, m=lib_mask, s=hd ** -0.5:
                    F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                   scale=s)))
    return cases


def _keep_compare(got, want):
    """K11 / K12: the output within the kernel gate, the keep masks
    exactly equal."""
    (out_k, keep_k), (out_p, keep_p) = got, want
    err, rel, ok = _compare(out_k, out_p, TOL, REL_L2)
    n_diff = int((keep_k != keep_p).sum())
    return (err, rel, ok and n_diff == 0,
            f" (keep masks: {n_diff} of {keep_p.numel()} differ, kept "
            f"{float(keep_p.float().mean()):.4f})")


def _grads_compare(got, want):
    """K10b: dq, dk and dv each against the plain version's."""
    results = [(nm, *_compare(a, b, TOL, GRAD_REL_L2))
               for nm, a, b in zip(("dq", "dk", "dv"), got, want)]
    detail = ", ".join(f"{nm} {e:.3g}/{r:.3g}" for nm, e, r, _ in results)
    return (max(e for _, e, _, _ in results),
            max(r for _, _, r, _ in results), all(ok for *_, ok in results),
            f" (max_abs/rel_l2: {detail}; rel_l2 <= {GRAD_REL_L2})")


def _bert_train_cases(g, lin, ln):
    """The fusion encoder's train kernels at the train step's shapes: 64
    (clip, text) pairs at L = 276, C = 768, 12 heads, dropout on (the
    same seed for kernel and plain version).  The step's own key mask
    is all ones (every caption 26 tokens), so the mask here pads some
    captions, as a batch of shorter ones would."""
    import torch.nn.functional as F

    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.encoder_attention import (
        encoder_attention_train_lanes_bwd, fused_encoder_attention_train_lanes)
    from lavender_tpu_torch.ops.fused_mlp import (
        fused_ffn_post_ln_train, fused_out_ln_train)

    B, C, nH, L = TRAIN_BATCH ** 2, 768, 12, FRAMES * 50 + TXT_LEN
    hd, M, layers = C // nH, TRAIN_BATCH ** 2 * L, 12
    scale = hd ** -0.5
    slab = _rnd(g, B, L, 3 * C)  # the model's one qkv GEMM
    q, k, v = slab.split(C, dim=-1)
    n_txt = torch.randint(5, TXT_LEN + 1, (B,), generator=g, device="cuda")
    n_txt[0] = TXT_LEN
    pad = torch.arange(L, device="cuda")[None] >= L - TXT_LEN + n_txt[:, None]
    # the model's mask after its clamp and the bf16 cast
    mask = (pad.float() * -1e4)[:, None, :].expand(B, L, L).to(
        torch.bfloat16).contiguous()
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda")
    sdpa = [t.view(B, L, nH, hd).transpose(1, 2) for t in (q, k, v)]
    sdpa_mask = mask[:, None]
    core_flops = 4.0 * B * nH * L * L * hd
    slab_bytes, mask_bytes, lse_bytes = B * L * C * 2, mask.numel() * 2, (
        B * nH * L * 4)
    cases = []
    for rate, count in ((0.1, layers), (0.5, 0)):
        cases.append(Case(
            fused_encoder_attention_train_lanes, f"B={B} L={L} C={C} "
            f"nH={nH} rate {rate}, padded keys", count,
            (q, k, v, mask, seed, scale, rate, nH), core_flops,
            4 * slab_bytes + mask_bytes + lse_bytes,
            library=lambda r=rate: F.scaled_dot_product_attention(
                *sdpa, attn_mask=sdpa_mask, dropout_p=r, scale=scale)))
    lse = torch.empty(B, nH, L, device="cuda")
    _build.attention(slab.view(B * L, 3 * C), B, L, nH, scale, mask=mask,
                     lse=lse, seed=seed, rate=0.1)
    dout = _rnd(g, B, L, C)
    # SDPA's backward alone: autograd of one forward, replayed
    leaves = [t.detach().requires_grad_(True) for t in sdpa]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask,
                                       dropout_p=0.1, scale=scale)
    d_heads = dout.view(B, L, nH, hd).transpose(1, 2)
    cases.append(Case(
        encoder_attention_train_lanes_bwd, f"B={B} L={L} C={C} nH={nH} "
        "rate 0.1, padded keys", layers,
        (q, k, v, mask, seed, dout, scale, 0.1, nH), 2.5 * core_flops,
        7 * slab_bytes + mask_bytes + lse_bytes, kw={"lse": lse},
        compare=_grads_compare,
        library=lambda: torch.autograd.grad(o, leaves, d_heads,
                                            retain_graph=True)))
    x, res = _rnd(g, M, C), _rnd(g, M, C)
    wo, bo = lin(C, C)
    lw, lb = ln(C)
    cases.append(Case(
        fused_out_ln_train, f"M={M} C={C} rate 0.1", layers,
        (x, res, wo, bo, lw, lb, seed, 1e-12, 0.1), 2.0 * M * C * C,
        3 * M * C * 2 + M * C + C * C * 2, compare=_keep_compare))
    w1, b1 = lin(3072, C)
    w2, b2 = lin(C, 3072)
    cases.append(Case(
        fused_ffn_post_ln_train, f"M={M} C={C} HD=3072 rate 0.1", layers,
        (x, w1, b1, w2, b2, lw, lb, seed, 1e-12, 0.1), 4.0 * M * C * 3072,
        2 * M * C * 2 + M * C + 2 * C * 3072 * 2, compare=_keep_compare))
    return cases


def _bert_core_vs_sdpa(g):
    """K4's attention core alone (the part one PyTorch call computes) at
    the serving shape: the port's core vs scaled_dot_product_attention
    with the same key-padding mask.  Returns (kernel ms, SDPA ms)."""
    import torch.nn.functional as F

    from lavender_tpu_torch.ops import _build

    C, nH, L = 768, 12, FRAMES * 50 + TXT_LEN
    qkv = _rnd(g, BATCH * L, 3 * C)
    keep = torch.ones(BATCH, L, dtype=torch.bool, device="cuda")
    keep[1:, L - 10:] = False
    q, k, v = qkv.view(BATCH, L, 3, nH, C // nH).permute(2, 0, 3, 1, 4)
    m = keep[:, None, None, :]
    ms = [_time_ms(lambda: _build.attention(qkv, BATCH, L, nH,
                                            (C // nH) ** -0.5, keep=keep)),
          _time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=m))]
    return ms[0], ms[1]


def check_kernels():
    """Phase 3: each kernel vs its plain version; returns per-kernel
    {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound by bytes
    time / FLOP time} summed over the calls of ``Case.count``."""
    g = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {}
    for c in _kernel_cases(g):
        got = c.op(*c.args, **c.kw)
        want = c.op.plain(*c.args, **c.kw)
        torch.cuda.synchronize()
        if c.compare is not None:
            err, rel, ok, branch = c.compare(got, want)
        else:
            v = c.valid
            err, rel, ok = _compare(got[v], want[v], TOL, REL_L2)
            branch = ""
            if c.residual is not None:  # the block's own contribution
                r = c.residual[v].float()
                d_got, d_want = got[v].float() - r, want[v].float() - r
                d_rel = float((d_got - d_want).norm() / d_want.norm())
                ok = ok and d_rel <= DELTA_REL_L2
                branch = (f", minus residual rel_l2 {d_rel:.3g} "
                          f"(<= {DELTA_REL_L2})")
        del got, want
        # plain, kernel, kernel, plain: drift cancels in the means
        t_p1 = _time_ms(lambda: c.op.plain(*c.args, **c.kw))
        t_k1 = _time_ms(lambda: c.op(*c.args, **c.kw))
        t_k2 = _time_ms(lambda: c.op(*c.args, **c.kw))
        t_p2 = _time_ms(lambda: c.op.plain(*c.args, **c.kw))
        ms, plain_ms = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
        lib_ms = None if c.library is None else _time_ms(c.library)
        t_bytes = c.bytes / HBM_BYTES_PER_S * 1e3
        t_flops = c.flops / BF16_FLOPS * 1e3
        bound = max(t_bytes, t_flops)
        lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        print(f"[kernel] {c.op.name} {c.name}: max_abs_err {err:.4g} rel_l2 "
              f"{rel:.3g} (tol {TOL} max(1,max|ref|), {REL_L2}){branch}; "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms{lib}, bound "
              f"{bound:.4f} ms ({'bytes' if t_bytes >= t_flops else 'FLOPs'})"
              f", x{c.count} in the counted runs", flush=True)
        if not ok:
            raise AssertionError(f"{c.op.name} {c.name}: kernel disagrees "
                                 f"with its plain version (max_abs_err {err})")
        k = per_kernel.setdefault(c.op, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": None, "bound_ms": 0.0, "t_bytes": 0.0,
            "t_flops": 0.0})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["ms"] += c.count * ms
        k["plain_ms"] += c.count * plain_ms
        k["bound_ms"] += c.count * bound
        k["t_bytes"] += c.count * t_bytes
        k["t_flops"] += c.count * t_flops
        if lib_ms is not None:
            k["library_ms"] = (k["library_ms"] or 0.0) + c.count * lib_ms
    core_ms, sdpa_ms = _bert_core_vs_sdpa(g)
    print(f"[kernel] K4's attention core alone, B={BATCH} L=276 (kernel "
          f"core vs scaled_dot_product_attention): {core_ms:.4f} ms vs "
          f"{sdpa_ms:.4f} ms per call", flush=True)
    return per_kernel


def _reset(ops):
    torch.cuda.synchronize()
    for op in ops:
        op.launches = 0


def _check_counts(ops, expected, runs, label):
    torch.cuda.synchronize()
    counts = {op: op.launches for op in ops}
    for op in ops:
        want = expected.get(op, 0) * runs
        print(f"[{label}] {op.name}: {counts[op]} launches in {runs} "
              f"run(s) (expected {expected.get(op, 0)} per run)", flush=True)
        if counts[op] != want:
            raise AssertionError(f"{op.name} launched {counts[op]} times, "
                                 f"expected {want}")
    return counts


def _shifted_blocks(swin) -> int:
    """Blocks that sit between a shift and its inverse: the second of each
    pair at every stage whose map is larger than the window (stage 4's
    7 x 7 map at 224 x 224 fills its window, so it is not shifted)."""
    side, n = SIZE // 4, 0
    for i, depth in enumerate(swin.depths):
        if side > swin.window_size[1]:
            n += depth // 2
        side = (side + 1) // 2
    return n


def _video_counts(ops, cfg):
    """Launches of one Swin-B pass over B clips in serving (go_feat)."""
    from lavender_tpu_torch.ops.swin_block_attn import mlp_in_block

    s = cfg.swin
    return {ops["K1"]: sum(s.depths), ops["K2"]: 2 * _shifted_blocks(s),
            ops["K3"]: sum(d for i, d in enumerate(s.depths)
                           if not mlp_in_block(s.embed_dim * 2 ** i,
                                               int(s.embed_dim * 2 ** i
                                                   * s.mlp_ratio),
                                               s.num_heads[i], 248))}


@torch.no_grad()
def _swin_layer_norms(server, seed: int):
    """Seeded Swin LayerNorm affines (scale 1 + N(0, 0.1^2), shift
    N(0, 0.1^2)) in place of the init's 1 and 0, under which the serving
    fold would change no number; the server's guard rebuilds its cache."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for mod in server.model.enc_img.swin.modules():
        if isinstance(mod, torch.nn.LayerNorm):
            mod.weight.copy_(1.0 + _rnd(g, *mod.weight.shape, std=0.1))
            mod.bias.copy_(_rnd(g, *mod.bias.shape, std=0.1))
    return server


def build_server():
    from lavender_tpu_torch.serve import LavenderServer

    t0 = time.perf_counter()
    # the default model: Swin-B + BERT-base, full depth and width
    server = _swin_layer_norms(LavenderServer(seed=0, frames=FRAMES,
                                              size=SIZE), 10)
    server.model.build_serving_cache(FRAMES, SIZE, SIZE)
    torch.cuda.synchronize()
    print(f"[serve] server built (seeded init, bf16, serving caches) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return server


def run_serving(ops, server):
    """Phase 4: the serving forward through the kernels, with counts."""
    from lavender_tpu_torch.ops._build import plain_path

    cfg = server.config

    def plain(*request):
        with plain_path():
            return server(*request)

    rs = np.random.RandomState(0)
    requests = []
    for _ in range(N_REQUESTS):
        img = rs.randint(0, 256, (BATCH, FRAMES, SIZE, SIZE, 3)).astype(np.uint8)
        lens = rs.randint(5, TXT_LEN + 1, BATCH)
        lens[0] = TXT_LEN
        mask = (np.arange(TXT_LEN)[None] < lens[:, None]).astype(np.int64)
        txt = rs.randint(1, cfg.bert.vocab_size, (BATCH, TXT_LEN)) * mask
        requests.append((img, txt, mask))

    per_fwd = {**_video_counts(ops, cfg),
               ops["K4"]: cfg.bert.num_hidden_layers,
               ops["K5"]: cfg.bert.num_hidden_layers}
    server(*requests[0])  # warm-up: allocator, first launches
    _reset(ops.values())
    outs = [server(*r) for r in requests]
    counts = _check_counts(ops.values(), per_fwd, N_REQUESTS, "serve")
    want_shape = (BATCH, TXT_LEN, cfg.bert.vocab_size)
    for i, (out, req) in enumerate(zip(outs, requests)):
        if tuple(out.shape) != want_shape:
            raise AssertionError(f"logits {tuple(out.shape)} != {want_shape}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"request {i}: non-finite logits")
        ref = plain(*req)
        err, rel, ok = _compare(out, ref, SLICE_TOL, SLICE_REL_L2)
        print(f"[serve] request {i} (text lengths {req[2].sum(1).tolist()}): "
              f"logits {tuple(out.shape)} finite; vs plain path max_abs_err "
              f"{err:.4g} rel_l2 {rel:.3g} (tol {SLICE_TOL} max(1,max|ref|), "
              f"{SLICE_REL_L2}), max|ref| "
              f"{float(ref.float().abs().max()):.3g}", flush=True)
        if not ok:
            raise AssertionError(f"request {i}: kernel path logits disagree "
                                 "with the plain path")

    iters = 10
    for label, srv, n in (("kernels", server, iters), ("plain", plain, 3)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            srv(*requests[0])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
        print(f"[serve] {label} path: {dt * 1e3:.2f} ms per forward, "
              f"{BATCH / dt:.2f} clips/s at B={BATCH} ({_nvidia_smi()})",
              flush=True)
    print(f"[serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    _check_step("(eval-mode gradients, one request) kernels vs plain:",
                _eval_loss_and_grads(server, requests[0], False),
                _eval_loss_and_grads(server, requests[0], True),
                _grad_groups(server.model), tag="serve")
    return counts


def _eval_loss_and_grads(server, request, plain: bool):
    """The serving model in eval() mode under autograd (JAX's
    deterministic forward under jax.grad): (loss, {name: gradient}) of
    the mean log-sum-exp of one request's logits.  Every kernel of the
    serving path (K1 whole block, K2, K3, K4, K5) must pass its gradient
    on."""
    from lavender_tpu_torch.ops._build import plain_path

    model = server.model
    img, txt, mask = (torch.as_tensor(np.asarray(a), device="cuda")
                      for a in request)
    model.zero_grad(set_to_none=True)
    with plain_path(plain):
        logits = model(img, txt.long(), mask.long())
    loss = logits.float().logsumexp(-1).mean()
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _train_batch(vocab: int):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (TRAIN_BATCH, FRAMES, SIZE, SIZE, 3))
    return {"img": torch.as_tensor(img.astype(np.uint8), device="cuda"),
            "txt": torch.as_tensor(rs.randint(1, vocab, (TRAIN_BATCH,
                                                         TXT_LEN)),
                                   device="cuda"),
            "mask": torch.ones(TRAIN_BATCH, TXT_LEN, dtype=torch.long,
                               device="cuda"),
            "vid": torch.arange(TRAIN_BATCH, device="cuda")}


def _grad_groups(model):
    groups = {"swin": [], "other": [], "rel-pos tables": []}
    for name, p in model.named_parameters():
        key = ("rel-pos tables" if "relative_position_bias_table" in name
               else "swin" if "swin" in name else "other")
        groups[key].append(name)
    return groups


def _loss_and_grads(state, loss_fn, batch, plain: bool):
    """One forward + backward outside the optimizer, with a fixed dropout
    and drop-path stream: (loss, {name: gradient})."""
    from lavender_tpu_torch.ops._build import plain_path

    state.model.zero_grad(set_to_none=True)
    gen = torch.Generator("cuda").manual_seed(1234)
    with (plain_path() if plain else contextlib.nullcontext()), \
            torch.autocast("cuda", dtype=torch.bfloat16):
        loss = loss_fn(state.model, batch, gen)
    loss.backward()
    grads = {n: p.grad.detach().clone()
             for n, p in state.model.named_parameters() if p.grad is not None}
    state.model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _check_step(label, a, b, groups, tag="train"):
    """Loss within LOSS_TOL and each gradient group within STEP_GRAD_REL_L2
    of the reference (a, b: (loss, grads) of the two sides)."""
    (loss_k, grads_k), (loss_p, grads_p) = a, b
    dl = abs(loss_k - loss_p)
    print(f"[{tag}] {label} loss {loss_k:.6f} vs {loss_p:.6f}: |diff| "
          f"{dl:.4g} (<= {LOSS_TOL} max(1, |loss|))", flush=True)
    ok = np.isfinite(loss_k) and dl <= LOSS_TOL * max(1.0, abs(loss_p))
    if grads_k.keys() != grads_p.keys():
        odd = sorted(grads_k.keys() ^ grads_p.keys())
        raise AssertionError(f"{label}: the two sides give gradients to "
                             f"other params: {odd[:8]}")
    for group, names in groups.items():
        names = [n for n in names if n in grads_p]
        k = torch.cat([grads_k[n].flatten() for n in names])
        p = torch.cat([grads_p[n].flatten() for n in names])
        rel = float((k - p).norm() / p.norm().clamp_min(1e-30))
        finite = bool(torch.isfinite(k).all())
        print(f"[{tag}] {label} gradients {group} ({len(names)} tensors, "
              f"{k.numel()} values): rel_l2 {rel:.4g} (<= "
              f"{STEP_GRAD_REL_L2}), finite {finite}", flush=True)
        ok = ok and finite and rel <= STEP_GRAD_REL_L2
    if not ok:
        raise AssertionError(f"train step {label}: the two sides disagree")


def run_train(ops):
    """Phase 5: the retrieval-MLM train step through the kernels, on the
    default configuration and on the other fusion-encoder routes."""
    from lavender_tpu_torch.config import BertConfig, ModelConfig, TrainConfig
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    cfg = ModelConfig()  # the default: fused_attn_train=True (K10, K11)
    module_cfg = dataclasses.replace(
        cfg, bert=BertConfig(fused_attn_train=False))
    loss_fn = retrieval.make_loss_fn(TRUE_ID, FALSE_ID)
    batch = _train_batch(cfg.bert.vocab_size)
    t0 = time.perf_counter()
    state = create_train_state(cfg, TrainConfig(max_iter=1000,
                                                max_grad_norm=1.0), seed=0)
    step = make_train_step(loss_fn, state)
    torch.cuda.synchronize()
    print(f"[train] state built (Swin-B + BERT-base, f32 weights, AdamW, "
          f"fused_attn_train={cfg.bert.fused_attn_train}, fused_ffn_train="
          f"{cfg.bert.fused_ffn_train}) in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (a) one step's loss and gradients, kernels vs plain, same masks
    groups = _grad_groups(state.model)
    _check_step("(a) kernels vs plain:",
                _loss_and_grads(state, loss_fn, batch, False),
                _loss_and_grads(state, loss_fn, batch, True), groups)

    # (b) one step through the entry point, with launch counts
    n_shift = _shifted_blocks(cfg.swin)
    depth, layers = sum(cfg.swin.depths), cfg.bert.num_hidden_layers
    per_step = {ops["K1"]: depth, ops["K2"]: 4 * n_shift,
                ops["K8a"]: depth, ops["K8b"]: depth, ops["K9"]: depth,
                ops["K10a"]: layers, ops["K10b"]: layers,
                ops["K11"]: layers}
    _reset(ops.values())
    loss = step(batch)
    counts = _check_counts(ops.values(), per_step, 1, "train")
    print(f"[train] (b) one step: loss {float(loss):.6f}", flush=True)
    del state, step
    torch.cuda.empty_cache()

    # (c) ten steps on one batch at a constant LR on both paths, then (d)
    # their step times and the module-math route's, in turns
    const = TrainConfig(lr=TRAIN_LR, warmup_ratio=0.0, max_iter=10 ** 9,
                        max_grad_norm=1.0)
    runs = {}
    for label in ("kernels", "plain"):
        st = create_train_state(cfg, const, seed=0)
        stp = make_train_step(loss_fn, st)
        ctx = plain_path if label == "plain" else contextlib.nullcontext
        with ctx():
            losses = [float(stp(batch)) for _ in range(TRAIN_STEPS)]
        drop = losses[0] - losses[-1]
        print(f"[train] (c) {label} path, {TRAIN_STEPS} steps at lr "
              f"{TRAIN_LR}: loss {' '.join(f'{v:.4f}' for v in losses)}; "
              f"down {drop:.4f} nat (>= {MIN_LOSS_DROP})", flush=True)
        if not (all(np.isfinite(losses)) and drop >= MIN_LOSS_DROP):
            raise AssertionError(f"{label} path: the loss did not fall by "
                                 f"{MIN_LOSS_DROP} nat in {TRAIN_STEPS} steps")
        runs[label] = (stp, ctx)
    label = "kernels, fused_attn_train=False"
    stp = make_train_step(loss_fn, create_train_state(module_cfg, const,
                                                      seed=0))
    stp(batch)  # warm-up
    runs[label] = (stp, contextlib.nullcontext)
    times = {name: [] for name in runs}
    torch.cuda.reset_peak_memory_stats()
    order = list(runs)
    for name in order + order[::-1]:
        stp, ctx = runs[name]
        with ctx():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                stp(batch)
            torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / 2)
    for name, ts in times.items():
        dt = sum(ts) / len(ts)
        print(f"[train] (d) {name} path: {dt * 1e3:.2f} ms per step "
              f"({', '.join(f'{t * 1e3:.2f}' for t in ts)}), "
              f"{TRAIN_BATCH / dt:.2f} train clips/s at B={TRAIN_BATCH} "
              f"({TRAIN_BATCH ** 2} pairs) ({_nvidia_smi()})", flush=True)
    print(f"[train] (d) peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB (three "
          f"states resident)", flush=True)
    del runs, stp
    torch.cuda.empty_cache()

    # (e) fused_ffn_train=True: kernels vs plain, and K12's launches
    ffn_cfg = dataclasses.replace(cfg, bert=BertConfig(fused_ffn_train=True))
    state = create_train_state(ffn_cfg, TrainConfig(max_iter=1000,
                                                    max_grad_norm=1.0),
                               seed=0)
    _check_step("(e) fused_ffn_train=True, kernels vs plain:",
                _loss_and_grads(state, loss_fn, batch, False),
                _loss_and_grads(state, loss_fn, batch, True), groups)
    step = make_train_step(loss_fn, state)
    _reset(ops.values())
    step(batch)
    ffn_counts = _check_counts(ops.values(), {**per_step,
                                              ops["K12"]: layers}, 1,
                               "train (e)")
    counts[ops["K12"]] = ffn_counts[ops["K12"]]
    del state, step
    torch.cuda.empty_cache()

    # (f) without dropout and drop-path, on the same weights: the default
    # route (K10, K11) against the module math it replaces
    def no_dropout(c):
        return dataclasses.replace(
            c, swin=dataclasses.replace(c.swin, drop_path_rate=0.0),
            bert=dataclasses.replace(c.bert, hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0))
    sides = []
    for c in (cfg, module_cfg):
        st = create_train_state(no_dropout(c), TrainConfig(max_iter=1000),
                                seed=0)
        sides.append(_loss_and_grads(st, loss_fn, batch, False))
        del st
    _check_step("(f) no dropout, fused_attn_train=True vs False:", *sides,
                groups)
    return counts


def _caption_text(rs, batch: int, vocab: int):
    """Captions of [CLS] + words + [SEP], padded to CAP_LEN (lengths 5 to
    25, the first full): (ids, mask) int64 arrays."""
    lens = rs.randint(5, CAP_LEN + 1, batch)
    lens[0] = CAP_LEN
    pos = np.arange(CAP_LEN)[None]
    txt = rs.randint(1000, vocab, (batch, CAP_LEN))
    txt[:, 0] = CLS_ID
    txt = np.where(pos == lens[:, None] - 1, SEP_ID, txt)
    mask = (pos < lens[:, None]).astype(np.int64)
    return txt * mask, mask


def _ms(fn, iters: int) -> float:
    """Host milliseconds per call of ``fn`` (synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _device_profile(fn):
    """One call of ``fn`` under torch.profiler: (host ms of the call,
    device-busy ms = the union of the device activities' intervals, number
    of device activities: kernels, copies, sets).  (ms, None, 0) when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return host_ms, None, 0
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy_us, lo, hi = busy_us + hi - lo, a, b
        else:
            hi = max(hi, b)
    return host_ms, (busy_us + hi - lo) / 1e3, len(spans)


def _kernel_times(fn, n: int):
    """ms of device time per call of ``fn`` by device activity name (the
    sum of each activity's duration, over ``n`` calls under
    torch.profiler, divided by ``n``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dur = (e.time_range.end - e.time_range.start) / 1e3 / n
            out[e.name] = out.get(e.name, 0.0) + dur
    return out


def run_captioning(ops, server):
    """Phase 6: captioning on the serving model ((a) the seq2seq forward,
    (b) the KV-cache decoder against the re-encode decoder) and the
    caption train step on ModelConfig() ((c)).  Returns the launches of
    the runs whose counts were checked."""
    from lavender_tpu_torch.config import ModelConfig, TrainConfig
    from lavender_tpu_torch.models import captioning
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    cfg, model = server.config, server.model
    layers, vocab = cfg.bert.num_hidden_layers, cfg.bert.vocab_size
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (BATCH, FRAMES, SIZE, SIZE, 3)).astype(np.uint8)
    txt, mask = _caption_text(rs, BATCH, vocab)
    total = {op: 0 for op in ops.values()}

    def add(counts):
        for op, n in counts.items():
            total[op] += n

    # (a) the seq2seq serving forward: K6 in every layer, no K4
    server(img, txt, mask, "seq2seq")  # warm-up
    _reset(ops.values())
    out = server(img, txt, mask, "seq2seq")
    add(_check_counts(ops.values(), {**_video_counts(ops, cfg),
                                     ops["K5"]: layers, ops["K6"]: layers},
                      1, "caption (a)"))
    with plain_path():
        ref = server(img, txt, mask, "seq2seq")
    err, rel, ok = _compare(out, ref, SLICE_TOL, SLICE_REL_L2)
    ms_k = _ms(lambda: server(img, txt, mask, "seq2seq"), 10)
    with plain_path():
        ms_p = _ms(lambda: server(img, txt, mask, "seq2seq"), 3)
    print(f"[caption] (a) seq2seq forward, B={BATCH} L="
          f"{FRAMES * 50 + CAP_LEN}: logits {tuple(out.shape)}; vs plain "
          f"path max_abs_err {err:.4g} rel_l2 {rel:.3g} (tol {SLICE_TOL} "
          f"max(1,max|ref|), {SLICE_REL_L2}), max|ref| "
          f"{float(ref.float().abs().max()):.3g}; {ms_k:.2f} ms per forward "
          f"vs plain {ms_p:.2f} ms ({_nvidia_smi()})", flush=True)
    if not (ok and tuple(out.shape) == (BATCH, CAP_LEN, vocab)):
        raise AssertionError("(a) seq2seq forward: kernel path logits "
                             "disagree with the plain path")
    gate = SLICE_TOL * max(1.0, float(ref.float().abs().max()))

    # (b) the KV-cache decoder, greedy, GenerateConfig(): its logits at
    # every step against the re-encode decoder teacher-forced on its ids
    gen_cfg = captioning.GenerateConfig(max_gen_length=GEN_LEN)
    n_steps = gen_cfg.max_gen_length - 1
    generate = captioning.make_generate_fn(model, CLS_ID, SEP_ID, PAD_ID,
                                           MASK_ID, gen_cfg)
    generate(img)  # warm-up
    steps = []
    hook = model.fc_mtm.register_forward_hook(
        lambda mod, inp, o: steps.append(o[:, 0].float()))
    _reset(ops.values())
    try:
        ids, logp = generate(img)
    finally:
        hook.remove()
    add(_check_counts(ops.values(), {
        **_video_counts(ops, cfg), ops["K4"]: layers,
        ops["K5"]: layers * (1 + n_steps)}, 1, "caption (b) KV decode"))
    if len(steps) != n_steps or not bool(torch.isfinite(logp).all()):
        raise AssertionError("(b) the KV decoder ran the wrong number of "
                             "steps or gave a non-finite log-prob")
    dummy = torch.ones(BATCH, 1, dtype=torch.long, device="cuda")
    img_t = torch.as_tensor(img, device="cuda")
    re_k, re_p = [], []
    with torch.inference_mode():
        fi, mi, _, _ = model.go_feat(img_t, dummy, dummy)
        _reset(ops.values())
        for t in range(1, n_steps + 1):
            re_k.append(captioning.rencode_logits(model, fi, mi, ids[:, :t],
                                                  MASK_ID))
        add(_check_counts(ops.values(), {ops["K5"]: layers,
                                         ops["K6"]: layers}, n_steps,
                          "caption (b) re-encode"))
        with plain_path():
            fi_p, mi_p, _, _ = model.go_feat(img_t, dummy, dummy)
            for t in range(1, n_steps + 1):
                re_p.append(captioning.rencode_logits(
                    model, fi_p, mi_p, ids[:, :t], MASK_ID))
    kv, re_k, re_p = torch.stack(steps), torch.stack(re_k), torch.stack(re_p)
    results = {"KV decoder": _compare(kv, re_p, SLICE_TOL, SLICE_REL_L2),
               "re-encode decoder": _compare(re_k, re_p, SLICE_TOL,
                                             SLICE_REL_L2)}
    # a token must match wherever the plain top-1 / top-2 gap leaves no
    # room for a near-tie; rows past their [SEP] are padding
    top2 = re_p.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * gate
    running = torch.ones(n_steps, BATCH, dtype=torch.bool, device="cuda")
    running[1:] = (ids[:, 1:n_steps] != SEP_ID).cumprod(1).bool().T
    checked = decided & running
    mismatch = int(((kv.argmax(-1) != re_p.argmax(-1)) & checked).sum())
    for name, (e, r, good) in results.items():
        print(f"[caption] (b) {name} vs the plain re-encode decoder, "
              f"teacher-forced, {n_steps} steps x {BATCH} clips: "
              f"max_abs_err {e:.4g} rel_l2 {r:.3g} (tol {SLICE_TOL} "
              f"max(1,max|ref|), {SLICE_REL_L2})", flush=True)
    print(f"[caption] (b) tokens (informational beside the logits gate: "
          f"random weights make near-ties): {int(checked.sum())} of "
          f"{int(running.sum())} running steps decided by a top-1/top-2 gap "
          f"> {2 * gate:.3g}, {mismatch} differ; "
          f"{int((running & ~decided).sum())} near-ties exempt; captions "
          f"{ids.tolist()}", flush=True)
    if mismatch or not all(good for *_, good in results.values()):
        raise AssertionError("(b) the caption decoders disagree with the "
                             "plain re-encode decoder")
    ms_kv = _ms(lambda: generate(img), 3)
    _reset(ops.values())
    ms_re = _ms(lambda: captioning.rencode_generate_reference(
        model, img, CLS_ID, SEP_ID, PAD_ID, MASK_ID, gen_cfg.max_gen_length),
        1)
    re_steps = max(ops["K6"].launches // layers, 1)
    with torch.inference_mode():
        ms_feat = _ms(lambda: model.go_feat(img_t, dummy, dummy), 3)
    print(f"[caption] (b) greedy captions of {BATCH} clips, "
          f"{gen_cfg.max_gen_length} tokens: KV-cache decoder {ms_kv:.2f} ms "
          f"({ms_kv / n_steps:.3f} ms per generated token; "
          f"{(ms_kv - ms_feat) / n_steps:.3f} without the Swin pass, "
          f"prefill included); re-encode decoder {ms_re:.2f} ms for "
          f"{re_steps} steps ({ms_re / re_steps:.3f} ms per generated "
          f"token; {(ms_re - ms_feat) / re_steps:.3f} without the Swin "
          f"pass); the clips' Swin pass (go_feat) {ms_feat:.2f} ms "
          f"({_nvidia_smi()})", flush=True)
    # where a decoder's time goes: the device's busy share of one call
    def rencode():
        captioning.rencode_generate_reference(
            model, img, CLS_ID, SEP_ID, PAD_ID, MASK_ID, GEN_LEN)

    for name, fn, n_tok in (("KV-cache", lambda: generate(img), n_steps),
                            ("re-encode", rencode, re_steps)):
        host_ms, busy_ms, n_dev = _device_profile(fn)
        busy = ("device time not measured (the profiler recorded no device "
                "activity)" if busy_ms is None else
                f"device busy {busy_ms:.2f} ms ({busy_ms / host_ms:.1%} of "
                f"the profiled call), {n_dev} device activities "
                f"({n_dev / n_tok:.1f} per generated token)")
        print(f"[caption] (b) {name} decoder under torch.profiler: "
              f"{host_ms:.2f} ms host; {busy} ({_nvidia_smi()})", flush=True)

    # (c) the caption train step on ModelConfig(): B=8, seq2seq mask
    tcfg = ModelConfig()
    loss_fn = captioning.make_caption_loss_fn(label_smoothing=0.1)
    rs = np.random.RandomState(4)
    clips = rs.randint(0, 256, (TRAIN_BATCH, FRAMES, SIZE, SIZE, 3))
    words, tmask = _caption_text(rs, TRAIN_BATCH, vocab)
    masked, ans = captioning.caption_masking(words, PAD_ID, MASK_ID, 0.15,
                                             rs)
    batch = {"img": torch.as_tensor(clips.astype(np.uint8), device="cuda"),
             **{k: torch.as_tensor(v, device="cuda").long() for k, v in
                (("txt", masked), ("mask", tmask), ("ans_mtm", ans))}}
    print(f"[caption] (c) batch: {TRAIN_BATCH} clips, {CAP_LEN} tokens, "
          f"{int((ans >= 0).sum())} masked by caption_masking", flush=True)
    state = create_train_state(tcfg, TrainConfig(max_iter=1000,
                                                 max_grad_norm=1.0), seed=0)
    _check_step("(c) caption step, kernels vs plain:",
                _loss_and_grads(state, loss_fn, batch, False),
                _loss_and_grads(state, loss_fn, batch, True),
                _grad_groups(state.model))
    step = make_train_step(loss_fn, state)
    depth, n_shift = sum(tcfg.swin.depths), _shifted_blocks(tcfg.swin)
    _reset(ops.values())
    step(batch)
    add(_check_counts(ops.values(), {
        ops["K1"]: depth, ops["K2"]: 4 * n_shift, ops["K8a"]: depth,
        ops["K8b"]: depth, ops["K9"]: depth, ops["K10a"]: layers,
        ops["K10b"]: layers, ops["K11"]: layers}, 1, "caption (c)"))
    del state, step
    torch.cuda.empty_cache()
    const = TrainConfig(lr=TRAIN_LR, warmup_ratio=0.0, max_iter=10 ** 9,
                        max_grad_norm=1.0)
    runs = {}
    for label in ("kernels", "plain"):
        stp = make_train_step(loss_fn, create_train_state(tcfg, const,
                                                          seed=0))
        ctx = plain_path if label == "plain" else contextlib.nullcontext
        with ctx():
            losses = [float(stp(batch)) for _ in range(TRAIN_STEPS)]
        drop = losses[0] - losses[-1]
        print(f"[caption] (c) {label} path, {TRAIN_STEPS} steps at lr "
              f"{TRAIN_LR}: loss {' '.join(f'{v:.4f}' for v in losses)}; "
              f"down {drop:.4f} nat (>= {MIN_LOSS_DROP})", flush=True)
        if not (all(np.isfinite(losses)) and drop >= MIN_LOSS_DROP):
            raise AssertionError(f"(c) {label} path: the caption loss did "
                                 f"not fall by {MIN_LOSS_DROP} nat")
        runs[label] = (stp, ctx)
    times = {name: [] for name in runs}
    for name in ("kernels", "plain", "plain", "kernels"):
        stp, ctx = runs[name]
        with ctx():
            times[name].append(_ms(lambda: stp(batch), 3))
    for name, ts in times.items():
        dt = sum(ts) / len(ts)
        print(f"[caption] (c) {name} path: {dt:.2f} ms per caption train "
              f"step ({', '.join(f'{t:.2f}' for t in ts)}), "
              f"{TRAIN_BATCH / dt * 1e3:.2f} train clips/s at "
              f"B={TRAIN_BATCH} ({_nvidia_smi()})", flush=True)
    del runs
    torch.cuda.empty_cache()
    return total


# The spatial routes' launches per Swin-B forward at T=5, 224 x 224, from
# the JAX package's gates (full_block_fits_vmem holds at stages 1-3,
# weights_fit_vmem fails at stage 4): "fused" runs the whole block K14 at
# stages 1-3 (22 blocks), its attention half + K3 at stage 4 (2); "pallas"
# runs K15 in all 24 blocks and K9 in the 22 blocks of stages 1-3.
FUSED_SERVE = {"K14f": 22, "K14a": 2, "K3": 2}
PALLAS_SERVE = {"K15": 24, "K9": 22}
# one remat train step (B=8): the attention half and K9 (stages 1-3) in
# the forward and again in the recomputation; the attention half's
# backward recomputes through K8a / K8b once per block
REMAT_STEP = {"K14a": 48, "K9": 44, "K8a": 24, "K8b": 24}


def run_spatial(ops, wm_server):
    """Phase 7: the spatial routes.  (b) serving under attn_impl="fused"
    and "pallas": 3 requests of B=4 each against the plain path, launch
    counts, clips/s beside the window-major route's in turns; (c) the
    remat train step on ModelConfig(swin=Swin-B + remat=True), B=8: loss
    and gradients kernels vs plain, launches, ten steps lowering the loss
    >= 1 nat, step time and peak memory beside the default step's.
    Returns the launches of the counted runs."""
    from lavender_tpu_torch.config import (
        SWIN_PRESETS, ModelConfig, TrainConfig)
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.serve import LavenderServer
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    total = {op: 0 for op in ops.values()}
    layers = wm_server.config.bert.num_hidden_layers
    rs = np.random.RandomState(5)
    requests = []
    for _ in range(N_REQUESTS):
        img = rs.randint(0, 256, (BATCH, FRAMES, SIZE, SIZE, 3)).astype(
            np.uint8)
        lens = rs.randint(5, TXT_LEN + 1, BATCH)
        mask = (np.arange(TXT_LEN)[None] < lens[:, None]).astype(np.int64)
        txt = rs.randint(1, wm_server.config.bert.vocab_size,
                         (BATCH, TXT_LEN)) * mask
        requests.append((img, txt, mask))
    servers = {"wm": wm_server}
    for impl, per_fwd in (("fused", FUSED_SERVE), ("pallas", PALLAS_SERVE)):
        cfg = ModelConfig(swin=dataclasses.replace(SWIN_PRESETS["base"],
                                                   attn_impl=impl))
        server = LavenderServer(cfg, seed=0, frames=FRAMES, size=SIZE)
        servers[impl] = server
        server(*requests[0])  # warm-up
        expected = {ops[k]: n for k, n in per_fwd.items()}
        expected[ops["K4"]] = expected[ops["K5"]] = layers
        _reset(ops.values())
        outs = [server(*r) for r in requests]
        for op, n in _check_counts(ops.values(), expected, N_REQUESTS,
                                   f"spatial (b) {impl}").items():
            total[op] += n
        for i, (out, req) in enumerate(zip(outs, requests)):
            with plain_path():
                ref = server(*req)
            err, rel, ok = _compare(out, ref, SLICE_TOL, SLICE_REL_L2)
            print(f"[spatial] (b) {impl} request {i}: logits "
                  f"{tuple(out.shape)}; vs plain path max_abs_err {err:.4g} "
                  f"rel_l2 {rel:.3g} (tol {SLICE_TOL} max(1,max|ref|), "
                  f"{SLICE_REL_L2}), max|ref| "
                  f"{float(ref.float().abs().max()):.3g}", flush=True)
            if not (ok and tuple(out.shape) == (BATCH, TXT_LEN,
                                                cfg.bert.vocab_size)):
                raise AssertionError(f"(b) {impl} request {i}: kernel path "
                                     "logits disagree with the plain path")
    times = {name: [] for name in servers}
    order = list(servers)
    for name in order + order[::-1]:
        times[name].append(_ms(lambda: servers[name](*requests[0]), 10))
    for name, ts in times.items():
        dt = sum(ts) / len(ts)
        host_ms, busy_ms, n_dev = _device_profile(
            lambda: servers[name](*requests[0]))
        busy = ("device time not measured (the profiler recorded no device "
                "activity)" if busy_ms is None else
                f"device busy {busy_ms:.2f} ms of {host_ms:.2f} "
                f"({busy_ms / host_ms:.1%}), {n_dev} device activities")
        print(f"[spatial] (b) attn_impl={name!r} serving: {dt:.2f} ms per "
              f"forward ({', '.join(f'{t:.2f}' for t in ts)}), "
              f"{BATCH / dt * 1e3:.2f} clips/s at B={BATCH}; one forward "
              f"under torch.profiler: {busy} ({_nvidia_smi()})", flush=True)
    del servers["fused"], servers["pallas"], server
    torch.cuda.empty_cache()

    # (c) the remat train step: the wm route falls back to K14 in every
    # stage, each block pair recomputed in the backward
    cfg = ModelConfig(swin=dataclasses.replace(SWIN_PRESETS["base"],
                                               remat=True))
    loss_fn = retrieval.make_loss_fn(TRUE_ID, FALSE_ID)
    batch = _train_batch(cfg.bert.vocab_size)
    state = create_train_state(cfg, TrainConfig(max_iter=1000,
                                                max_grad_norm=1.0), seed=0)
    _check_step("(c) remat=True, kernels vs plain:",
                _loss_and_grads(state, loss_fn, batch, False),
                _loss_and_grads(state, loss_fn, batch, True),
                _grad_groups(state.model), tag="spatial")
    step = make_train_step(loss_fn, state)
    expected = {ops[k]: n for k, n in REMAT_STEP.items()}
    for k in ("K10a", "K10b", "K11"):
        expected[ops[k]] = layers
    _reset(ops.values())
    step(batch)
    for op, n in _check_counts(ops.values(), expected, 1,
                               "spatial (c) remat step").items():
        total[op] += n
    del state, step
    torch.cuda.empty_cache()
    const = TrainConfig(lr=TRAIN_LR, warmup_ratio=0.0, max_iter=10 ** 9,
                        max_grad_norm=1.0)
    steps = {}
    both = dataclasses.replace(cfg, bert=dataclasses.replace(cfg.bert,
                                                             remat=True))
    for name, c in (("remat=True", cfg), ("default (wm)", ModelConfig()),
                    ("remat=True + BertConfig.remat=True", both)):
        steps[name] = make_train_step(loss_fn, create_train_state(
            c, const, seed=0))
    losses = [float(steps["remat=True"](batch)) for _ in range(TRAIN_STEPS)]
    drop = losses[0] - losses[-1]
    print(f"[spatial] (c) remat=True, {TRAIN_STEPS} steps at lr {TRAIN_LR}: "
          f"loss {' '.join(f'{v:.4f}' for v in losses)}; down {drop:.4f} "
          f"nat (>= {MIN_LOSS_DROP})", flush=True)
    if not (all(np.isfinite(losses)) and drop >= MIN_LOSS_DROP):
        raise AssertionError(f"(c) remat: the loss did not fall by "
                             f"{MIN_LOSS_DROP} nat in {TRAIN_STEPS} steps")
    for name in list(steps)[1:]:  # warm-up
        if not np.isfinite(float(steps[name](batch))):
            raise AssertionError(f"(c) {name}: non-finite loss")
    times = {name: [] for name in steps}
    peaks = {name: [] for name in steps}
    order = list(steps)
    for name in order + order[::-1]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times[name].append(_ms(lambda: steps[name](batch), 2))
        peaks[name].append(torch.cuda.max_memory_allocated() - base)
    for name in steps:
        dt = sum(times[name]) / len(times[name])
        print(f"[spatial] (c) {name} train step: {dt:.2f} ms per step "
              f"({', '.join(f'{t:.2f}' for t in times[name])}), "
              f"{TRAIN_BATCH / dt * 1e3:.2f} train clips/s at "
              f"B={TRAIN_BATCH}; peak device memory above the resident "
              f"states {max(peaks[name]) / 2 ** 30:.3f} GiB "
              f"({_nvidia_smi()})", flush=True)
    print(f"[spatial] (c) resident (three train states) "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    del steps
    torch.cuda.empty_cache()
    return total


# The JAX switches' routes, launches per Swin-B + BERT-base serving forward
# at T=5, 224 x 224 (JAX _BlockPairWM / SwinBlockWM / PatchEmbed3D): _IKS
# takes stage 3's 9 shifted blocks (nW = 4) into K16, with K9 (+residual)
# after each, and leaves K2 around stages 1 and 2; _PEK adds K17 once.
ROUTE_SERVE = {
    "default": {"K1": 24, "K2": 22, "K3": 2},
    "_PEK": {"K1": 24, "K2": 22, "K3": 2, "K17": 1},
    "_IKS": {"K16": 9, "K1": 15, "K2": 4, "K9": 9, "K3": 2}}
# one _IKS train step (B=8): K16's backward recomputes through K2 (two
# shifts and their transposes) and K8; stages 1-2 shift around K1 as before
IKS_STEP = {"K16": 9, "K1": 15, "K2": 44, "K8a": 24, "K8b": 24, "K9": 24}


@contextlib.contextmanager
def _switches(pek: bool = False, iks: bool = False):
    """The port's LVT_PEK / LVT_IKS module constants, for a block."""
    from lavender_tpu_torch.models import swin3d

    prev = swin3d._PEK, swin3d._IKS
    swin3d._PEK, swin3d._IKS = pek, iks
    try:
        yield
    finally:
        swin3d._PEK, swin3d._IKS = prev


ROUTE_FLAGS = {"default": {}, "_PEK": {"pek": True}, "_IKS": {"iks": True}}


def run_routes(ops, server):
    """Phase 8: the JAX switches' routes.  (a) the fold cache's logits
    against the uncached, unfolded ones, the guard's cost on an unchanged
    model, and new weights loaded into the built server; (b) serving under
    _PEK and _IKS against the plain path, launches, clips/s beside the
    default route in turns, device-busy share per route; (c) the _IKS
    train step: loss and gradients kernels vs plain, launches, ten steps,
    step time beside the default step's; (d) K16 against the K2 + K1
    attention half + K2^-1 composition it replaces.  Returns the launches
    of the counted runs."""
    from lavender_tpu_torch.config import ModelConfig, TrainConfig
    from lavender_tpu_torch.models import swin3d
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.ops.swin_block_attn import (
        fused_swin_block_wm, fused_swin_block_wm_shifted)
    from lavender_tpu_torch.ops.wm_permute import shift_indices, wm_shift_rows
    from lavender_tpu_torch.serve import LavenderServer
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    total = {op: 0 for op in ops.values()}
    layers = server.config.bert.num_hidden_layers
    swin = server.model.enc_img.swin
    rs = np.random.RandomState(8)
    requests = []
    for _ in range(N_REQUESTS):
        img = rs.randint(0, 256, (BATCH, FRAMES, SIZE, SIZE, 3)).astype(
            np.uint8)
        lens = rs.randint(5, TXT_LEN + 1, BATCH)
        mask = (np.arange(TXT_LEN)[None] < lens[:, None]).astype(np.int64)
        txt = rs.randint(1, server.config.bert.vocab_size,
                         (BATCH, TXT_LEN)) * mask
        requests.append((img, txt, mask))

    # (a) the fold cache against no cache, then the guard
    folds = next(iter(swin.layers[0]._cache.values()))[6]
    if folds[0] is None:
        raise AssertionError("(a) the server's cache holds no fold")
    cached = server(*requests[0])
    swin.clear_serving_cache()
    uncached = server(*requests[0])
    swin.build_serving_cache(FRAMES, SIZE, SIZE)
    err, rel, ok = _compare(cached, uncached, SLICE_TOL, SLICE_REL_L2)
    print(f"[routes] (a) fold cache vs no cache (unfolded): max_abs_err "
          f"{err:.4g} rel_l2 {rel:.3g} (tol {SLICE_TOL} max(1,max|ref|), "
          f"{SLICE_REL_L2})", flush=True)
    if not ok:
        raise AssertionError("(a) the folded serving logits disagree")
    # device time of the cache with and without the fold, in turns
    fold_ms = {True: [], False: []}
    try:
        for fold in (True, False, False, True):
            swin3d._FOLDCACHE = fold
            swin.build_serving_cache(FRAMES, SIZE, SIZE)
            fold_ms[fold].append(sum(_kernel_times(
                lambda: server(*requests[0]), 3).values()))
    finally:
        swin3d._FOLDCACHE = True
        swin.build_serving_cache(FRAMES, SIZE, SIZE)
    print(f"[routes] (a) device activities' time per forward: fold cache "
          f"{sum(fold_ms[True]) / 2:.3f} ms ({fold_ms[True]}), cache "
          f"without the fold {sum(fold_ms[False]) / 2:.3f} ms "
          f"({fold_ms[False]}) ({_nvidia_smi()})", flush=True)
    other = _swin_layer_norms(LavenderServer(seed=1, frames=FRAMES,
                                             size=SIZE), 11)
    other.model.build_serving_cache(FRAMES, SIZE, SIZE)
    calls = []
    fingerprint = swin3d.BasicLayer.fingerprint
    swin3d.BasicLayer.fingerprint = (
        lambda self, fold: calls.append(1) or fingerprint(self, fold))
    try:
        server(*requests[0])
        if calls:
            raise AssertionError("(a) the guard ran a fingerprint on an "
                                 "unchanged model")
        server.model.load_state_dict(other.model.state_dict())
        got = server(*requests[0])
        n_fp = len(calls)
    finally:
        swin3d.BasicLayer.fingerprint = fingerprint
    want = other(*requests[0])
    err, rel, ok = _compare(got, want, SLICE_TOL, SLICE_REL_L2)
    moved = float((want.float() - cached.float()).abs().max())
    print(f"[routes] (a) guard: 0 fingerprints on an unchanged model; after "
          f"load_state_dict of seed-1 weights {n_fp} stage fingerprints "
          f"(check and rebuild), the next request vs a fresh seed-1 server: "
          f"max_abs_err {err:.4g} rel_l2 {rel:.3g}; the old weights' logits "
          f"differ by {moved:.4g}", flush=True)
    if not (ok and err < moved and n_fp > 0):
        raise AssertionError("(a) the server served a stale cache")
    del other
    torch.cuda.empty_cache()

    # (b) serving under _PEK and _IKS against the plain path, launches
    for name, flags in ROUTE_FLAGS.items():
        expected = {ops[k]: n for k, n in ROUTE_SERVE[name].items()}
        expected[ops["K4"]] = expected[ops["K5"]] = layers
        with _switches(**flags):
            server(*requests[0])  # warm-up
            _reset(ops.values())
            outs = [server(*r) for r in requests]
            for op, n in _check_counts(ops.values(), expected, N_REQUESTS,
                                       f"routes (b) {name}").items():
                total[op] += n
            for i, (out, req) in enumerate(zip(outs, requests)):
                with plain_path():
                    ref = server(*req)
                err, rel, ok = _compare(out, ref, SLICE_TOL, SLICE_REL_L2)
                print(f"[routes] (b) {name} request {i}: vs plain path "
                      f"max_abs_err {err:.4g} rel_l2 {rel:.3g} (tol "
                      f"{SLICE_TOL} max(1,max|ref|), {SLICE_REL_L2}), "
                      f"max|ref| {float(ref.float().abs().max()):.3g}",
                      flush=True)
                if not (ok and bool(torch.isfinite(out).all())):
                    raise AssertionError(f"(b) {name} request {i}: kernel "
                                         "path logits disagree")
    times = {name: [] for name in ROUTE_FLAGS}
    order = list(ROUTE_FLAGS)
    for name in order + order[::-1]:
        with _switches(**ROUTE_FLAGS[name]):
            times[name].append(_ms(lambda: server(*requests[0]), 10))
    for name, ts in times.items():
        dt = sum(ts) / len(ts)
        with _switches(**ROUTE_FLAGS[name]):
            host_ms, busy_ms, n_dev = _device_profile(
                lambda: [server(*requests[0]) for _ in range(3)])
        busy = ("device time not measured (the profiler recorded no device "
                "activity)" if busy_ms is None else
                f"device busy {busy_ms / 3:.3f} ms of {host_ms / 3:.3f} "
                f"({busy_ms / host_ms:.1%}), {n_dev / 3:.0f} device "
                f"activities")
        print(f"[routes] (b) {name} serving: {dt:.2f} ms per forward "
              f"({', '.join(f'{t:.2f}' for t in ts)}), "
              f"{BATCH / dt * 1e3:.2f} clips/s at B={BATCH}; per forward of "
              f"3 under torch.profiler: {busy} ({_nvidia_smi()})",
              flush=True)
    # where a route's device time goes against the default's: the device
    # activities' time by name, 3 forwards a route, the routes in turns
    by_name = {name: {} for name in ROUTE_FLAGS}
    for name in order + order[::-1]:
        with _switches(**ROUTE_FLAGS[name]):
            for k, v in _kernel_times(lambda: server(*requests[0]),
                                      3).items():
                by_name[name][k] = by_name[name].get(k, 0.0) + v / 2
    base = by_name["default"]
    for name in order:
        kt = by_name[name]
        line = (f"[routes] (b) {name}: device activities' time "
                f"{sum(kt.values()):.3f} ms per forward")
        if name != "default":
            diff = sorted(((kt.get(k, 0.0) - base.get(k, 0.0), k)
                           for k in set(kt) | set(base)),
                          key=lambda d: -abs(d[0]))[:6]
            line += "; vs default: " + "; ".join(
                f"{d:+.4f} ms {k[:70]}" for d, k in diff)
        print(line, flush=True)

    # (c) the _IKS train step on ModelConfig()
    cfg = ModelConfig()
    loss_fn = retrieval.make_loss_fn(TRUE_ID, FALSE_ID)
    batch = _train_batch(cfg.bert.vocab_size)
    state = create_train_state(cfg, TrainConfig(max_iter=1000,
                                                max_grad_norm=1.0), seed=0)
    with _switches(iks=True):
        _check_step("(c) _IKS, kernels vs plain:",
                    _loss_and_grads(state, loss_fn, batch, False),
                    _loss_and_grads(state, loss_fn, batch, True),
                    _grad_groups(state.model), tag="routes")
        step = make_train_step(loss_fn, state)
        expected = {ops[k]: n for k, n in IKS_STEP.items()}
        for k in ("K10a", "K10b", "K11"):
            expected[ops[k]] = layers
        _reset(ops.values())
        step(batch)
        for op, n in _check_counts(ops.values(), expected, 1,
                                   "routes (c) _IKS step").items():
            total[op] += n
    del state, step
    torch.cuda.empty_cache()
    const = TrainConfig(lr=TRAIN_LR, warmup_ratio=0.0, max_iter=10 ** 9,
                        max_grad_norm=1.0)
    steps = {name: make_train_step(loss_fn, create_train_state(
        cfg, const, seed=0)) for name in ("_IKS", "default")}
    with _switches(iks=True):
        losses = [float(steps["_IKS"](batch)) for _ in range(TRAIN_STEPS)]
    drop = losses[0] - losses[-1]
    print(f"[routes] (c) _IKS, {TRAIN_STEPS} steps at lr {TRAIN_LR}: loss "
          f"{' '.join(f'{v:.4f}' for v in losses)}; down {drop:.4f} nat (>= "
          f"{MIN_LOSS_DROP})", flush=True)
    if not (all(np.isfinite(losses)) and drop >= MIN_LOSS_DROP):
        raise AssertionError(f"(c) _IKS: the loss did not fall by "
                             f"{MIN_LOSS_DROP} nat in {TRAIN_STEPS} steps")
    steps["default"](batch)  # warm-up
    times = {name: [] for name in steps}
    for name in ("_IKS", "default", "default", "_IKS", "_IKS", "default"):
        with _switches(iks=name == "_IKS"):
            times[name].append(_ms(lambda: steps[name](batch), 3))
    for name, ts in times.items():
        dt = sum(ts) / len(ts)
        print(f"[routes] (c) {name} train step: {dt:.2f} ms per step "
              f"({', '.join(f'{t:.2f}' for t in ts)}), "
              f"{TRAIN_BATCH / dt * 1e3:.2f} train clips/s at "
              f"B={TRAIN_BATCH} ({_nvidia_smi()})", flush=True)
    del steps
    torch.cuda.empty_cache()

    # (d) K16 against the composition it replaces, at stage 3
    g = torch.Generator(device="cuda").manual_seed(8)

    def lin(n_out, n_in):
        return _rnd(g, n_out, n_in, std=n_in ** -0.5), _rnd(g, n_out,
                                                            std=0.02)

    def ln(c):
        return 1.0 + _rnd(g, c, std=0.1), _rnd(g, c, std=0.1)

    params, statics, (nW, C, nH, N, Npad, _) = _stage3_block(g, lin, ln)
    spatial, window, shift, _, scale, eps = statics
    fwd, inv = shift_indices(window, *spatial, Npad, shift, "cuda")
    for B in (BATCH, TRAIN_BATCH):
        x = _rnd(g, B, nW, Npad, C)

        def composition():
            xs = wm_shift_rows(x, fwd, inv)
            ys = fused_swin_block_wm(xs, *params, nH, scale, eps)
            return wm_shift_rows(ys, inv, fwd)
        k16 = lambda: fused_swin_block_wm_shifted(x, *params, *statics)
        err, rel, ok = _compare(k16()[:, :, :N], composition()[:, :, :N],
                                TOL, REL_L2)
        ms = {"K16": [], "K2 + K1 + K2^-1": []}
        for name in ("K16", "K2 + K1 + K2^-1", "K2 + K1 + K2^-1", "K16"):
            ms[name].append(_time_ms(k16 if name == "K16" else composition,
                                     20))
        print(f"[routes] (d) stage 3 B={B}: K16 "
              f"{sum(ms['K16']) / 2:.4f} ms vs K2 + K1 attention half + "
              f"K2^-1 {sum(ms['K2 + K1 + K2^-1']) / 2:.4f} ms per block "
              f"({ms}); outputs max_abs_err {err:.4g} rel_l2 {rel:.3g} "
              f"({_nvidia_smi()})", flush=True)
        if not ok:
            raise AssertionError("(d) K16 disagrees with the composition")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA GPU")
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.encoder_attention import (
        encoder_attention_train_lanes_bwd, fused_bert_attn_block,
        fused_bert_attn_block_kmask, fused_encoder_attention,
        fused_encoder_attention_train_lanes)
    from lavender_tpu_torch.ops.fused_mlp import (
        fused_ffn_post_ln, fused_ffn_post_ln_train, fused_ln_mlp,
        fused_ln_mlp_chunked, fused_out_ln_train)
    from lavender_tpu_torch.ops.patch_embed_u8 import fused_patch_embed_u8
    from lavender_tpu_torch.ops.swin_block_attn import (
        fused_swin_block_attn, fused_swin_block_full, fused_swin_block_wm,
        fused_swin_block_wm_shifted)
    from lavender_tpu_torch.ops.swin_core_attn import (
        swin_core_attn, swin_core_attn_bwd)
    from lavender_tpu_torch.ops.window_attention import fused_window_attention
    from lavender_tpu_torch.ops.wm_permute import wm_shift_rows

    print(_nvidia_smi(), flush=True)  # the card's name and power limit
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {_build.library_path().name}: "
          f"{time.perf_counter() - t0:.1f} s ("
          f"{'found in build/' if prebuilt else 'nvcc'})", flush=True)

    ops = {"K1": fused_swin_block_wm, "K2": wm_shift_rows,
           "K3": fused_ln_mlp_chunked, "K4": fused_bert_attn_block_kmask,
           "K5": fused_ffn_post_ln, "K6": fused_bert_attn_block,
           "K7": fused_encoder_attention, "K8a": swin_core_attn,
           "K8b": swin_core_attn_bwd, "K9": fused_ln_mlp,
           "K10a": fused_encoder_attention_train_lanes,
           "K10b": encoder_attention_train_lanes_bwd,
           "K11": fused_out_ln_train, "K12": fused_ffn_post_ln_train,
           "K14a": fused_swin_block_attn, "K14f": fused_swin_block_full,
           "K15": fused_window_attention,
           "K16": fused_swin_block_wm_shifted, "K17": fused_patch_embed_u8}
    per_kernel = check_kernels()
    torch.cuda.empty_cache()
    server = build_server()
    serve_counts = run_serving(ops, server)
    torch.cuda.empty_cache()
    train_counts = run_train(ops)
    torch.cuda.empty_cache()
    caption_counts = run_captioning(ops, server)
    torch.cuda.empty_cache()
    spatial_counts = run_spatial(ops, server)
    torch.cuda.empty_cache()
    route_counts = run_routes(ops, server)

    meta = {
        "K1": ("lavender_tpu_torch/csrc/attention.cu",
               "lavender_tpu/ops/swin_block_attn.py:954"),
        "K2": ("lavender_tpu_torch/csrc/permute.cu",
               "lavender_tpu/ops/wm_permute.py:127"),
        "K3": ("lavender_tpu_torch/csrc/gemm.cu",
               "lavender_tpu/ops/fused_mlp.py:183"),
        "K4": ("lavender_tpu_torch/csrc/attention.cu",
               "lavender_tpu/ops/encoder_attention.py:322"),
        "K5": ("lavender_tpu_torch/csrc/gemm.cu",
               "lavender_tpu/ops/fused_mlp.py:283"),
        "K6": ("lavender_tpu_torch/csrc/attention.cu",
               "lavender_tpu/ops/encoder_attention.py:242"),
        "K7": ("lavender_tpu_torch/csrc/attention.cu",
               "lavender_tpu/ops/encoder_attention.py:75"),
        "K8a": ("lavender_tpu_torch/csrc/attention.cu",
                "lavender_tpu/ops/swin_core_attn.py:112"),
        "K8b": ("lavender_tpu_torch/csrc/attention_bwd.cu",
                "lavender_tpu/ops/swin_core_attn.py:147"),
        "K9": ("lavender_tpu_torch/csrc/gemm.cu",
               "lavender_tpu/ops/fused_mlp.py:91"),
        "K10a": ("lavender_tpu_torch/csrc/attention.cu",
                 "lavender_tpu/ops/encoder_attention.py:750"),
        "K10b": ("lavender_tpu_torch/csrc/attention_bwd.cu",
                 "lavender_tpu/ops/encoder_attention.py:780"),
        "K11": ("lavender_tpu_torch/csrc/layernorm.cu",
                "lavender_tpu/ops/fused_mlp.py:505"),
        "K12": ("lavender_tpu_torch/csrc/layernorm.cu",
                "lavender_tpu/ops/fused_mlp.py:379"),
        "K14a": ("lavender_tpu_torch/csrc/layernorm.cu",
                 "lavender_tpu/ops/swin_block_attn.py:468"),
        "K14f": ("lavender_tpu_torch/csrc/layernorm.cu",
                 "lavender_tpu/ops/swin_block_attn.py:468"),
        "K15": ("lavender_tpu_torch/csrc/attention.cu",
                "lavender_tpu/ops/window_attention.py:49"),
        "K16": ("lavender_tpu_torch/csrc/layernorm.cu",
                "lavender_tpu/ops/swin_block_attn.py:1137"),
        "K17": ("lavender_tpu_torch/csrc/patch_embed.cu",
                "lavender_tpu/ops/patch_embed_u8.py:76"),
    }
    kernels = []
    for key, op in ops.items():
        src, replaces = meta[key]
        k = per_kernel[op]
        kernels.append({
            "name": op.name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": (serve_counts[op] + train_counts[op]
                         + caption_counts[op] + spatial_counts[op]
                         + route_counts[op]),
            "launches_serving": serve_counts[op],
            "launches_train_step": train_counts[op],
            "launches_captioning": caption_counts[op],
            "launches_spatial": spatial_counts[op],
            "launches_routes": route_counts[op],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": ("bytes" if k["t_bytes"] >= k["t_flops"]
                         else "operations"),
            "library_ms": k["library_ms"]})
    print(_nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
