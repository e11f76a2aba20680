#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lavender_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only K2 K5   # phases 1-3 for these kernels
    python3 chip_smoke.py --only K1 K4   # and K1's and K4's parts
    python3 chip_smoke.py --only K3 K9   # and K3's and K9's parts
    python3 chip_smoke.py --only K6 K11  # and K6's and K11's parts
    python3 chip_smoke.py --only K12 K14a K14f  # and K12's and K14's parts
    python3 chip_smoke.py --only K16 K17  # and K16's parts
    python3 chip_smoke.py --only K16 K17 --cases  # their cases alone

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
   keep masks exactly equal, K12 at rate 0.1 and 0.5, each call repeated
   and required bitwise equal, with its device time a call in a CUDA
   graph), on a key mask with padded captions; K10a
   and K10b (the tensor-core forward and backward) also at rate 0.5 and
   under the seq2seq mask at L=276 and the caption step's L=275, each
   call repeated and required bitwise equal; K6 (the
   sub-block under a full mask) and K7 (the heads-layout core) at the
   seq2seq forward's B=4, L=275 under the seq2seq mask and a random 0/1
   mask, K6 also at the re-encode decoder's first and last L (252, 270),
   each K6 call repeated and required bitwise equal, with its device time
   a call in a CUDA graph beside the event time; K11 at the train step's
   17,664 rows (rate 0.1 and 0.5) and the caption step's 2,200, each call
   repeated and required bitwise equal (output and keep mask), with its
   device time a call in a CUDA graph; K11's parts (``_k6_k11_parts``, also under
   ``--only K6`` / ``K11``): the proj's K-slices against F.linear, the
   row kernel's dropout mode against its bytes at 3.35 TB/s, at the
   caption step's rows the plan's slices against 2, and K6's core under
   the bf16 seq2seq mask against scaled_dot_product_attention; K12's and
   K14's parts (``_k12_k14_parts``, also under ``--only K12`` / ``K14a``
   / ``K14f``): K14's gathering chunk LN1 against the scalar gathering
   LN, its qkv product and its proj's scatter epilogue (and at B=4
   stages 1-3 its MLP's fc1 + GELU and fc2) against F.linear, its core
   against scaled_dot_product_attention with the bias and mask rows at
   245 and at 248 elements; K12's fc1 + GELU and fc2 K-slices against
   F.linear and its row kernel against its bytes at 3.35 TB/s; K16's
   parts (``_k16_parts``, also under ``--only K16`` / ``K17``) at stage
   3, B=4 and B=8: its gathering chunk LN1 (through the wm shift's index)
   against the scalar gathering LN, its qkv product and its proj's
   zeroing scatter epilogue against F.linear, its core against
   scaled_dot_product_attention with the bias and mask rows at 248
   elements, and the whole call's device time beside its parts' sum;
   first in the phase, by kernel name under torch.profiler, that K14a,
   K14f, K16 and K12 launch the tile GEMM (K14 and K16 also the chunk LN
   and the tensor-core forward) and no wmma GEMM, f32-pipe core (both
   gone) or scalar LN;
   K4 and K5 at the KV decoder's prefill (L=250) and K5 at its step (M=8
   rows), K5 each call repeated and required bitwise equal; K2 and K5
   also with their device time a call under torch.profiler beside the
   event time, K2's beside index_select's device time, K5's beside its
   plain version's; K8b's and K7's one-call counterparts are
   scaled_dot_product_attention's backward with a bias that requires
   grad and its forward with the additive mask; K14 (the spatial Swin
   block, whole and attention half, also minus its residual, each call
   repeated and required bitwise equal, with its device time a call in a
   CUDA graph; the bias and mask as the model passes them, in rows padded
   to 16 bytes) and K15
   (the per-window attention, its yardstick SDPA with bias + shift mask
   as one additive mask) at the four Swin-B stages at B=4 and B=8,
   shifted and unshifted; K7 and K15 (the tensor-core forward without
   lse) each call repeated and required bitwise equal, and each at its
   mask and bias rows' own pitch against rows padded to 16 bytes (K15 at
   N=245 with a bf16 and an f32 mask, K7 at L=275; event and device
   time, outputs bitwise equal); K17 (the uint8 patch embed) on the B=4 and
   B=8 clips, its yardstick F.conv3d on the padded normalized bf16 clip;
   K16 (the shifted wm block with the shift inside, K14's one C call on
   the window-major slab) at Swin-B stage 3, B=4 and B=8, also minus its
   residual, its input's pad rows random, its output's exactly 0; K16 and
   K17 each call repeated and required bitwise equal, with its device time
   a call in a CUDA graph;
   K13a / K13b (the heads-layout train attention of LVT_ATTNLANES=0) at
   the retrieval step's 64 pairs, L=276, rate 0.1, on heads views of one
   qkv slab, under a padding and a seq2seq mask (f32), K13a and K13b
   (the tensor-core forward and backward) also at rate 0.5 and at L=275
   under the seq2seq mask, each call repeated and required bitwise
   equal, K13b also with the mask's gradient (the f32-pipe kernel); the
   lse K10a and K13a write against the logsumexp of the plain scores
   (f64, within 1e-3) at rates 0.1 and 0.5 under both masks and at
   L=275, a second call bitwise equal; the keep masks K13a and K10a
   draw from one seed, read back from the kernels, each exactly
   ``dropout.attention_keep``, and
   their outputs equal to bf16 rounding; K13's one-call yardstick is
   scaled_dot_product_attention with the float mask and dropout_p (and
   its backward); K8a and K8b (the Swin window core on the tensor cores,
   its per-head bias and dbias) each call repeated and required bitwise
   equal, the lse K8a writes against the f64 logsumexp of the plain scores
   (within 1e-3) at every stage, shifted and unshifted, and at the spatial
   route's unpadded N=245, and K8b's dbias at B=8, stage 1, shifted (512
   windows) against an f64 sum of the plain per-clip dbias (within 1e-2 x
   max(1, max|dbias|)); K1 (every stage, shifted and unshifted, B=4 and
   B=8), K4 (L=276 with padded captions, the prefill's L=250 with every
   key open and with padded keys), K9 (the B=8 stages 1-4) and K3 (B=4
   stage 4) each call repeated and required bitwise equal, with their
   device time a call in a CUDA graph beside the event time; and their
   parts against one PyTorch call each (``_k1_k4_parts``, also under
   ``--only K1`` / ``K4``; ``_k3_k9_parts``, also under ``--only K3`` /
   ``K9``): every product of the tile GEMM against F.linear at its shape
   (K3's and K9's fc1 + GELU against F.gelu(F.linear), fc1 alone, fc2 as
   their plan runs it, and their whole C call against the plain
   version), K1's core against scaled_dot_product_attention with bias +
   shift mask as one additive mask, K4's against it with the key-padding
   mask;
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
   kernels vs plain, and the launch counts of one step (K12 12 times),
   and its device-busy time under torch.profiler beside the default
   step's;
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
   B=8: loss and gradients kernels vs plain, launches, its device-busy
   time under torch.profiler, ten steps lowering
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
   the default step's; (d) K16 (the shift inside) against the K2 + K1
   attention half + K2^-1 composition, which does the same work with two
   relayouts around it, at stage 3, B=4 and B=8, in turns;
9. the tasks on ModelConfig(), B=8 clips, 26 tokens (``run_tasks``): (a)
   one train step each of QA-MC, QA-OE, RetMC (5 options: 40 pairs),
   pretraining (vtm_batch=4: 8 MLM + 32 VTM sequences) and the
   task-specific head (``make_cls_loss``), loss and gradients kernels vs
   plain, launches; ten QA-MC steps lowering the loss >= 1 nat; the
   multi-task dispatch, each kind's step once (captioning and retrieval
   included); (b) the retrieval-MLM and pretraining steps under
   LVT_ATTNLANES=0 (K13a/K13b 12 per fusion pass, no K10), kernels vs
   plain, launches on both routes, step time and device time of the
   retrieval step on both routes in turns; (c) each task's eval step,
   kernels vs plain on the logits it reads (the serving gate), and QA-MC's
   eval launches under LVT_KMASK=1 (K4) and =0 (K6).

Every time is the median of five CUDA-event windows of five calls.
The last lines: the card's name and power limit, then a JSON line of the
kernels (per kernel: launches in the phase-4, phase-5 (b), the checked
phase-6, phase-7, phase-8 and phase-9 runs, K12's in 5 (e); its largest
error in phase 3;
``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms``, each the time per
call x its calls in one serving forward plus one train step plus one
seq2seq forward (K7: as if in each of its 12 layers) plus the text part
of one KV decode (K4 and K5 in the prefill, K5 in the 19 steps) plus one
"fused" and one "pallas" serving forward and one remat train step (K14,
K15) plus one ``_PEK`` serving forward (K17) and one ``_IKS`` serving
forward and train step (K16) plus one retrieval step under
LVT_ATTNLANES=0 (K13a, K13b), summed over the shapes;
``bound_ms`` is the larger of the bytes over 3.35 TB/s and the FLOPs over
989 TFLOP/s), then the device line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
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


def _time_ms(fn, iters: int = 5, windows: int = 5) -> float:
    """ms per call of ``fn``: the median of ``windows`` CUDA-event windows
    of ``iters`` calls each, after one warm-up call (one window can catch
    a stall of the host that launches the calls)."""
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(windows)]
    for start, end in marks:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) / iters
                             for start, end in marks)


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
    bitwise_repeat: bool = False  # a second call must give the same bits
    device_ms: bool = False  # also the device time a call (torch.profiler)
    graph_ms: bool = False  # also the device time a call (a CUDA graph)


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
            2 * B * Lx * C * 2 + 4 * C * C * 2 + mask.numel() * 4,
            bitwise_repeat=True, graph_ms=True)

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
                q, k, v, attn_mask=m, scale=hd ** -0.5),
            bitwise_repeat=True))
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
                    residual=x, bitwise_repeat=True, graph_ms=True))
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
                        q, k, v, attn_mask=m, scale=s),
                    bitwise_repeat=True))
                lse = torch.empty(B * nW, nH, Npad, device="cuda")
                out = _build.attention(qkv.view(-1, 3 * C), B * nW, Npad, nH,
                                       hd ** -0.5, bias=bias, mask=mask,
                                       lse=lse).view(B, nW, Npad, C)
                dout = _rnd(g, B, nW, Npad, C)
                dout[:, :, N:] = 0.0  # the recompute's pad rows: identity
                cases.append(Case(
                    swin_core_attn_bwd, f"B={B} stage {stage} C={C} nH={nH} "
                    f"{kind}", blocks, (qkv, lse, dout, bias, mask, nH,
                                        hd ** -0.5),
                    2.5 * core_flops, 2 * qkv_bytes + M * C * 2
                    + M * nH * 4 + bias.numel() * 6 + mask_bytes,
                    kw={"out": out}, compare=_core_compare(C),
                    library=_sdpa_bias_backward(
                        (sdpa_q, sdpa_k, sdpa_v), bias, mask, dout, B, nW,
                        nH, hd), bitwise_repeat=True))
            rows = x.reshape(-1, C)
            if train:  # K9: the MLP of every train block, no residual
                cases.append(Case(
                    fused_ln_mlp, f"B={B} stage {stage} M={M} C={C} "
                    f"HD={4 * C}", 2 * n_blocks, (rows, *mlp, 1e-5),
                    16.0 * M * C * C, 2 * M * C * 2 + mlp_bytes,
                    bitwise_repeat=True, graph_ms=True))
            elif stage == 4:  # K3: the stage-4 serving MLP + residual
                cases.append(Case(
                    fused_ln_mlp_chunked, f"B={B} stage 4 M={M} C={C} "
                    f"HD={4 * C}", 2, (rows, *mlp, 1e-5), 16.0 * M * C * C,
                    2 * M * C * 2 + mlp_bytes, residual=rows,
                    bitwise_repeat=True, graph_ms=True))
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
                    library=lambda s=src, i=rows_idx: s.index_select(1, i),
                    device_ms=True))

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
        2 * M * C * 2 + 4 * C * C * 2 + BATCH * L, bitwise_repeat=True,
        graph_ms=True))
    w1, b1 = lin(3072, C)
    w2, b2 = lin(C, 3072)
    cases.append(Case(
        fused_ffn_post_ln, f"M={M} C={C} HD=3072", 12,
        (x.reshape(-1, C), w1, b1, w2, b2, lw, lb, 1e-12),
        4.0 * M * C * 3072, 2 * M * C * 2 + 2 * C * 3072 * 2,
        bitwise_repeat=True, device_ms=True))
    # the KV decoder of 4 clips (phase 6 (b)): the prefill runs K4 and K5
    # over the 250 video tokens (every key open), each of the 19 steps K5
    # over 2 rows a clip
    Lp, n_steps = FRAMES * 50, GEN_LEN - 1
    xp = _rnd(g, BATCH, Lp, C)
    # the prefill (every key open), and at its L = 250 (keep rows off
    # 4-byte boundaries) with padded keys, checked, not counted
    keep_p = torch.ones(BATCH, Lp, dtype=torch.bool, device="cuda")
    keep_pad = keep_p.clone()
    for i, n in enumerate((0, 6, 14, Lp - 1)):  # one clip keeps one key
        keep_pad[i, Lp - n:] = False
    for kp, what, count in ((keep_p, "prefill (all keys open)", 12),
                            (keep_pad, "padded keys", 0)):
        cases.append(Case(
            fused_bert_attn_block_kmask, f"B={BATCH} L={Lp} C={C} nH={nH}, "
            f"{what}", count,
            (xp, wq, wk, wv, bq, bk, bv, wo, bo, lw, lb, kp, nH,
             (C // nH) ** -0.5, 1e-12),
            8.0 * BATCH * Lp * C * C + 4.0 * BATCH * Lp * Lp * C,
            2 * BATCH * Lp * C * 2 + 4 * C * C * 2 + BATCH * Lp,
            bitwise_repeat=True, graph_ms=count > 0))
    for rows, count, what in ((BATCH * Lp, 12, "prefill"),
                              (2 * BATCH, 12 * n_steps, "decode step")):
        xr = _rnd(g, rows, C)
        cases.append(Case(
            fused_ffn_post_ln, f"M={rows} C={C} HD=3072, {what}", count,
            (xr, w1, b1, w2, b2, lw, lb, 1e-12), 4.0 * rows * C * 3072,
            2 * rows * C * 2 + 2 * C * 3072 * 2, bitwise_repeat=True,
            device_ms=True))
    cases += _full_mask_cases(g, lin, ln)
    cases += _bert_train_cases(g, lin, ln)
    cases += _heads_train_cases(g)
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
    kernel reads none of them).  Each call twice, bitwise equal, and its
    device time a call in a CUDA graph."""
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
                                           stride=(1, 4, 4)),
            bitwise_repeat=True, graph_ms=True))
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
            compare=_shifted_compare(x, N), bitwise_repeat=True,
            graph_ms=True))
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
    path passes, at B=4 with the bias and shift mask as that forward
    passes them (bf16, rows padded to 16 bytes), at B=8 with the f32 mask;
    its library yardstick is scaled_dot_product_attention with bias +
    shift mask as one additive [W, nH, N, N] mask."""
    import torch.nn.functional as F

    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops import _build
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
                # K14 takes the bias and the mask as the model passes them,
                # bf16 in rows padded to 16 bytes (the serving cache's, the
                # stage's geometry, the remat step's gather)
                b14, m14 = (None if t is None else _build.with_padded_rows(t)
                            for t in (bias, mask_b))
                args = (x, n1w, n1b, wqkv, bqkv, wproj, bproj, b14, m14)
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
                    nbytes + mlp_bytes, residual=x, bitwise_repeat=True,
                    graph_ms=True))
                cases.append(Case(
                    fused_swin_block_attn, name + " attention half",
                    2 * n_kind if train else (n_kind if stage == 4 else 0),
                    (*args, *statics), flops, nbytes, residual=x,
                    bitwise_repeat=True, graph_ms=True))
                full = bias.float()[None].expand(B * nW, nH, N, N)
                if mask is not None:
                    full = (full.reshape(B, nW, nH, N, N)
                            + mask[None, :, None]).reshape(B * nW, nH, N, N)
                lib_mask = full.to(torch.bfloat16).contiguous()
                # the "pallas" serving forward (B=4) passes the bias and the
                # mask in bf16 in rows padded to 16 bytes (BasicLayer's
                # cache and geometry); B=8 (checked only) the f32 mask at
                # the rows' own pitch
                k_bias, k_mask = bias, mask
                if not train:
                    k_bias, k_mask = (
                        None if t is None else _build.with_padded_rows(
                            t.to(torch.bfloat16)) for t in (bias, mask))
                cases.append(Case(
                    fused_window_attention, f"W={B * nW} nH={nH} N={N} "
                    f"hd={hd} {kind} (B={B} stage {stage}"
                    f"{', bf16 padded rows' if not train else ''})",
                    0 if train else n_kind,
                    (q, k, v, k_bias, k_mask, hd ** -0.5), core_flops,
                    4 * B * nW * nH * N * hd * 2 + bias.numel() * 2
                    + (0 if k_mask is None
                       else k_mask.numel() * k_mask.element_size()),
                    library=lambda q=q, k=k, v=v, m=lib_mask, s=hd ** -0.5:
                    F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                   scale=s),
                    bitwise_repeat=True))
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
    captions, as a batch of shorter ones would; K10a and K10b also under
    the caption step's seq2seq mask at L = 276 and 275, and at rate 0.5,
    each call repeated and bitwise equal."""
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
            4 * slab_bytes + mask_bytes + lse_bytes, bitwise_repeat=True,
            library=lambda r=rate: F.scaled_dot_product_attention(
                *sdpa, attn_mask=sdpa_mask, dropout_p=r, scale=scale)))
    # the caption step's seq2seq mask (a row per text token sees the video
    # and the text before it), at L = 250 + 26 and its own 250 + 25
    s2s_masks = {n_txt: torch.where(
        _seq2seq_keep(B, L - TXT_LEN, n_txt), 0.0, -1e4).to(torch.bfloat16)
        for n_txt in (TXT_LEN, CAP_LEN)}
    for n_txt, s2s in s2s_masks.items():
        n_tok = L - TXT_LEN + n_txt
        slab_t = slab if n_tok == L else _rnd(g, B, n_tok, 3 * C)
        for rate in (0.1, 0.5):
            cases.append(Case(
                fused_encoder_attention_train_lanes, f"B={B} L={n_tok} "
                f"C={C} nH={nH} rate {rate}, seq2seq mask", 0,
                (*slab_t.split(C, dim=-1), s2s, seed, scale, rate, nH),
                4.0 * B * nH * n_tok * n_tok * hd,
                4 * B * n_tok * C * 2 + s2s.numel() * 2 + B * nH * n_tok * 4,
                bitwise_repeat=True))

    def bwd_case(n_tok, kind, mask, rate, count, library=None):
        """K10b (the tensor-core backward) on a slab of n_tok tokens, its
        lse from K10a's forward; checked twice for the same bits."""
        slab_t = slab if n_tok == L else _rnd(g, B, n_tok, 3 * C)
        lse = torch.empty(B, nH, n_tok, device="cuda")
        out = _build.attention(slab_t.view(B * n_tok, 3 * C), B, n_tok, nH,
                               scale, mask=mask, lse=lse, seed=seed,
                               rate=rate).view(B, n_tok, C)
        dout = dout_l if n_tok == L else _rnd(g, B, n_tok, C)
        flops = 10.0 * B * nH * n_tok * n_tok * hd  # the five products
        return Case(
            encoder_attention_train_lanes_bwd, f"B={B} L={n_tok} C={C} "
            f"nH={nH} rate {rate}, {kind}", count,
            (*slab_t.split(C, dim=-1), mask, seed, dout, scale, rate, nH),
            flops, 7 * B * n_tok * C * 2 + mask.numel() * 2 + B * nH * n_tok
            * 4, kw={"lse": lse, "o": out}, compare=_grads_compare,
            library=library, bitwise_repeat=True)

    dout_l = _rnd(g, B, L, C)
    # SDPA's backward alone: autograd of one forward, replayed
    leaves = [t.detach().requires_grad_(True) for t in sdpa]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask,
                                       dropout_p=0.1, scale=scale)
    d_heads = dout_l.view(B, L, nH, hd).transpose(1, 2)
    cases.append(bwd_case(L, "padded keys", mask, 0.1, layers, library=(
        lambda: torch.autograd.grad(o, leaves, d_heads, retain_graph=True))))
    cases.append(bwd_case(L, "padded keys", mask, 0.5, 0))
    for n_txt, s2s in s2s_masks.items():
        for rate in (0.1, 0.5):
            cases.append(bwd_case(L - TXT_LEN + n_txt, "seq2seq mask", s2s,
                                  rate, 0))
    x, res = _rnd(g, M, C), _rnd(g, M, C)
    wo, bo = lin(C, C)
    lw, lb = ln(C)
    # the default step's 64 pairs, also at rate 0.5, and the caption
    # step's 8 clips of 275 tokens (checked, not counted)
    for rows, rate, count, what in (
            (M, 0.1, layers, "train step"), (M, 0.5, 0, "train step"),
            (TRAIN_BATCH * (L - 1), 0.1, 0, "caption step")):
        cases.append(Case(
            fused_out_ln_train, f"M={rows} C={C} rate {rate}, {what}", count,
            (x[:rows], res[:rows], wo, bo, lw, lb, seed, 1e-12, rate),
            2.0 * rows * C * C, 3 * rows * C * 2 + rows * C + C * C * 2,
            compare=_keep_compare, bitwise_repeat=True, graph_ms=True))
    w1, b1 = lin(3072, C)
    w2, b2 = lin(C, 3072)
    for rate, count in ((0.1, layers), (0.5, 0)):
        cases.append(Case(
            fused_ffn_post_ln_train, f"M={M} C={C} HD=3072 rate {rate}",
            count, (x, w1, b1, w2, b2, lw, lb, seed, 1e-12, rate),
            4.0 * M * C * 3072, 2 * M * C * 2 + M * C + 2 * C * 3072 * 2,
            compare=_keep_compare, bitwise_repeat=True, graph_ms=True))
    return cases


def _heads_grads_compare(got, want):
    """K13b: dq, dk, dv and, where formed, dmask each against the plain
    version's."""
    names = ("dq", "dk", "dv", "dmask")
    if (got[3] is None) != (want[3] is None):
        raise AssertionError("K13b: dmask formed on one side only")
    results = [(nm, *_compare(a, b, TOL, GRAD_REL_L2))
               for nm, a, b in zip(names, got, want) if b is not None]
    detail = ", ".join(f"{nm} {e:.3g}/{r:.3g}" for nm, e, r, _ in results)
    return (max(e for _, e, _, _ in results),
            max(r for _, _, r, _ in results), all(ok for *_, ok in results),
            f" (max_abs/rel_l2: {detail}; rel_l2 <= {GRAD_REL_L2})")


def _heads_train_cases(g):
    """K13a / K13b, the fusion encoder's train attention under
    LVT_ATTNLANES=0, at the retrieval train step's shapes: 64 pairs at
    L = 276, 12 heads of 64, rate 0.1 (the same seed for kernel and plain
    version), q, k and v the [B, nH, L, hd] views of one qkv slab that the
    model passes; the key mask padding some captions and the seq2seq mask,
    both f32 at 0 / finfo(f32).min as the model passes them; K13a and K13b
    also at rate 0.5 and at the caption step's L = 275 (seq2seq), each
    call repeated and bitwise equal; K13b also with
    the mask's gradient (dmask, checked only: the model's mask never
    requires grad).  Timed into the kernels line: the padded-keys shape,
    12 calls a step.  The one-call yardstick: scaled_dot_product_attention
    on the same heads views with the float mask and dropout_p, and its
    backward."""
    import torch.nn.functional as F

    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.encoder_attention import (
        encoder_attention_train_bwd, fused_encoder_attention_train)

    B, C, nH, L = TRAIN_BATCH ** 2, 768, 12, FRAMES * 50 + TXT_LEN
    hd, rate, layers = C // nH, 0.1, 12
    scale = hd ** -0.5
    slab = _rnd(g, B, L, 3 * C)
    q, k, v = slab.view(B, L, 3, nH, hd).permute(2, 0, 3, 1, 4)
    n_txt = torch.randint(5, TXT_LEN + 1, (B,), generator=g, device="cuda")
    n_txt[0] = TXT_LEN
    pad = torch.arange(L, device="cuda")[None] >= L - TXT_LEN + n_txt[:, None]
    big_neg = torch.finfo(torch.float32).min
    masks = {"padded keys": torch.where(pad, big_neg, 0.0)[:, None, :].expand(
        B, L, L).contiguous(), "seq2seq mask": torch.where(
            _seq2seq_keep(B, L - TXT_LEN, TXT_LEN), 0.0, big_neg)}
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda")
    dout = _rnd(g, B, nH, L, hd)
    core_flops = 4.0 * B * nH * L * L * hd
    slab_bytes, mask_bytes, lse_bytes = B * L * C * 2, B * L * L * 4, (
        B * nH * L * 4)
    cases = []
    for kind, mask in masks.items():
        count = layers if kind == "padded keys" else 0
        sdpa_mask = mask.clamp_min(-1e4)[:, None].to(torch.bfloat16)
        for r in (rate, 0.5):  # 0.5 checked only
            cases.append(Case(
                fused_encoder_attention_train, f"B={B} nH={nH} L={L} "
                f"hd={hd} rate {r}, {kind}, heads views of the qkv slab",
                count if r == rate else 0,
                (q, k, v, mask, seed, scale, r), core_flops,
                4 * slab_bytes + mask_bytes + lse_bytes, bitwise_repeat=True,
                library=None if r != rate else (
                    lambda m=sdpa_mask: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=m, dropout_p=rate, scale=scale))))
        lse = torch.empty(B, nH, L, device="cuda")
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask,
                                           dropout_p=rate, scale=scale)
        for r in (rate, 0.5):  # the tensor-core backward; 0.5 checked only
            # its D = rowsum(out * dout) needs the output of this rate
            out = _build.attention_heads(q, k, v, mask.clamp_min(-1e4), scale,
                                         lse=lse, seed=seed, rate=r)
            cases.append(Case(
                encoder_attention_train_bwd, f"B={B} nH={nH} L={L} hd={hd} "
                f"rate {r}, {kind}", count if r == rate else 0,
                (q, k, v, mask, seed, dout, scale, r), 2.5 * core_flops,
                7 * slab_bytes + mask_bytes + lse_bytes,
                kw={"lse": lse, "o": out},
                compare=_heads_grads_compare, bitwise_repeat=True,
                library=None if r != rate else (
                    lambda o=o, leaves=leaves: torch.autograd.grad(
                        o, leaves, dout, retain_graph=True))))
        if kind == "padded keys":  # the f32-pipe kernel, which forms dmask
            cases.append(Case(
                encoder_attention_train_bwd, f"B={B} nH={nH} L={L} hd={hd} "
                f"rate {rate}, {kind}, with dmask", 0,
                (q, k, v, mask, seed, dout, scale, rate), 2.5 * core_flops,
                7 * slab_bytes + 2 * mask_bytes + lse_bytes,
                kw={"lse": lse, "dmask": True},
                compare=_heads_grads_compare, bitwise_repeat=True))
    # the caption step's L = 250 + 25 under its seq2seq mask
    n_tok = L - TXT_LEN + CAP_LEN
    slab_c = _rnd(g, B, n_tok, 3 * C)
    qc, kc, vc = slab_c.view(B, n_tok, 3, nH, hd).permute(2, 0, 3, 1, 4)
    mask_c = torch.where(_seq2seq_keep(B, L - TXT_LEN, CAP_LEN), 0.0,
                         big_neg)
    lse_c = torch.empty(B, nH, n_tok, device="cuda")
    out_c = _build.attention_heads(qc, kc, vc, mask_c.clamp_min(-1e4), scale,
                                   lse=lse_c, seed=seed, rate=rate)
    cases.append(Case(
        fused_encoder_attention_train, f"B={B} nH={nH} L={n_tok} hd={hd} "
        f"rate {rate}, seq2seq mask, heads views of the qkv slab", 0,
        (qc, kc, vc, mask_c, seed, scale, rate),
        4.0 * B * nH * n_tok * n_tok * hd,
        4 * B * n_tok * C * 2 + B * n_tok * n_tok * 4 + B * nH * n_tok * 4,
        bitwise_repeat=True))
    cases.append(Case(
        encoder_attention_train_bwd, f"B={B} nH={nH} L={n_tok} hd={hd} "
        f"rate {rate}, seq2seq mask", 0,
        (qc, kc, vc, mask_c, seed, _rnd(g, B, nH, n_tok, hd), scale, rate),
        10.0 * B * nH * n_tok * n_tok * hd,
        7 * B * n_tok * C * 2 + B * n_tok * n_tok * 4 + B * nH * n_tok * 4,
        kw={"lse": lse_c, "o": out_c}, compare=_heads_grads_compare,
        bitwise_repeat=True))
    return cases


def _probe_keep(run, B, nH, L, hd):
    """The keep mask [B, nH, L, L] a train attention kernel drew, read back
    exactly: with q = k = 0 every probability is 1 / L, and v one-hot in
    key j = offset + d puts probability (i, j), 0 where dropped, at output
    column d.  ``run(q, k, v)`` takes [B, nH, L, hd] bf16 heads views."""
    keep = torch.zeros(B, nH, L, L, dtype=torch.bool, device="cuda")
    slab = torch.zeros(B, L, 3, nH, hd, dtype=torch.bfloat16, device="cuda")
    q, k, v = slab.permute(2, 0, 3, 1, 4)
    for off in range(0, L, hd):
        n = min(hd, L - off)
        v.zero_()
        v[:, :, off:off + n].copy_(torch.eye(n, hd, device="cuda"))
        keep[..., off:off + n] = run(q, k, v)[..., :n] > 0
    return keep


def _heads_vs_lanes(g):
    """K13a on heads views of a qkv slab against K10a on the slab itself,
    one seed, at the train step's shape (64 pairs, L = 276, rate 0.1): the
    keep masks both kernels drew, read back exactly, each equal to
    ``dropout.attention_keep``; the outputs equal to bf16 rounding."""
    from lavender_tpu_torch.ops import dropout
    from lavender_tpu_torch.ops.encoder_attention import (
        fused_encoder_attention_train, fused_encoder_attention_train_lanes)

    B, C, nH, L, rate = TRAIN_BATCH ** 2, 768, 12, FRAMES * 50 + TXT_LEN, 0.1
    hd = C // nH
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda")
    # the probe's mask opens every key; the outputs' pads some captions
    open_keys = torch.zeros(B, L, L, device="cuda")
    padded = open_keys.clone()
    padded[1:, :, L - 10:] = torch.finfo(torch.float32).min

    def heads(q, k, v, mask=open_keys, scale=1.0):
        return fused_encoder_attention_train(q, k, v, mask, seed, scale, rate)

    def lanes(q, k, v, mask=open_keys, scale=1.0):
        t = [x.transpose(1, 2).reshape(B, L, C) for x in (q, k, v)]
        o = fused_encoder_attention_train_lanes(
            *t, mask.clamp_min(-1e4).to(torch.bfloat16), seed, scale, rate,
            nH)
        return o.view(B, L, nH, hd).transpose(1, 2)

    want = dropout.attention_keep(seed, B, nH, L, rate)
    n_diff = {name: int((_probe_keep(run, B, nH, L, hd) != want).sum())
              for name, run in (("K13a", heads), ("K10a", lanes))}
    slab = _rnd(g, B, L, 3 * C)
    q, k, v = slab.view(B, L, 3, nH, hd).permute(2, 0, 3, 1, 4)
    o13 = heads(q, k, v, padded, hd ** -0.5)
    o10 = lanes(q, k, v, padded, hd ** -0.5)
    err, rel, ok = _compare(o13, o10, TOL, REL_L2)
    n_out = int((o13 != o10).sum())
    print(f"[kernel] K13a vs K10a, B={B} L={L} rate {rate}, one seed: keep "
          f"masks read back from the kernels differ from "
          f"dropout.attention_keep in {n_diff['K13a']} (K13a) and "
          f"{n_diff['K10a']} (K10a) of {want.numel()} (kept "
          f"{float(want.float().mean()):.4f}); outputs differ in {n_out} of "
          f"{o13.numel()} elements, max_abs_err {err:.4g} rel_l2 {rel:.3g}",
          flush=True)
    if n_diff["K13a"] or n_diff["K10a"] or not ok:
        raise AssertionError("K13a and K10a draw other keep masks or "
                             "disagree")


def _train_fwd_lse(g):
    """The row log-sum-exp that K10a and K13a (the tensor-core forward)
    write for their backward, against torch.logsumexp of the plain scores
    in f64, at the train step's 64 pairs and 12 heads of 64, rates 0.1 and
    0.5: padded keys and the seq2seq mask at L = 276, the seq2seq mask at
    the caption step's L = 275 (K10a's mask bf16, K13a's f32, both at
    -1e4 as the Functions clamp them); max |lse - want| <= 1e-3 and a
    second call bitwise equal."""
    from lavender_tpu_torch.ops import _build

    B, C, nH, L = TRAIN_BATCH ** 2, 768, 12, FRAMES * 50 + TXT_LEN
    hd = C // nH
    scale = hd ** -0.5
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda")
    n_txt = torch.randint(5, TXT_LEN + 1, (B,), generator=g, device="cuda")
    pad = torch.arange(L, device="cuda")[None] >= L - TXT_LEN + n_txt[:, None]
    masks = [(L, "padded keys", torch.where(pad, -1e4, 0.0)[:, None, :]
              .expand(B, L, L).contiguous())]
    masks += [(L - TXT_LEN + n, "seq2seq mask", torch.where(
        _seq2seq_keep(B, L - TXT_LEN, n), 0.0, -1e4)) for n in (TXT_LEN,
                                                               CAP_LEN)]
    for n_tok, kind, mask in masks:
        slab = _rnd(g, B, n_tok, 3 * C)
        q, k, v = slab.view(B, n_tok, 3, nH, hd).permute(2, 0, 3, 1, 4)
        for name, m in (("K10a", mask.to(torch.bfloat16)), ("K13a", mask)):
            want = torch.logsumexp(
                (q.double() @ k.double().transpose(-1, -2)) * scale
                + m.double()[:, None], dim=-1)
            for rate in (0.1, 0.5):
                got = [torch.empty(B, nH, n_tok, device="cuda")
                       for _ in range(2)]
                for lse in got:
                    if name == "K10a":
                        _build.attention(slab.view(B * n_tok, 3 * C), B,
                                         n_tok, nH, scale, mask=m, lse=lse,
                                         seed=seed, rate=rate)
                    else:
                        _build.attention_heads(q, k, v, m, scale, lse=lse,
                                               seed=seed, rate=rate)
                err = float((got[0].double() - want).abs().max())
                same = torch.equal(got[0], got[1])
                print(f"[kernel] {name} lse, B={B} L={n_tok} rate {rate}, "
                      f"{kind}: max |lse - logsumexp of the plain scores| "
                      f"{err:.3g} (<= 1e-3), a second call "
                      f"{'bitwise equal' if same else 'DIFFERS'}",
                      flush=True)
                if err > 1e-3 or not same:
                    raise AssertionError(f"{name} lse, L={n_tok} rate {rate}"
                                         f", {kind}: off or not repeatable")


def _swin_core_lse_and_dbias(g):
    """K8a's row log-sum-exp (the tensor-core forward with the per-head
    bias) against torch.logsumexp of the plain scores q k^T * scale + bias
    + mask in f64, at the train step's B=8 at every Swin-B stage, shifted
    and unshifted, and at the spatial route's unpadded N = 245 (stages 1
    and 3, shifted): max |lse - want| <= 1e-3 and a second call bitwise
    equal.  Then K8b's dbias at B=8, stage 1, shifted (512 windows)
    against the f64 sum of the plain version's per-clip dbias (each over
    its 64 windows in f32): max |dbias - want| <= 1e-2 * max(1, max|want|).
    The bias is drawn as in ``_kernel_cases`` (std 1), the mask is
    Swin-B's shift mask."""
    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.swin_block_attn import (
        pad_window_mask, rel_pos_bias_wm)
    from lavender_tpu_torch.ops.swin_core_attn import swin_core_attn_bwd

    window, shift, N, B = (5, 7, 7), (0, 3, 3), 245, TRAIN_BATCH
    rel_index = relative_position_index((8, 7, 7))
    runs = [(st, n_tok, shifted) for st in SWIN_STAGES
            for n_tok, shifted in ((248, False), (248, True))
            if shifted is False or st[0] < 4]
    runs += [(SWIN_STAGES[i], N, True) for i in (0, 2)]
    for (stage, nW, C, nH, side, _), n_tok, shifted in runs:
        hd = C // nH
        scale = hd ** -0.5
        table = _rnd(g, 15 * 13 * 13, nH, std=1.0)
        bias = rel_pos_bias_wm(table, rel_index, N, n_tok, torch.bfloat16)
        mask = None
        if shifted:
            mask = torch.as_tensor(compute_shift_mask(5, side, side, window,
                                                      shift), device="cuda")
            mask = pad_window_mask(mask, n_tok).to(torch.bfloat16)
        qkv = _rnd(g, B, nW, n_tok, 3 * C)
        q, k, _ = qkv.view(B, nW, n_tok, 3, nH, hd).permute(3, 0, 1, 4, 2, 5)
        s = (q.double() @ k.double().transpose(-1, -2)) * scale
        s += bias.double()
        if mask is not None:
            s += mask.double()[None, :, None]
        want = torch.logsumexp(s, dim=-1).reshape(B * nW, nH, n_tok)
        del s
        got = [torch.empty(B * nW, nH, n_tok, device="cuda")
               for _ in range(2)]
        outs = [_build.attention(qkv.view(-1, 3 * C), B * nW, n_tok, nH,
                                 scale, bias=bias, mask=mask, lse=lse)
                for lse in got]
        err = float((got[0].double() - want).abs().max())
        same = torch.equal(got[0], got[1]) and torch.equal(*outs)
        kind = "shifted" if shifted else "unshifted"
        print(f"[kernel] K8a lse, B={B} stage {stage} N={n_tok} {kind}: max "
              f"|lse - logsumexp of the plain scores| {err:.3g} (<= 1e-3), "
              f"a second call {'bitwise equal' if same else 'DIFFERS'}",
              flush=True)
        if err > 1e-3 or not same:
            raise AssertionError(f"K8a lse, stage {stage} N={n_tok} {kind}: "
                                 "off or not repeatable")
        if stage != 1 or not shifted or n_tok != 248:
            continue
        dout = _rnd(g, B, nW, n_tok, C)
        dout[:, :, N:] = 0.0
        _, dbias = swin_core_attn_bwd(qkv, got[0], dout, bias, mask, nH,
                                      scale, out=outs[0].view(dout.shape))
        want = torch.zeros(nH, n_tok, n_tok, dtype=torch.float64,
                           device="cuda")
        for b in range(B):
            _, db = swin_core_attn_bwd.plain(qkv[b:b + 1], None,
                                             dout[b:b + 1], bias, mask, nH,
                                             scale)
            want += db.double()
        err = float((dbias.double() - want).abs().max())
        bound = 1e-2 * max(1.0, float(want.abs().max()))
        print(f"[kernel] K8b dbias, B={B} stage 1 shifted ({B * nW} "
              f"windows): max |dbias - f64 sum of the plain per-clip dbias| "
              f"{err:.4g} (<= {bound:.4g})", flush=True)
        if err > bound:
            raise AssertionError("K8b dbias off the f64 sum")


def _bert_core_vs_sdpa(g, L=FRAMES * 50 + TXT_LEN, padded=True):
    """K4's attention core alone (the part one PyTorch call computes): the
    tensor-core forward on the packed slab with the key-keep vector vs
    scaled_dot_product_attention with the same key-padding mask, B=4, L
    tokens (serving's 276 with padded captions; the prefill's 250, every
    key open).  Returns the two callables."""
    import torch.nn.functional as F

    from lavender_tpu_torch.ops import _build

    C, nH = 768, 12
    qkv = _rnd(g, BATCH * L, 3 * C)
    keep = torch.ones(BATCH, L, dtype=torch.bool, device="cuda")
    if padded:
        keep[1:, L - 10:] = False
    q, k, v = qkv.view(BATCH, L, 3, nH, C // nH).permute(2, 0, 3, 1, 4)
    m = keep[:, None, None, :]
    return (lambda: _build.attention(qkv, BATCH, L, nH, (C // nH) ** -0.5,
                                     keep=keep, tensor_cores=True),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m))


class _Parts:
    """Parts of a kernel, each against one PyTorch call: ``add`` times
    both in turns (event and device ms a call, ``_graph_ms``) and prints
    them; ``summary`` prints per group the worst device ratio and the
    ratio of the device times summed over the shapes' calls in the
    counted runs."""

    def __init__(self):
        self.worst, self.sums = {}, {}

    def add(self, group, name, kernel, library, count):
        t = [_time_ms(f) for f in (library, kernel, kernel, library)]
        ev_k, ev_l = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        g = [_graph_ms(f) for f in (library, kernel, kernel, library)]
        dev_k, dev_l = (g[1] + g[2]) / 2, (g[0] + g[3]) / 2
        self.worst[group] = max(self.worst.get(group, 0.0), dev_k / dev_l)
        k, l = self.sums.get(group, (0.0, 0.0))
        self.sums[group] = (k + count * dev_k, l + count * dev_l)
        print(f"[part] {name}: {ev_k:.4f} ms ({dev_k:.4f} device) vs "
              f"{ev_l:.4f} ms ({dev_l:.4f} device): {ev_k / ev_l:.2f}x "
              f"event, {dev_k / dev_l:.2f}x device, x{count}", flush=True)

    def summary(self, gate: str):
        print("[part] device ratio, worst shape / summed over the counted "
              "runs' calls of these shapes: " + ", ".join(
                  f"{k} {v:.2f}x / {self.sums[k][0] / self.sums[k][1]:.2f}x"
                  for k, v in self.worst.items())
              + f" ({gate}; {_nvidia_smi()})", flush=True)


def _k1_k4_parts(g):
    """K1's and K4's parts, each against one PyTorch call, at the shapes
    of the B=4 serving forward and the B=8 train step (K1) and of serving
    and the KV prefill (K4): each product of the tile GEMM
    (``_build.gemm_tc``; K4's proj + residual + LN ``_build.gemm_tc_ln``,
    its K-slices and row kernel) against F.linear at its shape (K4's q |
    k | v, one launch, against one F.linear of the three weights stacked),
    and each core on the tensor cores against
    scaled_dot_product_attention: K1's with the rel-pos bias + shift mask
    as one additive mask (as K8a's case builds it), K4's with the
    key-padding mask (``_bert_core_vs_sdpa``).  Prints event and device ms
    a call (``_graph_ms``), in turns, and their ratios, and per group the
    worst device ratio and the ratio of the device times summed over the
    shapes' calls in the counted runs (the cores: the shifted ones at
    stages 1-3)."""
    import torch.nn.functional as F

    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.swin_block_attn import (
        pad_window_mask, rel_pos_bias_wm)

    parts = _Parts()
    part = parts.add
    window, shift, N, Npad = (5, 7, 7), (0, 3, 3), 245, 248
    for stage, nW, C, nH, side, pairs in SWIN_STAGES:
        hd = C // nH
        bias = rel_pos_bias_wm(_rnd(g, 15 * 13 * 13, nH),
                               relative_position_index((8, 7, 7)), N, Npad,
                               torch.bfloat16)
        ws = {n: (_rnd(g, o, i, std=i ** -0.5), _rnd(g, o, std=0.02))
              for n, o, i in (("qkv", 3 * C, C), ("proj", C, C),
                              ("fc1", 4 * C, C), ("fc2", C, 4 * C))}
        mask = None
        if stage < 4:
            mask = pad_window_mask(torch.as_tensor(compute_shift_mask(
                5, side, side, window, shift), device="cuda"),
                Npad).to(torch.bfloat16)
        for B in (BATCH, TRAIN_BATCH):
            M = B * nW * Npad
            a, r = _rnd(g, M, C), _rnd(g, M, C)
            names = ["qkv", "proj"] + (
                ["fc1", "fc2"] if stage < 4 and B == BATCH else [])
            for n in names:
                w, b = ws[n]
                x = _rnd(g, M, 4 * C) if n == "fc2" else a
                kw = {"gelu": n == "fc1",
                      "residual": r if n in ("proj", "fc2") else None}
                part("K1 products", f"K1 B={B} stage {stage} {n} M={M} "
                     f"N={w.shape[0]} K={w.shape[1]}"
                     f"{' +GELU' if kw['gelu'] else ''}"
                     f"{' +residual' if kw['residual'] is not None else ''}"
                     " vs F.linear",
                     lambda x=x, w=w, b=b, kw=kw: _build.gemm_tc(x, w, b,
                                                                  **kw),
                     lambda x=x, w=w, b=b: F.linear(x, w, b), 2 * pairs)
                del x
            qkv = _rnd(g, M, 3 * C)
            q, k, v = qkv.view(B * nW, Npad, 3, nH, hd).permute(2, 0, 3, 1, 4)
            full = bias[None].expand(B * nW, nH, Npad, Npad)
            if mask is not None:
                full = (full.view(B, nW, nH, Npad, Npad)
                        + mask[None, :, None]).view_as(full)
            full = full.contiguous()
            part("K1 cores", f"K1 B={B} stage {stage} core nH={nH} "
                 f"{'shifted' if mask is not None else 'unshifted'} vs SDPA "
                 "(bias + mask as one additive mask)",
                 lambda qkv=qkv, B=B: _build.attention(
                     qkv, B * nW, Npad, nH, hd ** -0.5, bias=bias, mask=mask,
                     tensor_cores=True),
                 lambda q=q, k=k, v=v, m=full: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=m, scale=hd ** -0.5),
                 pairs if mask is not None else 2 * pairs)
            del a, r, qkv, q, k, v, full
    C = 768
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (
        (_rnd(g, C, C, std=C ** -0.5), _rnd(g, C, std=0.02))
        for _ in range(4))
    w3, b3 = torch.cat([wq, wk, wv]), torch.cat([bq, bk, bv])
    lw, lb = 1.0 + _rnd(g, C, std=0.1), _rnd(g, C, std=0.1)
    for L, what, padded in ((FRAMES * 50 + TXT_LEN, "serving", True),
                            (FRAMES * 50, "prefill", False)):
        M = BATCH * L
        x, o = _rnd(g, M, C), _rnd(g, M, C)
        part("K4 products", f"K4 {what} qkv (3 weights, 1 launch) M={M} "
             f"N={C}x3 K={C} vs F.linear of the stacked weights",
             lambda x=x: _build.gemm_tc(x, (wq, wk, wv), (bq, bk, bv)),
             lambda x=x: F.linear(x, w3, b3), 12)
        part("K4 products", f"K4 {what} proj + residual + LN (K-slices, "
             f"row kernel) M={M} N={C} K={C} vs F.linear",
             lambda x=x, o=o: _build.gemm_tc_ln(o, wo, bo, x, lw, lb, 1e-12),
             lambda o=o: F.linear(o, wo, bo), 12)
        part("K4 cores", f"K4 {what} core B={BATCH} L={L} nH=12 vs SDPA "
             "(key-padding mask)", *_bert_core_vs_sdpa(g, L, padded), 12)
    parts.summary("gate 1.25x")


def _k3_k9_parts(g):
    """K3's and K9's parts, each against one PyTorch call, at the shapes
    of the B=8 train step (K9, no residual, stages 1-4) and of B=4
    serving's stage 4 (K3, + residual): fc1 + GELU on the tile GEMM
    (``_build.gemm_tc``) against F.gelu(F.linear(...)), fc1 with the bias
    epilogue alone against F.linear, fc2 (+ residual) as ``ln_mlp_plan``
    runs it against F.linear (K-slices: the tile GEMM's partial
    epilogue alone, without the row kernel that sums them), and the whole
    C call (``_build.ln_mlp``) against its plain version, which is LN,
    F.linear, F.gelu, F.linear (+ x).  Prints as ``_k1_k4_parts``
    does."""
    import torch.nn.functional as F

    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.fused_mlp import fused_ln_mlp

    parts = _Parts()
    lib = _build.library()
    shapes = [("K9", TRAIN_BATCH, stage, nW, C, 2 * pairs, False)
              for stage, nW, C, _, _, pairs in SWIN_STAGES]
    shapes.append(("K3", BATCH, 4, 1, 1024, 2, True))
    for kid, B, stage, nW, C, count, residual in shapes:
        M, HD = B * nW * 248, 4 * C
        x, h = _rnd(g, M, C), _rnd(g, M, HD)
        mlp = (1.0 + _rnd(g, C, std=0.1), _rnd(g, C, std=0.1),
               _rnd(g, HD, C, std=C ** -0.5), _rnd(g, HD, std=0.02),
               _rnd(g, C, HD, std=HD ** -0.5), _rnd(g, C, std=0.02))
        w1, b1, w2, b2 = mlp[2:]
        plan = _build.ln_mlp_plan(M, C, HD, residual)
        at = f"{kid} B={B} stage {stage} M={M} C={C}"
        parts.add(f"{kid} fc1", f"{at} fc1 + GELU vs F.gelu(F.linear)",
                  lambda: _build.gemm_tc(x, w1, b1, gelu=True),
                  lambda: F.gelu(F.linear(x, w1, b1)), count)
        parts.add(f"{kid} fc1", f"{at} fc1 (bias alone) vs F.linear",
                  lambda: _build.gemm_tc(x, w1, b1),
                  lambda: F.linear(x, w1, b1), count)
        r = x if residual else None
        if plan.splits == 1:
            fc2 = lambda: _build.gemm_tc(h, w2, b2, residual=r)
            how = f"bm {plan.fc2_bm}"
        else:
            part = torch.empty(plan.splits * M * C, device="cuda")

            def fc2(part=part):  # the partial epilogue, as ln_mlp runs it
                _build._raise_on(lib.lvt_gemm_tc_bf16(
                    h.data_ptr(), HD, w2.data_ptr(), None, None, None, None,
                    None, 1, None, 0, part.data_ptr(), C, M, C, HD, 3,
                    plan.fc2_bm, plan.splits,
                    torch.cuda.current_stream().cuda_stream),
                    "lvt_gemm_tc_bf16")
            how = (f"{plan.splits} f32 K-slices at bm {plan.fc2_bm}, "
                   "without their row sum")
        parts.add(f"{kid} fc2", f"{at} fc2{' + residual' if residual else ''}"
                  f" ({how}) vs F.linear", fc2,
                  lambda: F.linear(h, w2, b2), count)
        parts.add(f"{kid} whole", f"{at} the one C call vs the plain version",
                  lambda: _build.ln_mlp(x, *mlp, 1e-5, residual),
                  lambda: fused_ln_mlp.plain(x, *mlp, 1e-5, residual), count)
        del x, h
    parts.summary("no gate")


def _k6_k11_parts(g):
    """K11's two parts at the default step's 64 x 276 rows and the caption
    step's 8 x 275 (C = 768, rate 0.1): the proj as the split plan's f32
    K-slices (the tile GEMM's partial epilogue alone) against F.linear,
    and the row kernel's dropout mode (the whole C call less the proj)
    against its bytes at 3.35 TB/s (the slices read, the residual read,
    out and the keep mask written), each as device time a call in a CUDA
    graph (``_graph_ms``), in turns; at the caption step's rows also the
    whole call at 2 K-slices of 128 rows beside the plan's.  K6's core
    under the clamped bf16 seq2seq mask in rows padded to 16 bytes (B=4,
    L=275; the tensor-core forward on heads views of one qkv slab, the
    kernel the C call launches) against scaled_dot_product_attention with
    that mask.  Prints ``_Parts``'s lines."""
    import torch.nn.functional as F

    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.dropout import threshold
    from lavender_tpu_torch.ops.encoder_attention import padded_clamped_mask

    parts = _Parts()
    lib = _build.library()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    C, L = 768, FRAMES * 50 + TXT_LEN
    w, b = _rnd(g, C, C, std=C ** -0.5), _rnd(g, C, std=0.02)
    lw, lb = 1.0 + _rnd(g, C, std=0.1), _rnd(g, C, std=0.1)
    seed = torch.tensor([1234], device="cuda")
    thresh = threshold(0.1)
    for M, what in ((TRAIN_BATCH ** 2 * L, "train step"),
                    (TRAIN_BATCH * (L - 1), "caption step")):
        o, res = _rnd(g, M, C), _rnd(g, M, C)
        plan = _build.gemm_tc_plan(M, C, C, split=True)
        part = torch.empty(2 * M * C, device="cuda")
        keep = torch.empty(M, C, dtype=torch.bool, device="cuda")
        out = torch.empty_like(res)

        def proj(bm=plan.bm, S=plan.splits):
            _build._raise_on(lib.lvt_gemm_tc_bf16(
                o.data_ptr(), C, w.data_ptr(), None, None, None, None, None,
                1, None, 0, part.data_ptr(), C, M, C, C, 3, bm, S, stream()),
                "lvt_gemm_tc_bf16")

        def whole(bm=plan.bm, S=plan.splits):
            _build._raise_on(lib.lvt_gemm_tc_dropout_ln_bf16(
                o.data_ptr(), C, w.data_ptr(), b.data_ptr(), res.data_ptr(),
                lw.data_ptr(), lb.data_ptr(), part.data_ptr(),
                out.data_ptr(), keep.data_ptr(), M, C, C, bm, S, 1e-12,
                seed.data_ptr(), thresh, 1.0 / 0.9, stream()),
                "lvt_gemm_tc_dropout_ln_bf16")

        at = (f"K11 {what} M={M} C={C} (plan: bm {plan.bm}, "
              f"{plan.splits} K-slice(s))")
        count = 12 if what == "train step" else 0
        parts.add("K11 proj", f"{at} proj K-slices vs F.linear", proj,
                  lambda: F.linear(o, w, b), count)
        t = [_graph_ms(f) for f in (proj, whole, whole, proj)]
        rows_ms = (t[1] + t[2] - t[0] - t[3]) / 2
        nbytes = plan.splits * M * C * 4 + 2 * M * C * 2 + M * C + 3 * C * 2
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[part] {at} row kernel (dropout mode): {rows_ms:.4f} ms of "
              f"device time (the call {(t[1] + t[2]) / 2:.4f} less the proj "
              f"{(t[0] + t[3]) / 2:.4f}) vs {nbytes / 1e6:.1f} MB at 3.35 "
              f"TB/s {bound:.4f} ms: {rows_ms / bound:.2f}x, "
              f"{nbytes / rows_ms / 1e9:.2f} TB/s", flush=True)
        if what == "caption step":
            t = [_graph_ms(f) for f in (whole, lambda: whole(128, 2),
                                        lambda: whole(128, 2), whole)]
            print(f"[part] {at} the whole call, the plan's "
                  f"{(t[0] + t[3]) / 2:.4f} ms vs 2 K-slices at bm 128 "
                  f"{(t[1] + t[2]) / 2:.4f} ms of device time", flush=True)
        del o, res, part, keep, out
    nH, hd, n_txt = 12, 64, CAP_LEN
    Lc = FRAMES * 50 + n_txt
    mask = torch.where(_seq2seq_keep(BATCH, Lc - n_txt, n_txt), 0.0,
                       torch.finfo(torch.float32).min)
    bf = padded_clamped_mask(mask, torch.bfloat16)
    qkv = _rnd(g, BATCH * Lc, 3 * C)
    q, k, v = qkv.view(BATCH, Lc, 3, nH, hd).permute(2, 0, 3, 1, 4)
    sdpa_mask = mask.clamp_min(-1e4).to(torch.bfloat16)[:, None]
    parts.add("K6 core", f"K6 core B={BATCH} L={Lc} nH={nH}, seq2seq mask "
              "(bf16, rows padded) vs SDPA (the same mask)",
              lambda: _build.window_attention(q, k, v, None, bf,
                                              hd ** -0.5),
              lambda: F.scaled_dot_product_attention(
                  q, k, v, attn_mask=sdpa_mask, scale=hd ** -0.5), 12)
    parts.summary("no gate")


def _k12_k14_parts(g):
    """K14's and K12's parts, each against one PyTorch call, and the
    kernels each one C call launches.  K14 at the four Swin-B stages, B=4
    (the "fused" serving forward) and B=8 (the remat step), M = B * 5 *
    side^2 spatial rows of N = 245 windows: the gathering 16-byte-chunk
    LN1 (``_build.layernorm_rows`` with the row index) against the scalar
    gathering LN it replaces (``_build.layernorm``); the qkv product and
    the proj's scatter epilogue (+ residual, ``_build.gemm_tc(...,
    rows=)``) against F.linear; at B=4 stages 1-3 the MLP's fc1 + GELU and
    fc2 + residual as ``swin_spatial_plan`` runs them against F.linear;
    the core on the tensor cores (the forward the C call launches, on
    heads views of one qkv slab) with the bias and the shift mask at their
    own 245-element pitch and in rows padded to 248, each against
    scaled_dot_product_attention with bias + mask as one additive mask.
    K12 at the train step's 17,664 rows: fc1 + GELU on its plan's tile
    against F.gelu(F.linear), fc2's f32 K-slices (the partial epilogue
    alone) against F.linear, and the row kernel's dropout mode (the whole
    call less the products) against its bytes at 3.35 TB/s, device time
    in CUDA graphs."""
    import torch.nn.functional as F

    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.fused_mlp import ffn_plan
    from lavender_tpu_torch.ops.swin_block_attn import (
        _device_rows, rel_pos_bias_wm)

    parts = _Parts()
    lib = _build.library()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    window, shift, N = (5, 7, 7), (0, 3, 3), 245
    for stage, nW, C, nH, side, pairs in SWIN_STAGES:
        hd, HD = C // nH, 4 * C
        bias = rel_pos_bias_wm(_rnd(g, 15 * 13 * 13, nH),
                               relative_position_index((8, 7, 7)), N, N,
                               torch.bfloat16)
        sh = shift if stage < 4 else (0, 0, 0)
        mask = None
        if stage < 4:
            mask = torch.as_tensor(compute_shift_mask(
                5, side, side, window, shift), device="cuda").to(
                torch.bfloat16)
        ws = {n: (_rnd(g, o, i, std=i ** -0.5), _rnd(g, o, std=0.02))
              for n, o, i in (("qkv", 3 * C, C), ("proj", C, C),
                              ("fc1", HD, C), ("fc2", C, HD))}
        lw, lb = 1.0 + _rnd(g, C, std=0.1), _rnd(g, C, std=0.1)
        for B in (BATCH, TRAIN_BATCH):
            M = B * 5 * side * side
            # K14 calls of this shape in the counted runs: every block of
            # the stage once a "fused" forward (B=4), twice a remat step
            count = 2 * pairs * (1 if B == BATCH else 2)
            rows, _ = _device_rows(B, 5, side, side, window, sh, "cuda")
            x, o = _rnd(g, M, C), _rnd(g, M, C)
            at = f"K14 B={B} stage {stage} M={M} C={C}"
            parts.add("K14 LN1", f"{at} gathering chunk LN1 vs the scalar "
                      "gathering LN",
                      lambda: _build.layernorm_rows(x, lw, lb, 1e-5, rows),
                      lambda: _build.layernorm(x, lw, lb, 1e-5, rows=rows),
                      count)
            w, b = ws["qkv"]
            parts.add("K14 products", f"{at} qkv N={3 * C} K={C} vs "
                      "F.linear", lambda: _build.gemm_tc(x, w, b),
                      lambda: F.linear(x, w, b), count)
            w, b = ws["proj"]
            out = torch.empty_like(x)
            parts.add("K14 products", f"{at} proj + residual, scattered by "
                      f"the row index, N={C} K={C} vs F.linear",
                      lambda: _build.gemm_tc(o, w, b, residual=x, rows=rows,
                                             out=out),
                      lambda: F.linear(o, w, b), count)
            if B == BATCH and stage < 4:  # K14f: the MLP of the whole block
                plan = _build.swin_spatial_plan(M, C, HD)
                w1, b1 = ws["fc1"]
                w2, b2 = ws["fc2"]
                h = _rnd(g, M, HD)
                parts.add("K14f MLP", f"{at} fc1 + GELU N={HD} K={C} vs "
                          "F.gelu(F.linear)",
                          lambda: _build.gemm_tc(x, w1, b1, gelu=True),
                          lambda: F.gelu(F.linear(x, w1, b1)), count)
                if plan.splits != 1:
                    raise AssertionError(f"{at}: fc2 planned as "
                                         f"{plan.splits} K-slices")
                parts.add("K14f MLP", f"{at} fc2 + residual N={C} K={HD} "
                          f"(bm {plan.fc2_bm}) vs F.linear",
                          lambda: _build.gemm_tc(h, w2, b2, residual=x),
                          lambda: F.linear(h, w2, b2), count)
                del h
            qkv = _rnd(g, B * nW, N, 3, nH, hd)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)  # the slab's heads views
            full = bias.float()[None].expand(B * nW, nH, N, N)
            if mask is not None:
                full = (full.reshape(B, nW, nH, N, N)
                        + mask.float()[None, :, None]).reshape(B * nW, nH, N,
                                                               N)
            full = full.to(torch.bfloat16).contiguous()
            kind = "shifted" if mask is not None else "unshifted"
            for pitch, (bt, mt) in (
                    (N, (bias, mask)),
                    (248, (_build.with_padded_rows(bias),
                           None if mask is None
                           else _build.with_padded_rows(mask)))):
                parts.add(f"K14 core, pitch {pitch}", f"{at} core nH={nH} "
                          f"{kind}, bias and mask rows {pitch} elements "
                          "apart vs SDPA (bias + mask as one additive mask)",
                          lambda bt=bt, mt=mt: _build.window_attention(
                              q, k, v, bt, mt, hd ** -0.5),
                          lambda: F.scaled_dot_product_attention(
                              q, k, v, attn_mask=full, scale=hd ** -0.5),
                          count // 2 if mask is not None else count)
            del x, o, out, qkv, q, k, v, full
    C, HD, M = 768, 3072, TRAIN_BATCH ** 2 * (FRAMES * 50 + TXT_LEN)
    x = _rnd(g, M, C)
    w1, b1 = _rnd(g, HD, C, std=C ** -0.5), _rnd(g, HD, std=0.02)
    w2, b2 = _rnd(g, C, HD, std=HD ** -0.5), _rnd(g, C, std=0.02)
    lw, lb = 1.0 + _rnd(g, C, std=0.1), _rnd(g, C, std=0.1)
    h = _rnd(g, M, HD)
    seed = torch.tensor([1234], device="cuda")
    S = ffn_plan(M, C, HD, long_m=True).splits
    bm1 = _build.gemm_tc_plan(M, HD, C).bm
    part = torch.empty(S * M * C, device="cuda")
    at = f"K12 train step M={M} C={C} HD={HD} (fc1 bm {bm1}, {S} K-slice(s))"
    parts.add("K12 fc1", f"{at} fc1 + GELU vs F.gelu(F.linear)",
              lambda: _build.gemm_tc(x, w1, b1, gelu=True),
              lambda: F.gelu(F.linear(x, w1, b1)), 12)

    def fc2():  # the partial epilogue, as the C call runs it
        _build._raise_on(lib.lvt_gemm_tc_bf16(
            h.data_ptr(), HD, w2.data_ptr(), None, None, None, None, None, 1,
            None, 0, part.data_ptr(), C, M, C, HD, 3, 128, S, stream()),
            "lvt_gemm_tc_bf16")

    def products():
        _build.gemm_tc(x, w1, b1, gelu=True)
        fc2()

    def whole():
        return _build.ffn_dropout_ln(x, w1, b1, w2, b2, lw, lb, 1e-12, seed,
                                     0.1, S)

    parts.add("K12 fc2", f"{at} fc2 K-slices vs F.linear", fc2,
              lambda: F.linear(h, w2, b2), 12)
    t = [_graph_ms(f) for f in (products, whole, whole, products)]
    rows_ms = (t[1] + t[2] - t[0] - t[3]) / 2
    nbytes = S * M * C * 4 + 2 * M * C * 2 + M * C + 3 * C * 2
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[part] {at} row kernel (dropout mode): {rows_ms:.4f} ms of "
          f"device time (the call {(t[1] + t[2]) / 2:.4f} less the products "
          f"{(t[0] + t[3]) / 2:.4f}) vs {nbytes / 1e6:.1f} MB at 3.35 TB/s "
          f"{bound:.4f} ms: {rows_ms / bound:.2f}x, "
          f"{nbytes / rows_ms / 1e9:.2f} TB/s", flush=True)
    del x, h, part
    parts.summary("no gate")


def _k16_parts(g):
    """K16's parts, each against one PyTorch call, at Swin-B stage 3, B=4
    (the ``_IKS`` serving forward) and B=8 (the ``_IKS`` train step), M =
    B * 4 * 248 window-major rows: the gathering chunk LN1 through the wm
    shift's row index (-1 at the pad rows; ``_build.layernorm_rows``)
    against the scalar gathering LN that K16 ran before
    (``_build.layernorm``); the qkv product and the proj's zeroing scatter
    epilogue (+ residual, ``_build.gemm_tc(..., rows=, pad_zero=True)``)
    against F.linear; the core on the tensor cores (the forward the C call
    launches, on heads views of one qkv slab) with the bias and the padded
    shift mask at their 248-element pitch against
    scaled_dot_product_attention with bias + mask as one additive mask;
    then the whole call's device time beside the sum of its parts'.
    Device time in CUDA graphs."""
    import torch.nn.functional as F

    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.swin_block_attn import (
        _batch_shift_rows, fused_swin_block_wm_shifted)
    from lavender_tpu_torch.ops.wm_permute import shift_indices

    def lin(n_out, n_in):
        return _rnd(g, n_out, n_in, std=n_in ** -0.5), _rnd(g, n_out,
                                                            std=0.02)

    def ln(c):
        return 1.0 + _rnd(g, c, std=0.1), _rnd(g, c, std=0.1)

    parts = _Parts()
    params, statics, (nW, C, nH, N, Npad, n_blocks) = _stage3_block(g, lin,
                                                                     ln)
    n1w, n1b, wqkv, bqkv, wproj, bproj, bias, mask = params
    spatial, window, shift, _, scale, eps = statics
    hd = C // nH
    fwd, _ = shift_indices(window, *spatial, Npad, shift, "cuda")
    for B in (BATCH, TRAIN_BATCH):
        M = B * nW * Npad
        rows = _batch_shift_rows(B, fwd)
        x, o = _rnd(g, M, C), _rnd(g, M, C)
        out = torch.empty_like(x)
        qkv = _rnd(g, B * nW, Npad, 3, nH, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # the slab's heads views
        full = (bias.float()[None, None] + mask.float()[None, :, None]
                ).expand(B, -1, -1, -1, -1).reshape(B * nW, nH, Npad, Npad)
        full = full.to(torch.bfloat16).contiguous()
        at = f"K16 B={B} stage 3 M={M} C={C}"
        kernels = [
            ("K16 LN1", f"{at} gathering chunk LN1 vs the scalar gathering "
             "LN", lambda: _build.layernorm_rows(x, n1w, n1b, eps, rows),
             lambda: _build.layernorm(x, n1w, n1b, eps, rows=rows)),
            ("K16 products", f"{at} qkv N={3 * C} K={C} vs F.linear",
             lambda: _build.gemm_tc(x, wqkv, bqkv),
             lambda: F.linear(x, wqkv, bqkv)),
            ("K16 core", f"{at} core nH={nH} shifted, bias and mask rows "
             f"{Npad} elements apart vs SDPA (bias + mask as one additive "
             "mask)", lambda: _build.window_attention(q, k, v, bias, mask,
                                                      scale),
             lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=full,
                                                    scale=scale)),
            ("K16 products", f"{at} proj + residual, the zeroing scatter "
             f"by the row index, N={C} K={C} vs F.linear",
             lambda: _build.gemm_tc(o, wproj, bproj, residual=x, rows=rows,
                                    out=out, pad_zero=True),
             lambda: F.linear(o, wproj, bproj))]
        for group, name, kernel, library in kernels:
            parts.add(group, name, kernel, library, n_blocks)
        x4 = x.view(B, nW, Npad, C)
        whole = _graph_ms(lambda: fused_swin_block_wm_shifted(x4, *params,
                                                              *statics))
        summed = sum(_graph_ms(kernel) for _, _, kernel, _ in kernels)
        print(f"[part] {at}: the whole call {whole:.4f} ms of device time, "
              f"its parts {summed:.4f} summed ({_nvidia_smi()})", flush=True)
        del x, o, out, qkv, q, k, v, full
    parts.summary("no gate")


def _kernel_names(g, only=None):
    """One call each of K14a and K14f (B=4, Swin-B stage 1, shifted), K16
    (B=4, stage 3) and K12 (1,104 rows) under torch.profiler, those in
    ``only`` where given, first in phase 3 (the profiler's records thin
    out once a process has traced many windows): their kernels' names
    must include the tile GEMM and (K14, K16) the chunk LN and the
    tensor-core forward, (K12) the row kernel, and none of the wmma GEMM
    (gemm_bf16_kernel) and the f32-pipe core (attention_kernel), both
    gone, or the scalar LN (layernorm_bf16_kernel).  A call is traced up
    to three times, its names the union: a process's first traced window
    has dropped the first kernel's record (the chunk LN of K14a)."""
    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.fused_mlp import fused_ffn_post_ln_train
    from lavender_tpu_torch.ops.swin_block_attn import (
        fused_swin_block_attn, fused_swin_block_full,
        fused_swin_block_wm_shifted, rel_pos_bias_rows)

    _, _, C, nH, side, _ = SWIN_STAGES[0]
    window, shift = (5, 7, 7), (0, 3, 3)
    lin = lambda o, i: (_rnd(g, o, i, std=i ** -0.5), _rnd(g, o, std=0.02))
    ln = (1.0 + _rnd(g, C, std=0.1), _rnd(g, C, std=0.1))
    bias = rel_pos_bias_rows(_rnd(g, 15 * 13 * 13, nH),
                             relative_position_index((8, 7, 7)), 245,
                             torch.bfloat16)
    mask = _build.with_padded_rows(torch.as_tensor(compute_shift_mask(
        5, side, side, window, shift), device="cuda").to(torch.bfloat16))
    args = (_rnd(g, BATCH, 5, side, side, C), *ln, *lin(3 * C, C),
            *lin(C, C), bias, mask)
    statics = (window, shift, nH, (C // nH) ** -0.5, 1e-5)
    mlp = (*ln, *lin(4 * C, C), *lin(C, 4 * C))
    D, HD = 768, 3072
    ffn = (_rnd(g, 1104, D), *lin(HD, D), *lin(D, HD),
           1.0 + _rnd(g, D, std=0.1), _rnd(g, D, std=0.1),
           torch.tensor([7], device="cuda"), 1e-12, 0.1)
    params16, statics16, (nW16, C16, _, _, Npad16, _) = _stage3_block(
        g, lin, lambda c: (1.0 + _rnd(g, c, std=0.1), _rnd(g, c, std=0.1)))
    x16 = _rnd(g, BATCH, nW16, Npad16, C16)
    need = ("tile_kernel", "layernorm_rows_kernel", "fwd_kernel")
    for kid, fn, want in (
            ("K14a", lambda: fused_swin_block_attn(*args, *statics), need),
            ("K14f", lambda: fused_swin_block_full(*args, *mlp, *statics),
             need),
            ("K16", lambda: fused_swin_block_wm_shifted(x16, *params16,
                                                        *statics16), need),
            ("K12", lambda: fused_ffn_post_ln_train(*ffn),
             ("tile_kernel", "rows_kernel"))):
        if only and kid not in only:
            continue
        fn()  # warm: the first call builds the row index and the scratch
        names = set()
        for _ in range(3):  # a process's first traced window can drop a record
            names |= set(_kernel_times(fn, 1))
            if all(any(p in n for n in names) for p in want):
                break
        bad = [n for n in names for old in ("gemm_bf16_kernel",
                                            "attention_kernel",
                                            "layernorm_bf16_kernel")
               if old in n]
        missing = [p for p in want if not any(p in n for n in names)]
        print(f"[kernel] {kid} one call launches {len(names)} kernel(s): "
              f"{'; '.join(sorted(set(n[:70] for n in names)))}", flush=True)
        if bad or missing:
            raise AssertionError(f"{kid}: old kernels {bad}, missing "
                                 f"{missing}")


def _heads_tc_pitch(g):
    """K15 at N = 245 (B=4, stage 1, shifted: the bias and the shift mask
    in bf16, as the model path passes them, and the mask in f32) and K7 at
    L = 275 (B=4, 12 heads of 64, the clamped f32 seq2seq mask), their
    mask and bias rows at their own pitch (N elements: 4-byte copies) and
    padded to 16 bytes (``_build.padded_rows``: 16-byte copies), launched
    directly: event ms per call (in turns: own, padded, padded, own) and
    device ms per call under torch.profiler, beside the one-call library
    yardstick's (scaled_dot_product_attention with the additive mask in
    bf16).  The outputs at the two pitches must be bitwise equal."""
    import torch.nn.functional as F

    from lavender_tpu_torch.models.swin3d import compute_shift_mask
    from lavender_tpu_torch.ops import _build

    def device_ms(fn, match="lvt::TcFwd"):
        return sum(ms for name, ms in _kernel_times(fn, 5).items()
                   if match in name)

    N, W, nH, hd = 245, BATCH * 64, 4, 32
    q, k, v = _rnd(g, W, N, 3, nH, hd).permute(2, 0, 3, 1, 4)
    bias = _rnd(g, nH, N, N)
    shift = torch.as_tensor(compute_shift_mask(5, 56, 56, (5, 7, 7),
                                               (0, 3, 3)), device="cuda")
    full = (bias.float()[None, None] + shift[None, :, None]).expand(
        BATCH, -1, -1, -1, -1).reshape(W, nH, N, N).to(torch.bfloat16)
    cases = []
    for m in (shift.to(torch.bfloat16), shift):
        dt = str(m.dtype).replace("torch.", "")
        cases.append((
            f"K15 W={W} nH={nH} N={N} hd={hd}, bf16 bias + {dt} mask",
            lambda b=bias, m=m: _build.window_attention(q, k, v, b, m,
                                                        hd ** -0.5),
            lambda b=_build.with_padded_rows(bias),
            m=_build.with_padded_rows(m): _build.window_attention(
                q, k, v, b, m, hd ** -0.5),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=full,
                                                   scale=hd ** -0.5)))
    L, nH7, hd7 = FRAMES * 50 + CAP_LEN, 12, 64
    q7, k7, v7 = (_rnd(g, BATCH, nH7, L, hd7) for _ in range(3))
    keep = _seq2seq_keep(BATCH, L - CAP_LEN, CAP_LEN)
    m7 = torch.where(keep, 0.0, -1e4)
    m7_lib = m7[:, None].to(torch.bfloat16)
    cases.append((
        f"K7 B={BATCH} nH={nH7} L={L} hd={hd7}, f32 seq2seq mask",
        lambda: _build.attention_heads(q7, k7, v7, m7, hd7 ** -0.5),
        lambda m=_build.with_padded_rows(m7): _build.attention_heads(
            q7, k7, v7, m, hd7 ** -0.5),
        lambda: F.scaled_dot_product_attention(q7, k7, v7, attn_mask=m7_lib,
                                               scale=hd7 ** -0.5)))
    for name, own, pad, lib in cases:
        if not torch.equal(own(), pad()):
            raise AssertionError(f"{name}: the two row pitches differ")
        t = [_time_ms(f) for f in (own, pad, pad, own)]
        print(f"[kernel] pitch {name}: rows of N elements "
              f"{(t[0] + t[3]) / 2:.4f} ms ({device_ms(own):.4f} device) vs "
              f"padded to 16 bytes {(t[1] + t[2]) / 2:.4f} ms "
              f"({device_ms(pad):.4f} device) per call, outputs bitwise "
              f"equal; library {_time_ms(lib):.4f} ms ({device_ms(lib, ''):.4f}"
              f" device) ({_nvidia_smi()})", flush=True)


def _device_ms(fn, n: int = 20) -> float:
    """ms of device time per call of ``fn``: all its device activities
    over ``n`` calls under torch.profiler, divided by ``n``."""
    return sum(_kernel_times(fn, n).values())


def _graph_ms(fn, n: int = 10) -> float:
    """ms of device time per call of ``fn`` without its host time: ``n``
    calls captured in one CUDA graph (after a warm-up call, so that no
    scratch grows inside it), the replay timed as ``_time_ms`` times a
    call, divided by ``n``.  The profiler's sums under-count once it has
    traced many windows in one process; a graph's replay has no host gaps
    to hide."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = _time_ms(graph.replay) / n
    del graph
    return ms


def check_kernels(only=None, parts: bool = True):
    """Phase 3: each kernel vs its plain version; returns per-kernel
    {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound by bytes
    time / FLOP time} summed over the calls of ``Case.count``.  ``only``
    (kernel ids such as "K2") keeps those kernels' cases and skips the
    checks beside them; ``parts`` False also skips their parts and
    kernel-name checks, which call this tree's primitives (so the cases
    alone also run on an older tree's package)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    if parts and (not only or only & {"K12", "K14a", "K14f", "K16"}):
        _kernel_names(g, only)
    per_kernel = {}
    for c in _kernel_cases(g):
        if only and c.op.name.split()[0] not in only:
            continue
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
        if c.bitwise_repeat:
            again = c.op(*c.args, **c.kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None)
            ok = ok and same
            branch += f", a second call {'bitwise equal' if same else 'DIFFERS'}"
            del again
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
        if c.graph_ms:  # the call's device time, without its host time
            dev = _graph_ms(lambda: c.op(*c.args, **c.kw))
            print(f"[kernel] {c.op.name} {c.name}: device {dev:.4f} ms a "
                  f"call in a CUDA graph (event {ms:.4f} ms) "
                  f"({_nvidia_smi()})", flush=True)
        if c.device_ms:  # the call's device time, without its host time
            dev = _device_ms(lambda: c.op(*c.args, **c.kw))
            other = (f"library {_device_ms(c.library):.4f} ms" if c.library
                     else "plain version "
                     f"{_device_ms(lambda: c.op.plain(*c.args, **c.kw)):.4f}"
                     " ms")
            print(f"[kernel] {c.op.name} {c.name}: device {dev:.4f} ms a "
                  f"call (event {ms:.4f} ms) vs {other} of device time "
                  f"({_nvidia_smi()})", flush=True)
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
    if parts and (not only or only & {"K1", "K4"}):
        _k1_k4_parts(g)
    if parts and (not only or only & {"K3", "K9"}):
        _k3_k9_parts(g)
    if parts and (not only or only & {"K6", "K11"}):
        _k6_k11_parts(g)
    if parts and (not only or only & {"K12", "K14a", "K14f"}):
        _k12_k14_parts(g)
    if parts and (not only or only & {"K16", "K17"}):
        _k16_parts(g)
    if only:
        return per_kernel
    _heads_vs_lanes(g)
    _train_fwd_lse(g)
    _swin_core_lse_and_dbias(g)
    _heads_tc_pitch(g)
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
    default_busy = _device_profile(lambda: step(batch))
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
    for name, (host_ms, busy_ms, n_dev) in (
            ("default", default_busy),
            ("fused_ffn_train=True", _device_profile(lambda: step(batch)))):
        print(f"[train] (e) one {name} step under torch.profiler: "
              + ("device time not measured (no device activity recorded)"
                 if busy_ms is None else
                 f"device busy {busy_ms:.2f} ms of {host_ms:.2f} "
                 f"({busy_ms / host_ms:.1%}), {n_dev} device activities")
              + f" ({_nvidia_smi()})", flush=True)
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


# the attention cores' device activities by name: the f32-pipe cores
# (attention_*) and the tensor-core ones (taking lvt::TcFwd / lvt::TcBwd /
# lvt::RowDot, and K8b's dbias chunk sum)
ATTENTION_KERNELS = ("attention", "lvt::Tc", "lvt::RowDot", "sum_chunks")


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
    host_ms, busy_ms, n_dev = _device_profile(lambda: step(batch))
    print("[spatial] (c) one remat step under torch.profiler: "
          + ("device time not measured (no device activity recorded)"
             if busy_ms is None else
             f"device busy {busy_ms:.2f} ms of {host_ms:.2f} "
             f"({busy_ms / host_ms:.1%}), {n_dev} device activities")
          + f" ({_nvidia_smi()})", flush=True)
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


# phase 9: the BERT-base uncased ids of the option digits "0".."4" (QA-MC's
# answers at the [MASK]); RetMC's options (B * O = 40 pairs); pretraining's
# VTM pairs a clip (O = min(B, 4): 32 VTM sequences beside the 8 MLM ones)
DIGIT_IDS = (1014, 1015, 1016, 1017, 1018)
N_OPT, VTM_BATCH = 5, 4


@contextlib.contextmanager
def _bert_switches(attnlanes: bool = True, kmask: bool = True):
    """LVT_ATTNLANES / LVT_KMASK in the environment for a block (the port
    reads them per call), restored after it."""
    names = ("LVT_ATTNLANES", "LVT_KMASK")
    prev = [os.environ.get(n) for n in names]
    os.environ.update({n: str(int(on)) for n, on in zip(names, (attnlanes,
                                                                 kmask))})
    try:
        yield
    finally:
        for n, p in zip(names, prev):
            if p is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = p


def _task_text(rs, n: int, vocab: int):
    """[CLS] words [MASK] [SEP], padded to TXT_LEN (lengths 6 to 26, the
    first full): (ids, mask) int64 arrays."""
    lens = rs.randint(6, TXT_LEN + 1, n)
    lens[0] = TXT_LEN
    pos = np.arange(TXT_LEN)[None]
    txt = rs.randint(1000, vocab, (n, TXT_LEN))
    txt[:, 0] = CLS_ID
    txt = np.where(pos == lens[:, None] - 2, MASK_ID, txt)
    txt = np.where(pos == lens[:, None] - 1, SEP_ID, txt)
    mask = (pos < lens[:, None]).astype(np.int64)
    return txt * mask, mask


def _task_batches(vocab: int):
    """One batch of each task at the train shape: B=8 clips of 5 x 224 x
    224, 26 tokens; RetMC 8 x 5 option texts."""
    from lavender_tpu_torch.models import captioning
    from lavender_tpu_torch.tasks import pretrain

    rs = np.random.RandomState(9)
    B = TRAIN_BATCH
    img = rs.randint(0, 256, (B, FRAMES, SIZE, SIZE, 3)).astype(np.uint8)
    txt, mask = _task_text(rs, B, vocab)
    at_mask = txt == MASK_ID
    ans_idx = rs.randint(0, N_OPT, B)
    qamc_ans = np.where(at_mask, np.asarray(DIGIT_IDS)[ans_idx][:, None], -1)
    qaoe_ans = np.where(at_mask, rs.randint(1000, vocab, (B, 1)), -1)
    qaoe_ans[B - 1] = -1  # an answer outside the vocabulary: no target
    opt_txt, opt_mask = _task_text(rs, B * N_OPT, vocab)
    opt_txt, opt_mask = (a.reshape(B, N_OPT, TXT_LEN)
                         for a in (opt_txt, opt_mask))
    right = rs.randint(0, N_OPT, B)
    truth = np.where(np.arange(N_OPT)[None] == right[:, None], TRUE_ID,
                     FALSE_ID)[..., None]
    retmc_ans = np.where(opt_txt == MASK_ID, truth, -1)
    pre_txt, pre_ans = pretrain.mask_tokens(
        txt, (PAD_ID, CLS_ID, SEP_ID, MASK_ID), MASK_ID, 0.15, rs)
    cap_txt, cap_ans = captioning.caption_masking(txt, PAD_ID, MASK_ID, 0.15,
                                                  rs)
    raw = {
        "qamc": {"txt": txt, "mask": mask, "mask_ans": qamc_ans,
                 "ans_idx": ans_idx},
        "qaoe": {"txt": txt, "mask": mask, "mask_ans": qaoe_ans},
        "retmc": {"txt": opt_txt, "mask": opt_mask, "mask_ans": retmc_ans,
                  "ans_idx": right},
        "pretrain": {"txt": pre_txt, "mask": mask, "ans_mtm": pre_ans},
        "cls": {"txt": txt, "mask": mask, "ans": ans_idx},
        "retrieval": {"txt": txt, "mask": mask, "vid": np.arange(B)},
        "captioning": {"txt": cap_txt, "mask": mask, "ans_mtm": cap_ans}}
    clips = torch.as_tensor(img, device="cuda")
    return {task: {"img": clips, **{k: torch.as_tensor(
        np.asarray(v), device="cuda").long() for k, v in b.items()}}
        for task, b in raw.items()}


def _first(loss_fn):
    """A loss with aux (loss, metrics) as a plain loss."""
    return lambda model, batch, gen: loss_fn(model, batch, gen)[0]


def run_tasks(ops):
    """Phase 9: the fine-tuning and pretraining tasks on ModelConfig(), B=8.
    (a) one train step each of QA-MC, QA-OE, RetMC, pretraining
    (vtm_batch=4) and the task-specific head (``make_cls_loss``): loss and
    gradients kernels vs plain, launches; ten QA-MC steps lowering the loss
    >= 1 nat; the multi-task dispatch, each kind's step once, launches.
    (b) the retrieval-MLM and the pretraining step under LVT_ATTNLANES=0:
    loss and gradients kernels vs plain, launches (K13 in place of K10);
    step time and device time of both routes, in turns.  (c) each task's
    eval step, kernels vs plain on the logits it reads, and the launches
    of QA-MC's under LVT_KMASK=1 (K4) and =0 (K6).  Returns the launches
    of the counted runs."""
    from lavender_tpu_torch.config import ModelConfig, TrainConfig
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.tasks import (common, multi_task, pretrain, qamc,
                                          qaoe, retmc, retrieval,
                                          task_specific)
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    cfg = ModelConfig()
    layers, vocab = cfg.bert.num_hidden_layers, cfg.bert.vocab_size
    depth, n_shift = sum(cfg.swin.depths), _shifted_blocks(cfg.swin)
    batches = _task_batches(vocab)
    total = {op: 0 for op in ops.values()}

    def add(counts):
        for op, n in counts.items():
            total[op] += n

    def step_counts(passes: int, lanes: bool = True):
        attn = ("K10a", "K10b") if lanes else ("K13a", "K13b")
        return {ops["K1"]: depth, ops["K2"]: 4 * n_shift,
                ops["K8a"]: depth, ops["K8b"]: depth, ops["K9"]: depth,
                ops[attn[0]]: passes * layers, ops[attn[1]]: passes * layers,
                ops["K11"]: passes * layers}

    t0 = time.perf_counter()
    tc = TrainConfig(max_iter=1000, max_grad_norm=1.0)
    state = create_train_state(cfg, tc, seed=0)
    ts_state = create_train_state(
        cfg, tc, seed=0, model=task_specific.LavenderTS(cfg, head_out=N_OPT))
    torch.cuda.synchronize()
    print(f"[tasks] states built (ModelConfig(); LavenderTS with a {N_OPT}-way "
          f"head) in {time.perf_counter() - t0:.1f} s", flush=True)
    groups = _grad_groups(state.model)
    ts_groups = _grad_groups(ts_state.model)

    # (a) one step of each task: kernels vs plain, then its launches
    tasks = {
        "qamc": (qamc.make_loss_fn(), state, 1, False),
        "qaoe": (qaoe.make_loss_fn(), state, 1, False),
        "retmc": (retmc.make_loss_fn(), state, 1, False),
        "pretrain": (pretrain.make_loss_fn(TRUE_ID, FALSE_ID, VTM_BATCH),
                     state, 2, True),
        "cls": (task_specific.make_cls_loss(), ts_state, 1, False)}
    for name, (loss_fn, st, passes, aux) in tasks.items():
        fn = _first(loss_fn) if aux else loss_fn
        b = batches[name]
        _check_step(f"(a) {name} step, kernels vs plain:",
                    _loss_and_grads(st, fn, b, False),
                    _loss_and_grads(st, fn, b, True),
                    ts_groups if st is ts_state else groups, tag="tasks")
        step = make_train_step(loss_fn, st, has_aux=aux)
        _reset(ops.values())
        out = step(b)
        add(_check_counts(ops.values(), step_counts(passes), 1,
                          f"tasks (a) {name}"))
        loss, metrics = out if aux else (out, {})
        parts = "".join(f", {k} {float(v):.4f}" for k, v in metrics.items())
        print(f"[tasks] (a) {name}: one step, loss {float(loss):.6f}{parts}",
              flush=True)
    const = TrainConfig(lr=TRAIN_LR, warmup_ratio=0.0, max_iter=10 ** 9,
                        max_grad_norm=1.0)
    stp = make_train_step(qamc.make_loss_fn(),
                          create_train_state(cfg, const, seed=0))
    losses = [float(stp(batches["qamc"])) for _ in range(TRAIN_STEPS)]
    drop = losses[0] - losses[-1]
    print(f"[tasks] (a) QA-MC, {TRAIN_STEPS} steps at lr {TRAIN_LR}: loss "
          f"{' '.join(f'{v:.4f}' for v in losses)}; down {drop:.4f} nat "
          f"(>= {MIN_LOSS_DROP})", flush=True)
    if not (all(np.isfinite(losses)) and drop >= MIN_LOSS_DROP):
        raise AssertionError(f"(a) the QA-MC loss did not fall by "
                             f"{MIN_LOSS_DROP} nat in {TRAIN_STEPS} steps")
    del stp
    torch.cuda.empty_cache()
    steps = multi_task.make_multi_task_train_steps(
        multi_task.build_multi_task_losses(TRUE_ID, FALSE_ID), state)
    for kind, step in steps.items():
        _reset(ops.values())
        loss = step(batches[kind])
        add(_check_counts(ops.values(), step_counts(1), 1,
                          f"tasks (a) multi-task {kind}"))
        print(f"[tasks] (a) multi-task dispatch, {kind}: loss "
              f"{float(loss):.6f}", flush=True)
        if not np.isfinite(float(loss)):
            raise AssertionError(f"(a) multi-task {kind}: non-finite loss")

    # (b) LVT_ATTNLANES=0: the heads route (K13) in the fusion encoder
    heads_runs = {
        "retrieval": (retrieval.make_loss_fn(TRUE_ID, FALSE_ID), 1, False),
        "pretrain": (pretrain.make_loss_fn(TRUE_ID, FALSE_ID, VTM_BATCH), 2,
                     True)}
    timed = {}
    for name, (loss_fn, passes, aux) in heads_runs.items():
        fn = _first(loss_fn) if aux else loss_fn
        b = batches[name]
        with _bert_switches(attnlanes=False):
            _check_step(f"(b) {name} step under LVT_ATTNLANES=0, kernels vs "
                        "plain:", _loss_and_grads(state, fn, b, False),
                        _loss_and_grads(state, fn, b, True), groups,
                        tag="tasks")
        step = make_train_step(loss_fn, state, has_aux=aux)
        for lanes in (False, True):
            with _bert_switches(attnlanes=lanes):
                _reset(ops.values())
                step(b)
                counts = _check_counts(
                    ops.values(), step_counts(passes, lanes), 1,
                    f"tasks (b) {name}, LVT_ATTNLANES={int(lanes)}")
            if not lanes:
                add(counts)
        timed[name] = (step, b)
    step, b = timed["retrieval"]
    times = {True: [], False: []}
    device = {True: [], False: []}
    for lanes in (True, False, False, True):
        with _bert_switches(attnlanes=lanes):
            times[lanes].append(_ms(lambda: step(b), 3))
            per_kernel = _kernel_times(lambda: step(b), 1)
            device[lanes].append((sum(per_kernel.values()), sum(
                ms for name, ms in per_kernel.items()
                if any(k in name for k in ATTENTION_KERNELS))))
    for lanes in (True, False):
        ms = sum(times[lanes]) / 2
        dev = " / ".join(f"{a:.3f} ({c:.3f} in the attention kernels)"
                         for a, c in device[lanes])
        print(f"[tasks] (b) retrieval step, LVT_ATTNLANES={int(lanes)} "
              f"({'K10' if lanes else 'K13'}): {ms:.2f} ms per step "
              f"({', '.join(f'{t:.2f}' for t in times[lanes])}); device "
              f"time per step (sum of device activities) {dev} ms "
              f"({_nvidia_smi()})", flush=True)
    del steps, timed, step
    torch.cuda.empty_cache()

    # (c) the eval steps: kernels vs plain on the logits each reads
    def eval_cases():
        bq, be, br = batches["qamc"], batches["qaoe"], batches["retmc"]
        bp, bt, bc = batches["pretrain"], batches["retrieval"], batches["cls"]
        neg = lambda: torch.Generator("cuda").manual_seed(5)
        return {
            "qamc": (state.model, lambda m: qamc.make_eval_step(DIGIT_IDS)(
                m, bq["img"], bq["txt"], bq["mask"], bq["mask_ans"],
                bq["ans_idx"]), lambda m: common.fused_mlm_logits(
                    m, bq["img"], bq["txt"], bq["mask"])[0]),
            "qaoe": (state.model, lambda m: qaoe.make_eval_step(5)(
                m, be["img"], be["txt"], be["mask"], be["mask_ans"]),
                lambda m: common.fused_mlm_logits(
                    m, be["img"], be["txt"], be["mask"])[0]),
            "retmc": (state.model, lambda m: retmc.make_eval_step(
                TRUE_ID, FALSE_ID)(m, br["img"], br["txt"], br["mask"],
                                   br["mask_ans"], br["ans_idx"]),
                lambda m: retmc.option_logits(m, br["img"], br["txt"],
                                              br["mask"], last_only=True)),
            "retrieval": (state.model, lambda m: retrieval.make_eval_step(
                TRUE_ID, FALSE_ID)(m, bt["img"], bt["txt"], bt["mask"],
                                   bt["vid"]),
                lambda m: retrieval.pairwise_mlm_logits(
                    m, bt["img"], bt["txt"], bt["mask"])[0]),
            "pretrain": (state.model, lambda m: pretrain.make_eval_step(
                TRUE_ID, FALSE_ID, VTM_BATCH)(m, bp["img"], bp["txt"],
                                              bp["mask"], bp["ans_mtm"],
                                              neg()),
                lambda m: torch.cat([o.flatten() for o in (
                    pretrain.pretrain_forward(
                        m, bp["img"], bp["txt"], bp["mask"],
                        pretrain.sample_negatives(
                            neg(), TRAIN_BATCH,
                            min(TRAIN_BATCH, VTM_BATCH) - 1)))])),
            "cls": (ts_state.model, lambda m: task_specific.make_cls_eval()(
                m, bc["img"], bc["txt"], bc["mask"], bc["ans"]),
                lambda m: m.cls_head(bc["img"], bc["txt"], bc["mask"]))}

    for name, (model, eval_fn, logits_fn) in eval_cases().items():
        outs = []
        for plain in (False, True):
            with plain_path(plain):
                ev = eval_fn(model)
                with common.evaluating(model):
                    outs.append((ev, logits_fn(model)))
        (ev_k, lk), (ev_p, lp) = outs
        err, rel, ok = _compare(lk, lp, SLICE_TOL, SLICE_REL_L2)
        same = [bool(torch.equal(a, b)) for a, b in zip(ev_k, ev_p)
                if a.dtype == torch.bool or a.dim() == 0]
        print(f"[tasks] (c) {name} eval step: its logits {tuple(lk.shape)} "
              f"kernels vs plain max_abs_err {err:.4g} rel_l2 {rel:.3g} "
              f"(tol {SLICE_TOL} max(1,max|ref|), {SLICE_REL_L2}); outputs "
              f"{[tuple(t.shape) for t in ev_k]}, "
              f"{[round(float(t.float().mean()), 4) for t in ev_k]} vs plain "
              f"{[round(float(t.float().mean()), 4) for t in ev_p]}"
              + (f", equal {same}" if same else ""), flush=True)
        if not ok:
            raise AssertionError(f"(c) {name} eval: kernels disagree with "
                                 "the plain path")
    bq = batches["qamc"]
    serve = {**_video_counts(ops, cfg), ops["K5"]: layers}
    for kmask in (True, False):
        with _bert_switches(kmask=kmask):
            _reset(ops.values())
            qamc.make_eval_step(DIGIT_IDS)(state.model, bq["img"], bq["txt"],
                                           bq["mask"], bq["mask_ans"],
                                           bq["ans_idx"])
            add(_check_counts(ops.values(), {
                **serve, ops["K4" if kmask else "K6"]: layers}, 1,
                f"tasks (c) QA-MC eval, LVT_KMASK={int(kmask)}"))
    del state, ts_state
    torch.cuda.empty_cache()
    return total


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA GPU")
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.encoder_attention import (
        encoder_attention_train_bwd, encoder_attention_train_lanes_bwd,
        fused_bert_attn_block, fused_bert_attn_block_kmask,
        fused_encoder_attention, fused_encoder_attention_train,
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
           "K13a": fused_encoder_attention_train,
           "K13b": encoder_attention_train_bwd,
           "K14a": fused_swin_block_attn, "K14f": fused_swin_block_full,
           "K15": fused_window_attention,
           "K16": fused_swin_block_wm_shifted, "K17": fused_patch_embed_u8}
    if sys.argv[1:2] == ["--only"]:  # phase 3 for these kernels alone
        only = set(sys.argv[2:]) - {"--cases"}  # K14a / K14f: "K14" cases
        check_kernels(only | {ops[k].name.split()[0] for k in only
                              if k in ops}, "--cases" not in sys.argv)
        print(_nvidia_smi(), flush=True)
        return 0
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
    del server
    torch.cuda.empty_cache()
    task_counts = run_tasks(ops)

    meta = {
        "K1": ("lavender_tpu_torch/csrc/gemm_tc.cu",
               "lavender_tpu/ops/swin_block_attn.py:954"),
        "K2": ("lavender_tpu_torch/csrc/permute.cu",
               "lavender_tpu/ops/wm_permute.py:127"),
        "K3": ("lavender_tpu_torch/csrc/blocks.cu",
               "lavender_tpu/ops/fused_mlp.py:183"),
        "K4": ("lavender_tpu_torch/csrc/gemm_tc.cu",
               "lavender_tpu/ops/encoder_attention.py:322"),
        "K5": ("lavender_tpu_torch/csrc/ffn_post_ln.cu",
               "lavender_tpu/ops/fused_mlp.py:283"),
        "K6": ("lavender_tpu_torch/csrc/blocks.cu",
               "lavender_tpu/ops/encoder_attention.py:242"),
        "K7": ("lavender_tpu_torch/csrc/attention_fwd_tc.cu",
               "lavender_tpu/ops/encoder_attention.py:75"),
        "K8a": ("lavender_tpu_torch/csrc/attention_fwd_tc.cu",
                "lavender_tpu/ops/swin_core_attn.py:112"),
        "K8b": ("lavender_tpu_torch/csrc/attention_bwd_tc.cu",
                "lavender_tpu/ops/swin_core_attn.py:147"),
        "K9": ("lavender_tpu_torch/csrc/blocks.cu",
               "lavender_tpu/ops/fused_mlp.py:91"),
        "K10a": ("lavender_tpu_torch/csrc/attention_fwd_tc.cu",
                 "lavender_tpu/ops/encoder_attention.py:750"),
        "K10b": ("lavender_tpu_torch/csrc/attention_bwd_tc.cu",
                 "lavender_tpu/ops/encoder_attention.py:780"),
        "K11": ("lavender_tpu_torch/csrc/gemm_tc.cu",
                "lavender_tpu/ops/fused_mlp.py:505"),
        "K12": ("lavender_tpu_torch/csrc/ffn_post_ln.cu",
                "lavender_tpu/ops/fused_mlp.py:379"),
        "K13a": ("lavender_tpu_torch/csrc/attention_fwd_tc.cu",
                 "lavender_tpu/ops/encoder_attention.py:526"),
        "K13b": ("lavender_tpu_torch/csrc/attention_bwd_tc.cu",
                 "lavender_tpu/ops/encoder_attention.py:555"),
        "K14a": ("lavender_tpu_torch/csrc/blocks.cu",
                 "lavender_tpu/ops/swin_block_attn.py:468"),
        "K14f": ("lavender_tpu_torch/csrc/blocks.cu",
                 "lavender_tpu/ops/swin_block_attn.py:468"),
        "K15": ("lavender_tpu_torch/csrc/attention_fwd_tc.cu",
                "lavender_tpu/ops/window_attention.py:49"),
        "K16": ("lavender_tpu_torch/csrc/blocks.cu",
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
                         + route_counts[op] + task_counts[op]),
            "launches_serving": serve_counts[op],
            "launches_train_step": train_counts[op],
            "launches_captioning": caption_counts[op],
            "launches_spatial": spatial_counts[op],
            "launches_routes": route_counts[op],
            "launches_tasks": task_counts[op],
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
