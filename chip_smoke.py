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
    python3 chip_smoke.py --cli          # phases 1, 2 and 12 (the CLI)
    python3 chip_smoke.py --dp           # data parallel on 4 GPUs (run_dp)
    python3 chip_smoke.py --tp           # tensor parallel on 4 GPUs (run_tp)
    python3 chip_smoke.py --tp SWINL     # its Swin-L-384 tp 2 step (e) alone
    python3 chip_smoke.py --only TP      # phase 3's tensor-parallel shapes
    python3 chip_smoke.py --only SWINL   # Swin-L-384: its phase-3 cases, 13

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
   and K10b (the tensor-core forward, the wgmma + TMA backward) also at
   rate 0.5 and
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
   first in the phase, from the library's SASS, that every instance of the
   wgmma backward of K10b / K13b and K8b, of K8b's dbias kernel and of
   K8a's wgmma forward runs its products as HGMMA and its tile loads as
   UTMALDG (the TMA), with no HMMA, and that no mma.sync dq, dk/dv or
   dbias kernel is left; then by kernel name under torch.profiler, that
   K14a, K14f, K16 and K12 launch the tile GEMM (K14 and K16 also the
   chunk LN and the tensor-core forward), K10b and K13b the wgmma
   backward, K8a the wgmma forward (not the mma.sync one), K8b the wgmma
   backward, its dbias kernel and the chunks' sum, and none of them a
   wmma GEMM, f32-pipe core (both gone), scalar LN or mma.sync dq / dk/dv
   / dbias kernel; K10b's and K13b's counted cases (and Swin-L's K10b) also list
   their device activities and those of SDPA's backward by name;
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
   (the tensor-core forward, the wgmma backward) also at rate 0.5 and at
   L=275 under the seq2seq mask, each call repeated and required bitwise
   equal, K13b also with the mask's gradient (the f32-pipe kernel); the
   lse K10a and K13a write against the logsumexp of the plain scores
   (f64, within 1e-3) at rates 0.1 and 0.5 under both masks and at
   L=275, a second call bitwise equal; the keep masks K13a and K10a
   draw from one seed, read back from the kernels, each exactly
   ``dropout.attention_keep``, and
   their outputs equal to bf16 rounding; K13's one-call yardstick is
   scaled_dot_product_attention with the float mask and dropout_p (and
   its backward); K8a and K8b (the Swin window core on wgmma + TMA,
   its per-head bias and dbias) each call repeated and required bitwise
   equal, the lse K8a writes against the f64 logsumexp of the plain scores
   (within 1e-3) at every stage, shifted and unshifted, and at the spatial
   route's unpadded N=245, and K8b's dbias at B=8, stage 1, shifted (512
   windows) against an f64 sum of the plain per-clip dbias (within 1e-2 x
   max(1, max|dbias|)); K4 (B=4, L=276), K6 (its seq2seq mask, L=275) and
   K10a / K10b (64 pairs, L=276, rate 0.1) under phase 10's SwinBERT mask,
   the video's [CLS] keys 0, 50, .., 200 masked INSIDE the sequence (plus
   padded captions), each call repeated and required bitwise equal; K1
   (every stage, shifted and unshifted, B=4 and
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
   the default route in turns, each route's device-busy share, and so
   ``LVT_PSHIFT=0`` (the shift as torch.roll: K2 0x) and ``LVT_EMBING=1``
   (stage 1's window-major layout from the patch embed); (c) the
   ``_IKS`` train step on ModelConfig(): loss and gradients kernels vs
   plain, launches, ten steps lowering the loss >= 1 nat, step time beside
   the default step's; (d) K16 (the shift inside) against the K2 + K1
   attention half + K2^-1 composition, which does the same work with two
   relayouts around it, at stage 3, B=4 and B=8, in turns; (e) the train
   step under ``LVT_COREBWD=0`` (no K8) and under ``LVT_SWINTRAIN=1`` (no
   K1, no K9; K8a / K8b 24x): loss and gradients kernels vs plain,
   launches, step time and device busy beside the default step's, in
   turns;
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
   eval launches under LVT_KMASK=1 (K4) and =0 (K6);
10. SwinBERT and checkpoints (``run_swinbert``) on
   ModelConfig(swinbert=True), Swin-B + BERT-base with seeded weights:
   (a) the weights written as a SwinBERT-layout ``.pt`` (under build/)
   and loaded by ``load_reference_checkpoint`` into a fresh f32 model on
   the card, every mapped tensor equal to the written one, the unmapped
   at their init; (b) 3 requests of B=4 against the plain path, launches,
   clips/s, device busy a forward under torch.profiler; (c) the seq2seq
   forward (K6 12x, no K4) against the plain path; (e) the same clips as
   float frames normalized on the card against the uint8 path, and clips
   of 2 x 5 x 98 x 98 (the patch embed's spatial pad) against the plain
   path; (d) the retrieval-MLM step at B=8 from the checkpoint: loss and
   gradients kernels vs plain, launches; 3 steps straight, twice, against
   2 steps + ``save_train_state`` + ``restore_train_state`` into a fresh
   state + 1 step (torch's deterministic algorithms on): loss, every
   parameter, the AdamW moments, LR, step and generator state bitwise
   equal where the two straight runs are, else within their largest
   difference;
11. the data plane and the full-corpus retrieval eval (``run_data``) on
   the fixture corpus of ``tests/data/make_clip_tsv.py`` (8 videos of
   6-12 JPEG frames at 320 x 240, 16 captions a split): (a) the clip
   decode path and the host's JPEG decoder the port picked, with the
   native library's build time where it builds; every frame decoded
   against the generator's frames (numpy alone): each frame's mean
   |diff| <= 3 levels, max <= 48; the native path bitwise equal to the
   Python path where both exist; (b) ``full_retrieval_eval``'s two
   phases on a seeded Swin-B + BERT-base server model (bf16, serving
   caches), multi-clip (2 clips of 5 x 224 x 224), pair_batch 64, against
   the same model under ``plain_path()``: the [MASK] logits at the
   "true" / "false" ids within the logits gate, the scores where |p_true
   + p_false| >= 1 within the gate carried through the ratio, R@1/5/10
   and MedR equal unless each ranking flip lies within the gate (such
   flips printed); launches (K1 24x, K2 22x, K3 2x a Swin pass; K4 and K5
   12x a cross chunk); host decode clips/s with 1 and 4 workers,
   feat-phase ms a clip (events and device busy), cross-phase pairs/s;
   (c) the train split -> ``DataLoader`` (B=8, shuffle, 4 workers,
   pinned) -> ``device_prefetch`` -> 3 retrieval-MLM steps on
   ModelConfig(): each device batch bitwise equal to its host batch,
   finite losses, phase 5 (b)'s launches a step; then, on epochs of 2
   batches (the split) and of 16 (its items repeated 8 times), windows of
   16 steps fed by the loader (with the time spent waiting for the first
   batch and the mean wait for each later one) and on batches already
   on the card, in turns, and the loader's ms a batch alone;
12. the CLI (``run_cli``; ``python -m lavender_tpu_torch.cli.main``) on
   ModelConfig() at full width, on the fixture's 8 videos at 5 frames a
   clip (written to build/cli/): (a) ``retrieval_mlm``, one epoch of 4
   steps at B=8 and the val eval: ``ls_tr`` finite, ``ac_vl`` in [0, 1],
   args.json, log.json and the checkpoint written, the serving cache built
   fresh for the eval (no failed build), the train epoch's launches
   phase 5 (b)'s x 4, K1-K5 launched in the eval; the same run at rates 0
   on the kernels and on the plain path: ``ls_tr`` within LOSS_TOL,
   ``ac_vl`` equal or each flipped clip inside ``_score_tol``'s gate; (b)
   ``caption``, 2 steps and the KV decode of 8 clips: BLEU-4, CIDEr-D,
   ROUGE-L finite, the train launches phase 5 (b)'s x 2, K4 and K5 in the
   decoder (K6 printed); (c) world size 1 on NCCL (hand all-reduce,
   ZeRO-1): 2 steps against the same without a process group, bitwise or
   within CLI_DP_TOL, then a consolidated save, a restore into a fresh
   sharded state and the next loss; (d) printed: the Agent's clips/s and
   ms a step (host clock), peak memory, the card's name and power;
13. Swin-L-384 (``run_swinl``; the ``large_384`` preset: embed 192,
   depths 2/2/18/2, heads 6/12/24/48, window 8 x 12 x 12, so N = Npad =
   720 and the fusion sequence L = 5 x (1 + 12 x 12) + 26 = 751) at full
   width and depth, seeded weights: (a) serving, B=4 uint8 clips of 5 x
   384 x 384, 3 requests against the plain path, the launches a forward
   from the routing predicates, ms a forward, its device time and largest
   activities, peak memory; (b) the retrieval-MLM step at B=8 (kernels
   vs plain at SWINL_COMPARE_BATCH = 4, the largest B whose plain path
   fits), launches, ms a step, device time, peak memory; (c) ``cli.main``
   retrieval_mlm at ``vis_backbone_size: "large", size_img: 384``: 2 steps
   and one eval batch.  Phase 3 holds every kernel of this path at its
   shapes (``_swinl_cases``: K1 at the four stages, B=4 and B=8, and the
   stage-4 fold; K8a / K8b, K9 and K3; K2 at Npad = 720; K4, K5, K10a /
   K10b and K11 at L = 751; K11's row kernel also at C = 1536 and 2048;
   K14 and K16 at C = 1536, checked only) and the row primitives at C =
   1536 and 2048 (``_swinl_rows``: both LNs, the row kernel's LN and sum
   modes), each against its plain version with a second call bitwise
   equal and its bound, K2 / K8a / K8b / K10a / K10b also against one
   PyTorch call (index_select, scaled_dot_product_attention and its
   backward).

Phase 3 also holds the tensor-parallel route's shapes (``_tp_shapes``,
also alone under ``--only TP``): K8a / K8b at Swin-B's heads / 2 and / 4
at every stage and K10a / K10b / K13a / K13b at the fusion encoder's 6 and
3 heads with a head offset, each against its plain version and repeated
bitwise, the keep masks exactly the offset's and those heads of the
one-process mask.  ``--tp`` (four GPUs, ``run_tp``, not in the default
run): (a) tp 4's B=8 step against one GPU's at rates 0 and at the default
rates, the launches a rank, ms a step, peak memory, moments, the NCCL
share and one all-reduce alone; (b) ``cli.main`` at dp 2 x tp 2 with its
checkpoint served on one GPU; (c) tp 4's eval logits against one GPU's
K1-K5 forward; (d) tp 2's greedy captions against one GPU's; (e)
Swin-L-384's B=8 step at dp 2 x tp 2 against one GPU's (also alone:
``--tp SWINL``).

Every time is the median of five CUDA-event windows of five calls.
The last lines: the card's name and power limit, then a JSON line of the
kernels (per kernel: launches in the phase-4, phase-5 (b), the checked
phase-6, phase-7, phase-8, phase-9, phase-10, phase-11, phase-12 and
phase-13 runs, K12's in 5 (e), each phase's also apart
(``launches_swinbert`` phase 10's, ``launches_data`` phase 11's (b) and
(c), ``launches_cli`` phase 12's (a) and (b), ``launches_swinl`` phase
13's (a), (b) and (c)); its largest error in phase 3, the Swin-L-384
cases' included;
``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms``, each the time per
call x its calls in one serving forward plus one train step plus one
seq2seq forward (K7: as if in each of its 12 layers) plus the text part
of one KV decode (K4 and K5 in the prefill, K5 in the 19 steps) plus one
"fused" and one "pallas" serving forward and one remat train step (K14,
K15) plus one ``_PEK`` serving forward (K17) and one ``_IKS`` serving
forward and train step (K16) plus one retrieval step under
LVT_ATTNLANES=0 (K13a, K13b), summed over the shapes; ``swinl_ms``,
``swinl_plain_ms``, ``swinl_library_ms`` and ``swinl_bound_ms`` the same
over one Swin-L-384 serving forward and one train step (phase 13);
``bound_ms`` is the larger of the bytes over 3.35 TB/s and the FLOPs over
989 TFLOP/s), then the device line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
    # also the device activities of a call and of ``library`` by name
    # (torch.profiler): which kernels the library's call ran as
    trace: bool = False
    # a Swin-L-384 shape: ``count`` then is the calls in one Swin-L
    # serving forward and train step, summed apart (the "swinl_*" keys)
    swinl: bool = False


def _rnd(g, *shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)


def _core_compare(C, N=245):
    """K8b: dq, dk, dv and dbias each against the plain version's, on the
    N valid rows of a window."""
    def compare(got, want):
        (dq_k, db_k), (dq_p, db_p) = got, want
        rows, parts = slice(0, N), []
        for i, nm in enumerate(("dq", "dk", "dv")):
            sl = slice(i * C, (i + 1) * C)
            parts.append((nm, dq_k[:, :, rows, sl], dq_p[:, :, rows, sl]))
        parts.append(("dbias", db_k[:, :N, :N], db_p[:, :N, :N]))
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
    cases += _swinbert_mask_cases(g, lin, ln)
    return cases


def swinbert_video_keep(n_frames: int = FRAMES, per_frame: int = 50):
    """The SwinBERT adapter's video key mask [T * (1 + hw)]: each frame's
    leading zero [CLS] masked (positions 0, 50, ..., 200 at T = 5, 224 x
    224), every patch token open: masked keys INSIDE the sequence."""
    keep = torch.ones(n_frames, per_frame, dtype=torch.bool, device="cuda")
    keep[:, 0] = False
    return keep.reshape(-1)


def _swinbert_mask_cases(g, lin, ln):
    """The fusion encoder's kernels under the SwinBERT mask (phase 10's
    model), checked, not counted: K4 at the serving forward's B=4, L = 250
    + 26 with the video's [CLS] keys masked and padded captions; K6 at the
    seq2seq forward's B=4, L = 250 + 25 under the seq2seq mask built from
    it; K10a / K10b at the train step's 64 pairs, L = 276, rate 0.1, the
    same keys masked (-1e4, the model's clamp, in bf16) and padded
    captions.  Each call repeated and required bitwise equal."""
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.encoder_attention import (
        encoder_attention_train_lanes_bwd, fused_bert_attn_block,
        fused_bert_attn_block_kmask, fused_encoder_attention_train_lanes)

    C, nH, n_video = 768, 12, FRAMES * 50
    hd, scale = C // nH, (C // nH) ** -0.5
    video = swinbert_video_keep()
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (lin(C, C) for _ in range(4))
    lw, lb = ln(C)

    def keep_rows(B, n_txt, lens):
        """[B, n_video + n_txt]: the video keep, then each caption's
        first lens[b] tokens."""
        txt = torch.arange(n_txt, device="cuda")[None] < torch.as_tensor(
            lens, device="cuda")[:, None]
        return torch.cat([video[None].expand(B, -1), txt], dim=1)

    cases = []
    L = n_video + TXT_LEN
    keep = keep_rows(BATCH, TXT_LEN, (26, 20, 12, 5))
    x = _rnd(g, BATCH, L, C)
    cases.append(Case(
        fused_bert_attn_block_kmask, f"B={BATCH} L={L} C={C} nH={nH}, "
        "SwinBERT keys (video [CLS] 0, 50, .., 200 masked) + padded "
        "captions", 0, (x, wq, wk, wv, bq, bk, bv, wo, bo, lw, lb, keep, nH,
                        scale, 1e-12),
        8.0 * BATCH * L * C * C + 4.0 * BATCH * L * L * C,
        2 * BATCH * L * C * 2 + 4 * C * C * 2 + BATCH * L,
        bitwise_repeat=True))
    Ls = n_video + CAP_LEN
    s2s = _seq2seq_keep(BATCH, n_video, CAP_LEN)
    s2s[:, :, :n_video] &= video[None, None]
    mask = torch.where(s2s, 0.0, torch.finfo(torch.float32).min)
    cases.append(Case(
        fused_bert_attn_block, f"B={BATCH} L={Ls} C={C} nH={nH}, seq2seq "
        "mask of the SwinBERT keys", 0,
        (_rnd(g, BATCH, Ls, C), wq, wk, wv, bq, bk, bv, wo, bo, lw, lb,
         mask, nH, scale, 1e-12),
        8.0 * BATCH * Ls * C * C + 4.0 * BATCH * Ls * Ls * C,
        2 * BATCH * Ls * C * 2 + 4 * C * C * 2 + mask.numel() * 4,
        bitwise_repeat=True))
    B = TRAIN_BATCH ** 2
    lens = torch.randint(5, TXT_LEN + 1, (B,), generator=g, device="cuda")
    keep = keep_rows(B, TXT_LEN, lens)
    bmask = ((~keep).float() * -1e4)[:, None, :].expand(B, L, L).to(
        torch.bfloat16).contiguous()
    slab = _rnd(g, B, L, 3 * C)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda")
    core_flops = 4.0 * B * nH * L * L * hd
    cases.append(Case(
        fused_encoder_attention_train_lanes, f"B={B} L={L} C={C} nH={nH} "
        "rate 0.1, SwinBERT keys + padded captions", 0,
        (*slab.split(C, dim=-1), bmask, seed, scale, 0.1, nH), core_flops,
        4 * B * L * C * 2 + bmask.numel() * 2 + B * nH * L * 4,
        bitwise_repeat=True))
    lse = torch.empty(B, nH, L, device="cuda")
    out = _build.attention(slab.view(B * L, 3 * C), B, L, nH, scale,
                           mask=bmask, lse=lse, seed=seed, rate=0.1
                           ).view(B, L, C)
    cases.append(Case(
        encoder_attention_train_lanes_bwd, f"B={B} L={L} C={C} nH={nH} "
        "rate 0.1, SwinBERT keys + padded captions", 0,
        (*slab.split(C, dim=-1), bmask, seed, _rnd(g, B, L, C), scale, 0.1,
         nH), 2.5 * core_flops,
        7 * B * L * C * 2 + bmask.numel() * 2 + B * nH * L * 4,
        kw={"lse": lse, "o": out}, compare=_grads_compare,
        bitwise_repeat=True))
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
        tail = got[:, :, N:]  # none where N = Npad (Swin-L's 720)
        pad = float(tail.float().abs().max()) if tail.numel() else 0.0
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
        """K10b (the wgmma backward) on a slab of n_tok tokens, its
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
            library=library, bitwise_repeat=True, trace=library is not None)

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
        for r in (rate, 0.5):  # the wgmma backward; 0.5 checked only
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
                trace=r == rate and kind == "padded keys",
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
    """K8a's row log-sum-exp (the wgmma forward with the per-head bias)
    against torch.logsumexp of the plain scores q k^T * scale + bias
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


def _tp_check(name, op, args, kw, compare):
    """``op`` twice and its plain version once on the same inputs: within
    ``compare``'s gate and the two calls bitwise equal."""
    got = op(*args, **kw)
    again = op(*args, **kw)
    want = op.plain(*args, **kw)
    torch.cuda.synchronize()
    err, rel, ok, detail = compare(got, want)
    pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
    same = all(torch.equal(a, b) for a, b in pairs if a is not None)
    print(f"[kernel] {op.name} {name}: max_abs_err {err:.4g} rel_l2 "
          f"{rel:.3g}{detail}, a second call "
          f"{'bitwise equal' if same else 'DIFFERS'}", flush=True)
    if not (ok and same):
        raise AssertionError(f"{op.name} {name}: disagrees with its plain "
                             "version or is not repeatable")


def _tp_shapes(g):
    """The tensor-parallel route's shapes on one GPU (``--tp`` runs them
    on each rank), each kernel against its plain version, each call
    repeated and bitwise equal: K8a / K8b at Swin-B's heads / 2 and / 4 at
    every stage (B=8, shifted and unshifted), on the last rank's heads
    and their bias rows; K10a / K10b and K13a / K13b at the fusion
    encoder's 12 heads / 2 and / 4 (nH 6 and 3, C 384 and 192, 64 pairs
    at L = 276, padded keys), rate 0.1, on the last rank's heads (head0
    6 and 9 of 12): their keep masks, read back from the kernels, exactly
    ``dropout.attention_keep`` with that offset and exactly those heads
    of the one-process mask."""
    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops import _build, dropout
    from lavender_tpu_torch.ops.encoder_attention import (
        encoder_attention_train_bwd, encoder_attention_train_lanes_bwd,
        fused_encoder_attention_train, fused_encoder_attention_train_lanes)
    from lavender_tpu_torch.ops.swin_block_attn import (
        pad_window_mask, rel_pos_bias_wm)
    from lavender_tpu_torch.ops.swin_core_attn import (
        swin_core_attn, swin_core_attn_bwd)

    t0 = time.perf_counter()
    window, shift, N, Npad, B = (5, 7, 7), (0, 3, 3), 245, 248, TRAIN_BATCH
    rel_index = relative_position_index((8, 7, 7))
    for stage, nW, C, nH, side, _ in SWIN_STAGES:
        hd = C // nH
        table = _rnd(g, 15 * 13 * 13, nH, std=1.0)
        masks = [None]
        if stage < 4:
            m = compute_shift_mask(5, side, side, window, shift)
            masks.append(pad_window_mask(torch.as_tensor(m, device="cuda"),
                                         Npad).to(torch.bfloat16))
        for tp in (2, 4):
            held, h0 = nH // tp, nH // tp * (tp - 1)
            Cl = held * hd
            bias = rel_pos_bias_wm(table[:, h0:h0 + held], rel_index, N,
                                   Npad, torch.bfloat16)
            qkv = _rnd(g, B, nW, Npad, 3 * Cl)
            for mask in masks:
                kind = "shifted" if mask is not None else "unshifted"
                what = (f"tp {tp}: B={B} stage {stage} nH={held} (heads "
                        f"{h0}.. of {nH}) hd={hd} {kind}")
                args = (qkv, bias, mask, held, hd ** -0.5)
                _tp_check(what, swin_core_attn, args, {}, lambda k, p: (
                    *_compare(k[:, :, :N], p[:, :, :N], TOL, REL_L2), ""))
                lse = torch.empty(B * nW, held, Npad, device="cuda")
                out = _build.attention(qkv.view(-1, 3 * Cl), B * nW, Npad,
                                       held, hd ** -0.5, bias=bias, mask=mask,
                                       lse=lse).view(B, nW, Npad, Cl)
                dout = _rnd(g, B, nW, Npad, Cl)
                dout[:, :, N:] = 0.0
                _tp_check(what, swin_core_attn_bwd,
                          (qkv, lse, dout, bias, mask, held, hd ** -0.5),
                          {"out": out}, _core_compare(Cl))
    Bp, nH, hd, L, rate = TRAIN_BATCH ** 2, 12, 64, FRAMES * 50 + TXT_LEN, 0.1
    scale = hd ** -0.5
    n_txt = torch.randint(5, TXT_LEN + 1, (Bp,), generator=g, device="cuda")
    pad = torch.arange(L, device="cuda")[None] >= L - TXT_LEN + n_txt[:, None]
    mask32 = torch.where(pad, -1e4, 0.0)[:, None, :].expand(
        Bp, L, L).contiguous()
    mask16 = mask32.to(torch.bfloat16)
    open_keys = torch.zeros(Bp, L, L, device="cuda")
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda")
    whole = dropout.attention_keep(seed, Bp, nH, L, rate)
    for tp in (2, 4):
        held, h0 = nH // tp, nH // tp * (tp - 1)
        C = held * hd
        heads = {"head0": h0, "heads_total": nH}
        what = (f"tp {tp}: B={Bp} L={L} C={C} nH={held} (heads {h0}.. of "
                f"{nH}) rate {rate}, padded keys")
        slab = _rnd(g, Bp, L, 3 * C)
        q, k, v = slab.split(C, dim=-1)
        _tp_check(what, fused_encoder_attention_train_lanes,
                  (q, k, v, mask16, seed, scale, rate, held), heads,
                  lambda a, b: (*_compare(a, b, TOL, REL_L2), ""))
        lse = torch.empty(Bp, held, L, device="cuda")
        out = _build.attention(slab.view(Bp * L, 3 * C), Bp, L, held, scale,
                               mask=mask16, lse=lse, seed=seed, rate=rate,
                               **heads).view(Bp, L, C)
        dout = _rnd(g, Bp, L, C)
        _tp_check(what, encoder_attention_train_lanes_bwd,
                  (q, k, v, mask16, seed, dout, scale, rate, held),
                  {"lse": lse, "o": out, **heads}, _grads_compare)
        qh, kh, vh = slab.view(Bp, L, 3, held, hd).permute(2, 0, 3, 1, 4)
        _tp_check(what + ", heads views", fused_encoder_attention_train,
                  (qh, kh, vh, mask32, seed, scale, rate), heads,
                  lambda a, b: (*_compare(a, b, TOL, REL_L2), ""))
        lse_h = torch.empty(Bp, held, L, device="cuda")
        out_h = _build.attention_heads(qh, kh, vh, mask32, scale, lse=lse_h,
                                       seed=seed, rate=rate, **heads)
        _tp_check(what + ", heads views", encoder_attention_train_bwd,
                  (qh, kh, vh, mask32, seed, _rnd(g, Bp, held, L, hd), scale,
                   rate), {"lse": lse_h, "o": out_h, **heads},
                  _heads_grads_compare)

        def k13(q, k, v):
            return fused_encoder_attention_train(
                q, k, v, open_keys, seed, 1.0, rate, **heads)

        def k10(q, k, v):
            t = [x.transpose(1, 2).reshape(Bp, L, C) for x in (q, k, v)]
            o = fused_encoder_attention_train_lanes(
                *t, open_keys.to(torch.bfloat16), seed, 1.0, rate, held,
                **heads)
            return o.view(Bp, L, held, hd).transpose(1, 2)

        want = dropout.attention_keep(seed, Bp, held, L, rate, h0, nH)
        n_off = int((want != whole[:, h0:h0 + held]).sum())
        for name, run in (("K10a", k10), ("K13a", k13)):
            n_diff = int((_probe_keep(run, Bp, held, L, hd) != want).sum())
            print(f"[kernel] {name} tp {tp}, heads {h0}..{h0 + held - 1} of "
                  f"{nH}, rate {rate}: the keep mask read back from the "
                  f"kernel differs from dropout.attention_keep(head0={h0}) "
                  f"in {n_diff} of {want.numel()}; that mask differs from "
                  f"those heads of the one-process mask in {n_off}",
                  flush=True)
            if n_diff or n_off:
                raise AssertionError(f"{name} tp {tp}: the head offset's "
                                     "keep mask is not one process's")
    print(f"[kernel] tensor-parallel shapes checked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


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
    (B=4, stage 3), K12 (1,104 rows), K10b and K13b (64 pairs, L = 276),
    K8a and K8b (B=8, stage 1, shifted) under torch.profiler, those in
    ``only`` where given, first in phase 3 (the profiler's records thin
    out once a process has traced many windows): their kernels' names must
    include the tile GEMM and (K14, K16) the chunk LN and the tensor-core
    forward, (K12) the row kernel, (K10b, K13b) the wgmma backward and the
    row-dot pass before it, (K8a) the wgmma forward, (K8b) the wgmma
    backward, the row-dot pass, the dbias kernel and the chunks' sum, and
    none of the wmma GEMM (gemm_bf16_kernel) and the f32-pipe core
    (attention_kernel), both gone, the scalar LN (layernorm_bf16_kernel)
    or the mma.sync dq, dk/dv and dbias kernels (gone with K8b's move).  A
    call is traced up to three times, its names the union: a process's
    first traced window has dropped the first kernel's record (the chunk LN
    of K14a)."""
    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.encoder_attention import (
        encoder_attention_train_bwd, encoder_attention_train_lanes_bwd)
    from lavender_tpu_torch.ops.fused_mlp import fused_ffn_post_ln_train
    from lavender_tpu_torch.ops.swin_block_attn import (
        fused_swin_block_attn, fused_swin_block_full,
        fused_swin_block_wm_shifted, pad_window_mask, rel_pos_bias_rows,
        rel_pos_bias_wm)
    from lavender_tpu_torch.ops.swin_core_attn import (
        swin_core_attn, swin_core_attn_bwd)

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
    # K10b and K13b at the train step's 64 pairs, L = 276, rate 0.1
    Bp, nHb, hdb, Lb = TRAIN_BATCH ** 2, 12, 64, FRAMES * 50 + TXT_LEN
    Cb = nHb * hdb
    slab = _rnd(g, Bp, Lb, 3 * Cb)
    seed = torch.tensor([11], device="cuda")
    mask_b = torch.zeros(Bp, Lb, Lb, device="cuda")
    lse_b, lse_h = (torch.empty(Bp, nHb, Lb, device="cuda") for _ in range(2))
    out_b = _build.attention(slab.view(-1, 3 * Cb), Bp, Lb, nHb, hdb ** -0.5,
                             mask=mask_b.to(torch.bfloat16), lse=lse_b,
                             seed=seed, rate=0.1).view(Bp, Lb, Cb)
    qh, kh, vh = slab.view(Bp, Lb, 3, nHb, hdb).permute(2, 0, 3, 1, 4)
    out_h = _build.attention_heads(qh, kh, vh, mask_b, hdb ** -0.5,
                                   lse=lse_h, seed=seed, rate=0.1)
    dout_b = _rnd(g, Bp, Lb, Cb)
    # K8a and K8b at B=8, stage 1, shifted (Npad = 248)
    Np = 248
    bias8 = rel_pos_bias_wm(_rnd(g, 15 * 13 * 13, nH),
                            relative_position_index((8, 7, 7)), 245, Np,
                            torch.bfloat16)
    mask8 = pad_window_mask(torch.as_tensor(compute_shift_mask(
        5, side, side, window, shift), device="cuda"), Np).to(torch.bfloat16)
    nW8 = mask8.shape[0]
    qkv8 = _rnd(g, TRAIN_BATCH, nW8, Np, 3 * C)
    lse8 = torch.empty(TRAIN_BATCH * nW8, nH, Np, device="cuda")
    out8 = _build.attention(qkv8.view(-1, 3 * C), TRAIN_BATCH * nW8, Np, nH,
                            (C // nH) ** -0.5, bias=bias8, mask=mask8,
                            lse=lse8).view(TRAIN_BATCH, nW8, Np, C)
    dout8 = _rnd(g, TRAIN_BATCH, nW8, Np, C)
    need = ("tile_kernel", "layernorm_rows_kernel", "fwd_kernel")
    avoid = {"K8a": ("fwd_kernel",)}  # the mma.sync forward: not K8a's now
    for kid, fn, want in (
            ("K14a", lambda: fused_swin_block_attn(*args, *statics), need),
            ("K14f", lambda: fused_swin_block_full(*args, *mlp, *statics),
             need),
            ("K16", lambda: fused_swin_block_wm_shifted(x16, *params16,
                                                        *statics16), need),
            ("K12", lambda: fused_ffn_post_ln_train(*ffn),
             ("tile_kernel", "rows_kernel")),
            ("K10b", lambda: encoder_attention_train_lanes_bwd(
                *slab.split(Cb, dim=-1), mask_b.to(torch.bfloat16), seed,
                dout_b, hdb ** -0.5, 0.1, nHb, lse=lse_b, o=out_b),
             ("bwd_wg_kernel", "row_dot_kernel")),
            ("K13b", lambda: encoder_attention_train_bwd(
                qh, kh, vh, mask_b, seed, out_h, hdb ** -0.5, 0.1,
                lse=lse_h, o=out_h), ("bwd_wg_kernel", "row_dot_kernel")),
            ("K8a", lambda: swin_core_attn(qkv8, bias8, mask8, nH,
                                           (C // nH) ** -0.5),
             ("fwd_wg_kernel",)),
            ("K8b", lambda: swin_core_attn_bwd(
                qkv8, lse8, dout8, bias8, mask8, nH, (C // nH) ** -0.5,
                out=out8), ("bwd_wg_kernel", "row_dot_kernel",
                            "dbias_wg_kernel", "sum_chunks_kernel"))):
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
                                            "layernorm_bf16_kernel",
                                            "bwd_dq_kernel",
                                            "bwd_dkdv_kernel",
                                            "bwd_dbias_kernel",
                                            *avoid.get(kid, ()))
               if old in n]
        missing = [p for p in want if not any(p in n for n in names)]
        print(f"[kernel] {kid} one call launches {len(names)} kernel(s): "
              f"{'; '.join(sorted(set(n[:70] for n in names)))}", flush=True)
        if bad or missing:
            raise AssertionError(f"{kid}: old kernels {bad}, missing "
                                 f"{missing}")


def _wgmma_sass():
    """The SASS of the built library (cuobjdump, beside nvcc): each
    instance of the Hopper attention kernels, the backward of K10b / K13b
    (12: hd 16 / 32 / 64, a bf16 or f32 mask, dropout or not) and of K8b
    (6: its bias instances, template arguments DROP = false, BIAS = true,
    the bias and mask tiles by TMA or by cp.async), K8b's dbias kernel (12:
    hd, a mask or none, TMA or cp.async tiles) and K8a's forward (24: hd, a
    mask or none, key blocks of 256 or 128, TMA or cp.async tiles), runs its products as HGMMA and loads its operands by
    UTMALDG (the TMA), with no HMMA (mma.sync); and no mma.sync dq, dk/dv
    or dbias kernel is left."""
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.sass_diff import functions

    fns = functions(str(_build.library_path()))

    def count(lines, op):
        return sum(any(w == op or w.startswith(op + ".") for w in ln.split())
                   for ln in lines)

    want = {"bwd_wg_kernel": 18, "dbias_wg_kernel": 12, "fwd_wg_kernel": 24}
    wg = {n: v for n, v in fns.items() if any(k in n for k in want)}
    bad = [n for n, v in wg.items()
           if not count(v, "HGMMA") or not count(v, "UTMALDG")
           or count(v, "HMMA")]
    found = {k: sum(k in n for n in wg) for k in want}
    bias = sum(bool(re.search(r"bwd_wg_kernelILi\d+E13__nv_bfloat16Lb0ELb1E", n))
               for n in wg)
    mma = [n for n in fns if any(k in n for k in (
        "bwd_dq_kernel", "bwd_dkdv_kernel", "bwd_dbias_kernel"))]
    for n, v in sorted(wg.items()):
        print(f"[sass] {n}: HGMMA {count(v, 'HGMMA')}, UTMALDG "
              f"{count(v, 'UTMALDG')}, HMMA {count(v, 'HMMA')}", flush=True)
    print(f"[sass] the wgmma attention kernels' instances: {found} ({bias} "
          f"of the backward's with the bias); the mma.sync dq, dk/dv and "
          f"dbias kernels: {len(mma)} instances", flush=True)
    if found != want or bias != 6 or bad or mma:
        raise AssertionError(f"wgmma attention SASS: instances {found} "
                             f"(want {want}), {bias} with the bias; "
                             f"without HGMMA / UTMALDG or with HMMA {bad}; "
                             f"mma.sync backward instances {mma}")


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
    alone also run on an older tree's package).  The Swin-L-384 cases
    (``_swinl_cases``; with ``only``, under "SWINL" alone) sum into the
    "swinl_*" keys, and with ``parts`` the row primitives at C = 1536 and
    2048 (``_swinl_rows``) follow them."""
    import itertools

    g = torch.Generator(device="cuda").manual_seed(0)
    if parts and (not only or only & {"K8a", "K8b", "K10b", "K13b"}):
        _wgmma_sass()
    if parts and (not only or only & {"K8a", "K8b", "K12", "K14a", "K14f",
                                      "K16", "K10b", "K13b"}):
        _kernel_names(g, only)
    per_kernel = {}
    swinl = _swinl_cases(g) if not only or "SWINL" in only else ()
    for c in itertools.chain(_kernel_cases(g), swinl):
        if only and ("SWINL" not in only if c.swinl
                     else c.op.name.split()[0] not in only):
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
        if c.trace:
            for who, fn in (("kernel", lambda: c.op(*c.args, **c.kw)),
                            ("library", c.library)):
                acts = _kernel_times(fn, 3)
                print(f"[kernel] {c.op.name} {c.name}: {who}'s device "
                      "activities, ms a call: " + "; ".join(
                          f"{n[:100]} {ms_:.4f}" for n, ms_ in sorted(
                              acts.items(), key=lambda kv: -kv[1])),
                      flush=True)
        if not ok:
            raise AssertionError(f"{c.op.name} {c.name}: kernel disagrees "
                                 f"with its plain version (max_abs_err {err})")
        k = per_kernel.setdefault(c.op, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": None, "bound_ms": 0.0, "t_bytes": 0.0,
            "t_flops": 0.0, "swinl_ms": 0.0, "swinl_plain_ms": 0.0,
            "swinl_library_ms": None, "swinl_bound_ms": 0.0})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        pre = "swinl_" if c.swinl else ""
        k[pre + "ms"] += c.count * ms
        k[pre + "plain_ms"] += c.count * plain_ms
        k[pre + "bound_ms"] += c.count * bound
        if not c.swinl:
            k["t_bytes"] += c.count * t_bytes
            k["t_flops"] += c.count * t_flops
        if lib_ms is not None:
            k[pre + "library_ms"] = ((k[pre + "library_ms"] or 0.0)
                                     + c.count * lib_ms)
        del c
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
    if only and "TP" in only:
        _tp_shapes(g)
    if parts and (not only or "SWINL" in only):
        _swinl_rows(g)
    if only:
        return per_kernel
    _heads_vs_lanes(g)
    _train_fwd_lse(g)
    _swin_core_lse_and_dbias(g)
    _heads_tc_pitch(g)
    _tp_shapes(g)
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


def _shifted_blocks(swin, size: int = SIZE) -> int:
    """Blocks that sit between a shift and its inverse: the second of each
    pair at every stage whose map is larger than the window (stage 4's
    7 x 7 map at 224 x 224 fills its window, so it is not shifted; so does
    Swin-L-384's 12 x 12 one)."""
    side, n = size // 4, 0
    for i, depth in enumerate(swin.depths):
        if side > swin.window_size[1]:
            n += depth // 2
        side = (side + 1) // 2
    return n


def _video_counts(ops, cfg, size: int = SIZE):
    """Launches of one Swin pass over B clips of ``size`` x ``size`` in
    serving (go_feat), from the routing predicates: K1 every block, K2
    around each shifted one, K3 where the MLP is not in K1's block
    (``mlp_in_block`` at the window's Npad: the window's FRAMES x wh x
    ww tokens rounded up to 8)."""
    from lavender_tpu_torch.ops.swin_block_attn import mlp_in_block

    s = cfg.swin
    wd, wh, ww = s.window_size
    npad = -(-min(wd, FRAMES) * wh * ww // 8) * 8
    return {ops["K1"]: sum(s.depths), ops["K2"]: 2 * _shifted_blocks(s, size),
            ops["K3"]: sum(d for i, d in enumerate(s.depths)
                           if not mlp_in_block(s.embed_dim * 2 ** i,
                                               int(s.embed_dim * 2 ** i
                                                   * s.mlp_ratio),
                                               s.num_heads[i], npad))}


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


def _requests(vocab: int, size: int = SIZE, seed: int = 0):
    """N_REQUESTS seeded requests of BATCH uint8 clips of FRAMES x size x
    size and TXT_LEN tokens (lengths 5 to TXT_LEN, the first full):
    (img, txt, mask) numpy arrays each."""
    rs = np.random.RandomState(seed)
    requests = []
    for _ in range(N_REQUESTS):
        img = rs.randint(0, 256, (BATCH, FRAMES, size, size, 3)).astype(
            np.uint8)
        lens = rs.randint(5, TXT_LEN + 1, BATCH)
        lens[0] = TXT_LEN
        mask = (np.arange(TXT_LEN)[None] < lens[:, None]).astype(np.int64)
        txt = rs.randint(1, vocab, (BATCH, TXT_LEN)) * mask
        requests.append((img, txt, mask))
    return requests


def run_serving(ops, server):
    """Phase 4: the serving forward through the kernels, with counts."""
    from lavender_tpu_torch.ops._build import plain_path

    cfg = server.config

    def plain(*request):
        with plain_path():
            return server(*request)

    requests = _requests(cfg.bert.vocab_size)
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


def _train_batch(vocab: int, size: int = SIZE, batch: int = TRAIN_BATCH):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (batch, FRAMES, size, size, 3))
    return {"img": torch.as_tensor(img.astype(np.uint8), device="cuda"),
            "txt": torch.as_tensor(rs.randint(1, vocab, (batch, TXT_LEN)),
                                   device="cuda"),
            "mask": torch.ones(batch, TXT_LEN, dtype=torch.long,
                               device="cuda"),
            "vid": torch.arange(batch, device="cuda")}


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
# after each, and leaves K2 around stages 1 and 2; _PEK adds K17 once;
# LVT_PSHIFT=0 rolls instead of K2; LVT_EMBING=1 changes no launch (its
# window-major patch embed is plain torch, as in JAX).
ROUTE_SERVE = {
    "default": {"K1": 24, "K2": 22, "K3": 2},
    "_PEK": {"K1": 24, "K2": 22, "K3": 2, "K17": 1},
    "_IKS": {"K16": 9, "K1": 15, "K2": 4, "K9": 9, "K3": 2},
    "LVT_PSHIFT=0": {"K1": 24, "K3": 2},
    "LVT_EMBING=1": {"K1": 24, "K2": 22, "K3": 2}}
# one _IKS train step (B=8): K16's backward recomputes through K2 (two
# shifts and their transposes) and K8; stages 1-2 shift around K1 as before
IKS_STEP = {"K16": 9, "K1": 15, "K2": 44, "K8a": 24, "K8b": 24, "K9": 24}


# one train step (B=8) under LVT_COREBWD=0 (the wm blocks' backward
# recomputes plain: no K8) and under LVT_SWINTRAIN=1 (the attention half
# a composition around K8a / K8b, no K1; the MLP plain, no K9)
SWITCH_STEP = {
    "default": {"K1": 24, "K2": 44, "K8a": 24, "K8b": 24, "K9": 24},
    "LVT_COREBWD=0": {"K1": 24, "K2": 44, "K9": 24},
    "LVT_SWINTRAIN=1": {"K2": 44, "K8a": 24, "K8b": 24}}


@contextlib.contextmanager
def _switches(pek: bool = False, iks: bool = False, pshift: bool = True,
              corebwd: bool = True, embing: bool = False,
              swintrain: bool = False):
    """The port's LVT_PEK / LVT_IKS / LVT_PSHIFT / LVT_COREBWD module
    constants and the LVT_EMBING / LVT_SWINTRAIN variables (read per
    call), for a block."""
    from lavender_tpu_torch.models import swin3d

    names = ("_PEK", "_IKS", "_PSHIFT", "_COREBWD")
    prev = [getattr(swin3d, n) for n in names]
    env = {k: os.environ.get(k) for k in ("LVT_EMBING", "LVT_SWINTRAIN")}
    for n, v in zip(names, (pek, iks, pshift, corebwd)):
        setattr(swin3d, n, v)
    os.environ["LVT_EMBING"] = "1" if embing else "0"
    os.environ["LVT_SWINTRAIN"] = "1" if swintrain else "0"
    try:
        yield
    finally:
        for n, v in zip(names, prev):
            setattr(swin3d, n, v)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


ROUTE_FLAGS = {"default": {}, "_PEK": {"pek": True}, "_IKS": {"iks": True},
               "LVT_PSHIFT=0": {"pshift": False},
               "LVT_EMBING=1": {"embing": True}}
STEP_FLAGS = {"default": {}, "LVT_COREBWD=0": {"corebwd": False},
              "LVT_SWINTRAIN=1": {"swintrain": True}}


def run_routes(ops, server):
    """Phase 8: the JAX switches' routes.  (a) the fold cache's logits
    against the uncached, unfolded ones, the guard's cost on an unchanged
    model, and new weights loaded into the built server; (b) serving under
    _PEK, _IKS, LVT_PSHIFT=0 and LVT_EMBING=1 against the plain path,
    launches, clips/s beside the default route in turns, device-busy share
    per route; (c) the _IKS train step: loss and gradients kernels vs
    plain, launches, ten steps, step time beside the default step's; (d)
    K16 against the K2 + K1 attention half + K2^-1 composition it
    replaces; (e) the train step under LVT_COREBWD=0 and under
    LVT_SWINTRAIN=1: loss and gradients kernels vs plain, launches, step
    time beside the default step's in turns.  Returns the launches of the
    counted runs."""
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

    # (e) the train step under LVT_COREBWD=0 and LVT_SWINTRAIN=1
    state = create_train_state(cfg, TrainConfig(max_iter=1000,
                                                max_grad_norm=1.0), seed=0)
    step = make_train_step(loss_fn, state)
    groups = _grad_groups(state.model)
    for name, flags in STEP_FLAGS.items():
        expected = {ops[k]: n for k, n in SWITCH_STEP[name].items()}
        for k in ("K10a", "K10b", "K11"):
            expected[ops[k]] = layers
        with _switches(**flags):
            if name != "default":
                _check_step(f"(e) {name}, kernels vs plain:",
                            _loss_and_grads(state, loss_fn, batch, False),
                            _loss_and_grads(state, loss_fn, batch, True),
                            groups, tag="routes")
            _reset(ops.values())
            step(batch)
            for op, n in _check_counts(ops.values(), expected, 1,
                                       f"routes (e) {name} step").items():
                total[op] += n
    times = {name: [] for name in STEP_FLAGS}
    order = list(STEP_FLAGS)
    for name in order + order[::-1]:
        with _switches(**STEP_FLAGS[name]):
            times[name].append(_ms(lambda: step(batch), 3))
    for name, ts in times.items():
        dt = sum(ts) / len(ts)
        with _switches(**STEP_FLAGS[name]):
            host_ms, busy_ms, _ = _device_profile(lambda: step(batch))
        busy = ("device time not measured" if busy_ms is None else
                f"device busy {busy_ms:.2f} ms of {host_ms:.2f} under "
                "torch.profiler")
        print(f"[routes] (e) {name} train step: {dt:.2f} ms per step "
              f"({', '.join(f'{t:.2f}' for t in ts)}), "
              f"{TRAIN_BATCH / dt * 1e3:.2f} train clips/s at "
              f"B={TRAIN_BATCH}; {busy} ({_nvidia_smi()})", flush=True)
    del state, step
    torch.cuda.empty_cache()
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


def _snapshot(state, loss):
    """What the resume check compares, copied on the device: the last
    loss, every parameter, the AdamW moments, each group's LR, the step
    and the generator's state."""
    opt = state.optimizer.state_dict()
    return {"loss": loss.detach().float().reshape(1).clone(),
            "params": {n: p.detach().clone()
                       for n, p in state.model.named_parameters()},
            "exp_avg": {i: s["exp_avg"].clone()
                        for i, s in opt["state"].items()},
            "exp_avg_sq": {i: s["exp_avg_sq"].clone()
                           for i, s in opt["state"].items()},
            "lr": [g["lr"] for g in state.optimizer.param_groups],
            "step": state.step, "generator": state.generator.get_state()}


def _snapshot_diff(a, b):
    """Largest |a - b| per kind of tensor of two snapshots; None where the
    LR, step or generator state differ."""
    if (a["lr"], a["step"]) != (b["lr"], b["step"]) or not torch.equal(
            a["generator"], b["generator"]):
        return None
    out = {"loss": float((a["loss"] - b["loss"]).abs().max())}
    for kind in ("params", "exp_avg", "exp_avg_sq"):
        out[kind] = max(float((a[kind][k] - b[kind][k]).abs().max())
                        for k in a[kind])
    return out


@torch.no_grad()
def _seeded_layer_norms(model, seed: int):
    """Seeded Swin LayerNorm affines (scale 1 + N(0, 0.1^2), shift
    N(0, 0.1^2)) in place of the init's 1 and 0 (see _swin_layer_norms)."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.enc_img.swin.modules():
        if isinstance(mod, torch.nn.LayerNorm):
            mod.weight.copy_(1.0 + 0.1 * torch.randn(mod.weight.shape,
                                                     generator=g))
            mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=g))
    return model


def run_swinbert(ops):
    """Phase 10: ModelConfig(swinbert=True) at full width (Swin-B +
    BERT-base, seeded random weights) from a SwinBERT-layout checkpoint.
    (a) the weights written as a SwinBERT ``.pt`` (``swinbert_layout_keys``)
    load through ``load_reference_checkpoint`` into a fresh f32 model on
    the card: every mapped tensor as written, the unmapped ones at their
    init; (b) serving, 3 requests of B=4, kernels vs plain, launches,
    clips/s, device time a forward; (c) the seq2seq forward (K6 in every
    layer), kernels vs plain; (d) the retrieval-MLM step at B=8 from the
    checkpoint: loss and gradients kernels vs plain, launches, then 3
    steps straight (twice) against 2 steps + ``save_train_state`` +
    ``restore_train_state`` into a fresh state + 1 step; (e) the same
    clips as float frames (``device_normalize`` on the card) against the
    uint8 path, and clips of 98 x 98 (the patch embed's spatial pad),
    kernels vs plain.  Returns the launches of the counted runs."""
    from lavender_tpu_torch.config import ModelConfig, TrainConfig
    from lavender_tpu_torch.convert import (remap_swinbert_keys,
                                            swinbert_layout_keys)
    from lavender_tpu_torch.data.transforms import device_normalize
    from lavender_tpu_torch.models.lavender import LavenderModel, init_weights
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.serve import LavenderServer
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train import checkpoint
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    cfg = ModelConfig(swinbert=True)
    layers, vocab = cfg.bert.num_hidden_layers, cfg.bert.vocab_size
    total = {op: 0 for op in ops.values()}

    def add(counts):
        for op, n in counts.items():
            total[op] += n

    def vs_plain(label, srv, *request):
        out = srv(*request)
        with plain_path():
            ref = srv(*request)
        err, rel, ok = _compare(out, ref, SLICE_TOL, SLICE_REL_L2)
        print(f"[swinbert] {label}: logits {tuple(out.shape)}, vs plain "
              f"path max_abs_err {err:.4g} rel_l2 {rel:.3g} (tol "
              f"{SLICE_TOL} max(1,max|ref|), {SLICE_REL_L2}), max|ref| "
              f"{float(ref.float().abs().max()):.3g}", flush=True)
        if not (ok and bool(torch.isfinite(out).all())):
            raise AssertionError(f"{label}: kernel path disagrees")
        return out

    tmp = tempfile.mkdtemp(prefix="swinbert_", dir=str(_build.BUILD_DIR))
    try:
        # (a) a SwinBERT-layout checkpoint into a fresh model on the card
        t0 = time.perf_counter()
        src = _seeded_layer_norms(init_weights(
            LavenderModel(cfg), torch.Generator().manual_seed(20)), 21)
        path = os.path.join(tmp, "ckpt_swinbert_seed20.pt")
        written = swinbert_layout_keys(src.state_dict())
        torch.save(written, path)
        mapped = set(remap_swinbert_keys(written))
        model = init_weights(LavenderModel(cfg),
                             torch.Generator().manual_seed(1)).to("cuda")
        init = {k: v.clone() for k, v in model.state_dict().items()}
        checkpoint.load_reference_checkpoint(path, model)
        n_mapped, src_sd = 0, src.state_dict()
        for k, v in model.state_dict().items():
            want = src_sd[k] if k in mapped else init[k]
            n_mapped += k in mapped
            if not (v.is_cuda and torch.equal(v.cpu(), want.cpu())):
                raise AssertionError(f"(a) {k}: not the "
                                     f"{'written' if k in mapped else 'init'}"
                                     " tensor")
        print(f"[swinbert] (a) {len(written)} tensors written as "
              f"{os.path.basename(path)} "
              f"({os.path.getsize(path) / 2 ** 20:.0f} MiB) loaded into a "
              f"fresh f32 model on the card: {n_mapped} mapped tensors "
              f"equal to the written ones, the {len(init) - n_mapped} "
              f"unmapped ({sorted(set(init) - mapped)}) at their init; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        server = LavenderServer(cfg, seed=2, frames=FRAMES, size=SIZE)
        server.model.load_state_dict(model.state_dict())
        del model, init, src, src_sd
        torch.cuda.empty_cache()

        # (b) serving: 3 requests of B=4
        rs = np.random.RandomState(10)
        requests = []
        for _ in range(N_REQUESTS):
            img = rs.randint(0, 256, (BATCH, FRAMES, SIZE, SIZE, 3)).astype(
                np.uint8)
            lens = rs.randint(5, TXT_LEN + 1, BATCH)
            lens[0] = TXT_LEN
            mask = (np.arange(TXT_LEN)[None] < lens[:, None]).astype(np.int64)
            requests.append((img, rs.randint(1, vocab, (BATCH, TXT_LEN))
                             * mask, mask))
        per_fwd = {**_video_counts(ops, cfg), ops["K4"]: layers,
                   ops["K5"]: layers}
        server(*requests[0])  # warm-up; the guard rebuilds the cache
        _reset(ops.values())
        outs = [server(*r) for r in requests]
        add(_check_counts(ops.values(), per_fwd, N_REQUESTS, "swinbert (b)"))
        for i, (out, req) in enumerate(zip(outs, requests)):
            with plain_path():
                ref = server(*req)
            err, rel, ok = _compare(out, ref, SLICE_TOL, SLICE_REL_L2)
            print(f"[swinbert] (b) request {i} (text lengths "
                  f"{req[2].sum(1).tolist()}): vs plain path max_abs_err "
                  f"{err:.4g} rel_l2 {rel:.3g} (tol {SLICE_TOL} "
                  f"max(1,max|ref|), {SLICE_REL_L2}), max|ref| "
                  f"{float(ref.float().abs().max()):.3g}", flush=True)
            if not (ok and bool(torch.isfinite(out).all())):
                raise AssertionError(f"(b) request {i}: kernel path logits "
                                     "disagree with the plain path")
        ts = [_ms(lambda: server(*requests[0]), 10) for _ in range(2)]
        host_ms, busy_ms, n_dev = _device_profile(
            lambda: [server(*requests[0]) for _ in range(3)])
        busy = ("device time not measured (the profiler recorded no device "
                "activity)" if busy_ms is None else
                f"device busy {busy_ms / 3:.3f} ms a forward of "
                f"{host_ms / 3:.3f} ({busy_ms / host_ms:.1%}), "
                f"{n_dev / 3:.0f} device activities")
        print(f"[swinbert] (b) serving: {sum(ts) / 2:.2f} ms per forward "
              f"({', '.join(f'{t:.2f}' for t in ts)}), "
              f"{BATCH / (sum(ts) / 2) * 1e3:.2f} clips/s at B={BATCH}; "
              f"under torch.profiler {busy} ({_nvidia_smi()})", flush=True)

        # (c) the seq2seq forward: K6 in every layer, no K4
        ctxt, cmask = _caption_text(rs, BATCH, vocab)
        _reset(ops.values())  # the plain path launches nothing
        vs_plain("(c) seq2seq forward", server, requests[0][0], ctxt, cmask,
                 "seq2seq")
        add(_check_counts(ops.values(), {**_video_counts(ops, cfg),
                                         ops["K5"]: layers,
                                         ops["K6"]: layers}, 1,
                          "swinbert (c)"))

        # (e) float frames normalized on the card against the uint8 path;
        # a geometry the patch does not divide, kernels vs plain
        img_f = device_normalize(torch.as_tensor(requests[0][0],
                                                 device="cuda"))
        _reset(ops.values())
        got = server(img_f, *requests[0][1:])
        add(_check_counts(ops.values(), per_fwd, 1, "swinbert (e) float"))
        err, rel, ok = _compare(got, outs[0], SLICE_TOL, SLICE_REL_L2)
        print(f"[swinbert] (e) float frames (device_normalize, the general "
              f"patch embed) vs the uint8 path: max_abs_err {err:.4g} "
              f"rel_l2 {rel:.3g} (tol {SLICE_TOL} max(1,max|ref|), "
              f"{SLICE_REL_L2})", flush=True)
        if not ok:
            raise AssertionError("(e) float frames disagree with uint8")
        odd = rs.randint(0, 256, (2, FRAMES, 98, 98, 3)).astype(np.uint8)
        _reset(ops.values())
        vs_plain("(e) clips 2 x 5 x 98 x 98 (spatial pad)", server, odd,
                 *(a[:2] for a in requests[0][1:]))
        torch.cuda.synchronize()
        counts = {op: op.launches for op in ops.values()}
        add(counts)
        print("[swinbert] (e) 98 x 98 forward's launches: " + ", ".join(
            f"{op.name.split()[0]} {n}" for op, n in counts.items() if n),
            flush=True)
        del server, outs
        torch.cuda.empty_cache()

        # (d) the retrieval-MLM step from the checkpoint, then the resume
        loss_fn = retrieval.make_loss_fn(TRUE_ID, FALSE_ID)
        batch = _train_batch(vocab)
        tc = TrainConfig(lr=1e-4, max_iter=10, warmup_ratio=0.2,
                         max_grad_norm=1.0)

        def fresh(seed):
            st = create_train_state(cfg, tc, seed=seed)
            checkpoint.load_reference_checkpoint(path, st.model)
            return st, make_train_step(loss_fn, st)

        state, step = fresh(0)
        _check_step("(d) SwinBERT retrieval step, kernels vs plain:",
                    _loss_and_grads(state, loss_fn, batch, False),
                    _loss_and_grads(state, loss_fn, batch, True),
                    _grad_groups(state.model), tag="swinbert")
        n_shift, depth = _shifted_blocks(cfg.swin), sum(cfg.swin.depths)
        per_step = {ops["K1"]: depth, ops["K2"]: 4 * n_shift,
                    ops["K8a"]: depth, ops["K8b"]: depth, ops["K9"]: depth,
                    ops["K10a"]: layers, ops["K10b"]: layers,
                    ops["K11"]: layers}
        # deterministic algorithms where torch has them (its index
        # backward); uninitialized memory stays unfilled, as the kernels'
        # scratch is in every other phase
        torch.use_deterministic_algorithms(True, warn_only=True)
        fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            _reset(ops.values())
            losses = [step(batch)]
            add(_check_counts(ops.values(), per_step, 1, "swinbert (d)"))
            losses += [step(batch) for _ in range(2)]
            straight = _snapshot(state, losses[-1])
            del state, step
            state, step = fresh(0)
            for _ in range(3):
                loss = step(batch)
            again = _snapshot(state, loss)
            del state, step
            state, step = fresh(0)
            step(batch)
            step(batch)
            ckpt = os.path.join(tmp, "train_state.pt")
            checkpoint.save_train_state(state, ckpt)
            del state, step
            state, step = fresh(3)
            checkpoint.restore_train_state(ckpt, state)
            resumed = _snapshot(state, step(batch))
            del state, step
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
        d_runs = _snapshot_diff(straight, again)
        d_resume = _snapshot_diff(straight, resumed)
        print(f"[swinbert] (d) losses of the straight run "
              f"{' '.join(f'{float(v):.6f}' for v in losses)}; the resumed "
              f"3rd step {float(resumed['loss']):.6f}; LR "
              f"{resumed['lr'][0]:.3g}; largest |diff| two straight runs "
              f"{d_runs}, straight vs resumed {d_resume} "
              f"({os.path.getsize(ckpt) / 2 ** 20:.0f} MiB state)",
              flush=True)
        if d_runs is None or d_resume is None:
            raise AssertionError("(d) the LR, step or generator state moved")
        if all(v == 0.0 for v in d_runs.values()):
            print("[swinbert] (d) two straight runs agree bitwise: the "
                  "resumed run must too", flush=True)
            ok = all(v == 0.0 for v in d_resume.values())
        else:
            bound = max(d_runs.values())
            print(f"[swinbert] (d) two straight runs differ: the resumed run "
                  f"must agree within their largest difference {bound:.4g}",
                  flush=True)
            ok = all(v <= bound for v in d_resume.values())
        if not ok:
            raise AssertionError("(d) the resumed run left the straight one")
        print(f"[swinbert] (d) resume: passed ({_nvidia_smi()})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


# phase 11: the fixture corpus of tests/data/make_clip_tsv.py (8 videos of
# 6-12 JPEG frames at 320 x 240, 16 captions a split); the eval's
# multi-clip sampling keeps 2 clips of 5 frames a video
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(REPO_DIR, "tests", "data")
EVAL_CLIPS, EVAL_BATCH, PAIR_BATCH, DATA_STEPS = 2, 8, 64, 3
DATA_TIMED, DATA_EPOCH_REPS = 16, 8  # phase 11 (c)'s timed windows
# the decoded frames against the generator's: JPEG at quality 95
DECODE_MEAN_MAX, DECODE_MAX = 3.0, 48


def _fixture_module():
    """tests/data/make_clip_tsv.py, loaded by path (its frames come from
    numpy alone)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_clip_tsv", os.path.join(DATA_DIR, "make_clip_tsv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _score_tol(logits, gate):
    """Per pair, the most the score p_t / (p_t + p_f) can move when each
    logit moves by at most ``gate``; inf where the denominator is within
    2 gates of 0."""
    den = np.abs(logits.sum(-1))
    s = np.abs(logits[:, 0] / np.where(den > 0, logits.sum(-1), 1.0))
    room = den - 2 * gate
    return np.where(room > 0, gate * (1 + 2 * s) / np.maximum(room, 1e-30),
                    np.inf)


def _rank_flips(k, p, gt, tol):
    """The (text, video) pairs whose order against the text's true video
    differs between the kernel scores ``k`` and the plain ``p`` [n_t, n_v],
    with the plain gap and the gate on it (``tol`` [n_t, n_v])."""
    flips = []
    for t in range(k.shape[0]):
        g = gt[t]
        for v in range(k.shape[1]):
            if v != g and (k[t, v] > k[t, g]) != (p[t, v] > p[t, g]):
                flips.append((t, v, float(p[t, g] - p[t, v]),
                              float(tol[t, g] + tol[t, v])))
    return flips


def run_data(ops):
    """Phase 11: the data plane and the full-corpus retrieval eval on the
    fixture corpus.  (a) the clip decode path and the host's JPEG decoder
    the port picked (and the native library's build time where it builds),
    every frame decoded against the generator's raw frames, the native
    path bitwise against the Python path where both exist; (b)
    ``full_retrieval_eval``'s two phases on Swin-B + BERT-base (seeded,
    bf16, serving caches), 8 videos x 16 captions, multi-clip (2 clips of 5
    x 224 x 224), pair_batch 64: kernels vs plain path on the [MASK]
    logits at the "true" / "false" ids and on the scores where |p_true +
    p_false| >= 1, R@1/5/10 and MedR equal unless a ranking flip lies
    within the gate, launches per Swin pass and per cross chunk; host
    decode clips/s (1 and 4 workers), feat-phase device ms a clip,
    cross-phase pairs/s; (c) the train split -> DataLoader (B=8, shuffle,
    4 workers, pinned) -> device_prefetch -> 3 retrieval-MLM steps on
    ModelConfig(): each device batch bitwise its host batch, finite
    losses, phase 5 (b)'s launches per step; the step time fed by the
    loader beside the step time on batches already on the card, in turns.
    Returns the launches of (b) and (c)."""
    from lavender_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from lavender_tpu_torch.data import dataset as ds
    from lavender_tpu_torch.data import native
    from lavender_tpu_torch.data import transforms as TF
    from lavender_tpu_torch.data.loader import (DataLoader,
                                                IterationBasedBatchIter,
                                                device_prefetch)
    from lavender_tpu_torch.data.tokenizer import BertTokenizer
    from lavender_tpu_torch.data.tsv import TSVFile
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.tasks import common, retrieval
    from lavender_tpu_torch.tasks import eval_retrieval as ER
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    import base64
    import io

    fx = _fixture_module()
    cfg = DataConfig(data_dir=DATA_DIR, dataset="fixture", task="retrieval")
    tok = BertTokenizer(os.path.join(REPO_DIR, "assets", "vocab_30k.txt"))
    sets = ds.load_task_data(cfg, ER.RetrievalEvalDataset, tok,
                             multi_clip=True, max_clips=EVAL_CLIPS)
    ev = sets["val"]
    total = {op: 0 for op in ops.values()}

    # (a) the decode
    path, why = ds.decode_path(cfg)
    print(f"[data] (a) clip decode: {path} ({why}); the host path's JPEG "
          f"decoder: {TF.decoder()}", flush=True)
    tsv = TSVFile(os.path.join(DATA_DIR, "img_fixture.tsv"))
    worst_mean, worst, n_frames, same = 0.0, 0, 0, 0
    try:
        from PIL import Image
    except ImportError as e:
        Image = None
        print(f"[data] (a) PIL does not import ({e})", flush=True)
    for v in range(fx.N_VIDEOS):
        for f, b64 in enumerate(tsv[v][2:]):
            img = TF.str2img(b64)
            d = np.abs(img.astype(np.int16) - fx.draw_frame(v, f))
            worst_mean = max(worst_mean, float(d.mean()))
            worst = max(worst, int(d.max()))
            n_frames += 1
            if Image is not None:
                pil = np.asarray(Image.open(io.BytesIO(
                    base64.b64decode(b64))).convert("RGB"))
                same += int(np.array_equal(pil, img))
    print(f"[data] (a) {n_frames} frames decoded against the generator's: "
          f"worst frame mean |diff| {worst_mean:.3f} (<= {DECODE_MEAN_MAX}), "
          f"max {worst} (<= {DECODE_MAX}); {TF.decoder()} and PIL bitwise "
          f"equal on {same} of {n_frames}", flush=True)
    if worst_mean > DECODE_MEAN_MAX or worst > DECODE_MAX:
        raise AssertionError("the decoded frames are not the fixture's")
    if path == "native":
        t0 = time.perf_counter()
        native.build()
        print(f"[data] (a) native library {native.library_path().name}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        nt = native.NativeTSV(os.path.join(DATA_DIR, "img_fixture.tsv"))
        for v in range(fx.N_VIDEOS):
            row = tsv[v]
            got = nt.decode_clip(ev.id2lineidx[fx.video_id(v)],
                                 list(range(2, len(row))), cfg.size_img)
            want = TF.transform_clip([TF.str2img(b) for b in row[2:]],
                                     cfg.size_img, "img_center_crop", False)
            if not np.array_equal(got, want):
                raise AssertionError(f"native != Python path on video {v}")
        print("[data] (a) native path bitwise equal to the Python path",
              flush=True)
    else:
        print(f"[data] (a) no native path here: {native.unavailable()}",
              flush=True)

    # (b) the eval, kernels vs plain
    server = build_server()
    model = server.model
    mcfg = server.config
    n_t = len(ev)
    n_pairs = n_t * len(set(ev.gt_txt2vid.values()))
    n_pass = -(-n_t // EVAL_BATCH)
    n_chunk = -(-n_pairs // PAIR_BATCH)
    layers = mcfg.bert.num_hidden_layers
    expected = {op: n * n_pass for op, n in _video_counts(ops, mcfg).items()}
    expected[ops["K4"]] = layers * n_chunk
    expected[ops["K5"]] = layers * n_chunk
    _reset(ops.values())
    fv, ft = ER.feat_phase(model, ev, EVAL_BATCH)
    out_k = ER.cross_phase(model, ev, fv, ft, PAIR_BATCH)
    counts = _check_counts(ops.values(), expected, 1, "data")
    for op, n in counts.items():
        total[op] += n
    with plain_path():
        fv_p, ft_p = ER.feat_phase(model, ev, EVAL_BATCH)
        out_p = ER.cross_phase(model, ev, fv_p, ft_p, PAIR_BATCH)
    lk, lp = out_k["logits"], out_p["logits"]
    err, rel, ok = _compare(torch.from_numpy(lk), torch.from_numpy(lp),
                            SLICE_TOL, SLICE_REL_L2)
    gate = SLICE_TOL * max(1.0, float(np.abs(lp).max()))
    print(f"[data] (b) eval: {n_t} captions x {n_pairs // n_t} videos, "
          f"{EVAL_CLIPS} clips of {ev.size_frame} x {cfg.size_img} x "
          f"{cfg.size_img}; {n_pass} Swin passes, {n_chunk} cross chunks; "
          f"[MASK] logits at true/false kernels vs plain: max|diff| {err:.4g}"
          f" (<= {gate:.4g}), rel_l2 {rel:.4g} (<= {SLICE_REL_L2})",
          flush=True)
    if not ok:
        raise AssertionError("eval logits: kernels vs plain disagree")
    sk, sp = out_k["score"], out_p["score"]
    rows, cols = out_p["t_rows"], out_p["v_cols"]
    big = np.abs(lp.sum(-1)) >= 1.0
    tol_pair = _score_tol(lp, gate)
    ds_err = np.abs(sk[rows, cols] - sp[rows, cols])
    print(f"[data] (b) scores on the {int(big.sum())} of {n_pairs} pairs "
          f"with |p_true + p_false| >= 1: max|diff| "
          f"{float(ds_err[big].max()) if big.any() else 0.0:.4g}, within "
          f"each pair's gate: {bool((ds_err[big] <= tol_pair[big]).all())}",
          flush=True)
    if not (ds_err[big] <= tol_pair[big]).all():
        raise AssertionError("eval scores: kernels vs plain disagree")
    mk = retrieval.recall_at_k(sk, out_k["gt"])
    mp = retrieval.recall_at_k(sp, out_p["gt"])
    print(f"[data] (b) kernels {mk} | plain {mp}", flush=True)
    if mk != mp:
        tol = np.full(sp.shape, np.inf)
        tol[rows, cols] = tol_pair
        flips = _rank_flips(sk, sp, out_p["gt"], tol)
        for t, v, gap, g in flips:
            print(f"[data] (b) text {t} video {v}: plain gap {gap:.4g}, "
                  f"gate {g:.4g}", flush=True)
        if any(abs(gap) > g for _, _, gap, g in flips):
            raise AssertionError("eval recall differs beyond the gate")
    # times: host decode, feat-phase device time, cross-phase pairs/s
    for workers in (1, 4):
        dl = DataLoader(ev, EVAL_BATCH, num_workers=workers)
        t0 = time.perf_counter()
        n = sum(b["img"].shape[0] * b["img"].shape[1] for b in dl)
        print(f"[data] (b) host decode, {workers} worker(s): "
              f"{n / (time.perf_counter() - t0):.1f} clips/s ({n} clips of "
              f"{ev.size_frame} frames)", flush=True)
    dtype = next(model.parameters()).dtype
    staged = [(TF.device_normalize(torch.as_tensor(b["img"], device="cuda"),
                                   dtype),
               torch.as_tensor(b["txt"], device="cuda").long(),
               torch.as_tensor(b["mask"], device="cuda").long())
              for b in DataLoader(ev, EVAL_BATCH, num_workers=4)]
    n_clips = sum(b[0].shape[0] * b[0].shape[1] for b in staged)
    feat_fn = ER.make_feat_fn(model)

    def feat_pass():
        for img, txt, mask in staged:
            feat_fn(img, txt, mask)
    with common.evaluating(model):
        ev_ms = _time_ms(feat_pass, iters=1, windows=3)
        host_ms, busy_ms, _ = _device_profile(feat_pass)
    busy = "not measured" if busy_ms is None else f"{busy_ms / n_clips:.3f}"
    cross_ms = _ms(lambda: ER.cross_phase(model, ev, fv, ft, PAIR_BATCH), 3)
    print(f"[data] (b) feat phase: {ev_ms / n_clips:.3f} ms a clip "
          f"(events), device busy {busy} ms a clip ({n_clips} clips); cross "
          f"phase: {n_pairs / cross_ms * 1e3:.1f} pairs/s ({cross_ms:.1f} ms "
          f"for {n_pairs} pairs) ({_nvidia_smi()})", flush=True)
    del server, model, fv, ft, fv_p, ft_p, staged
    torch.cuda.empty_cache()

    # (c) loader-fed train steps
    train = ds.load_task_data(cfg, retrieval.RetrievalDataset, tok)["train"]
    loader = DataLoader(train, TRAIN_BATCH, shuffle=True, num_workers=4,
                        pin_memory=True)
    tcfg = ModelConfig()
    state = create_train_state(tcfg, TrainConfig(max_iter=1000,
                                                 max_grad_norm=1.0), seed=0)
    step = make_train_step(retrieval.make_loss_fn(train.true_token_id,
                                                  train.false_token_id),
                           state)
    depth, n_shift = sum(tcfg.swin.depths), _shifted_blocks(tcfg.swin)
    per_step = {ops["K1"]: depth, ops["K2"]: 4 * n_shift,
                ops["K8a"]: depth, ops["K8b"]: depth, ops["K9"]: depth,
                ops["K10a"]: layers, ops["K10b"]: layers,
                ops["K11"]: layers}
    host = []

    def kept(batches):
        for b in batches:
            host.append({k: torch.as_tensor(v).clone() for k, v in b.items()})
            yield b
    dev, losses = [], []
    _reset(ops.values())
    for b in device_prefetch(kept(IterationBasedBatchIter(loader,
                                                          DATA_STEPS))):
        dev.append(b)
        losses.append(step(b))
    counts = _check_counts(ops.values(), per_step, DATA_STEPS, "data")
    for op, n in counts.items():
        total[op] += n
    same = all(torch.equal(d[k].cpu(), h[k]) for d, h in zip(dev, host)
               for k in h)
    losses = [float(v) for v in losses]
    print(f"[data] (c) {len(dev)} loader-fed steps (B={TRAIN_BATCH}, pinned, "
          f"4 workers): losses {' '.join(f'{v:.4f}' for v in losses)}; "
          f"device batches bitwise their host batches: {same}", flush=True)
    if not (same and len(dev) == DATA_STEPS
            and all(np.isfinite(v) for v in losses)):
        raise AssertionError("loader-fed steps: batches or losses wrong")

    def fed(n):
        """(ms a step, ms waiting for the first batch, mean ms waiting for
        each later one) over ``n`` loader-fed steps."""
        it = device_prefetch(IterationBasedBatchIter(loader, n))
        waits = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            tw = time.perf_counter()
            b = next(it, None)
            if b is None:
                break
            waits.append((time.perf_counter() - tw) * 1e3)
            step(b)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / n, waits[0],
                statistics.mean(waits[1:]))

    def prestaged(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(dev[i % len(dev)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n, 0.0, 0.0
    items = train.txt
    for reps in (1, DATA_EPOCH_REPS):
        # epochs of 2 batches (the split) and of 16 (its items repeated)
        train.txt = items * reps
        loader = DataLoader(train, TRAIN_BATCH, shuffle=True, num_workers=4,
                            pin_memory=True)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in IterationBasedBatchIter(loader,
                                                           DATA_TIMED))
        alone = (time.perf_counter() - t0) * 1e3 / n_batches
        times = {"loader": [], "staged": []}
        for label, fn in (("loader", fed), ("staged", prestaged),
                          ("staged", prestaged), ("loader", fed)):
            times[label].append(fn(DATA_TIMED))

        def fmt(i, k):
            return " ".join(f"{t[i]:.1f}" for t in times[k])
        print(f"[data] (c) epochs of {len(loader)} batches, {DATA_TIMED} "
              f"steps a window: ms a step fed by the loader {fmt(0, 'loader')}"
              f" (waiting for the first batch {fmt(1, 'loader')}, for each "
              f"later one, mean, {fmt(2, 'loader')}); on batches already "
              f"on the card {fmt(0, 'staged')} (in turns); the loader alone "
              f"{alone:.1f} ms a batch ({_nvidia_smi()})", flush=True)
    train.txt = items
    return total


# phase 12: the CLI's dataset (the fixture's 8 videos at 5 frames a clip),
# its retrieval epoch (32 train clips: 4 steps of B=8; 16 val captions, one
# a video kept: 1 eval batch) and its caption epoch (2 steps, 8 clips)
CLI_CAPS_TRAIN, CLI_CAPS_VAL, CLI_STEPS, CLI_CAP_STEPS = 4, 2, 4, 2
SWINL_CLI_STEPS = 2  # phase 13 (c): 2 train captions a video, B=8
CLI_DP_TOL = 1e-6  # (c): the data-parallel steps at world size 1


def _cli_data(root):
    """Phase 12's dataset in the reference layout under ``root``: the
    fixture's videos (``tests/data/make_clip_tsv.py``'s frames and
    captions) at 5 frames a clip, so that the train sampler draws no
    random frames and two runs see the same batches, each caption one
    string; ``txt_cli.json`` (4 train and 2 val items a video),
    ``txt_cap.json`` and ``txt_clil.json`` (2 train and 1 val item a
    video)."""
    import pickle

    from lavender_tpu_torch.data.tsv import tsv_writer

    fx = _fixture_module()
    os.makedirs(root, exist_ok=True)
    rows = [[fx.video_id(v), "{}"] + [fx._jpeg_b64(fx.draw_frame(v, f))
                                      for f in range(FRAMES)]
            for v in range(fx.N_VIDEOS)]
    tsv_writer(rows, os.path.join(root, "img_cli.tsv"))
    with open(os.path.join(root, "img_cli.lineidx")) as f:
        offsets = [int(line) for line in f]
    with open(os.path.join(root, "img_cli.id2lineidx.pkl"), "wb") as f:
        pickle.dump({fx.video_id(v): o for v, o in enumerate(offsets)}, f)
    for name, n_tr, n_vl in (("cli", CLI_CAPS_TRAIN, CLI_CAPS_VAL),
                             ("cap", CLI_CAP_STEPS, 1),
                             ("clil", SWINL_CLI_STEPS, 1)):
        items = {split: [{"video": fx.video_id(v),
                          "caption": fx.captions(v)[k % 3]}
                         for v in range(fx.N_VIDEOS) for k in range(n)]
                 for split, n in (("train", n_tr), ("val", n_vl))}
        with open(os.path.join(root, f"txt_{name}.json"), "w") as f:
            json.dump(items, f)


def _cli_config(root, name, task, rates0=False, batch=TRAIN_BATCH):
    """A run config of the default model (Swin-B + BERT-base) at 224 px, 5
    frames, 25 text tokens, ``batch`` clips a GPU (B=8), one epoch;
    ``rates0``: every dropout and drop-path rate 0."""
    cfg = {"type": "retrieval", "task": task, "dataset": "cli",
           "data_dir": root, "size_img": SIZE, "size_frame": FRAMES,
           "size_txt": TXT_LEN - 1, "size_batch": batch,
           "size_epoch": 1,
           "vocab_path": os.path.join(REPO_DIR, "assets", "vocab_30k.txt")}
    if rates0:
        cfg["swin"] = {"drop_path_rate": 0.0}
        cfg["bert"] = {"hidden_dropout_prob": 0.0,
                       "attention_probs_dropout_prob": 0.0}
    path = os.path.join(root, f"args_{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@contextlib.contextmanager
def _epoch_launches(ops):
    """The kernel launches of each Agent train and eval epoch run inside:
    {"train_epoch" | "eval_epoch": {op: launches}}; "agents": the Agents
    made inside, in order."""
    from lavender_tpu_torch.train import agent as agent_mod

    record = {n: {op: 0 for op in ops} for n in ("train_epoch",
                                                  "eval_epoch")}
    orig = {n: getattr(agent_mod.Agent, n) for n in record}
    orig["__init__"] = agent_mod.Agent.__init__
    record["agents"] = []

    def init(self, *args, **kw):
        orig["__init__"](self, *args, **kw)
        record["agents"].append(self)

    def wrap(name, fn):
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            before = {op: op.launches for op in ops}
            out = fn(self, *args, **kw)
            torch.cuda.synchronize()
            for op in ops:
                record[name][op] += op.launches - before[op]
            return out
        return run
    for n in ("train_epoch", "eval_epoch"):
        setattr(agent_mod.Agent, n, wrap(n, orig[n]))
    agent_mod.Agent.__init__ = init
    try:
        yield record
    finally:
        for n, fn in orig.items():
            setattr(agent_mod.Agent, n, fn)


def _cli_run(ops, argv, plain: bool = False):
    """``cli.main(argv)`` (inside ``plain_path()`` with ``plain``): (its
    log, its Agent, host seconds, the launches of its train and eval
    epochs as ``_epoch_launches`` records them)."""
    from lavender_tpu_torch.cli import main as cli
    from lavender_tpu_torch.ops._build import plain_path

    t0 = time.perf_counter()
    with plain_path() if plain else contextlib.nullcontext(), \
            _epoch_launches(ops) as rec:
        log = cli.main(argv)
    torch.cuda.synchronize()
    (agent,) = rec.pop("agents")
    return log, agent, time.perf_counter() - t0, rec


def _val_scores(agent, root, plain: bool):
    """The in-batch eval's scores [B, B] and true/false [MASK] logits
    [B * B, 2] of the val batch on ``agent``'s model, and each clip's
    true text."""
    from lavender_tpu_torch.config import DataConfig
    from lavender_tpu_torch.data.dataset import load_task_data
    from lavender_tpu_torch.data.tokenizer import BertTokenizer
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.tasks import common, retrieval

    tok = BertTokenizer(os.path.join(REPO_DIR, "assets", "vocab_30k.txt"))
    ds = load_task_data(DataConfig(data_dir=root, dataset="cli", task="cli",
                                   size_txt=TXT_LEN - 1), retrieval.
                        RetrievalDataset, tok)["val"]
    items = [ds[i] for i in range(len(ds))]
    b = {k: torch.as_tensor(np.stack([it[k] for it in items]),
                            device="cuda") for k in ("img", "txt", "mask",
                                                     "vid")}
    with plain_path() if plain else contextlib.nullcontext(), \
            common.evaluating(agent.model):
        logits, _ = retrieval.pairwise_mlm_logits(agent.model, b["img"],
                                                  b["txt"], b["mask"])
    tf = logits[:, -1][:, [ds.true_token_id, ds.false_token_id]].float()
    B = b["img"].shape[0]
    score = common.true_score(logits[:, -1], ds.true_token_id,
                              ds.false_token_id).reshape(B, B)
    vid = b["vid"]
    gt = (vid[:, None] == vid[None, :]).int().argmax(-1)
    return score.cpu().numpy(), tf.cpu().numpy(), gt.cpu().numpy()


def run_cli(ops):
    """Phase 12: the CLI (``python -m lavender_tpu_torch.cli.main``) on the
    default model at full width.  (a) ``retrieval_mlm``: one epoch of 4
    steps at B=8 and the val eval; ``ls_tr`` finite, ``ac_vl`` in [0, 1],
    args.json and the checkpoint written, the serving cache built fresh
    for the eval (no failed build), the train epoch's launches exactly phase 5
    (b)'s a step x 4, K1-K5 launched in the eval; then the same run with
    every rate 0 on the kernels and on the plain path: ``ls_tr`` within
    LOSS_TOL, ``ac_vl`` equal or each differing clip's ranking within the
    gate of ``_score_tol``; (b) ``caption``: 2 steps and the decode of 8
    clips, BLEU-4 / CIDEr-D / ROUGE-L finite, the train launches phase 5
    (b)'s x 2, K4 and K5 launched by the decoder (K6's count printed);
    (c) the data-parallel path at world size 1: an NCCL process group, the
    hand all-reduce and ZeRO-1, two steps on (a)'s first batches against
    the same two steps without a group (bitwise, or within CLI_DP_TOL
    relative: the line says which), then a consolidated save, a restore
    into a fresh sharded state and the next step's loss equal; (d)
    printed: the Agent's clips/s and ms a step of (a)'s epoch (host
    clock), the peak memory, the card's name and power limit.  Returns
    the launches of (a) and (b)."""
    from lavender_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from lavender_tpu_torch.data.dataset import load_task_data
    from lavender_tpu_torch.data.loader import DataLoader, device_prefetch
    from lavender_tpu_torch.data.tokenizer import BertTokenizer
    from lavender_tpu_torch.models import swin3d
    from lavender_tpu_torch.parallel import dist as pdist
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train import checkpoint
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step,
                                                  shard_train_state)
    from lavender_tpu_torch.utils.profiling import log_memory_string
    import glob
    import socket

    root = os.path.join(REPO_DIR, "build", "cli")
    shutil.rmtree(root, ignore_errors=True)
    _cli_data(root)
    out = os.path.join(root, "out")
    mcfg = ModelConfig()
    depth, n_shift = sum(mcfg.swin.depths), _shifted_blocks(mcfg.swin)
    layers = mcfg.bert.num_hidden_layers
    per_step = {ops["K1"]: depth, ops["K2"]: 4 * n_shift,
                ops["K8a"]: depth, ops["K8b"]: depth, ops["K9"]: depth,
                ops["K10a"]: layers, ops["K10b"]: layers,
                ops["K11"]: layers}
    total = {op: 0 for op in ops.values()}

    # (a) retrieval_mlm through main
    _reset(ops.values())
    torch.cuda.reset_peak_memory_stats()
    log, agent, wall, rec = _cli_run(
        ops.values(), ["--task", "retrieval_mlm", "--config",
                       _cli_config(root, "a", "cli"), "--path_output", out])
    torch.cuda.synchronize()
    for op in ops.values():
        total[op] += op.launches
    (run_dir,) = glob.glob(os.path.join(out, "_cli_*"))
    ls, ac = log["ls_tr"][0], log["ac_vl"][0]
    written = [os.path.exists(os.path.join(run_dir, f))
               for f in ("args.json", "log.json", "ckpt_cli_1.pt")]
    stats = dict(agent.epoch_stats)
    print(f"[cli] (a) retrieval_mlm: {stats['steps']} steps of "
          f"B={TRAIN_BATCH}, ls_tr {ls:.6f}, ac_vl {ac:.4f}; args.json, "
          f"log.json, ckpt_cli_1.pt written: {written}; serving caches "
          f"built fresh for the eval: {agent.cache_builds}, failed: "
          f"{agent.cache_failures}, dropped by train(): "
          f"{not swin3d.check_serving_cache(agent.model)}; {wall:.1f} s in "
          f"main", flush=True)
    if not (np.isfinite(ls) and 0.0 <= ac <= 1.0 and all(written)
            and stats["steps"] == CLI_STEPS and agent.cache_failures == 0
            and agent.cache_builds == 1):
        raise AssertionError("cli (a): the run's outputs are wrong")
    for op in ops.values():
        tr, ev = rec["train_epoch"][op], rec["eval_epoch"][op]
        want = per_step.get(op, 0) * CLI_STEPS
        print(f"[cli] (a) {op.name}: {tr} launches in the train epoch "
              f"(expected {want}), {ev} in the eval", flush=True)
        if tr != want:
            raise AssertionError(f"cli (a): {op.name} launched {tr} times "
                                 f"in training, expected {want}")
    silent = [k for k in ("K1", "K2", "K3", "K4", "K5")
              if rec["eval_epoch"][ops[k]] == 0]
    if silent:
        raise AssertionError(f"cli (a): no launch of {silent} in the eval")
    # (d) the epoch's rates
    print(f"[cli] (d) the Agent's train epoch: "
          f"{stats['clips'] / stats['seconds']:.2f} clips/s, "
          f"{stats['seconds'] / stats['steps'] * 1e3:.1f} ms a step (host "
          f"clock, {stats['steps']} steps, the first with its warm-up); "
          f"{log_memory_string(agent.state.step)} ({_nvidia_smi()})",
          flush=True)
    del agent
    torch.cuda.empty_cache()

    # (a) at rates 0: the kernels against the plain path
    cfg0 = _cli_config(root, "a0", "cli", rates0=True)
    runs = {}
    for label, plain in (("kernels", False), ("plain", True)):
        argv = ["--task", "retrieval_mlm", "--config", cfg0,
                "--path_output", os.path.join(root, f"out_{label}")]
        log, agent, wall, _ = _cli_run(ops.values(), argv, plain=plain)
        runs[label] = (log["ls_tr"][0], log["ac_vl"][0], agent,
                       *_val_scores(agent, root, plain))
        print(f"[cli] (a) rates 0, {label}: ls_tr {runs[label][0]:.6f}, "
              f"ac_vl {runs[label][1]:.4f} ({wall:.1f} s)", flush=True)
    (lk, ak, _, sk, _, gt), (lp, ap, _, sp, tfp, _) = (runs["kernels"],
                                                        runs["plain"])
    del runs
    torch.cuda.empty_cache()
    dl = abs(lk - lp)
    print(f"[cli] (a) rates 0: ls_tr |diff| {dl:.4g} (<= {LOSS_TOL} max(1, "
          f"|ls_tr|)); ac_vl {ak:.4f} vs {ap:.4f}", flush=True)
    if not dl <= LOSS_TOL * max(1.0, abs(lp)):
        raise AssertionError("cli (a): ls_tr, kernels vs plain, disagree")
    if ak != ap:
        gate = SLICE_TOL * max(1.0, float(np.abs(tfp).max()))
        tol = _score_tol(tfp, gate).reshape(sp.shape)
        flips = _rank_flips(sk, sp, gt, tol)
        for i, j, gap, g in flips:
            print(f"[cli] (a) clip {i} text {j}: plain gap {gap:.4g}, gate "
                  f"{g:.4g}", flush=True)
        if any(abs(gap) > g for _, _, gap, g in flips):
            raise AssertionError("cli (a): ac_vl differs beyond the gate")

    # (b) caption through main
    _reset(ops.values())
    log, agent, wall, rec = _cli_run(
        ops.values(), ["--task", "caption", "--config",
                       _cli_config(root, "b", "cap"), "--path_output", out])
    torch.cuda.synchronize()
    counts = {op: op.launches for op in ops.values()}
    for op in ops.values():
        total[op] += counts[op]
    metrics = log["metrics_vl"][0]
    print(f"[cli] (b) caption: ls_tr {log['ls_tr'][0]:.6f}, val "
          f"{ {k: round(v, 6) for k, v in metrics.items()} } ({wall:.1f} s)",
          flush=True)
    keys = ("Bleu_4", "CIDEr", "ROUGE_L")
    if not (np.isfinite(log["ls_tr"][0])
            and all(np.isfinite(metrics[k]) for k in keys)
            and agent.epoch_stats["steps"] == CLI_CAP_STEPS):
        raise AssertionError("cli (b): caption loss or metrics not finite")
    for op in ops.values():
        tr = rec["train_epoch"][op]
        want = per_step.get(op, 0) * CLI_CAP_STEPS
        print(f"[cli] (b) {op.name}: {tr} launches in the train epoch "
              f"(expected {want}), {counts[op] - tr} in the decode",
              flush=True)
        if tr != want:
            raise AssertionError(f"cli (b): {op.name} launched {tr} times "
                                 f"in training, expected {want}")
    decode = {k: counts[ops[k]] - rec["train_epoch"][ops[k]]
              for k in ("K4", "K5", "K6")}
    print(f"[cli] (b) the decoder's launches: {decode} (K6: the re-encode "
          f"route only)", flush=True)
    if decode["K4"] == 0 or decode["K5"] == 0:
        raise AssertionError("cli (b): the KV decoder launched no K4 / K5")
    del agent
    torch.cuda.empty_cache()

    # (c) the data-parallel path at world size 1
    tok = BertTokenizer(os.path.join(REPO_DIR, "assets", "vocab_30k.txt"))
    train = load_task_data(DataConfig(data_dir=root, dataset="cli",
                                      task="cli", size_txt=TXT_LEN - 1),
                           retrieval.RetrievalDataset, tok)["train"]
    loader = DataLoader(train, TRAIN_BATCH, shuffle=True, num_workers=4,
                        pin_memory=True)
    loader.set_epoch(1)
    batches = list(device_prefetch(loader))[:3]
    tcfg = TrainConfig(max_iter=1000, max_grad_norm=1.0)

    def fresh_state(shard):
        state = create_train_state(mcfg, tcfg, seed=0)
        if shard:
            state = shard_train_state(state, seed=0)
        return state, make_train_step(retrieval.make_loss_fn(
            train.true_token_id, train.false_token_id), state)

    def snapshot(state):
        return [p.detach().clone() for p in state.model.parameters()]

    state, step = fresh_state(False)
    ref = [float(step(b)) for b in batches[:2]]
    ref_params = snapshot(state)
    del state, step
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()
    pdist.distributed_init(addr, 1, 0, device="cuda")
    try:
        state, step = fresh_state(True)
        got = [float(step(b)) for b in batches[:2]]
        worst = max(float(((a - b).norm() / b.norm().clamp_min(1e-30))
                          .item()) for a, b in zip(snapshot(state),
                                                   ref_params))
        same = got == ref and worst == 0.0
        rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, ref))
        print(f"[cli] (c) world size 1 (NCCL, hand all-reduce, ZeRO-1): "
              f"losses {got} vs {ref} without a group; "
              f"{'bitwise equal' if same else 'not bitwise'}: loss rel "
              f"{rel:.3g}, worst parameter rel_l2 {worst:.3g} (<= "
              f"{CLI_DP_TOL})", flush=True)
        if not same and (rel > CLI_DP_TOL or worst > CLI_DP_TOL):
            raise AssertionError("cli (c): the data-parallel steps differ")
        path = os.path.join(root, "state_dp.pt")
        checkpoint.save_train_state(state, path)
        nxt = float(step(batches[2]))
        del state, step
        state, step = fresh_state(True)
        checkpoint.restore_train_state(path, state)
        resumed = float(step(batches[2]))
        print(f"[cli] (c) consolidated save + restore into a fresh ZeRO-1 "
              f"state: next loss {resumed} vs {nxt} straight", flush=True)
        if abs(resumed - nxt) > CLI_DP_TOL * max(1.0, abs(nxt)):
            raise AssertionError("cli (c): the resumed step differs")
        del state, step
    finally:
        torch.distributed.destroy_process_group()
    del batches, ref_params
    torch.cuda.empty_cache()
    return total


# --dp: the data-parallel path on 4 GPUs of one host, 2 clips a GPU (the
# global batch of phase 12's B=8)
DP_WORLD, DP_BATCH, DP_STEPS = 4, 2, 3


def _rates0_config():
    from lavender_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    return dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, drop_path_rate=0.0),
        bert=dataclasses.replace(cfg.bert, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0))


def _dp_worker(rank: int, world: int, port: int) -> int:
    """One rank of ``--dp``, on GPU ``rank`` (NCCL): (a) ``cli.main``'s
    retrieval_mlm data-parallel at rates 0, 2 clips a GPU; (b) phase 12's
    first B=8 batch, 2 clips a rank: the loss and the all-reduced
    gradients, on rank 0 against one GPU's on the whole batch with
    ``group=world`` (the JAX package's global batch of ``world`` data
    shards), then ``DP_STEPS`` ZeRO-1 steps at 2 and at 8 clips a rank:
    each rank's AdamW moments, ms a step, rank 0's step under
    torch.profiler, and rank 0's ms a step without a process group.  Rank
    0 writes the results to build/cli/dp.json."""
    from lavender_tpu_torch.cli import main as cli
    from lavender_tpu_torch.config import DataConfig, TrainConfig
    from lavender_tpu_torch.data.dataset import load_task_data
    from lavender_tpu_torch.data.loader import DataLoader
    from lavender_tpu_torch.data.tokenizer import BertTokenizer
    from lavender_tpu_torch.parallel import dist as pdist
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step,
                                                  shard_train_state)

    os.environ["LOCAL_RANK"] = str(rank)
    pdist.distributed_init(f"127.0.0.1:{port}", world, rank, device="cuda")
    root = os.path.join(REPO_DIR, "build", "cli")
    out = {}
    t0 = time.perf_counter()
    log = cli.main(["--task", "retrieval_mlm", "--config",
                    _cli_config(root, "dp", "cli", rates0=True,
                                batch=DP_BATCH),
                    "--path_output", os.path.join(root, "out_dp")])
    out["cli"] = {"ls_tr": log["ls_tr"][0], "ac_vl": log["ac_vl"][0],
                  "seconds": time.perf_counter() - t0}

    tok = BertTokenizer(os.path.join(REPO_DIR, "assets", "vocab_30k.txt"))
    train = load_task_data(DataConfig(data_dir=root, dataset="cli",
                                      task="cli", size_txt=TXT_LEN - 1),
                           retrieval.RetrievalDataset, tok)["train"]
    loader = DataLoader(train, TRAIN_BATCH, shuffle=True, num_workers=4)
    loader.set_epoch(1)
    host = next(iter(loader))
    whole = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
    mine = {k: v[rank * DP_BATCH:(rank + 1) * DP_BATCH]
            for k, v in whole.items()}
    mcfg, tcfg = _rates0_config(), TrainConfig(max_iter=1000,
                                               max_grad_norm=1.0)
    loss_fn = retrieval.make_loss_fn(train.true_token_id,
                                     train.false_token_id)
    state = shard_train_state(create_train_state(mcfg, tcfg, seed=0),
                              seed=0)
    params = [p for p in state.model.parameters() if p.requires_grad]
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss = loss_fn(state.model, mine, state.generator)
    loss.backward()
    pdist.all_reduce_grads(params)
    loss = float(pdist.all_reduce_sum(loss.detach().float())) / world
    grads = {n: p.grad.detach().clone()
             for n, p in state.model.named_parameters() if p.grad is not None}
    groups = _grad_groups(state.model)
    step = make_train_step(loss_fn, state)

    def timed(fn, batch):
        fn(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(DP_STEPS):
            fn(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) / DP_STEPS * 1e3
    out["ms_steps"] = pdist.all_gather_obj(timed(step, mine))
    # and at B=8 a GPU, the train step's batch (32 clips a step)
    out["ms_steps8"] = pdist.all_gather_obj(timed(step, whole))
    # where a step's device time goes (rank 0's trace; the ranks step in
    # lockstep through the collectives)
    host_ms, busy_ms, _ = _device_profile(lambda: step(mine))
    names = _kernel_times(lambda: step(mine), 1)
    out["profile"] = {"host_ms": host_ms, "busy_ms": busy_ms,
                      "top": sorted(names.items(), key=lambda kv: -kv[1])[:8]}
    local = state.optimizer.optim.state
    out["moments"] = pdist.all_gather_obj(sum(
        t.numel() * t.element_size() for st in local.values()
        for k, t in st.items() if k in ("exp_avg", "exp_avg_sq")))
    del state, step
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    if rank == 0:
        # the same B=2 step without a process group
        single = create_train_state(mcfg, tcfg, seed=0)
        step = make_train_step(loss_fn, single)
        out["ms_single"] = timed(step, mine)
        out["ms_single8"] = timed(step, whole)
        del single, step
        torch.cuda.empty_cache()
        ref = create_train_state(mcfg, tcfg, seed=0)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            want = retrieval.make_loss_fn(
                train.true_token_id, train.false_token_id,
                group=world)(ref.model, whole, ref.generator)
        want.backward()
        ref_grads = {n: p.grad.detach()
                     for n, p in ref.model.named_parameters()
                     if p.grad is not None}
        out["loss"], out["want_loss"] = loss, float(want.detach())
        out["grads_same_keys"] = grads.keys() == ref_grads.keys()
        out["rel_l2"] = {}
        for group, names in groups.items():
            names = [n for n in names if n in ref_grads]
            k = torch.cat([grads[n].flatten() for n in names])
            p = torch.cat([ref_grads[n].flatten() for n in names])
            out["rel_l2"][group] = float((k - p).norm()
                                         / p.norm().clamp_min(1e-30))
        with open(os.path.join(root, "dp.json"), "w") as f:
            json.dump(out, f)
    return 0


def run_dp() -> int:
    """``--dp``: the data-parallel path across ``DP_WORLD`` GPUs of one host
    (``_dp_worker`` on each), gated: every rank exits 0, the CLI's
    ``ls_tr`` finite and ``ac_vl`` in [0, 1], the loss within LOSS_TOL and
    each gradient group within STEP_GRAD_REL_L2 of one GPU's on the whole
    batch with ``group=world``, the AdamW moments split over the ranks
    (the largest share below 1.5 / world of their sum)."""
    import socket
    import subprocess

    if torch.cuda.device_count() < DP_WORLD:
        raise SystemExit(f"chip_smoke --dp: {DP_WORLD} GPUs needed, "
                         f"{torch.cuda.device_count()} found")
    root = os.path.join(REPO_DIR, "build", "cli")
    shutil.rmtree(root, ignore_errors=True)
    _cli_data(root)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
         str(DP_WORLD), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(DP_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        tail = text.strip().splitlines()[-12:]
        print(f"[dp] rank {r}: exit {p.returncode}; its last lines:",
              flush=True)
        for line in tail:
            print(f"[dp]   {line}", flush=True)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("--dp: a rank failed")
    with open(os.path.join(root, "dp.json")) as f:
        res = json.load(f)
    cli, moments = res["cli"], res["moments"]
    print(f"[dp] cli.main retrieval_mlm on {DP_WORLD} GPUs x {DP_BATCH} "
          f"clips, rates 0: ls_tr {cli['ls_tr']:.6f}, ac_vl "
          f"{cli['ac_vl']:.4f}, {cli['seconds']:.1f} s on rank 0", flush=True)
    print(f"[dp] the B={TRAIN_BATCH} batch on {DP_WORLD} ranks: loss "
          f"{res['loss']:.6f} vs {res['want_loss']:.6f} on one GPU with "
          f"group={DP_WORLD}; gradients rel_l2 {res['rel_l2']} (<= "
          f"{STEP_GRAD_REL_L2}); AdamW moments a rank "
          f"{[round(m / 2 ** 20, 1) for m in moments]} MiB of "
          f"{sum(moments) / 2 ** 20:.1f}; ms a ZeRO-1 step a rank "
          f"{[round(t, 1) for t in res['ms_steps']]} (the same "
          f"{DP_BATCH}-clip step without a group {res['ms_single']:.1f}) "
          f"({_nvidia_smi()})", flush=True)
    ms8, one8 = max(res["ms_steps8"]), res["ms_single8"]
    print(f"[dp] {TRAIN_BATCH} clips a GPU: ms a ZeRO-1 step a rank "
          f"{[round(t, 1) for t in res['ms_steps8']]} against {one8:.1f} "
          f"without a group: {DP_WORLD * TRAIN_BATCH / ms8 * 1e3:.1f} clips/s "
          f"on {DP_WORLD} GPUs against {TRAIN_BATCH / one8 * 1e3:.1f} on one "
          f"({DP_WORLD * one8 / ms8:.2f}x)", flush=True)
    prof = res["profile"]
    busy = ("not measured" if prof["busy_ms"] is None
            else f"{prof['busy_ms']:.1f} ms")
    print(f"[dp] rank 0's ZeRO-1 step under torch.profiler: host "
          f"{prof['host_ms']:.1f} ms, device busy {busy}; the largest "
          f"device activities: "
          f"{[(n[:60], round(t, 2)) for n, t in prof['top']]}", flush=True)
    ok = (np.isfinite(cli["ls_tr"]) and 0.0 <= cli["ac_vl"] <= 1.0
          and res["grads_same_keys"]
          and abs(res["loss"] - res["want_loss"])
          <= LOSS_TOL * max(1.0, abs(res["want_loss"]))
          and all(v <= STEP_GRAD_REL_L2 for v in res["rel_l2"].values())
          and max(moments) < 1.5 * sum(moments) / DP_WORLD)
    if not ok:
        raise AssertionError("--dp: the data-parallel step disagrees")
    return 0


TP_WORLD, TP_CLI_BATCH = 4, 4


def _plain_step(state, loss_fn):
    """One GPU's train step without a process group (the trainer's step
    minus its all-reduces): bf16 autocast, backward, clip, AdamW,
    schedule."""
    from lavender_tpu_torch.train.optimizer import clip_by_global_norm

    params = [p for p in state.model.parameters() if p.requires_grad]

    def step(batch):
        state.optimizer.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = loss_fn(state.model, batch, state.generator)
        loss.backward()
        clip_by_global_norm(params, state.config.max_grad_norm)
        state.optimizer.step()
        state.scheduler.step()
        return loss.detach()
    return step


def _timed_steps(step, batch, n: int = DP_STEPS) -> float:
    step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _nccl_times(group) -> dict:
    """ms of one f32 all-reduce over ``group`` (median of 10, CUDA events,
    after 3 warm-ups) at the tp step's sizes: a Swin-B stage-1 and
    stage-3 slab at B=8 ([8, 64, 248, 128], [8, 4, 248, 512]), the fusion
    encoder's [64, 276, 768], and the B=4 serving forward's fusion
    encoder ([4, 276, 768])."""
    import torch.distributed as tdist

    out = {}
    for name, shape in (("swin stage 1", (8, 64, 248, 128)),
                        ("swin stage 3", (8, 4, 248, 512)),
                        ("bert B=8 step", (64, 276, 768)),
                        ("bert B=4 serving", (4, 276, 768))):
        t = torch.ones(shape, device="cuda")
        times = []
        for i in range(13):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            tdist.all_reduce(t, group=group)
            b.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(a.elapsed_time(b))
        out[name] = (t.numel() * 4, statistics.median(times))
    return out


def _tp_step(gather, mcfg, tcfg, loss_fn, batch, profile: bool):
    """One forward + backward of ``loss_fn`` on ``batch`` under the global
    mesh, then timed steps: (res, the gathered full gradients).  ``res``
    holds this rank's loss and, over every rank, the launches of the
    forward + backward, its peak memory, ms a step, the peak with the
    steps, the AdamW moments and (with ``profile``) one step's device
    profile under torch.profiler."""
    from lavender_tpu_torch.parallel import mesh
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step,
                                                  shard_train_state)

    ops = kernel_ops()
    state = shard_train_state(create_train_state(mcfg, tcfg, seed=0), seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(ops.values())
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss = loss_fn(state.model, batch, state.generator)
    loss.backward()
    torch.cuda.synchronize()
    launches = {k: op.launches for k, op in ops.items()}
    peak_fb = torch.cuda.max_memory_allocated()
    plan = state.model.tp_plan
    grads = {n: mesh.gather_full(p.grad, *plan[n]).clone()
             for n, p in state.model.named_parameters()
             if p.grad is not None}
    res = {"loss": float(loss.detach()), "launches": gather(launches),
           "peak_fwd_bwd": gather(peak_fb)}
    del loss
    step = make_train_step(loss_fn, state)
    res["ms_step"] = gather(_timed_steps(step, batch))
    res["peak_step"] = gather(torch.cuda.max_memory_allocated())
    local = state.optimizer.optim.state
    res["moments"] = gather(sum(
        t.numel() * t.element_size() for st in local.values()
        for k, t in st.items() if k in ("exp_avg", "exp_avg_sq")))
    if profile:  # where a step's device time goes
        host_ms, busy_ms, _ = _device_profile(lambda: step(batch))
        names = _kernel_times(lambda: step(batch), 1)
        res["profile"] = gather({
            "host_ms": host_ms, "busy_ms": busy_ms,
            "nccl_ms": sum(t for n, t in names.items()
                           if "nccl" in n.lower()),
            "device_ms": sum(names.values()),
            "top": sorted(names.items(), key=lambda kv: -kv[1])[:6]})
    del state, step
    torch.cuda.empty_cache()
    return res, grads


def _tp_vs_one_gpu(res, grads, mcfg, tcfg, loss_fn, batch, label):
    """On rank 0 after ``_tp_step``: one GPU's forward + backward on the
    same batch and seed (rank_seed(0, 0)) against the tp one (LOSS_TOL /
    STEP_GRAD_REL_L2; raises), and one GPU's peak memory and ms a step
    into ``res``."""
    from lavender_tpu_torch.parallel import mesh
    from lavender_tpu_torch.train.trainer import create_train_state

    mesh.set_global_mesh(None)
    ref = create_train_state(mcfg, tcfg, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        want = loss_fn(ref.model, batch, gen)
    want.backward()
    torch.cuda.synchronize()
    res["peak_fwd_bwd_1"] = torch.cuda.max_memory_allocated()
    ref_grads = {n: p.grad.detach().clone()
                 for n, p in ref.model.named_parameters()
                 if p.grad is not None}
    _check_step(label, (res["loss"], grads),
                (float(want.detach()), ref_grads), _grad_groups(ref.model),
                tag="tp")
    del want, ref_grads
    res["ms_step_1"] = _timed_steps(_plain_step(ref, loss_fn), batch)
    res["peak_step_1"] = torch.cuda.max_memory_allocated()
    del ref
    torch.cuda.empty_cache()


def _tp_swinl(rank: int, gather, log) -> dict:
    """``--tp`` (e): Swin-L-384 (the ``large_384`` preset, for which the JAX
    package's model axis was written) at dp 2 x tp 2, each data shard the
    same B=8 batch of 5 x 384 x 384 clips (phase 13 (b)'s, drop-path 0.2,
    dropout 0.1): ``_tp_step`` with its profile, then on rank 0 against
    one GPU."""
    import torch.distributed as tdist

    from lavender_tpu_torch.config import TrainConfig
    from lavender_tpu_torch.parallel import mesh
    from lavender_tpu_torch.tasks import retrieval

    cfg = _swinl_config()
    tcfg = TrainConfig(max_iter=1000, max_grad_norm=1.0)
    loss_fn = retrieval.make_loss_fn(TRUE_ID, FALSE_ID)
    batch = _swinl_batch(cfg.bert.vocab_size)
    mesh.set_global_mesh(mesh.make_mesh(2))
    res, grads = _tp_step(gather, cfg, tcfg, loss_fn, batch, profile=True)
    log("(e) Swin-L-384 tp 2 step done")
    tdist.barrier()
    if rank == 0:
        _tp_vs_one_gpu(res, grads, cfg, tcfg, loss_fn, batch,
                       f"(e) Swin-L-384 tp 2 vs one GPU, "
                       f"B={SWINL_TRAIN_BATCH}:")
    del grads
    torch.cuda.empty_cache()
    tdist.barrier()
    return res


def _print_tp_profiles(tag: str, profiles):
    """Prints each rank's one-step profile of ``_tp_step``."""
    for r, p in enumerate(profiles):
        busy = ("not measured" if p["busy_ms"] is None
                else f"{p['busy_ms']:.1f} ms")
        print(f"[tp] {tag} rank {r}'s step under torch.profiler: host "
              f"{p['host_ms']:.1f} ms, device busy {busy}, device "
              f"activities {p['device_ms']:.1f} ms of which NCCL "
              f"{p['nccl_ms']:.1f} ms "
              f"({100 * p['nccl_ms'] / max(p['device_ms'], 1e-9):.1f}%); the "
              f"largest {[(n[:50], round(t, 2)) for n, t in p['top']]}",
              flush=True)


def _report_tp_swinl(e, smi) -> bool:
    """Prints ``--tp`` (e) and returns whether its launches are the tp
    route's (K8a / K8b 24, K10a / K10b 12, K2 launched, no K1 / K9 /
    K11) on every rank (rank 0's comparison raised there already)."""
    gib = [round(b / 2 ** 30, 2) for b in e["peak_step"]]
    print(f"[tp] (e) Swin-L-384, B={SWINL_TRAIN_BATCH} on dp 2 x tp 2: ms a "
          f"step a rank {[round(t, 1) for t in e['ms_step']]} against "
          f"{e['ms_step_1']:.1f} on one GPU; peak memory a rank {gib} GiB "
          f"against {e['peak_step_1'] / 2 ** 30:.2f} GiB on one GPU "
          f"(forward + backward alone "
          f"{[round(b / 2 ** 30, 2) for b in e['peak_fwd_bwd']]} against "
          f"{e['peak_fwd_bwd_1'] / 2 ** 30:.2f}); loss {e['loss']:.6f} "
          f"({smi})", flush=True)
    _print_tp_profiles("(e)", e["profile"])
    ok = True
    for r, launches in enumerate(e["launches"]):
        print(f"[tp] (e) rank {r}'s launches in one forward + backward: "
              f"{ {k: n for k, n in launches.items() if n} }", flush=True)
        ok = ok and launches["K2"] > 0 and all(
            launches[k] == n for k, n in (
                ("K8a", 24), ("K8b", 24), ("K10a", 12), ("K10b", 12),
                ("K1", 0), ("K9", 0), ("K11", 0)))
    return ok


def _tp_worker(rank: int, world: int, port: int,
               swinl_only: bool = False) -> int:
    """One rank of ``--tp``, on GPU ``rank`` (NCCL), the default
    ``ModelConfig()``: (a) tp 4, one data shard: phase 12's first B=8
    batch through the retrieval-MLM step at rates 0 and at the default
    rates (loss and gathered gradients, launches, peak memory, ms a step,
    AdamW moments, the step's profile), rank 0 against one GPU's; (b)
    dp 2 x tp 2: ``cli.main`` retrieval_mlm with ``"tp": 2``, its
    checkpoint served on one GPU; (c) tp 4: the eval forward's MLM logits
    against one GPU's K1-K5 forward; (d) tp 2: a greedy decode of 4 clips
    against one GPU's; (e) Swin-L-384's step at tp 2 (``_tp_swinl``;
    alone with ``swinl_only``).  Rank 0 writes build/cli/tp.json."""
    import torch.distributed as tdist

    from lavender_tpu_torch.cli import main as cli
    from lavender_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from lavender_tpu_torch.data.dataset import load_task_data
    from lavender_tpu_torch.data.loader import DataLoader
    from lavender_tpu_torch.data.tokenizer import BertTokenizer
    from lavender_tpu_torch.models import captioning
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.parallel import dist as pdist
    from lavender_tpu_torch.parallel import mesh
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train import checkpoint

    os.environ["LOCAL_RANK"] = str(rank)
    pdist.distributed_init(f"127.0.0.1:{port}", world, rank, device="cuda")
    ops = kernel_ops()
    root = os.path.join(REPO_DIR, "build", "cli")
    m4, m2 = mesh.make_mesh(4), mesh.make_mesh(2)
    out = {"a": {}}

    def gather(obj):  # one entry per rank, over every rank
        got = [None] * world
        tdist.all_gather_object(got, obj)
        return got

    def log(msg):
        print(f"[tp] rank {rank}: {msg}", flush=True)

    if swinl_only:
        out = {"e": _tp_swinl(rank, gather, log)}
        if rank == 0:
            with open(os.path.join(root, "tp.json"), "w") as f:
                json.dump(out, f)
        tdist.barrier()
        tdist.destroy_process_group()
        return 0

    tok = BertTokenizer(os.path.join(REPO_DIR, "assets", "vocab_30k.txt"))
    train = load_task_data(DataConfig(data_dir=root, dataset="cli",
                                      task="cli", size_txt=TXT_LEN - 1),
                           retrieval.RetrievalDataset, tok)["train"]
    loader = DataLoader(train, TRAIN_BATCH, shuffle=True, num_workers=4)
    loader.set_epoch(1)
    whole = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(iter(loader)).items()}
    loss_fn = retrieval.make_loss_fn(train.true_token_id,
                                     train.false_token_id)
    tcfg = TrainConfig(max_iter=1000, max_grad_norm=1.0)

    # (a) tp 4, one data shard, the whole B=8 batch
    for label, mcfg in (("rates 0", _rates0_config()),
                        ("default rates", ModelConfig())):
        mesh.set_global_mesh(m4)
        res, grads = _tp_step(gather, mcfg, tcfg, loss_fn, whole,
                              profile=label == "default rates")
        if label == "default rates":  # NCCL alone: the step's all-reduces
            res["nccl"] = gather(_nccl_times(mesh.model_group()))
        log(f"(a) {label}: tp 4 step done")
        tdist.barrier()
        if rank == 0:
            _tp_vs_one_gpu(res, grads, mcfg, tcfg, loss_fn, whole,
                           f"(a) tp 4 vs one GPU, {label}:")
        del grads
        out["a"][label] = res
        tdist.barrier()

    # (b) dp 2 x tp 2: cli.main retrieval_mlm with "tp": 2
    cfg_path = os.path.join(root, "args_tp.json")
    if rank == 0:  # one writer
        _cli_config(root, "tp", "cli", batch=TP_CLI_BATCH)
        with open(cfg_path) as f:
            raw = json.load(f)
        with open(cfg_path, "w") as f:
            json.dump(dict(raw, tp=2), f)
    tdist.barrier()
    out_dir = os.path.join(root, "out_tp")
    t0 = time.perf_counter()
    log_b = cli.main(["--task", "retrieval_mlm", "--config", cfg_path,
                      "--path_output", out_dir])
    out["b"] = {"ls_tr": gather(log_b["ls_tr"][0]),
                "ac_vl": gather(log_b["ac_vl"][0]),
                "seconds": time.perf_counter() - t0}
    log("(b) cli.main done")
    tdist.barrier()

    # (c) tp 4: the eval forward against one GPU's K1-K5 forward
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (BATCH, FRAMES, SIZE, SIZE, 3)).astype(np.uint8)
    lens = rs.randint(5, TXT_LEN + 1, BATCH)
    lens[0] = TXT_LEN
    mask = (np.arange(TXT_LEN)[None] < lens[:, None]).astype(np.int64)
    txt = rs.randint(1, 30522, (BATCH, TXT_LEN)) * mask
    mesh.set_global_mesh(m4)
    server = build_server()
    mesh.shard_model(server.model)
    server.model.build_serving_cache(FRAMES, SIZE, SIZE)
    server(img, txt, mask)  # warm-up
    _reset(ops.values())
    logits = server(img, txt, mask).float()
    torch.cuda.synchronize()
    out["c"] = {"launches": gather({k: op.launches
                                    for k, op in ops.items()}),
                "ms": gather(_ms(lambda: server(img, txt, mask), 5))}
    del server
    torch.cuda.empty_cache()
    log("(c) tp 4 eval forward done")

    # (d) tp 2: greedy captions of 4 clips
    rs = np.random.RandomState(3)
    cap_img = rs.randint(0, 256, (BATCH, FRAMES, SIZE, SIZE, 3)).astype(
        np.uint8)
    gen_cfg = captioning.GenerateConfig(max_gen_length=GEN_LEN)
    mesh.set_global_mesh(m2)
    server = build_server()
    mesh.shard_model(server.model)
    server.model.build_serving_cache(FRAMES, SIZE, SIZE)
    ids_tp, _ = captioning.make_generate_fn(
        server.model, CLS_ID, SEP_ID, PAD_ID, MASK_ID, gen_cfg)(cap_img)
    ids_tp = ids_tp.cpu()
    del server
    torch.cuda.empty_cache()
    log("(d) tp 2 decode done")
    tdist.barrier()
    out["e"] = _tp_swinl(rank, gather, log)

    if rank == 0:
        mesh.set_global_mesh(None)
        # (b) the files, written once, and the checkpoint on one GPU
        runs = os.listdir(out_dir)
        files = sorted(os.listdir(os.path.join(out_dir, runs[0])))
        ckpts = [f for f in files if f.startswith("ckpt_")]
        out["b"].update(runs=runs, files=files)
        server = build_server()
        checkpoint.load_params(os.path.join(out_dir, runs[0], ckpts[0]),
                               server.model)
        got = server(img, txt, mask)
        with plain_path():
            ref = server(img, txt, mask)
        err, rel, ok = _compare(got, ref, SLICE_TOL, SLICE_REL_L2)
        out["b"]["served"] = {"err": err, "rel": rel, "ok": ok,
                              "finite": bool(torch.isfinite(got).all())}
        del server, got, ref
        # (c) one GPU's forward (K1-K5) on the same weights
        server = build_server()
        want = server(img, txt, mask).float()
        err, rel, ok = _compare(logits, want, SLICE_TOL, SLICE_REL_L2)
        out["c"].update(err=err, rel=rel, ok=ok,
                        max_ref=float(want.abs().max()),
                        shape=list(logits.shape),
                        ms_1=_ms(lambda: server(img, txt, mask), 5))
        # (d) one GPU's decode, its logits at every step
        steps = []
        hook = server.model.fc_mtm.register_forward_hook(
            lambda mod, inp, o: steps.append(o[:, 0].float()))
        try:
            ids_1, _ = captioning.make_generate_fn(
                server.model, CLS_ID, SEP_ID, PAD_ID, MASK_ID,
                gen_cfg)(cap_img)
        finally:
            hook.remove()
        kv = torch.stack(steps)  # [steps, B, V]
        n_steps = kv.shape[0]
        gate = SLICE_TOL * max(1.0, float(kv.abs().max()))
        top2 = kv.topk(2, dim=-1).values
        decided = ((top2[..., 0] - top2[..., 1]) > 2 * gate).cpu()
        running = torch.ones(n_steps, BATCH, dtype=torch.bool)
        ids_1 = ids_1.cpu()
        running[1:] = (ids_1[:, 1:n_steps] != SEP_ID).cumprod(1).bool().T
        differ = (ids_tp[:, 1:n_steps + 1] != ids_1[:, 1:n_steps + 1]).T
        # a clip whose tokens part at a near-tie decodes other prefixes
        # from there on: its later steps are exempt too
        parted = (differ & ~decided).cumsum(0) > 0
        checked = decided & running & ~parted
        out["d"] = {"checked": int(checked.sum()),
                    "running": int(running.sum()),
                    "near_ties": int((running & ~decided).sum()),
                    "parted": int((running & decided & parted).sum()),
                    "mismatch": int((differ & checked).sum()),
                    "differ": int(differ.sum()), "gate": gate,
                    "ids_tp": ids_tp.tolist(), "ids_1": ids_1.tolist()}
        with open(os.path.join(root, "tp.json"), "w") as f:
            json.dump(out, f)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def run_tp(swinl_only: bool = False) -> int:
    """``--tp``: tensor parallelism across ``TP_WORLD`` GPUs of one host
    (``_tp_worker`` on each; ``swinl_only`` (``--tp SWINL``): (e) alone),
    gated: every rank exits 0; (a) the tp 4 step
    within LOSS_TOL / STEP_GRAD_REL_L2 of one GPU's at rates 0 and at the
    default rates (checked on rank 0), K8a / K8b at 24 and K10a / K10b at
    12 launches a step on every rank, K2 launched, K1, K9 and K11 not;
    (b) ``ls_tr`` finite and ``ac_vl`` in [0, 1] on every rank, one run
    directory with one log and one checkpoint, which served on one GPU
    agrees with the plain path within SLICE_TOL / SLICE_REL_L2; (c) the
    tp 4 eval forward within SLICE_TOL / SLICE_REL_L2 of one GPU's, K8a
    24 and K10a 12 launches, no K1 / K4 / K5; (d) the tp 2 greedy tokens
    equal to one GPU's wherever its top-1 / top-2 gap exceeds twice the
    gate; (e) Swin-L-384's tp 2 step within LOSS_TOL / STEP_GRAD_REL_L2
    of one GPU's (checked on rank 0), the tp route's launches on every
    rank."""
    import socket
    import subprocess

    if torch.cuda.device_count() < TP_WORLD:
        raise SystemExit(f"chip_smoke --tp: {TP_WORLD} GPUs needed, "
                         f"{torch.cuda.device_count()} found")
    root = os.path.join(REPO_DIR, "build", "cli")
    shutil.rmtree(root, ignore_errors=True)
    _cli_data(root)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    # each rank's output to a file; a rank that fails stops the others at
    # once (they would wait in their next collective)
    logs = [os.path.join(root, f"tp_rank{r}.log") for r in range(TP_WORLD)]
    procs = []
    for r in range(TP_WORLD):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-worker",
                 str(r), str(TP_WORLD), str(port)]
                + (["SWINL"] if swinl_only else []), stdout=f,
                stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.perf_counter() - t0 > 1200):
                break
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            lines = f.read().strip().splitlines()
        keep = [l for l in lines if l.startswith("[tp]")] + lines[-12:]
        print(f"[tp] rank {r}: exit {p.returncode}; its [tp] and last "
              f"lines:", flush=True)
        for line in dict.fromkeys(keep):
            print(f"[tp]   {line}", flush=True)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("--tp: a rank failed")
    with open(os.path.join(root, "tp.json")) as f:
        res = json.load(f)
    smi = _nvidia_smi()
    ok = _report_tp_swinl(res["e"], smi)
    if swinl_only:
        if not ok:
            raise AssertionError("--tp SWINL: a rank launched other kernels")
        return 0
    for label, a in res["a"].items():
        gib = [round(b / 2 ** 30, 2) for b in a["peak_step"]]
        print(f"[tp] (a) {label}, B={TRAIN_BATCH} on tp 4: ms a step a rank "
              f"{[round(t, 1) for t in a['ms_step']]} against "
              f"{a['ms_step_1']:.1f} on one GPU; peak memory a rank {gib} "
              f"GiB against {a['peak_step_1'] / 2 ** 30:.2f} GiB on one GPU "
              f"(forward + backward alone {[round(b / 2 ** 30, 2) for b in a['peak_fwd_bwd']]} "
              f"against {a['peak_fwd_bwd_1'] / 2 ** 30:.2f}); AdamW moments a "
              f"rank {[round(m / 2 ** 20, 1) for m in a['moments']]} MiB "
              f"({smi})", flush=True)
        for r, launches in enumerate(a["launches"]):
            named = {k: n for k, n in launches.items() if n}
            print(f"[tp] (a) {label}, rank {r}'s launches in one forward + "
                  f"backward: {named}", flush=True)
            ok = ok and all(launches[k] == n for k, n in (
                ("K8a", 24), ("K8b", 24), ("K10a", 12), ("K10b", 12),
                ("K1", 0), ("K9", 0), ("K11", 0)))
            ok = ok and launches["K2"] > 0
        for r, times in enumerate(a.get("nccl", [])):
            print(f"[tp] (a) rank {r}: one f32 all-reduce over the 4 ranks "
                  f"alone: " + ", ".join(
                      f"{n} {b / 2 ** 20:.1f} MiB {ms:.3f} ms ("
                      f"{1.5 * b / ms / 1e6:.1f} GB/s bus)"
                      for n, (b, ms) in times.items()), flush=True)
        if "profile" in a:
            _print_tp_profiles(f"(a) {label},", a["profile"])
    b = res["b"]
    print(f"[tp] (b) cli.main retrieval_mlm, dp 2 x tp 2, {TP_CLI_BATCH} "
          f"clips a data shard: ls_tr {b['ls_tr']}, ac_vl {b['ac_vl']}, "
          f"{b['seconds']:.1f} s on rank 0; run directories {b['runs']}, "
          f"files {b['files']}; its checkpoint served on one GPU vs the "
          f"plain path: max_abs_err {b['served']['err']:.4g} rel_l2 "
          f"{b['served']['rel']:.3g}", flush=True)
    ok = ok and all(np.isfinite(v) for v in b["ls_tr"]) and all(
        0.0 <= v <= 1.0 for v in b["ac_vl"]) and len(b["runs"]) == 1 and (
        b["files"].count("log.json") == 1) and sum(
        f.startswith("ckpt_") for f in b["files"]) == 1 and (
        b["served"]["ok"] and b["served"]["finite"])
    c = res["c"]
    print(f"[tp] (c) eval forward, B={BATCH}, tp 4 vs one GPU's K1-K5 "
          f"forward: logits {c['shape']} max_abs_err {c['err']:.4g} rel_l2 "
          f"{c['rel']:.3g} (tol {SLICE_TOL} max(1,max|ref|), {SLICE_REL_L2})"
          f", max|ref| {c['max_ref']:.3g}; ms a forward a rank "
          f"{[round(t, 2) for t in c['ms']]} against {c['ms_1']:.2f} on one "
          f"GPU ({smi})", flush=True)
    for r, launches in enumerate(c["launches"]):
        ok = ok and launches["K8a"] == 24 and launches["K10a"] == 12 and all(
            launches[k] == 0 for k in ("K1", "K3", "K4", "K5"))
    print(f"[tp] (c) rank 0's launches: "
          f"{ {k: n for k, n in c['launches'][0].items() if n} }", flush=True)
    ok = ok and c["ok"] and c["shape"] == [BATCH, TXT_LEN, 30522]
    d = res["d"]
    print(f"[tp] (d) greedy captions of {BATCH} clips, tp 2 vs one GPU: "
          f"{d['checked']} of {d['running']} running steps decided by a "
          f"top-1/top-2 gap > {2 * d['gate']:.3g}, {d['mismatch']} of them "
          f"differ ({d['differ']} differ in all); {d['near_ties']} near-ties "
          f"exempt, and {d['parted']} decided steps after a near-tie that "
          f"parted the two decodes", flush=True)
    ok = ok and d["mismatch"] == 0
    if not ok:
        raise AssertionError("--tp: the tensor-parallel runs disagree or "
                             "launched other kernels")
    return 0


# ---- Swin-L at 384 x 384 (the large_384 preset) ----------------------------

SWINL_PRESET, SWINL_SIZE, SWINL_TRAIN_BATCH = "large_384", 384, 8
# phase 13 (b)'s kernels-vs-plain step: the plain path's B=5 to 8 steps
# ran out of an H100 80GB HBM3's memory (they keep every block's f32
# [B nW, nH, 720, 720] softmax for the backward), its B=4 step fits
SWINL_COMPARE_BATCH = 4
# Swin-L at T=5, 384 x 384: (stage, windows nW, C, heads, map side, block
# pairs); the window (5, 12, 12) holds N = Npad = 720 tokens (no tail pad)
SWINL_STAGES = ((1, 64, 192, 6, 96, 1), (2, 16, 384, 12, 48, 1),
                (3, 4, 768, 24, 24, 9), (4, 1, 1536, 48, 12, 1))
SWINL_WINDOW, SWINL_SHIFT, SWINL_N = (5, 12, 12), (0, 6, 6), 720
# the fusion sequence: 5 x (1 + 12 x 12) video tokens + 26 text tokens
SWINL_L = FRAMES * (1 + 12 * 12) + TXT_LEN
# the row-resident primitives' widths beyond Swin-B's 1024: Swin-L's
# stage 4 and the instances' limit
SWINL_ROW_WIDTHS = (1536, 2048)


def _swinl_config():
    from lavender_tpu_torch.config import SWIN_PRESETS, ModelConfig

    return ModelConfig(swin=SWIN_PRESETS[SWINL_PRESET])


def _swinl_cases(g):
    """Phase 3's cases at Swin-L-384's shapes, made one at a time (the
    stage-1 yardsticks hold GBs): every shape the Swin-L serving forward
    (B=4) and train step (B=8) give K1 (whole block where
    ``mlp_in_block``, else the attention half; at stage 4 also with the
    fold cache's weights and pure normalize), K8a / K8b, K9, K3 and K2 at
    N = Npad = 720, and K4, K5, K10a / K10b (rate 0.1) and K11 at L = 751;
    ``Case.count`` the calls in one Swin-L serving forward plus one train
    step.  K8a / K8b / K10a / K10b each beside its one-call counterpart
    (scaled_dot_product_attention, with the bias + shift mask as one
    additive mask, or under dropout 0.1, and its backward), as at Swin-B's
    shapes; then K14 and K16 at C = 1536 (``_swinl_wide_blocks``)."""
    import torch.nn.functional as F

    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.encoder_attention import (
        encoder_attention_train_lanes_bwd, fused_bert_attn_block_kmask,
        fused_encoder_attention_train_lanes)
    from lavender_tpu_torch.ops.fused_mlp import (
        fused_ffn_post_ln, fused_ln_mlp, fused_ln_mlp_chunked,
        fused_out_ln_train)
    from lavender_tpu_torch.ops.swin_block_attn import (
        fused_swin_block_wm, mlp_in_block, rel_pos_bias_wm)
    from lavender_tpu_torch.ops.swin_core_attn import (
        swin_core_attn, swin_core_attn_bwd)
    from lavender_tpu_torch.ops.wm_permute import shift_index, wm_shift_rows

    N = Npad = SWINL_N
    wd, wh, ww = SWINL_WINDOW

    def lin(n_out, n_in):
        return _rnd(g, n_out, n_in, std=n_in ** -0.5), _rnd(g, n_out, std=0.02)

    def ln(c):
        return 1.0 + _rnd(g, c, std=0.1), _rnd(g, c, std=0.1)

    for stage, nW, C, nH, side, pairs in SWINL_STAGES:
        hd = C // nH
        table = _rnd(g, 15 * 23 * 23, nH, std=1.0)
        bias = rel_pos_bias_wm(table, relative_position_index((8, wh, ww)),
                               N, Npad, torch.bfloat16)
        wqkv, bqkv = lin(3 * C, C)
        wproj, bproj = lin(C, C)
        n1w, n1b = ln(C)
        mlp = (*ln(C), *lin(4 * C, C), *lin(C, 4 * C))
        shifted = stage < 4  # stage 4's 12 x 12 window covers its map
        masks = [None]
        if shifted:
            masks.append(torch.as_tensor(compute_shift_mask(
                wd, side, side, SWINL_WINDOW, SWINL_SHIFT),
                device="cuda").to(torch.bfloat16))
        in_block = mlp_in_block(C, 4 * C, nH, Npad)
        w_bytes = (4 * C * C + 4 * C) * 2
        mlp_bytes = (8 * C * C + 7 * C) * 2
        for B, train in ((BATCH, False), (SWINL_TRAIN_BATCH, True)):
            M = B * nW * Npad
            x = _rnd(g, B, nW, Npad, C)
            core_flops = 4.0 * B * nW * nH * Npad * Npad * hd
            for mask in masks:
                blocks = pairs if shifted else 2 * pairs
                mask_bytes = 0 if mask is None else mask.numel() * 2
                kind = "shifted" if mask is not None else "unshifted"
                with_mlp = in_block and not train
                args = (x, n1w, n1b, wqkv, bqkv, wproj, bproj, bias, mask, nH,
                        hd ** -0.5, 1e-5)
                flops = 2.0 * M * C * 4 * C + core_flops + (
                    16.0 * M * C * C if with_mlp else 0.0)
                nbytes = 2 * M * C * 2 + w_bytes + bias.numel() * 2 + (
                    mask_bytes + (mlp_bytes if with_mlp else 0))
                name = (f"Swin-L B={B} stage {stage} C={C} nH={nH} N={N} "
                        f"{kind}" + (" +MLP" if with_mlp else
                                     " attention half"))
                yield Case(fused_swin_block_wm, name, blocks, args, flops,
                           nbytes, kw={"mlp": mlp} if with_mlp else {},
                           residual=x, bitwise_repeat=True, graph_ms=True,
                           swinl=True)
                if stage == 4 and not train:  # the serving fold cache's
                    folded = (_rnd(g, 3 * C, C, std=C ** -0.5),
                              _rnd(g, 3 * C, std=0.02), None, None)
                    yield Case(fused_swin_block_wm, name + ", folded (pure "
                               "normalize)", 0, args, flops, nbytes,
                               kw={"folded": folded}, residual=x,
                               bitwise_repeat=True, graph_ms=True,
                               swinl=True)
                if not train:
                    continue
                qkv = _rnd(g, B, nW, Npad, 3 * C)
                qkv_bytes = qkv.numel() * 2
                heads = qkv.view(B * nW, Npad, 3, nH, hd).permute(2, 0, 3, 1,
                                                                  4)
                full_mask = bias[None].expand(B * nW, nH, Npad, Npad)
                if mask is not None:
                    full_mask = (full_mask.view(B, nW, nH, Npad, Npad)
                                 + mask[None, :, None]).view_as(full_mask)
                full_mask = full_mask.contiguous()
                yield Case(
                    swin_core_attn, f"Swin-L B={B} stage {stage} C={C} "
                    f"nH={nH} N={N} {kind}", blocks,
                    (qkv, bias, mask, nH, hd ** -0.5), core_flops,
                    qkv_bytes * 4 // 3 + bias.numel() * 2 + mask_bytes
                    + M * nH * 4, bitwise_repeat=True, swinl=True,
                    library=lambda h=heads, m=full_mask, s=hd ** -0.5:
                    F.scaled_dot_product_attention(*h, attn_mask=m, scale=s))
                del full_mask
                lse = torch.empty(B * nW, nH, Npad, device="cuda")
                out = _build.attention(qkv.view(-1, 3 * C), B * nW, Npad, nH,
                                       hd ** -0.5, bias=bias, mask=mask,
                                       lse=lse).view(B, nW, Npad, C)
                dout = _rnd(g, B, nW, Npad, C)
                yield Case(
                    swin_core_attn_bwd, f"Swin-L B={B} stage {stage} C={C} "
                    f"nH={nH} N={N} {kind}", blocks,
                    (qkv, lse, dout, bias, mask, nH, hd ** -0.5),
                    2.5 * core_flops, 2 * qkv_bytes + M * C * 2
                    + M * nH * 4 + bias.numel() * 6 + mask_bytes,
                    kw={"out": out}, compare=_core_compare(C, N),
                    library=_sdpa_bias_backward(heads, bias, mask, dout, B,
                                                nW, nH, hd),
                    bitwise_repeat=True, swinl=True)
                del qkv, heads, lse, out, dout
            rows = x.reshape(-1, C)
            if train:  # K9: the MLP of every train block
                yield Case(
                    fused_ln_mlp, f"Swin-L B={B} stage {stage} M={M} C={C} "
                    f"HD={4 * C}", 2 * pairs, (rows, *mlp, 1e-5),
                    16.0 * M * C * C, 2 * M * C * 2 + mlp_bytes,
                    bitwise_repeat=True, graph_ms=True, swinl=True)
            elif not in_block:  # K3: the serving MLP + residual
                yield Case(
                    fused_ln_mlp_chunked, f"Swin-L B={B} stage {stage} M={M} "
                    f"C={C} HD={4 * C}", 2 * pairs, (rows, *mlp, 1e-5),
                    16.0 * M * C * C, 2 * M * C * 2 + mlp_bytes,
                    residual=rows, bitwise_repeat=True, graph_ms=True,
                    swinl=True)
            if not shifted:
                continue
            # K2: bf16 in serving, the f32 residual stream in training
            dt = torch.float32 if train else torch.bfloat16
            t = _rnd(g, B, nW, Npad, C, dtype=dt)
            for inverse in (False, True):
                idx, inv = (torch.as_tensor(shift_index(
                    SWINL_WINDOW, wd, side, side, Npad, SWINL_SHIFT, i),
                    device="cuda") for i in (inverse, not inverse))
                src, rows_idx = t.view(B, nW * Npad, C), idx.clamp(min=0).long()
                yield Case(
                    wm_shift_rows, f"Swin-L B={B} stage {stage} C={C} "
                    f"Npad={Npad} {dt} "
                    + ("inverse" if inverse else "forward"),
                    pairs * (2 if train else 1), (t, idx, inv), 0.0,
                    2 * t.numel() * t.element_size() + idx.numel() * 4,
                    library=lambda s=src, i=rows_idx: s.index_select(1, i),
                    swinl=True)
            del t, x, rows
    yield from _swinl_wide_blocks(g, lin, ln)

    # the fusion encoder at L = 751: serving B=4 (K4, K5), the step's 64
    # pairs (K10a / K10b at rate 0.1, K11)
    C, nH, L, layers = 768, 12, SWINL_L, 12
    hd, scale = C // nH, (C // nH) ** -0.5
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (lin(C, C) for _ in range(4))
    lw, lb = ln(C)
    x = _rnd(g, BATCH, L, C)
    keep = torch.ones(BATCH, L, dtype=torch.bool, device="cuda")
    for i, n_txt in zip(range(BATCH), (26, 20, 12, 5)):  # padded tails
        keep[i, L - TXT_LEN + n_txt:] = False
    M = BATCH * L
    yield Case(
        fused_bert_attn_block_kmask, f"Swin-L B={BATCH} L={L} C={C} "
        f"nH={nH}, padded keys", layers,
        (x, wq, wk, wv, bq, bk, bv, wo, bo, lw, lb, keep, nH, scale, 1e-12),
        8.0 * M * C * C + 4.0 * BATCH * L * L * C,
        2 * M * C * 2 + 4 * C * C * 2 + BATCH * L, bitwise_repeat=True,
        graph_ms=True, swinl=True)
    w1, b1 = lin(3072, C)
    w2, b2 = lin(C, 3072)
    yield Case(
        fused_ffn_post_ln, f"Swin-L M={M} C={C} HD=3072", layers,
        (x.reshape(-1, C), w1, b1, w2, b2, lw, lb, 1e-12),
        4.0 * M * C * 3072, 2 * M * C * 2 + 2 * C * 3072 * 2,
        bitwise_repeat=True, swinl=True)
    del x
    B = SWINL_TRAIN_BATCH ** 2
    slab = _rnd(g, B, L, 3 * C)
    q, k, v = slab.split(C, dim=-1)
    n_txt = torch.randint(5, TXT_LEN + 1, (B,), generator=g, device="cuda")
    pad = torch.arange(L, device="cuda")[None] >= L - TXT_LEN + n_txt[:, None]
    mask = (pad.float() * -1e4)[:, None, :].expand(B, L, L).to(
        torch.bfloat16).contiguous()
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda")
    rate = 0.1
    core_flops = 4.0 * B * nH * L * L * hd
    slab_bytes = B * L * C * 2
    sdpa = [t.view(B, L, nH, hd).transpose(1, 2) for t in (q, k, v)]
    yield Case(
        fused_encoder_attention_train_lanes, f"Swin-L B={B} L={L} C={C} "
        f"nH={nH} rate {rate}, padded keys", layers,
        (q, k, v, mask, seed, scale, rate, nH), core_flops,
        4 * slab_bytes + mask.numel() * 2 + B * nH * L * 4,
        library=lambda: F.scaled_dot_product_attention(
            *sdpa, attn_mask=mask[:, None], dropout_p=rate, scale=scale),
        bitwise_repeat=True, swinl=True)
    lse = torch.empty(B, nH, L, device="cuda")
    out = _build.attention(slab.view(B * L, 3 * C), B, L, nH, scale,
                           mask=mask, lse=lse, seed=seed,
                           rate=rate).view(B, L, C)
    dout = _rnd(g, B, L, C)
    # SDPA's backward alone: autograd of one forward, replayed
    leaves = [t.detach().requires_grad_(True) for t in sdpa]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=mask[:, None],
                                       dropout_p=rate, scale=scale)
    d_heads = dout.view(B, L, nH, hd).transpose(1, 2)
    yield Case(
        encoder_attention_train_lanes_bwd, f"Swin-L B={B} L={L} C={C} "
        f"nH={nH} rate {rate}, padded keys", layers,
        (q, k, v, mask, seed, dout, scale, rate, nH),
        2.5 * core_flops, 7 * slab_bytes + mask.numel() * 2 + B * nH * L * 4,
        kw={"lse": lse, "o": out}, compare=_grads_compare,
        library=lambda: torch.autograd.grad(o, leaves, d_heads,
                                            retain_graph=True),
        bitwise_repeat=True, swinl=True, trace=True)
    del slab, q, k, v, mask, lse, out, dout, sdpa, leaves, o, d_heads
    M = B * L
    yield Case(
        fused_out_ln_train, f"Swin-L M={M} C={C} rate {rate}, train step",
        layers, (_rnd(g, M, C), _rnd(g, M, C), wo, bo, lw, lb, seed, 1e-12,
                 rate), 2.0 * M * C * C, 3 * M * C * 2 + M * C + C * C * 2,
        compare=_keep_compare, bitwise_repeat=True, graph_ms=True,
        swinl=True)
    # the row kernel's dropout mode at the widths beyond 1024 (checked)
    for C in SWINL_ROW_WIDTHS:
        M = 4 * SWINL_N * 2
        (wo, bo), (lw, lb) = lin(C, C), ln(C)
        yield Case(
            fused_out_ln_train, f"Swin-L rows M={M} C={C} rate {rate}, the "
            "row kernel's wide instance", 0,
            (_rnd(g, M, C), _rnd(g, M, C), wo, bo, lw, lb, seed, 1e-5, rate),
            2.0 * M * C * C, 3 * M * C * 2 + M * C + C * C * 2,
            compare=_keep_compare, bitwise_repeat=True, graph_ms=True,
            swinl=True)


def _swinl_wide_blocks(g, lin, ln):
    """K14 (whole block and attention half) and K16 at Swin-L's stage-4
    width, C = 1536, 48 heads, B=4, window (5, 12, 12): N = Npad = 720,
    checked only (on no default route; ``attn_impl="fused"`` runs K14 on
    the large_384 preset, and K16 is a direct call at this width: its
    ``LVT_IKS`` route takes no Swin-L stage).  K14 on the spatial rows
    [4, 5, 12, 12, C], unshifted as stage 4 runs; K16 on the window-major
    slab [4, 1, 720, C] with the cyclic shift (0, 6, 6) inside (stage 4's
    window covers its map, so no model path shifts it: the case drives
    the gather and the zeroing scatter at this width), its mask the shift
    mask of that one window."""
    from lavender_tpu_torch.models.swin3d import (
        compute_shift_mask, relative_position_index)
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.swin_block_attn import (
        fused_swin_block_attn, fused_swin_block_full,
        fused_swin_block_wm_shifted, rel_pos_bias_wm)

    _, nW, C, nH, side, _ = SWINL_STAGES[3]
    N = Npad = SWINL_N
    wd, wh, ww = SWINL_WINDOW
    hd, HD, B = C // nH, 4 * C, BATCH
    M = B * nW * N
    bias = rel_pos_bias_wm(_rnd(g, 15 * 23 * 23, nH, std=1.0),
                           relative_position_index((8, wh, ww)), N, Npad,
                           torch.bfloat16)
    (wqkv, bqkv), (wproj, bproj), (n1w, n1b) = lin(3 * C, C), lin(C, C), ln(C)
    mlp = (*ln(C), *lin(HD, C), *lin(C, HD))
    params = (n1w, n1b, wqkv, bqkv, wproj, bproj)
    flops = 2.0 * M * C * 4 * C + 4.0 * B * nW * nH * N * N * hd
    nbytes = 2 * M * C * 2 + (4 * C * C + 4 * C) * 2 + bias.numel() * 2
    scale, at = hd ** -0.5, f"Swin-L B={B} stage 4 C={C} nH={nH} N={N}"
    x = _rnd(g, B, wd, side, side, C)
    b14 = _build.with_padded_rows(bias)
    statics = (SWINL_WINDOW, (0, 0, 0), nH, scale, 1e-5)
    yield Case(fused_swin_block_full, f"{at} unshifted +MLP", 0,
               (x, *params, b14, None, *mlp, *statics),
               flops + 16.0 * M * C * C, nbytes + (8 * C * C + 7 * C) * 2,
               residual=x, bitwise_repeat=True, graph_ms=True, swinl=True)
    yield Case(fused_swin_block_attn, f"{at} unshifted attention half", 0,
               (x, *params, b14, None, *statics), flops, nbytes,
               residual=x, bitwise_repeat=True, graph_ms=True, swinl=True)
    shift = (0, wh // 2, ww // 2)
    mask = torch.as_tensor(compute_shift_mask(wd, side, side, SWINL_WINDOW,
                                              shift),
                           device="cuda").to(torch.bfloat16)
    xw = _rnd(g, B, nW, Npad, C)
    yield Case(fused_swin_block_wm_shifted, f"{at} shifted {shift}, shift "
               "inside", 0, (xw, *params, bias, mask, (wd, side, side),
                             SWINL_WINDOW, shift, nH, scale, 1e-5),
               flops, nbytes + mask.numel() * 2,
               compare=_shifted_compare(xw, N), bitwise_repeat=True,
               graph_ms=True, swinl=True)


def _prim_check(name, fn, ref, nbytes, flops, tol=TOL, rel_l2=REL_L2):
    """A primitive against its plain version: within (tol, rel_l2), a
    second call bitwise equal; event ms, device ms a call in a CUDA graph
    and the bound printed.  Raises when it disagrees."""
    got, want = fn(), ref()
    err, rel, ok = _compare(got, want, tol, rel_l2)
    same = torch.equal(got, fn())
    ms, dev = _time_ms(fn), _graph_ms(fn)
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound = max(t_bytes, t_flops)
    print(f"[swinl] (d) {name}: max_abs_err {err:.4g} rel_l2 {rel:.3g} (tol "
          f"{tol} max(1,max|ref|), {rel_l2}), a second call "
          f"{'bitwise equal' if same else 'DIFFERS'}; {ms:.4f} ms (device "
          f"{dev:.4f} ms a call in a CUDA graph), bound {bound:.4f} ms "
          f"({'bytes' if t_bytes >= t_flops else 'FLOPs'}, "
          f"{100 * bound / dev:.1f}% of it) ({_nvidia_smi()})", flush=True)
    if not (ok and same):
        raise AssertionError(f"swinl (d) {name}: the primitive disagrees "
                             "with its plain version or between two calls")


def _swinl_rows(g):
    """Phase 3 (d): the row-resident primitives at C = 1536 and 2048 (the
    template instances beyond Swin-B's 1024), rows as Swin-L's B=8 stage
    4 gives them (5,760): the scalar LN (affine and pure normalize), the
    chunk LN (and its gathering mode), and the tile GEMM's row kernel in
    its LN mode (``gemm_tc_ln``: the proj's f32 K-slices + bias +
    residual + LN) and its sum mode (``ln_mlp`` with fc2 cut into 4
    K-slices); the dropout mode is K11's case above."""
    import torch.nn.functional as F

    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.fused_mlp import _mlp_plain

    M = SWINL_TRAIN_BATCH * SWINL_N
    for C in SWINL_ROW_WIDTHS:
        x = _rnd(g, M, C, std=3.0)
        w, b = 1.0 + _rnd(g, C, std=0.1), _rnd(g, C, std=0.1)
        rows = torch.randperm(M, generator=g, device="cuda").to(torch.int32)
        rows[::7] = -1  # pad rows: zeros

        def plain_ln(t, w=None, b=None):
            return F.layer_norm(t.float(), (C,), None if w is None
                                else w.float(), None if b is None
                                else b.float(), 1e-5).to(torch.bfloat16)

        def gathered(t):
            out = plain_ln(t[rows.clamp(min=0).long()], w, b)
            out[rows < 0] = 0
            return out
        ln_bytes = 2 * M * C * 2
        for label, fn, ref in (
                ("scalar LN", lambda: _build.layernorm(x, w, b, 1e-5),
                 lambda: plain_ln(x, w, b)),
                ("scalar LN, pure normalize",
                 lambda: _build.layernorm(x, None, None, 1e-5),
                 lambda: plain_ln(x)),
                ("chunk LN", lambda: _build.layernorm_rows(x, w, b, 1e-5),
                 lambda: plain_ln(x, w, b)),
                ("chunk LN, gathering",
                 lambda: _build.layernorm_rows(x, w, b, 1e-5, rows=rows),
                 lambda: gathered(x))):
            _prim_check(f"{label} M={M} C={C}", fn, ref, ln_bytes, 0.0)
        # the row kernel's LN mode: LN(residual + a @ w.T + bias)
        a = _rnd(g, M, C)
        wp, bp = _rnd(g, C, C, std=C ** -0.5), _rnd(g, C, std=0.02)
        res = _rnd(g, M, C)
        plan = _build.gemm_tc_plan(M, C, C, split=True)
        _prim_check(
            f"row kernel LN mode (gemm_tc_ln, {plan.splits} K-slices) M={M} "
            f"C={C}", lambda: _build.gemm_tc_ln(a, wp, bp, res, w, b, 1e-5),
            lambda: plain_ln(res.float() + F.linear(a.float(), wp.float(),
                                                    bp.float()), w, b),
            (2 * M * C + C * C) * 2 + M * C * 2, 2.0 * M * C * C)
        # the row kernel's sum mode: the LN + MLP with fc2 in 4 K-slices
        HD = 4 * C
        w1, b1 = _rnd(g, HD, C, std=C ** -0.5), _rnd(g, HD, std=0.02)
        w2, b2 = _rnd(g, C, HD, std=HD ** -0.5), _rnd(g, C, std=0.02)
        auto = _build.ln_mlp_plan(M, C, HD, True)
        plan = _build.LnMlpPlan(auto.fc1_bm, 128, 4,
                                _build.library().lvt_ln_mlp_scratch(
                                    M, C, HD, 4))
        xr = _rnd(g, M, C)
        _prim_check(
            f"row kernel sum mode (ln_mlp, fc2 in 4 K-slices) M={M} C={C} "
            f"HD={HD}",
            lambda: _build.ln_mlp(xr, w, b, w1, b1, w2, b2, 1e-5, True,
                                  plan=plan),
            lambda: _mlp_plain(xr, w, b, w1, b1, w2, b2, 1e-5, True),
            2 * M * C * 2 + (2 * C * HD + HD + 3 * C) * 2,
            4.0 * M * C * HD)
        del x, a, res, xr


def _swinl_batch(vocab: int, batch: int = SWINL_TRAIN_BATCH):
    """Phase 5's batch at Swin-L-384's clips: ``batch`` clips of 5 x 384 x
    384, 26 tokens, seeded."""
    return _train_batch(vocab, size=SWINL_SIZE, batch=batch)


def _swinl_per_step(ops, cfg):
    """Launches of one retrieval-MLM train step on the wm route."""
    depth, layers = sum(cfg.swin.depths), cfg.bert.num_hidden_layers
    return {ops["K1"]: depth,
            ops["K2"]: 4 * _shifted_blocks(cfg.swin, SWINL_SIZE),
            ops["K8a"]: depth, ops["K8b"]: depth, ops["K9"]: depth,
            ops["K10a"]: layers, ops["K10b"]: layers, ops["K11"]: layers}


def _top_ops(fn, n: int = 8):
    """(device ms a call summed over its activities, the n largest by
    name) of one call of ``fn`` under torch.profiler."""
    names = _kernel_times(fn, 1)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:n]
    return sum(names.values()), [(k[:60], round(t, 3)) for k, t in top]


def run_swinl(ops):
    """Phase 13: the ``large_384`` preset (Swin-L, window 8 x 12 x 12, at
    384 x 384; BERT-base) at full width and depth, seeded weights.  (a)
    ``LavenderServer`` with the LN-fold serving cache and drawn Swin LN
    affines: 3 requests of B=4 uint8 clips of 5 x 384 x 384 and 26 text
    tokens against the plain path (SLICE_TOL / SLICE_REL_L2), the launches a
    forward from the routing predicates (``_video_counts``), ms a forward
    (host clock), its device time and largest activities under
    torch.profiler, peak memory; (b) the retrieval-MLM step through
    ``create_train_state`` / ``make_train_step`` at B=8 (64 pairs at L =
    751, drop-path 0.2, dropout 0.1): loss and gradient groups kernels vs
    plain (LOSS_TOL / STEP_GRAD_REL_L2) at B = SWINL_COMPARE_BATCH (the
    largest whose plain path fits the card), the launches of one step, ms
    a step, its device time, peak memory; (c) ``cli.main`` retrieval_mlm
    with ``vis_backbone_size: "large", size_img: 384`` on the fixture's
    videos: 2 train steps at B=8 and one eval batch, ``ls_tr`` finite,
    ``ac_vl`` in [0, 1], the train epoch's launches (b)'s x 2, K1-K5 in
    the eval.  Returns the launches of (a), (b) and (c)."""
    from lavender_tpu_torch.config import TrainConfig
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.serve import LavenderServer
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    smi = _nvidia_smi()
    cfg = _swinl_config()
    total = {op: 0 for op in ops.values()}

    # (a) serving
    t0 = time.perf_counter()
    server = _swin_layer_norms(LavenderServer(cfg, seed=0, frames=FRAMES,
                                              size=SWINL_SIZE), 11)
    server.model.build_serving_cache(FRAMES, SWINL_SIZE, SWINL_SIZE)
    torch.cuda.synchronize()
    print(f"[swinl] (a) server built ({SWINL_PRESET}: embed "
          f"{cfg.swin.embed_dim}, depths {cfg.swin.depths}, heads "
          f"{cfg.swin.num_heads}, window {cfg.swin.window_size}; bf16, "
          f"serving caches) in {time.perf_counter() - t0:.1f} s", flush=True)
    requests = _requests(cfg.bert.vocab_size, SWINL_SIZE, seed=5)
    per_fwd = {**_video_counts(ops, cfg, SWINL_SIZE),
               ops["K4"]: cfg.bert.num_hidden_layers,
               ops["K5"]: cfg.bert.num_hidden_layers}
    server(*requests[0])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _reset(ops.values())
    outs = [server(*r) for r in requests]
    counts = _check_counts(ops.values(), per_fwd, N_REQUESTS, "swinl (a)")
    peak = torch.cuda.max_memory_allocated()
    for op in ops.values():
        total[op] += counts[op]
    want_shape = (BATCH, TXT_LEN, cfg.bert.vocab_size)
    for i, (out, req) in enumerate(zip(outs, requests)):
        with plain_path():
            ref = server(*req)
        err, rel, ok = _compare(out, ref, SLICE_TOL, SLICE_REL_L2)
        print(f"[swinl] (a) request {i}: logits {tuple(out.shape)} vs plain "
              f"path max_abs_err {err:.4g} rel_l2 {rel:.3g} (tol {SLICE_TOL}"
              f" max(1,max|ref|), {SLICE_REL_L2}), max|ref| "
              f"{float(ref.float().abs().max()):.3g}", flush=True)
        if tuple(out.shape) != want_shape or not ok:
            raise AssertionError(f"swinl (a) request {i}: the logits are "
                                 "wrong or disagree with the plain path")
    del outs
    ms = _ms(lambda: server(*requests[0]), 10)
    host_ms, busy_ms, n_dev = _device_profile(lambda: server(*requests[0]))
    dev_ms, top = _top_ops(lambda: server(*requests[0]))
    busy = "not measured" if busy_ms is None else f"{busy_ms:.3f} ms"
    print(f"[swinl] (a) {ms:.2f} ms a forward (host clock), "
          f"{BATCH / ms * 1e3:.2f} clips/s at B={BATCH}; under "
          f"torch.profiler device busy {busy} of {host_ms:.2f} host ms in "
          f"{n_dev} device activities, their sum {dev_ms:.3f} ms, the "
          f"largest {top}; peak {peak / 2 ** 30:.2f} GiB ({smi})",
          flush=True)
    del server
    torch.cuda.empty_cache()

    # (b) the train step; kernels vs plain at SWINL_COMPARE_BATCH
    loss_fn = retrieval.make_loss_fn(TRUE_ID, FALSE_ID)
    state = create_train_state(cfg, TrainConfig(max_iter=1000,
                                                max_grad_norm=1.0), seed=0)
    sub = _swinl_batch(cfg.bert.vocab_size, SWINL_COMPARE_BATCH)
    kernels = _loss_and_grads(state, loss_fn, sub, False)
    plain = _loss_and_grads(state, loss_fn, sub, True)
    _check_step(f"(b) B={SWINL_COMPARE_BATCH} kernels vs plain:", kernels,
                plain, _grad_groups(state.model), tag="swinl")
    del kernels, plain, sub
    torch.cuda.empty_cache()
    batch = _swinl_batch(cfg.bert.vocab_size)
    step = make_train_step(loss_fn, state)
    per_step = _swinl_per_step(ops, cfg)
    torch.cuda.reset_peak_memory_stats()
    _reset(ops.values())
    loss = float(step(batch))
    counts = _check_counts(ops.values(), per_step, 1, "swinl (b)")
    peak = torch.cuda.max_memory_allocated()
    for op in ops.values():
        total[op] += counts[op]
    ms = _ms(lambda: step(batch), 3)
    host_ms, busy_ms, n_dev = _device_profile(lambda: step(batch))
    dev_ms, top = _top_ops(lambda: step(batch))
    busy = "not measured" if busy_ms is None else f"{busy_ms:.2f} ms"
    print(f"[swinl] (b) one step: loss {loss:.6f}; {ms:.1f} ms a step (host "
          f"clock), {SWINL_TRAIN_BATCH / ms * 1e3:.2f} train clips/s at "
          f"B={SWINL_TRAIN_BATCH} ({SWINL_TRAIN_BATCH ** 2} pairs at L="
          f"{SWINL_L}); under torch.profiler device busy {busy} of "
          f"{host_ms:.1f} host ms in {n_dev} device activities, their sum "
          f"{dev_ms:.2f} ms, the largest {top}; peak "
          f"{peak / 2 ** 30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}"
          f" ({smi})", flush=True)
    del state, step
    torch.cuda.empty_cache()

    # (c) the CLI at vis_backbone_size "large", size_img 384
    root = os.path.join(REPO_DIR, "build", "cli_swinl")
    shutil.rmtree(root, ignore_errors=True)
    _cli_data(root)
    path = _cli_config(root, "swinl", "clil")
    with open(path) as f:
        raw = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(raw, vis_backbone_size="large", size_img=SWINL_SIZE),
                  f)
    _reset(ops.values())
    log, agent, wall, rec = _cli_run(
        ops.values(), ["--task", "retrieval_mlm", "--config", path,
                       "--path_output", os.path.join(root, "out")])
    for op in ops.values():
        total[op] += op.launches
    ls, ac = log["ls_tr"][0], log["ac_vl"][0]
    stats = dict(agent.epoch_stats)
    swin = agent.cfg.model.swin
    print(f"[swinl] (c) cli.main retrieval_mlm on {swin.embed_dim} x "
          f"{swin.depths} window {swin.window_size} at {SWINL_SIZE} px: "
          f"{stats['steps']} steps of B={TRAIN_BATCH}, ls_tr {ls:.6f}, "
          f"ac_vl {ac:.4f}; {stats['seconds'] / stats['steps'] * 1e3:.1f} ms "
          f"a step (host clock, the first with its warm-up); {wall:.1f} s in "
          f"main ({smi})", flush=True)
    if not (np.isfinite(ls) and 0.0 <= ac <= 1.0
            and stats["steps"] == SWINL_CLI_STEPS
            and (swin.embed_dim, swin.depths, swin.window_size)
            == (cfg.swin.embed_dim, cfg.swin.depths, cfg.swin.window_size)):
        raise AssertionError("swinl (c): the run's outputs are wrong")
    for op in ops.values():
        tr, ev = rec["train_epoch"][op], rec["eval_epoch"][op]
        want = per_step.get(op, 0) * SWINL_CLI_STEPS
        print(f"[swinl] (c) {op.name}: {tr} launches in the train epoch "
              f"(expected {want}), {ev} in the eval", flush=True)
        if tr != want:
            raise AssertionError(f"swinl (c): {op.name} launched {tr} times "
                                 f"in training, expected {want}")
    silent = [k for k in ("K1", "K2", "K3", "K4", "K5")
              if rec["eval_epoch"][ops[k]] == 0]
    if silent:
        raise AssertionError(f"swinl (c): no launch of {silent} in the eval")
    del agent
    torch.cuda.empty_cache()
    return total


def kernel_ops():
    """Each ported kernel's wrapper by its id (K1 .. K17)."""
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

    return {"K1": fused_swin_block_wm, "K2": wm_shift_rows,
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA GPU")
    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of --dp
        return _dp_worker(*map(int, sys.argv[2:5]))
    if sys.argv[1:2] == ["--tp-worker"]:  # one rank of --tp
        return _tp_worker(*map(int, sys.argv[2:5]),
                          swinl_only=sys.argv[5:6] == ["SWINL"])
    from lavender_tpu_torch.ops import _build

    print(_nvidia_smi(), flush=True)  # the card's name and power limit
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {_build.library_path().name}: "
          f"{time.perf_counter() - t0:.1f} s ("
          f"{'found in build/' if prebuilt else 'nvcc'})", flush=True)

    ops = kernel_ops()
    if sys.argv[1:2] == ["--only"]:  # phase 3 for these kernels alone
        only = set(sys.argv[2:]) - {"--cases"}  # K14a / K14f: "K14" cases
        check_kernels(only | {ops[k].name.split()[0] for k in only
                              if k in ops}, "--cases" not in sys.argv)
        if "SWINL" in only:  # and phase 13
            torch.cuda.empty_cache()
            run_swinl(ops)
        print(_nvidia_smi(), flush=True)
        return 0
    if sys.argv[1:2] == ["--cli"]:  # phase 12 alone
        run_cli(ops)
        print(_nvidia_smi(), flush=True)
        return 0
    if sys.argv[1:2] == ["--dp"]:  # the data-parallel path on 4 GPUs
        return run_dp()
    if sys.argv[1:2] == ["--tp"]:  # tensor parallelism on 4 GPUs
        return run_tp(sys.argv[2:3] == ["SWINL"])
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
    torch.cuda.empty_cache()
    swinbert_counts = run_swinbert(ops)
    torch.cuda.empty_cache()
    data_counts = run_data(ops)
    torch.cuda.empty_cache()
    cli_counts = run_cli(ops)
    torch.cuda.empty_cache()
    swinl_counts = run_swinl(ops)

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
        "K8a": ("lavender_tpu_torch/csrc/attention_fwd_wgmma.cu",
                "lavender_tpu/ops/swin_core_attn.py:112"),
        "K8b": ("lavender_tpu_torch/csrc/attention_bwd_wgmma.cu",
                "lavender_tpu/ops/swin_core_attn.py:147"),
        "K9": ("lavender_tpu_torch/csrc/blocks.cu",
               "lavender_tpu/ops/fused_mlp.py:91"),
        "K10a": ("lavender_tpu_torch/csrc/attention_fwd_tc.cu",
                 "lavender_tpu/ops/encoder_attention.py:750"),
        "K10b": ("lavender_tpu_torch/csrc/attention_bwd_wgmma.cu",
                 "lavender_tpu/ops/encoder_attention.py:780"),
        "K11": ("lavender_tpu_torch/csrc/gemm_tc.cu",
                "lavender_tpu/ops/fused_mlp.py:505"),
        "K12": ("lavender_tpu_torch/csrc/ffn_post_ln.cu",
                "lavender_tpu/ops/fused_mlp.py:379"),
        "K13a": ("lavender_tpu_torch/csrc/attention_fwd_tc.cu",
                 "lavender_tpu/ops/encoder_attention.py:526"),
        "K13b": ("lavender_tpu_torch/csrc/attention_bwd_wgmma.cu",
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
                         + route_counts[op] + task_counts[op]
                         + swinbert_counts[op] + data_counts[op]
                         + cli_counts[op] + swinl_counts[op]),
            "launches_serving": serve_counts[op],
            "launches_train_step": train_counts[op],
            "launches_captioning": caption_counts[op],
            "launches_spatial": spatial_counts[op],
            "launches_routes": route_counts[op],
            "launches_tasks": task_counts[op],
            "launches_swinbert": swinbert_counts[op],
            "launches_data": data_counts[op],
            "launches_cli": cli_counts[op],
            "launches_swinl": swinl_counts[op],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": ("bytes" if k["t_bytes"] >= k["t_flops"]
                         else "operations"),
            "library_ms": k["library_ms"],
            **{key: k[key] for key in ("swinl_ms", "swinl_plain_ms",
                                       "swinl_bound_ms",
                                       "swinl_library_ms")}})
    print(_nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
