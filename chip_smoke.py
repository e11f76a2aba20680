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
4. serving slice: Swin-B + BERT-base with seeded random weights answers 3
   requests of 4 uint8 clips; checks the logits' shape and finiteness,
   that each kernel was launched the expected number of times, and the
   kernel path's logits against the plain path's (the same server inside
   ``plain_path()``); prints clips/s;
5. train slice: ``create_train_state`` + ``make_train_step`` on Swin-B +
   BERT-base (``fused_attn_train=False``), B=8 clips and 26 tokens:
   (a) one step's loss and gradients through the kernels against the
   plain path under the same dropout and drop-path masks; (b) the launch
   counts of one step; (c) ten steps on one batch at a constant LR of 1e-4
   on both paths, each loss finite and the loss down by at least 1 nat;
   (d) step time, train clips/s and peak memory of both paths.

The last lines: the card's name and power limit, then a JSON line of the
kernels (per kernel: launches in the phase-4 and phase-5 runs; its
largest error in phase 3; ``ms``, ``plain_ms``, ``library_ms`` and
``bound_ms``, each the time per call x its calls in one serving forward
plus one train step, summed over the shapes; ``bound_ms`` is the larger
of the bytes over 3.35 TB/s and the FLOPs over 989 TFLOP/s), then the
device line.
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
# K8b's gradients sum N = 248 bf16-rounded products per entry (dbias over
# up to 512 sequences more), and both sides round P and dS to bf16 at
# other points: relative L2 per gradient
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
    forward plus one train step; ``flops`` and ``bytes`` of one call."""
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


def _kernel_cases(g):
    """Every distinct shape the serving forward (B=4) and the train step
    (B=8) give the kernels."""
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
                    compare=_core_compare(C)))
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
    time / FLOP time} summed over one serving forward + one train step."""
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
              f", x{c.count} per forward + step", flush=True)
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


def run_serving(ops):
    """Phase 4: the serving forward through the kernels, with counts."""
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.ops.swin_block_attn import mlp_in_block
    from lavender_tpu_torch.serve import LavenderServer

    t0 = time.perf_counter()
    # the default model: Swin-B + BERT-base, full depth and width
    server = LavenderServer(seed=0, frames=FRAMES, size=SIZE)
    cfg = server.config
    torch.cuda.synchronize()
    print(f"[serve] server built (seeded init, bf16, serving caches) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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

    s = cfg.swin
    per_fwd = {ops["K1"]: sum(s.depths),
               ops["K2"]: 2 * _shifted_blocks(s),
               ops["K3"]: sum(d for i, d in enumerate(s.depths)
                              if not mlp_in_block(s.embed_dim * 2 ** i,
                                                  int(s.embed_dim * 2 ** i
                                                      * s.mlp_ratio),
                                                  s.num_heads[i], 248)),
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
    return counts


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


def run_train(ops):
    """Phase 5: the retrieval-MLM train step through the kernels."""
    from lavender_tpu_torch.config import BertConfig, ModelConfig, TrainConfig
    from lavender_tpu_torch.ops._build import plain_path
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    cfg = ModelConfig(bert=BertConfig(fused_attn_train=False))
    loss_fn = retrieval.make_loss_fn(TRUE_ID, FALSE_ID)
    batch = _train_batch(cfg.bert.vocab_size)
    t0 = time.perf_counter()
    state = create_train_state(cfg, TrainConfig(max_iter=1000,
                                                max_grad_norm=1.0), seed=0)
    step = make_train_step(loss_fn, state)
    torch.cuda.synchronize()
    print(f"[train] state built (Swin-B + BERT-base, f32 weights, AdamW) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (a) one step's loss and gradients, kernels vs plain, same masks
    def loss_and_grads(plain: bool):
        state.model.zero_grad(set_to_none=True)
        gen = torch.Generator("cuda").manual_seed(1234)
        with (plain_path() if plain else contextlib.nullcontext()), \
                torch.autocast("cuda", dtype=torch.bfloat16):
            loss = loss_fn(state.model, batch, gen)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone()
                             for n, p in state.model.named_parameters()
                             if p.grad is not None}

    loss_k, grads_k = loss_and_grads(False)
    loss_p, grads_p = loss_and_grads(True)
    dl = abs(loss_k - loss_p)
    print(f"[train] (a) loss kernels {loss_k:.6f} vs plain {loss_p:.6f}: "
          f"|diff| {dl:.4g} (<= {LOSS_TOL} max(1, |loss|))", flush=True)
    ok = np.isfinite(loss_k) and dl <= LOSS_TOL * max(1.0, abs(loss_p))
    if grads_k.keys() != grads_p.keys():
        raise AssertionError("the two paths give gradients to other params")
    for group, names in _grad_groups(state.model).items():
        k = torch.cat([grads_k[n].flatten() for n in names if n in grads_k])
        p = torch.cat([grads_p[n].flatten() for n in names if n in grads_p])
        rel = float((k - p).norm() / p.norm().clamp_min(1e-30))
        finite = bool(torch.isfinite(k).all())
        print(f"[train] (a) gradients {group} ({len(names)} tensors, "
              f"{k.numel()} values): rel_l2 {rel:.4g} (<= "
              f"{STEP_GRAD_REL_L2}), finite {finite}", flush=True)
        ok = ok and finite and rel <= STEP_GRAD_REL_L2
    del grads_k, grads_p
    state.model.zero_grad(set_to_none=True)
    if not ok:
        raise AssertionError("train step: kernel path disagrees with the "
                             "plain path")

    # (b) one step through the entry point, with launch counts
    n_shift = _shifted_blocks(cfg.swin)
    depth = sum(cfg.swin.depths)
    per_step = {ops["K1"]: depth, ops["K2"]: 4 * n_shift,
                ops["K8a"]: depth, ops["K8b"]: depth, ops["K9"]: depth}
    _reset(ops.values())
    loss = step(batch)
    counts = _check_counts(ops.values(), per_step, 1, "train")
    print(f"[train] (b) one step: loss {float(loss):.6f}", flush=True)
    del state, step
    torch.cuda.empty_cache()

    # (c) ten steps on one batch at a constant LR on both paths, then (d)
    # their step times in turns (plain, kernels, kernels, plain)
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
    times = {"kernels": [], "plain": []}
    torch.cuda.reset_peak_memory_stats()
    for label in ("plain", "kernels", "kernels", "plain"):
        stp, ctx = runs[label]
        with ctx():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                stp(batch)
            torch.cuda.synchronize()
        times[label].append((time.perf_counter() - t0) / 2)
    for label, ts in times.items():
        dt = sum(ts) / len(ts)
        print(f"[train] (d) {label} path: {dt * 1e3:.2f} ms per step "
              f"({', '.join(f'{t * 1e3:.2f}' for t in ts)}), "
              f"{TRAIN_BATCH / dt:.2f} train clips/s at B={TRAIN_BATCH} "
              f"({TRAIN_BATCH ** 2} pairs) ({_nvidia_smi()})", flush=True)
    print(f"[train] (d) peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB (both "
          f"states resident)", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA GPU")
    from lavender_tpu_torch.ops import _build
    from lavender_tpu_torch.ops.encoder_attention import (
        fused_bert_attn_block_kmask)
    from lavender_tpu_torch.ops.fused_mlp import (
        fused_ffn_post_ln, fused_ln_mlp, fused_ln_mlp_chunked)
    from lavender_tpu_torch.ops.swin_block_attn import fused_swin_block_wm
    from lavender_tpu_torch.ops.swin_core_attn import (
        swin_core_attn, swin_core_attn_bwd)
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
           "K5": fused_ffn_post_ln, "K8a": swin_core_attn,
           "K8b": swin_core_attn_bwd, "K9": fused_ln_mlp}
    per_kernel = check_kernels()
    torch.cuda.empty_cache()
    serve_counts = run_serving(ops)
    torch.cuda.empty_cache()
    train_counts = run_train(ops)

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
        "K8a": ("lavender_tpu_torch/csrc/attention.cu",
                "lavender_tpu/ops/swin_core_attn.py:112"),
        "K8b": ("lavender_tpu_torch/csrc/attention_bwd.cu",
                "lavender_tpu/ops/swin_core_attn.py:147"),
        "K9": ("lavender_tpu_torch/csrc/gemm.cu",
               "lavender_tpu/ops/fused_mlp.py:91"),
    }
    kernels = []
    for key, op in ops.items():
        src, replaces = meta[key]
        k = per_kernel[op]
        kernels.append({
            "name": op.name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": serve_counts[op] + train_counts[op],
            "launches_serving": serve_counts[op],
            "launches_train_step": train_counts[op],
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
