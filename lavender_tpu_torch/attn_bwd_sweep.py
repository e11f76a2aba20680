"""Device time of the fusion encoder's attention backward (K10b
``encoder_attention_train_lanes_bwd``, K13b ``encoder_attention_train_bwd``)
at the model's shapes, against its plain version and against the backward
of one scaled_dot_product_attention call, on one CUDA GPU.

    python -m lavender_tpu_torch.attn_bwd_sweep

Times whichever package ``lavender_tpu_torch`` resolves to: with an older
tree first on PYTHONPATH, run this file by path (``python
/path/to/attn_bwd_sweep.py``) to time that tree's kernels on the same card
(the wrappers take the same arguments).  Prints the card's name and power
limit, the SASS of the wgmma kernel's instances where the library has
them (its HGMMA products and UTMALDG tensor loads, and no HMMA), then per
shape: the largest error and rel_l2 of dq, dk, dv against the plain
version (gates 2e-2 x max(1, max|ref|) and 5e-2) and whether a second call
gives the same bits; ms a call (the median of 5 CUDA-event windows of 5
calls) of the kernel and of SDPA's backward on the same heads (its
forward with the same float mask and dropout, replayed); and, under
torch.profiler, each one's device activities by name, ms a call.  Ends
with one JSON line of the cases.  Exits 1 where a case fails its gates;
needs a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from lavender_tpu_torch.ops import _build
from lavender_tpu_torch.ops.encoder_attention import (
    encoder_attention_train_bwd, encoder_attention_train_lanes_bwd)

PAIRS, NH, HD, TXT = 64, 12, 64, 26  # the B=8 train step's fusion encoder
TOL, GRAD_REL_L2 = 2e-2, 5e-2


def _time_ms(fn, iters: int = 5, windows: int = 5) -> float:
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
    return statistics.median(s.elapsed_time(e) / iters for s, e in marks)


def _by_name(fn, n: int = 5) -> dict:
    """ms a call of each device activity of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
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


def _masks(g, L: int) -> dict:
    """{kind: f32 [PAIRS, L, L] additive mask at -1e4}: padded captions,
    the caption step's seq2seq mask, SwinBERT's inner keys (0, 50, .. of
    the video part masked) over padded captions."""
    n_vid = L - TXT
    n_txt = torch.randint(5, TXT + 1, (PAIRS,), generator=g, device="cuda")
    n_txt[0] = TXT
    pad = torch.arange(L, device="cuda")[None] >= n_vid + n_txt[:, None]
    padded = torch.where(pad, -1e4, 0.0)[:, None, :].expand(PAIRS, L, L)
    keep = torch.zeros(L, L, dtype=torch.bool, device="cuda")
    keep[:, :n_vid] = True
    keep[n_vid:, n_vid:] = torch.ones(L - n_vid, L - n_vid, dtype=torch.bool,
                                      device="cuda").tril()
    inner = padded.clone()
    inner[:, :, 0:n_vid:50] = -1e4
    return {"padded keys": padded.contiguous(),
            "seq2seq": torch.where(keep, 0.0, -1e4).expand(
                PAIRS, L, L).contiguous(),
            "inner keys": inner}


def _case(g, kid: str, L: int, kind: str, rate: float, nH: int = NH,
          head0: int = 0):
    """(kernel call, plain call, SDPA backward call) of one shape."""
    C, scale = nH * HD, HD ** -0.5
    heads = {"head0": head0, "heads_total": NH if head0 else 0}
    slab = (torch.randn(PAIRS, L, 3 * C, generator=g, device="cuda")
            .to(torch.bfloat16))
    mask = _masks(g, L)[kind]
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda")
    lse = torch.empty(PAIRS, nH, L, device="cuda")
    qh, kh, vh = slab.view(PAIRS, L, 3, nH, HD).permute(2, 0, 3, 1, 4)
    if kid == "K10b":
        m = mask.to(torch.bfloat16)
        q, k, v = slab.split(C, dim=-1)
        o = _build.attention(slab.view(-1, 3 * C), PAIRS, L, nH, scale,
                             mask=m, lse=lse, seed=seed, rate=rate,
                             **heads).view(PAIRS, L, C)
        dout = (torch.randn(PAIRS, L, C, generator=g, device="cuda")
                .to(torch.bfloat16))
        op, args = encoder_attention_train_lanes_bwd, (
            q, k, v, m, seed, dout, scale, rate, nH)
        d_heads = dout.view(PAIRS, L, nH, HD).transpose(1, 2)
        sdpa_mask = m[:, None]
    else:
        o = _build.attention_heads(qh, kh, vh, mask, scale, lse=lse,
                                   seed=seed, rate=rate, **heads)
        dout = (torch.randn(PAIRS, nH, L, HD, generator=g, device="cuda")
                .to(torch.bfloat16))
        op, args = encoder_attention_train_bwd, (
            qh, kh, vh, mask, seed, dout, scale, rate)
        d_heads = dout
        sdpa_mask = mask[:, None].to(torch.bfloat16)
    kw = {"lse": lse, "o": o, **heads}
    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask,
                                         dropout_p=rate, scale=scale)
    return (lambda: op(*args, **kw)[:3], lambda: op.plain(*args, **kw)[:3],
            lambda: torch.autograd.grad(out, leaves, d_heads,
                                        retain_graph=True))


def _compare(got, want):
    errs = []
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        err = float((a - b).abs().max())
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        errs.append((err, rel, err <= TOL * max(1.0, float(b.abs().max()))
                     and rel <= GRAD_REL_L2 and bool(torch.isfinite(a).all())))
    return errs


def _sass() -> None:
    """The wgmma kernel's instances in the library's SASS: HGMMA (its
    products), UTMALDG (its tensor loads) and HMMA (mma.sync) counts."""
    from lavender_tpu_torch.sass_diff import functions

    fns = {k: v for k, v in functions(str(_build.library_path())).items()
           if "bwd_wg_kernel" in k}
    if not fns:
        print("[sass] no bwd_wg_kernel in this library", flush=True)
    for name, lines in sorted(fns.items()):
        count = {op: sum(op in ln.split() or any(w.startswith(op + ".")
                                                 for w in ln.split())
                         for ln in lines)
                 for op in ("HGMMA", "UTMALDG", "HMMA")}
        print(f"[sass] {name}: {count}", flush=True)


SHAPES = (  # (kernel, L, mask, rate, heads, head0)
    ("K10b", 276, "padded keys", 0.1, NH, 0),
    ("K10b", 275, "seq2seq", 0.1, NH, 0),
    ("K10b", 276, "inner keys", 0.1, NH, 0),
    ("K10b", 276, "padded keys", 0.1, 3, 9),
    ("K13b", 276, "padded keys", 0.1, NH, 0),
    ("K13b", 275, "seq2seq", 0.1, NH, 0),
    ("K10b", 751, "padded keys", 0.1, NH, 0),
)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("attn_bwd_sweep: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.library()
    print(f"[build] {_build.library_path()}", flush=True)
    _sass()
    g = torch.Generator(device="cuda").manual_seed(0)
    cases, ok_all = [], True
    for kid, L, kind, rate, nH, head0 in SHAPES:
        name = (f"{kid} B={PAIRS} L={L} nH={nH}"
                f"{f' (heads {head0}.. of {NH})' if head0 else ''} rate "
                f"{rate}, {kind}")
        kernel, plain, sdpa = _case(g, kid, L, kind, rate, nH, head0)
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        errs = _compare(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = same and all(e[2] for e in errs)
        ok_all &= ok
        del got, again, want
        ms, sdpa_ms = _time_ms(kernel), _time_ms(sdpa)
        detail = ", ".join(f"{n} {e:.3g}/{r:.3g}" for n, (e, r, _) in
                           zip(("dq", "dk", "dv"), errs))
        print(f"[case] {name}: max_abs/rel_l2 {detail}; a second call "
              f"{'bitwise equal' if same else 'DIFFERS'}; "
              f"{'ok' if ok else 'FAILED'}; {ms:.4f} ms, SDPA's backward "
              f"{sdpa_ms:.4f} ms ({smi})", flush=True)
        for who, fn in (("kernel", kernel), ("SDPA", sdpa)):
            acts = _by_name(fn)
            print(f"[trace] {name}: {who} " + "; ".join(
                f"{n[:90]} {t:.4f}" for n, t in sorted(
                    acts.items(), key=lambda kv: -kv[1])), flush=True)
        cases.append({"name": name, "ms": ms, "sdpa_ms": sdpa_ms, "ok": ok,
                      "bitwise": same,
                      "max_abs_err": max(e for e, _, _ in errs)})
        del kernel, plain, sdpa
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "cases": cases}))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
