"""Device time of the Swin window core (K8a ``swin_core_attn``, K8b
``swin_core_attn_bwd``) at the train step's shapes, against one
scaled_dot_product_attention call and its bound, on one CUDA GPU.

    python -m lavender_tpu_torch.swin_core_sweep [--swin base|large|all]

Times whichever package ``lavender_tpu_torch`` resolves to: with an older
tree first on PYTHONPATH, run this file by path (``PYTHONPATH=OLD python
/path/to/swin_core_sweep.py``) to time that tree's kernels on the same card
(the wrappers take the same arguments), and run the two in turns.  Shapes:
B = 8 clips of Swin-B (window 5 x 7 x 7: Npad = 248 with N = 245 real rows,
stages 1-4, shifted and unshifted, and the spatial route's unpadded N = 245
at stage 1) and of Swin-L-384 (N = Npad = 720, stages 1-4), hd 32, the
rel-pos bias and the shift mask in bf16 as the model passes them.  Prints
the card's name and power limit, then per shape: the largest error of the
output (K8a), of dq, dk, dv and dbias (K8b) against the plain version
(gates 2e-2 x max(1, max|ref|), rel_l2 1e-2 and 5e-2) and whether a second
call gives the same bits; ms a call (the median of 5 CUDA-event windows of
5 calls) of K8a and K8b, of SDPA's forward (the bias and mask as one
additive mask) and of its backward (a bias that requires grad), the bound
of each (its bytes at 3.35 TB/s against its products at 989 TFLOP/s); and,
under torch.profiler, each one's device activities by name, ms a call,
and their sum (the device time: a short call's event time is the host's).
Ends with the sums of both over one B=8 train step's calls (24 a model)
and one JSON line of the cases.  Exits 1 where a case fails its gates; needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from lavender_tpu_torch.models.swin3d import (
    compute_shift_mask, relative_position_index)
from lavender_tpu_torch.ops import _build
from lavender_tpu_torch.ops.swin_block_attn import (
    pad_window_mask, rel_pos_bias_wm)
from lavender_tpu_torch.ops.swin_core_attn import (
    swin_core_attn, swin_core_attn_bwd)

B, HD = 8, 32  # the train step's clips; every Swin stage's head dim
TOL, REL_L2, GRAD_REL_L2 = 2e-2, 1e-2, 5e-2
HBM, BF16 = 3.35e12, 989e12  # the H100 SXM's memory and bf16 rates
# (model, stage, windows a clip, C, heads, map side, block pairs, window,
# shift, N, Npad); each pair is a shifted and an unshifted block, stage 4
# (one window covering the map) two unshifted ones
SWIN_B = [("Swin-B", s, nW, C, nH, side, pairs, (5, 7, 7), (0, 3, 3), 245,
           248) for s, nW, C, nH, side, pairs in (
               (1, 64, 128, 4, 56, 1), (2, 16, 256, 8, 28, 1),
               (3, 4, 512, 16, 14, 9), (4, 1, 1024, 32, 7, 1))]
SWIN_L = [("Swin-L", s, nW, C, nH, side, pairs, (5, 12, 12), (0, 6, 6), 720,
           720) for s, nW, C, nH, side, pairs in (
               (1, 64, 192, 6, 96, 1), (2, 16, 384, 12, 48, 1),
               (3, 4, 768, 24, 24, 9), (4, 1, 1536, 48, 12, 1))]


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


def _by_name(fn, n: int = 3) -> dict:
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


def _compare(got, want, rel_l2):
    a, b = got.float(), want.float()
    err = float((a - b).abs().max())
    rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
    ok = (err <= TOL * max(1.0, float(b.abs().max())) and rel <= rel_l2
          and bool(torch.isfinite(a).all()))
    return err, rel, ok


def _shapes(which: str):
    rows = []
    for model, stage, nW, C, nH, side, pairs, win, shift, N, Npad in (
            (SWIN_B if which in ("base", "all") else [])
            + (SWIN_L if which in ("large", "all") else [])):
        if stage < 4:
            rows.append((model, stage, nW, C, nH, side, pairs, win, shift, N,
                         Npad, True))
        rows.append((model, stage, nW, C, nH, side,
                     pairs if stage < 4 else 2 * pairs, win, shift, N, Npad,
                     False))
        if model == "Swin-B" and stage == 1:  # the spatial route's N = 245
            rows.append((model, stage, nW, C, nH, side, 0, win, shift, N, N,
                         True))
    return rows


def _case(g, model, stage, nW, C, nH, side, win, shift, N, Npad, shifted):
    """The inputs of one shape and its calls: (K8a, plain K8a, SDPA
    forward, K8b, plain K8b, SDPA backward), the K8a and K8b bytes and
    products."""
    nS, scale = B * nW, HD ** -0.5
    wd, wh, ww = win
    table = torch.randn(15 * (2 * wh - 1) * (2 * ww - 1), nH, generator=g,
                        device="cuda")
    bias = rel_pos_bias_wm(table, relative_position_index((8, wh, ww)), N,
                           Npad, torch.bfloat16)
    mask = None
    if shifted:
        mask = torch.as_tensor(compute_shift_mask(wd, side, side, win, shift),
                               device="cuda")
        mask = pad_window_mask(mask, Npad).to(torch.bfloat16)
    qkv = (torch.randn(B, nW, Npad, 3 * C, generator=g, device="cuda")
           .to(torch.bfloat16))
    dout = (torch.randn(B, nW, Npad, C, generator=g, device="cuda")
            .to(torch.bfloat16))
    dout[:, :, N:] = 0.0  # the recompute's pad rows: identity
    lse = torch.empty(nS, nH, Npad, device="cuda")
    out = _build.attention(qkv.view(-1, 3 * C), nS, Npad, nH, scale,
                           bias=bias, mask=mask, lse=lse).view(dout.shape)
    heads = qkv.view(nS, Npad, 3, nH, HD).permute(2, 0, 3, 1, 4)
    d_heads = dout.view(nS, Npad, nH, HD).transpose(1, 2)
    made = {}  # SDPA's mask and graph, made at their first call (GBs at
    #            Swin-L's stage 1), after the plain versions have run

    def full_mask(b):
        full = b[None].expand(nS, -1, -1, -1)
        if mask is not None:
            full = (full.reshape(B, nW, nH, Npad, Npad)
                    + mask[None, :, None]).reshape(nS, nH, Npad, Npad)
        return full

    def sdpa_fwd():
        if "full" not in made:
            made["full"] = full_mask(bias).contiguous()
        return F.scaled_dot_product_attention(*heads, attn_mask=made["full"],
                                              scale=scale)

    def sdpa_bwd():
        if "o" not in made:
            leaves = [t.detach().requires_grad_(True) for t in (*heads, bias)]
            made["leaves"] = leaves
            made["o"] = F.scaled_dot_product_attention(
                *leaves[:3], attn_mask=full_mask(leaves[3]), scale=scale)
        return torch.autograd.grad(made["o"], made["leaves"], d_heads,
                                   retain_graph=True)

    fwd_args = (qkv, bias, mask, nH, scale)
    bwd_args = (qkv, lse, dout, bias, mask, nH, scale)
    M = nS * Npad
    qkv_bytes, mask_bytes = qkv.numel() * 2, 0 if mask is None else (
        mask.numel() * 2)
    flops = 4.0 * nS * nH * Npad * Npad * HD
    fwd_bytes = qkv_bytes * 4 // 3 + bias.numel() * 2 + mask_bytes + M * nH * 4
    bwd_bytes = (2 * qkv_bytes + M * C * 2 + M * nH * 4 + bias.numel() * 6
                 + mask_bytes)
    return ((lambda: swin_core_attn(*fwd_args)),
            (lambda: swin_core_attn.plain(*fwd_args)), sdpa_fwd,
            (lambda: swin_core_attn_bwd(*bwd_args, out=out)),
            (lambda: swin_core_attn_bwd.plain(*bwd_args, out=out)), sdpa_bwd,
            fwd_bytes, flops, bwd_bytes, 2.5 * flops)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--swin", choices=("base", "large", "all"), default="all")
    ap.add_argument("--tag", default="", help="a label for the JSON line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("swin_core_sweep: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.library()
    print(f"[build] {_build.library_path()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    cases, sums, ok_all = [], {}, True
    for (model, stage, nW, C, nH, side, count, win, shift, N, Npad,
         shifted) in _shapes(args.swin):
        name = (f"{model} B={B} stage {stage} nH={nH} N={N} Npad={Npad} "
                f"{'shifted' if shifted else 'unshifted'}")
        (k8a, k8a_plain, sdpa_f, k8b, k8b_plain, sdpa_b, fb, ff, bb,
         bf) = _case(g, model, stage, nW, C, nH, side, win, shift, N, Npad,
                     shifted)
        rows = slice(0, N)
        got, again, want = k8a(), k8a(), k8a_plain()
        fa = _compare(got[:, :, rows], want[:, :, rows], REL_L2)
        same_a = torch.equal(got, again)
        del got, again, want
        (dq, db), (dq2, db2), (dq_p, db_p) = k8b(), k8b(), k8b_plain()
        errs = [_compare(dq[:, :, rows, i * C:(i + 1) * C],
                         dq_p[:, :, rows, i * C:(i + 1) * C], GRAD_REL_L2)
                for i in range(3)]
        errs.append(_compare(db[:N, :N], db_p[:N, :N], GRAD_REL_L2))
        same_b = torch.equal(dq, dq2) and torch.equal(db, db2)
        del dq, db, dq2, db2, dq_p, db_p
        torch.cuda.synchronize()
        ok = fa[2] and same_a and same_b and all(e[2] for e in errs)
        ok_all &= ok
        t = {"k8a": _time_ms(k8a), "sdpa_fwd": _time_ms(sdpa_f),
             "k8b": _time_ms(k8b), "sdpa_bwd": _time_ms(sdpa_b)}
        bound_a = max(fb / HBM, ff / BF16) * 1e3
        bound_b = max(bb / HBM, bf / BF16) * 1e3
        detail = ", ".join(f"{n} {e:.3g}/{r:.3g}" for n, (e, r, _) in zip(
            ("dq", "dk", "dv", "dbias"), errs))
        print(f"[case] {name} (x{count} a step): K8a max_abs/rel_l2 "
              f"{fa[0]:.3g}/{fa[1]:.3g}, K8b {detail}; second calls "
              f"{'bitwise equal' if same_a and same_b else 'DIFFER'}; "
              f"{'ok' if ok else 'FAILED'}; K8a {t['k8a']:.4f} ms (SDPA "
              f"{t['sdpa_fwd']:.4f}, bound {bound_a:.4f}), K8b "
              f"{t['k8b']:.4f} ms (SDPA's backward {t['sdpa_bwd']:.4f}, "
              f"bound {bound_b:.4f}) ({smi})", flush=True)
        for who, key, fn in (("K8a", "k8a", k8a), ("K8b", "k8b", k8b),
                             ("SDPA", "sdpa_fwd", sdpa_f),
                             ("SDPA's backward", "sdpa_bwd", sdpa_b)):
            acts = _by_name(fn)
            t["dev_" + key] = sum(acts.values())
            print(f"[trace] {name}: {who} " + "; ".join(
                f"{n[:90]} {v:.4f}" for n, v in sorted(
                    acts.items(), key=lambda kv: -kv[1])), flush=True)
        s = sums.setdefault(model, {})
        for k, v in (*t.items(), ("bound_k8a", bound_a),
                     ("bound_k8b", bound_b)):
            s[k] = s.get(k, 0.0) + count * v
        cases.append({"name": name, "count": count, **t,
                      "bound_k8a": bound_a, "bound_k8b": bound_b, "ok": ok,
                      "max_abs_err": max(fa[0], *(e[0] for e in errs))})
        del k8a, k8a_plain, sdpa_f, k8b, k8b_plain, sdpa_b
        torch.cuda.empty_cache()
    for model, s in sums.items():
        print(f"[sum] {model}, one B={B} train step's 24 calls, event / "
              f"device ms: K8a {s['k8a']:.3f} / {s['dev_k8a']:.3f} (SDPA "
              f"{s['sdpa_fwd']:.3f} / {s['dev_sdpa_fwd']:.3f}, bound "
              f"{s['bound_k8a']:.3f}), K8b {s['k8b']:.3f} / "
              f"{s['dev_k8b']:.3f} (SDPA's backward {s['sdpa_bwd']:.3f} / "
              f"{s['dev_sdpa_bwd']:.3f}, bound {s['bound_k8b']:.3f}) "
              f"({smi})", flush=True)
    print(json.dumps({"tag": args.tag, "device": smi, "sums": sums,
                      "cases": cases}))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
