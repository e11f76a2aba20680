"""Where the serving forward's (or the train step's) time goes, on one
CUDA GPU.

    python -m lavender_tpu_torch.profile_serving [--batch 4 8 16 32]
        [--iters 5] [--top 15] [--train [--remat] [--ffn-train] |
        --seq2seq] [--impl auto|wm|fused|pallas]

Builds the default server (Swin-B + BERT-base, seeded random weights,
bf16, clips of 5 x 224 x 224, 26 text tokens) and prints, after the
card's name and power limit as nvidia-smi reports them:

1. per batch size: ms per forward and clips/s on the host clock (``iters``
   forwards ending in ``torch.cuda.synchronize()``), and the peak
   allocated device memory;
2. at the first batch size: a ``torch.profiler`` trace of ``iters``
   forwards (device activity only), read as device time per forward by
   kernel (launches, ms, share of the device time), and the device's busy
   share two ways: the union of its kernel, memcpy and memset intervals
   over their span in the trace (the profiler's own host cost widens the
   gaps), and the device time per forward over the unprofiled host-clock
   time per forward of step 1.

With ``--seq2seq`` the same for the captioning forward instead: the
server under ``attn_mask_type="seq2seq"`` on 25 text tokens (L = 275),
the forward that runs the full-mask sub-block K6 in every layer.  With
``--train`` the same for the retrieval-MLM train step instead
(``train.trainer`` on the default ``ModelConfig()``: f32 weights, bf16
autocast, AdamW, B x B pairs, the fusion encoder on its default train
route through K10 and K11, seeded dropout), per step and train clips/s;
``--remat`` checkpoints the Swin stages (``SwinConfig.remat``: the wm
route falls back to the spatial "fused" blocks, K14's attention half),
``--ffn-train`` takes the fusion encoder's FFN through K12
(``BertConfig.fused_ffn_train``).  ``--impl`` sets the Swin stages'
``attn_impl`` of the serving forward ("fused": K14, "pallas": K15).

Needs a CUDA device; raises without one.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

from lavender_tpu_torch.serve import LavenderServer

FRAMES, SIZE, TXT_LEN = 5, 224, 26
CAP_LEN = 25  # the caption forward's text tokens
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _requests(batch: int, vocab: int, seed: int = 0,
              txt_len: int = TXT_LEN):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (batch, FRAMES, SIZE, SIZE, 3)).astype(np.uint8)
    lens = rs.randint(5, txt_len + 1, batch)
    mask = (np.arange(txt_len)[None] < lens[:, None]).astype(np.int64)
    txt = rs.randint(1, vocab, (batch, txt_len)) * mask
    return img, txt, mask


def serving_runner(server, batch: int, seq2seq: bool = False):
    """(forward closure, unit) for ``batch`` clips on ``server``: the
    full-mask forward on TXT_LEN text tokens or, with ``seq2seq``, the
    captioning forward on CAP_LEN (``attn_mask_type="seq2seq"``)."""
    vocab = server.config.bert.vocab_size
    if seq2seq:
        req = _requests(batch, vocab, txt_len=CAP_LEN)
        return (lambda: server(*req, attn_mask_type="seq2seq"),
                "seq2seq forward")
    req = _requests(batch, vocab)
    return lambda: server(*req), "forward"


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name[:90]


def device_events(trace_path: str):
    """(name, start us, duration us) of every device-side event."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
            for e in events if e.get("cat") in DEVICE_CATS]


def busy_share(events) -> float:
    """Union of the events' intervals over their span."""
    spans = sorted((t, t + d) for _, t, d in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / (spans[-1][1] - spans[0][0])


def profile(run, iters: int, top: int, host_ms: float, unit: str):
    """Trace ``iters`` calls of ``run`` and print the device time per call
    by kernel and the device's busy share."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        events = device_events(path)
    if not events:
        raise RuntimeError("the trace holds no device events")
    per = collections.defaultdict(lambda: [0, 0.0])
    for name, _, dur in events:
        per[name][0] += 1
        per[name][1] += dur
    total = sum(d for _, d in per.values())
    dev_ms = total / iters / 1e3
    print(f"device time per {unit}: {dev_ms:.4f} ms in "
          f"{len(events) / iters:.0f} launches; busy "
          f"{100 * busy_share(events):.1f}% of the traced span, "
          f"{100 * dev_ms / host_ms:.1f}% of the unprofiled {host_ms:.3f} ms")
    for name, (n, dur) in sorted(per.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {dur / iters / 1e3:8.4f} ms {100 * dur / total:5.1f}% "
              f"x{n / iters:5.0f}  {_short(name)}")


def _config(impl: str = "auto", remat: bool = False,
            ffn_train: bool = False):
    """``ModelConfig()`` with the Swin stages' ``attn_impl`` and ``remat``
    and the fusion encoder's ``fused_ffn_train`` set."""
    import dataclasses

    from lavender_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    return dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, attn_impl=impl, remat=remat),
        bert=dataclasses.replace(cfg.bert, fused_ffn_train=ffn_train))


def _train_runner(batch: int, cfg):
    """(step closure, "step") for the retrieval-MLM train step at B clips
    on ``cfg``."""
    from lavender_tpu_torch.config import TrainConfig
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train.trainer import (create_train_state,
                                                  make_train_step)

    state = create_train_state(cfg, TrainConfig(max_iter=1000,
                                                max_grad_norm=1.0), seed=0)
    step = make_train_step(retrieval.make_loss_fn(2081, 6270), state)
    img, txt, mask = _requests(batch, cfg.bert.vocab_size)
    data = {"img": torch.as_tensor(img, device="cuda"),
            "txt": torch.as_tensor(txt, device="cuda"),
            "mask": torch.as_tensor(mask, device="cuda"),
            "vid": torch.arange(batch, device="cuda")}
    return lambda: step(data), "step"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[4])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--train", action="store_true",
                      help="profile the retrieval-MLM train step")
    what.add_argument("--seq2seq", action="store_true",
                      help="profile the captioning (seq2seq) forward")
    ap.add_argument("--impl", default="auto",
                    choices=("auto", "wm", "fused", "pallas"),
                    help="the Swin stages' attn_impl")
    ap.add_argument("--remat", action="store_true",
                    help="--train: SwinConfig.remat (the spatial K14 route)")
    ap.add_argument("--ffn-train", action="store_true",
                    help="--train: BertConfig.fused_ffn_train (K12)")
    args = ap.parse_args()
    if (args.remat or args.ffn_train) and not args.train:
        ap.error("--remat and --ffn-train go with --train")
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())

    cfg = _config(args.impl, args.remat, args.ffn_train)
    print(f"attn_impl={args.impl!r}"
          + (f" remat={args.remat} fused_ffn_train={args.ffn_train}"
             if args.train else ""), flush=True)
    if args.train:
        runners = [(b, *_train_runner(b, cfg)) for b in args.batch[:1]]
    else:
        server = LavenderServer(cfg, seed=0, frames=FRAMES, size=SIZE)
        runners = [(b, *serving_runner(server, b, args.seq2seq))
                   for b in args.batch]
    host_ms = []
    for b, run, unit in runners:
        run()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / args.iters
        host_ms.append(dt * 1e3)
        print(f"B={b}: {dt * 1e3:.3f} ms per {unit}, {b / dt:.2f} "
              f"{'train ' if args.train else ''}clips/s, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
    b, run, unit = runners[0]
    profile(run, args.iters, args.top, host_ms[0], unit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
