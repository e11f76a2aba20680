"""Tracing / profiling utilities (port of lavender_tpu/utils/profiling.py;
the reference only logs max GPU memory + LR per step, agent.py:184-195):
``torch.profiler`` trace capture, clips/s and tokens/s counters, CUDA
memory snapshots, and the reference's ``humanbytes`` (utils/misc.py:20).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


def humanbytes(n: float) -> str:
    """Bytes -> human string (reference utils/misc.py:20)."""
    kb, mb, gb, tb = 1024.0, 1024.0 ** 2, 1024.0 ** 3, 1024.0 ** 4
    if n < kb:
        return f"{int(n)} B"
    if n < mb:
        return f"{n / kb:.2f} KB"
    if n < gb:
        return f"{n / mb:.2f} MB"
    if n < tb:
        return f"{n / gb:.2f} GB"
    return f"{n / tb:.2f} TB"


def device_memory_stats(device=None) -> Dict[str, int]:
    """Live and peak bytes of the CUDA caching allocator
    (``torch.cuda.memory_stats``) under the JAX package's names
    ``bytes_in_use`` / ``peak_bytes_in_use``, plus torch's own keys; {}
    without CUDA."""
    if not torch.cuda.is_available():
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    return stats


def log_memory_string(step: int, lr_swin: float = None,
                      lr_other: float = None, device=None) -> str:
    """Agent_Base.log_memory equivalent (agent.py:184-195)."""
    stats = device_memory_stats(device)
    peak = stats.get("peak_bytes_in_use", stats.get("bytes_in_use", 0))
    parts = [f"step: {step}"]
    if lr_swin is not None:
        parts.append(f"lr_swin: {lr_swin:.2e}")
    if lr_other is not None:
        parts.append(f"lr_bert: {lr_other:.2e}")
    parts.append(f"max memory: {humanbytes(peak)}")
    return ", ".join(parts)


@contextlib.contextmanager
def trace(log_dir: str = "./_trace"):
    """A ``torch.profiler`` trace (CPU and, where there is one, CUDA
    activity) around a block, written to ``log_dir`` for TensorBoard's
    profiler plugin; yields the profiler (``key_averages()``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class Throughput:
    """Clips/sec + tokens/sec counter."""

    def __init__(self):
        self.t0 = time.time()
        self.clips = 0
        self.tokens = 0

    def update(self, n_clips: int, n_tokens: int = 0):
        self.clips += n_clips
        self.tokens += n_tokens

    def rates(self) -> Dict[str, float]:
        dt = max(time.time() - self.t0, 1e-9)
        return {"clips_per_sec": self.clips / dt,
                "tokens_per_sec": self.tokens / dt}

    def reset(self):
        self.t0 = time.time()
        self.clips = self.tokens = 0
