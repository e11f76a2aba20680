"""Misc utilities (port of lavender_tpu/utils/misc.py; reference
utils/misc.py): the retry wrapper (limited_retry_agent, :86-98),
flock-guarded reads (exclusive_open_to_read, :101-120), and parameter
freeze by regex (:190-214) over a module's named parameters.
"""
from __future__ import annotations

import contextlib
import os
import re
import time
from typing import Callable, Dict, Sequence

import torch
from torch import nn

from lavender_tpu_torch.utils.logging import LOGGER


def limited_retry(func: Callable, num_retries: int = 5, delay: float = 1.0,
                  *args, **kwargs):
    """Call func with retries + exponential backoff (utils/misc.py:86-98)."""
    for i in range(num_retries):
        try:
            return func(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — IO retry wrapper
            if i == num_retries - 1:
                raise
            LOGGER.warning(f"retry {i + 1}/{num_retries} after {e!r}")
            time.sleep(delay * (2 ** i))


@contextlib.contextmanager
def exclusive_open_to_read(path: str, mode: str = "r"):
    """Open with an exclusive flock on a sidecar lock file
    (utils/misc.py:101-120) — protects concurrent lineidx generation."""
    import fcntl
    lock_path = path + ".lock"
    with open(lock_path, "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            with open(path, mode) as f:
                yield f
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    try:
        os.remove(lock_path)
    except OSError:
        pass


def freeze_mask(model: nn.Module, patterns: Sequence[str]) -> Dict[str, bool]:
    """Parameter name -> False (frozen) where the name matches any regex
    (reference freeze/unfreeze by regex, utils/misc.py:190-214; the JAX
    package matches "/"-joined paths, the port the "."-joined names)."""
    regs = [re.compile(p) for p in patterns]
    return {name: not any(r.search(name) for r in regs)
            for name, _ in model.named_parameters()}


@torch.no_grad()
def zero_frozen_grads(model: nn.Module, mask: Dict[str, bool]) -> None:
    """Zero the gradients of the parameters that ``mask`` freezes (call
    between ``backward`` and the optimizer step)."""
    for name, p in model.named_parameters():
        if not mask.get(name, True) and p.grad is not None:
            p.grad.zero_()
