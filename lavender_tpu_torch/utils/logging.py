"""Logging utilities (port of lavender_tpu/utils/logging.py; reference
utils/logger.py): the global LOGGER, file logging, the NoOp logger of the
ranks other than 0, and the EMA RunningMeter.
"""
from __future__ import annotations

import logging
import sys

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"

logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO,
                    stream=sys.stdout)
LOGGER = logging.getLogger("lavender_tpu_torch")


def add_log_to_file(log_path: str):
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(fh)


class NoOp:
    """Silences the ranks other than 0 (reference utils/dist.py:260-266)."""

    def __getattr__(self, name):
        def noop(*args, **kwargs):
            return None
        return noop


def main_logger():
    """LOGGER on rank 0, NoOp elsewhere."""
    from lavender_tpu_torch.parallel.dist import is_main_process
    return LOGGER if is_main_process() else NoOp()


class RunningMeter:
    """EMA meter (reference utils/logger.py:164-187)."""

    def __init__(self, name: str, val=None, smooth: float = 0.99):
        self._name = name
        self._sm = smooth
        self._val = val

    def __call__(self, value):
        val = (value if self._val is None
               else value * (1 - self._sm) + self._val * self._sm)
        if val == val:  # skip NaN
            self._val = val

    def __str__(self):
        return f"{self._name}: {self._val:.4f}"

    @property
    def val(self):
        return self._val

    @property
    def name(self):
        return self._name
