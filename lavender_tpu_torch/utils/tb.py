"""TensorBoard scalar logging without a TensorFlow/tensorboardX dependency
(the port's own copy of lavender_tpu/utils/tb.py: the same bytes out).

Reference: utils/logger.py:119-161 (``TensorboardLogger`` wrapping
tensorboardX's SummaryWriter — defined but unused by the reference mains;
provided here for drop-in parity).  Rather than pulling in tensorboardX,
this writes the TFRecord/Event wire format directly: a TensorBoard event
file is a sequence of records

    [uint64 len][uint32 masked_crc32c(len)][data][uint32 masked_crc32c(data)]

where ``data`` is a serialized ``tensorflow.Event`` proto.  Only the
fields TensorBoard needs for scalars are emitted (wall_time, step,
summary.value{tag, simple_value}), hand-encoded — the proto wire format
for this subset is ~30 lines and stable since TF 1.x.
"""
from __future__ import annotations

import os
import os.path as op
import socket
import struct
import time
from typing import Dict, Optional

# ---- crc32c (Castagnoli), table-driven — required by the TFRecord framing

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal proto wire-format encoders (varint / length-delimited)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: Optional[int] = None,
           summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    # Event: 1=wall_time double, 2=step int64, 3=file_version string,
    # 5=summary message
    out = _f_double(1, wall_time)
    if step is not None:
        out += _f_int64(2, step)
    if file_version is not None:
        out += _f_bytes(3, file_version.encode())
    if summary is not None:
        out += _f_bytes(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value: 1=tag string, 2=simple_value float; Summary: 1=value
    val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    return _f_bytes(1, val)


class TensorboardLogger:
    """Scalar event-file writer, API-compatible with the reference's
    TensorboardLogger (utils/logger.py:119-161): ``add_scalar``,
    ``add_scalars`` (dict, with optional prefix), ``step()``/``set_step``
    global-step tracking, ``flush``/``close``.  Files are readable by
    stock TensorBoard (`tensorboard --logdir <dir>`)."""

    def __init__(self, logdir: str, suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}{suffix}")
        self.path = op.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._step = 0
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    # -- reference API (utils/logger.py:127-161)

    def step(self):
        self._step += 1

    def set_step(self, step: int):
        self._step = int(step)

    @property
    def global_step(self) -> int:
        return self._step

    def add_scalar(self, tag: str, value, step: Optional[int] = None):
        self._write(_event(time.time(),
                           step=self._step if step is None else int(step),
                           summary=_scalar_summary(tag, float(value))))

    def add_scalars(self, scalars: Dict[str, float], prefix: str = "",
                    step: Optional[int] = None):
        for k, v in scalars.items():
            tag = f"{prefix}{'_' if prefix else ''}{k}"
            try:
                self.add_scalar(tag, float(v), step)
            except (TypeError, ValueError):
                continue  # reference skips non-scalar values

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
