"""ctypes binding to the repo's native data plane, ``native/loader.cpp``
(port of lavender_tpu/data/native.py, the same ``NativeTSV`` API).

The C++ library owns the hot host path: mmap'd TSV seek, base64, libjpeg
decode, Pillow-exact bilinear resize + crop, with an internal thread pool.
Python stays in charge of sampling and tokenization.

The library is built from the source at first use with ``g++`` into the
git-ignored ``build/``, under a name keyed by the hash of the source and
the flags (as ``ops/_build.py`` builds the kernels), and only where the
compiler finds libjpeg's header: :func:`unavailable` says why not
otherwise.  A build that starts and fails raises with the compiler's
output; nothing falls back silently.  ``native/`` is only read.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SRC = REPO / "native" / "loader.cpp"
BUILD_DIR = REPO / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def unavailable() -> Optional[str]:
    """None where ``g++`` finds ``jpeglib.h`` (the library can be built),
    else the reason it cannot."""
    try:
        proc = subprocess.run([CXX, "-x", "c++", "-E", "-", "-o", os.devnull],
                              input="#include <cstdio>\n#include <jpeglib.h>\n",
                              capture_output=True, text=True)
    except FileNotFoundError:
        return f"no {CXX} on PATH"
    if proc.returncode != 0:
        return f"{CXX} finds no libjpeg header (jpeglib.h)"
    return None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"liblvt_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/loader.cpp`` unless the library for its hash
    exists; raises RuntimeError with the compiler's output on failure.  The
    library is written to a temporary name and renamed, so concurrent
    builds never load a half-written file."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        out = Path(tmp) / so.name
        cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(out), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
        os.replace(out, so)
    return so


def load() -> ctypes.CDLL:
    """The library, built at first use (see :func:`build`)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.lvt_tsv_open.restype = ctypes.c_void_p
        lib.lvt_tsv_open.argtypes = [ctypes.c_char_p]
        lib.lvt_tsv_close.argtypes = [ctypes.c_void_p]
        lib.lvt_row_num_fields.restype = ctypes.c_int
        lib.lvt_row_num_fields.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.lvt_decode_clip.restype = ctypes.c_int
        lib.lvt_decode_clip.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.lvt_decode_batch.restype = ctypes.c_int
        lib.lvt_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return lib


class NativeTSV:
    """mmap'd TSV with parallel clip decoding."""

    def __init__(self, tsv_path: str):
        self.lib = load()
        self.handle = self.lib.lvt_tsv_open(str(tsv_path).encode())
        if not self.handle:
            raise OSError(f"cannot open {tsv_path}")

    def close(self):
        if self.handle:
            self.lib.lvt_tsv_close(self.handle)
            self.handle = None

    def __del__(self):
        if getattr(self, "handle", None):
            self.close()

    def num_fields(self, offset: int) -> int:
        return self.lib.lvt_row_num_fields(self.handle, offset)

    def decode_clip(self, offset: int, frame_cols: Sequence[int],
                    size_img: int, random_crop: bool = False,
                    seed: int = 0) -> np.ndarray:
        n = len(frame_cols)
        out = np.empty((n, size_img, size_img, 3), np.uint8)
        cols = (ctypes.c_int * n)(*frame_cols)
        r = self.lib.lvt_decode_clip(
            self.handle, offset, cols, n, size_img,
            1 if random_crop else 0, seed,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if r != 0:
            raise ValueError(f"native decode failed: {r}")
        return out

    def decode_batch(self, offsets: Sequence[int],
                     frame_cols: np.ndarray, size_img: int,
                     random_crop: bool = False, seed: int = 0,
                     n_threads: int = 8) -> np.ndarray:
        n_clips, n_frames = frame_cols.shape
        out = np.empty((n_clips, n_frames, size_img, size_img, 3), np.uint8)
        offs = (ctypes.c_long * n_clips)(*offsets)
        cols = np.ascontiguousarray(frame_cols, dtype=np.int32)
        r = self.lib.lvt_decode_batch(
            self.handle, offs,
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            n_clips, n_frames, size_img, 1 if random_crop else 0, seed,
            n_threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if r != 0:
            raise ValueError(f"native batch decode failed: {r}")
        return out
