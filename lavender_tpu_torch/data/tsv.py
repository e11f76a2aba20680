"""Seek-based TSV storage (port of lavender_tpu/data/tsv.py; reference:
utils/tsv_file.py, utils/tsv_file_ops.py).

One row per video: ``key \\t meta \\t b64(JPEG frame) * N``.  A ``.lineidx``
sidecar stores the byte offset of each row so readers can ``seek`` directly.
Readers are safe across threads and forks (one handle per thread and pid).
The native reader (``data/native.py``) maps the same file for the clip
decode.
"""
from __future__ import annotations

import os
import os.path as op
from typing import List, Optional, Sequence


def create_lineidx(tsv_path: str, idx_path: Optional[str] = None) -> str:
    """Generate the .lineidx sidecar (offsets of each row)."""
    idx_path = idx_path or op.splitext(tsv_path)[0] + ".lineidx"
    tmp = idx_path + ".tmp"
    offsets = []
    with open(tsv_path, "rb") as f:
        pos = 0
        for line in f:
            offsets.append(pos)
            pos += len(line)
    with open(tmp, "w") as f:
        f.write("\n".join(str(o) for o in offsets) + "\n")
    os.replace(tmp, idx_path)  # atomic publish (cf. tsv_file_ops.py tmp+rename)
    return idx_path


class TSVFile:
    """Random-access TSV reader with .lineidx sidecar (utils/tsv_file.py:38)."""

    def __init__(self, tsv_path: str, generate_lineidx: bool = True):
        self.tsv_path = tsv_path
        self.lineidx_path = op.splitext(tsv_path)[0] + ".lineidx"
        if not op.isfile(self.lineidx_path) and generate_lineidx:
            create_lineidx(tsv_path, self.lineidx_path)
        self._offsets: Optional[List[int]] = None
        import threading
        self._tls = threading.local()

    def _ensure_offsets(self):
        if self._offsets is None:
            with open(self.lineidx_path) as f:
                self._offsets = [int(l) for l in f if l.strip()]

    def _ensure_fp(self):
        # One handle per (thread, pid): loader threads share the dataset, so
        # a shared fp would race on seek+readline (the reference's analogous
        # guard is the per-worker reopen, utils/tsv_file.py:98-106).
        pid = os.getpid()
        fp = getattr(self._tls, "fp", None)
        if fp is None or getattr(self._tls, "pid", None) != pid:
            self._tls.fp = open(self.tsv_path, "rb")
            self._tls.pid = pid
        return self._tls.fp

    def num_rows(self) -> int:
        self._ensure_offsets()
        return len(self._offsets)

    def __len__(self):
        return self.num_rows()

    def seek(self, idx: int) -> List[str]:
        self._ensure_offsets()
        fp = self._ensure_fp()
        fp.seek(self._offsets[idx])
        line = fp.readline()
        return [s.strip() for s in line.decode("utf-8").split("\t")]

    def seek_offset(self, offset: int) -> List[str]:
        """Seek by raw byte offset (id2lineidx pkl flow, dataset.py:44-46)."""
        fp = self._ensure_fp()
        fp.seek(offset)
        line = fp.readline()
        return [s.strip() for s in line.decode("utf-8").split("\t")]

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)

    def get_key(self, idx: int) -> str:
        return self.seek(idx)[0]

    def close(self):
        fp = getattr(self._tls, "fp", None)
        if fp is not None:
            fp.close()
            self._tls.fp = None


class CompositeTSVFile:
    """(source, row) indirection over many TSV shards (utils/tsv_file.py:109)."""

    def __init__(self, list_file, seq_file, root: str = "."):
        if isinstance(list_file, str):
            with open(op.join(root, list_file) if not op.isfile(list_file)
                      else list_file) as f:
                self.file_list = [l.strip() for l in f if l.strip()]
        else:
            self.file_list = list(list_file)
        self.root = root
        self.seq: List = []
        if isinstance(seq_file, str):
            with open(seq_file) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    self.seq.append((int(parts[0]), int(parts[1])))
        else:
            self.seq = [(int(a), int(b)) for a, b in seq_file]
        self.tsvs = [TSVFile(self._resolve(p)) for p in self.file_list]

    def _resolve(self, p: str) -> str:
        return p if op.isfile(p) else op.join(self.root, p)

    def num_rows(self) -> int:
        return len(self.seq)

    def __len__(self):
        return self.num_rows()

    def __getitem__(self, idx: int) -> List[str]:
        src, row = self.seq[idx]
        return self.tsvs[src].seek(row)

    def get_key(self, idx: int) -> str:
        src, row = self.seq[idx]
        return f"{self.file_list[src]}_{self.tsvs[src].get_key(row)}"


def tsv_writer(rows, tsv_path: str, sep: str = "\t"):
    """Atomic TSV writer with .lineidx + .lineidx.8b sidecars
    (cf. utils/tsv_file_ops.py:34-79; the .8b file holds the same offsets
    as little-endian uint64 — the reference's binary index format)."""
    lineidx_path = op.splitext(tsv_path)[0] + ".lineidx"
    idx8b_path = lineidx_path + ".8b"
    tmp_tsv, tmp_idx = tsv_path + ".tmp", lineidx_path + ".tmp"
    tmp_8b = idx8b_path + ".tmp"
    os.makedirs(op.dirname(op.abspath(tsv_path)), exist_ok=True)
    with open(tmp_tsv, "wb") as ftsv, open(tmp_idx, "w") as fidx, \
            open(tmp_8b, "wb") as f8b:
        pos = 0
        for row in rows:
            line = sep.join(str(v) if not isinstance(v, bytes)
                            else v.decode("utf-8") for v in row) + "\n"
            data = line.encode("utf-8")
            ftsv.write(data)
            fidx.write(f"{pos}\n")
            f8b.write(pos.to_bytes(8, "little"))
            pos += len(data)
    os.replace(tmp_tsv, tsv_path)
    os.replace(tmp_idx, lineidx_path)
    os.replace(tmp_8b, idx8b_path)


def tsv_reader(tsv_path: str, sep: str = "\t"):
    with open(tsv_path, encoding="utf-8") as f:
        for line in f:
            yield [s.strip() for s in line.split(sep)]


def reorder_tsv_keys(in_path: str, ordered_keys: Sequence[str],
                     out_path: str):
    """Rewrite a TSV so rows follow ``ordered_keys`` (cf. caption eval flow,
    main_caption.py:137-158)."""
    tsv = TSVFile(in_path)
    key2idx = {tsv.get_key(i): i for i in range(len(tsv))}
    tsv_writer((tsv[key2idx[k]] for k in ordered_keys), out_path)
