"""The serving profiler's trace reading, on a synthetic trace: only device
events count, and overlapping intervals count once in the busy share; and
the requests of its serving and ``--seq2seq`` runs, on a recording
stand-in for the server."""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from lavender_tpu_torch.profile_serving import (busy_share, device_events,
                                                serving_runner)


def test_device_events_and_busy_share(tmp_path):
    trace = {"traceEvents": [
        {"cat": "kernel", "name": "a", "ts": 0, "dur": 10},
        {"cat": "kernel", "name": "b", "ts": 5, "dur": 10},   # overlaps a
        {"cat": "cpu_op", "name": "host", "ts": 0, "dur": 100},
        {"cat": "gpu_memcpy", "name": "m", "ts": 30, "dur": 10},
        {"ph": "M", "name": "process_name"}]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    events = device_events(str(path))
    assert [e[0] for e in events] == ["a", "b", "m"]
    assert busy_share(events) == (15 + 10) / 40


@pytest.mark.parametrize("seq2seq", [False, True])
def test_serving_runner_requests(seq2seq):
    """The default run serves 26 text tokens under the full mask; --seq2seq
    serves the caption forward's 25 under attn_mask_type "seq2seq"."""
    calls = []
    stand_in = type("Server", (), {
        "config": SimpleNamespace(bert=SimpleNamespace(vocab_size=50)),
        "__call__": lambda self, *a, **kw: calls.append((a, kw))})()
    run, unit = serving_runner(stand_in, 4, seq2seq)
    run()
    (img, txt, mask), kw = calls[0]
    n_txt = 25 if seq2seq else 26
    assert unit == ("seq2seq forward" if seq2seq else "forward")
    assert kw == ({"attn_mask_type": "seq2seq"} if seq2seq else {})
    assert img.shape == (4, 5, 224, 224, 3) and img.dtype == np.uint8
    assert txt.shape == mask.shape == (4, n_txt)
    assert ((txt > 0) == (mask > 0)).all() and (txt < 50).all()
