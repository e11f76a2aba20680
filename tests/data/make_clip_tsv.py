#!/usr/bin/env python3
"""Writes the fixture corpus: 8 videos of smooth seeded frames, JPEG in a
TSV, in the reference's dataset layout.

    python tests/data/make_clip_tsv.py [OUT_DIR]   # default: tests/data

writes, under OUT_DIR:

* ``img_fixture.tsv``: one row per video, ``key \\t meta \\t b64(JPEG) * N``,
  each frame 320 x 240 (so a 224 crop really resizes), JPEG quality 95;
  videos 2 and 5 have 6 and 12 frames, the others 8;
* ``img_fixture.lineidx`` (+ ``.8b``): the byte offset of each row;
* ``img_fixture.id2lineidx.pkl``: {video id: byte offset};
* ``txt_retrieval.json``: {"train": 16 items, "val": 16 items}, two
  captions of each video per split (the train items' captions a list of
  2-3 sentences or one string).

The frames come from :func:`draw_frame`, numpy alone, so a reader can hold
decoded frames against them without a JPEG encoder.  Encoding needs PIL.
"""
from __future__ import annotations

import base64
import io
import json
import os
import os.path as op
import pickle
import sys

import numpy as np

SEED = 19
N_VIDEOS = 8
HEIGHT, WIDTH = 240, 320
QUALITY = 95
_SUBJ = ["a man", "a woman", "two children", "the dog", "a cat",
         "a group of people", "an old man", "a young girl"]
_VERB = ["is playing", "is cooking", "runs across", "is talking about",
         "is riding", "jumps over", "is explaining", "is singing near"]
_OBJ = ["a guitar on stage", "food in the kitchen", "the busy street",
        "a new smartphone", "the soccer ball", "a bicycle downhill",
        "the wooden fence", "how engines work"]


def n_frames(video: int) -> int:
    return {2: 6, 5: 12}.get(video, 8)


def video_id(video: int) -> str:
    return f"video{video}"


def draw_frame(video: int, frame: int) -> np.ndarray:
    """uint8 [HEIGHT, WIDTH, 3]: a few low-frequency waves per channel,
    their phases drifting with the frame, from (SEED, video)."""
    rs = np.random.RandomState(SEED * 1000 + video)
    freq = rs.uniform(0.5, 3.0, (3, 3, 2))    # channel, wave, (y, x)
    phase = rs.uniform(0, 2 * np.pi, (3, 3))
    drift = rs.uniform(0.1, 0.4, (3, 3))
    base = rs.uniform(70, 185, 3)
    y = np.linspace(0, 1, HEIGHT)[:, None]
    x = np.linspace(0, 1, WIDTH)[None, :]
    img = np.empty((HEIGHT, WIDTH, 3))
    for c in range(3):
        v = np.full((HEIGHT, WIDTH), base[c])
        for k in range(3):
            v += 22 * np.sin(2 * np.pi * (freq[c, k, 0] * y + freq[c, k, 1] * x)
                             + phase[c, k] + drift[c, k] * frame)
        img[..., c] = v
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def captions(video: int):
    return [f"{_SUBJ[video]} {_VERB[(video + k) % 8]} {_OBJ[(video + 2 * k) % 8]}."
            for k in range(3)]


def _jpeg_b64(arr: np.ndarray) -> str:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=QUALITY)
    return base64.b64encode(buf.getvalue()).decode()


def write(out_dir: str) -> None:
    here = op.dirname(op.abspath(__file__))
    sys.path.insert(0, op.dirname(op.dirname(here)))
    from lavender_tpu_torch.data.tsv import tsv_writer

    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for v in range(N_VIDEOS):
        frames = [_jpeg_b64(draw_frame(v, f)) for f in range(n_frames(v))]
        rows.append([video_id(v), json.dumps({"frames": len(frames)})]
                    + frames)
    tsv = op.join(out_dir, "img_fixture.tsv")
    tsv_writer(rows, tsv)
    with open(op.join(out_dir, "img_fixture.lineidx")) as f:
        offsets = [int(line) for line in f]
    with open(op.join(out_dir, "img_fixture.id2lineidx.pkl"), "wb") as f:
        pickle.dump({video_id(v): o for v, o in enumerate(offsets)}, f,
                    protocol=4)
    train, val = [], []
    for v in range(N_VIDEOS):
        caps = captions(v)
        train.append({"video": video_id(v), "caption": caps[: 2 + v % 2]})
        train.append({"video": video_id(v), "caption": caps[2]})
        val += [{"video": video_id(v), "caption": c} for c in caps[:2]]
    with open(op.join(out_dir, "txt_retrieval.json"), "w") as f:
        json.dump({"train": train, "val": val}, f, indent=1)


if __name__ == "__main__":
    write(sys.argv[1] if len(sys.argv) > 1 else op.dirname(op.abspath(__file__)))
