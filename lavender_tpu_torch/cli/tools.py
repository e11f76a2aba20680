"""Preprocessing tools (port of lavender_tpu/cli/tools.py; reference
_tools/*), on the port's ``data/tsv.py`` and ``data/transforms.py``.

    python -m lavender_tpu_torch.cli.tools <subcommand> ...

Subcommands:
  extract-frames  — decode videos, sparse-sample N frames, write b64-JPEG TSV
                    (_tools/extract_video-frame.py + extract_tsv.py, with
                    cv2.VideoCapture)
  id2lineidx      — build the video-id -> byte-offset pkl
                    (_tools/make_id2lineidx_pkl.py)
  visualize       — dump decoded frames of a TSV row to PNGs
                    (_tools/visualize_frame_tsv.py)
  filter-videos   — drop test-set videos of other tasks from a txt json
                    (_tools/multi_task_vid_filter.py)
  convert-ckpt    — a reference LAVENDER .pt -> the port's state dict
                    (``torch.save``; loads with ``train.checkpoint.
                    load_params``)
  build-vocab     — train a BERT WordPiece vocab.txt (needs ``tokenizers``)
"""
from __future__ import annotations

import argparse
import base64
import glob
import json
import os.path as op
import pickle
import sys
from typing import List

from lavender_tpu_torch.data.transforms import uniform_indices
from lavender_tpu_torch.data.tsv import TSVFile, create_lineidx, tsv_writer


def extract_frames(video_path: str, n_frames: int = 32) -> List[bytes]:
    """Sparse-sample n JPEG-encoded frames from a video file."""
    import cv2
    cap = cv2.VideoCapture(video_path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        frames = []
        ok, frame = cap.read()
        while ok:
            frames.append(frame)
            ok, frame = cap.read()
        total = len(frames)
        picks = uniform_indices(0, total - 1, min(n_frames, total)) \
            if total else []
        sel = [frames[i] for i in picks]
    else:
        picks = uniform_indices(0, total - 1, min(n_frames, total))
        sel = []
        for i in picks:
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            ok, frame = cap.read()
            if ok:
                sel.append(frame)
    cap.release()
    out = []
    for frame in sel:
        ok, buf = cv2.imencode(".jpg", frame,
                               [int(cv2.IMWRITE_JPEG_QUALITY), 90])
        if ok:
            out.append(buf.tobytes())
    return out


def cmd_extract_frames(args):
    rows = []
    paths = sorted(glob.glob(args.videos))
    for p in paths:
        key = op.splitext(op.basename(p))[0]
        jpegs = extract_frames(p, args.n_frames)
        if not jpegs:
            print(f"skip (no frames): {p}", file=sys.stderr)
            continue
        rows.append([key, "{}"] + [base64.b64encode(j).decode()
                                   for j in jpegs])
        print(f"{key}: {len(jpegs)} frames")
    tsv_writer(rows, args.output)
    print(f"wrote {len(rows)} rows -> {args.output}")


def cmd_id2lineidx(args):
    tsv_path = args.tsv
    lineidx = op.splitext(tsv_path)[0] + ".lineidx"
    if not op.isfile(lineidx):
        create_lineidx(tsv_path, lineidx)
    with open(lineidx) as f:
        offsets = [int(l) for l in f if l.strip()]
    tsv = TSVFile(tsv_path)
    id2lineidx = {tsv.get_key(i): offsets[i] for i in range(len(offsets))}
    out = args.output or op.splitext(tsv_path)[0] + ".id2lineidx.pkl"
    with open(out, "wb") as f:
        pickle.dump(id2lineidx, f)
    print(f"wrote {len(id2lineidx)} keys -> {out}")


def cmd_visualize(args):
    from lavender_tpu_torch.data.transforms import str2img
    from PIL import Image
    tsv = TSVFile(args.tsv)
    row = tsv.seek(args.row)
    key, bufs = row[0], row[2:]
    for i, b in enumerate(bufs[: args.max_frames]):
        img = str2img(b)
        out = f"{args.output_prefix}{key}_{i:03d}.png"
        Image.fromarray(img).save(out)
        print(out)


def cmd_filter_videos(args):
    """Remove videos that appear in other tasks' test splits
    (_tools/multi_task_vid_filter.py behavior)."""
    with open(args.txt) as f:
        data = json.load(f)
    banned = set()
    for other in args.test_jsons:
        with open(other) as f:
            od = json.load(f)
        for item in od.get("test", []):
            banned.add(item["video"])
    before = len(data.get("train", []))
    data["train"] = [it for it in data.get("train", [])
                     if it["video"] not in banned]
    with open(args.output, "w") as f:
        json.dump(data, f)
    print(f"train: {before} -> {len(data['train'])} "
          f"({len(banned)} banned videos)")


def cmd_convert_ckpt(args):
    from lavender_tpu_torch.convert import (
        convert_lavender_checkpoint, load_torch_checkpoint)
    from lavender_tpu_torch.train.checkpoint import save_params
    sd = load_torch_checkpoint(args.pt)
    save_params(convert_lavender_checkpoint(sd), args.output)
    print(f"converted {args.pt} -> {args.output}")


def cmd_build_vocab(args):
    """Train a BERT-style WordPiece vocab (lowercase + NFD strip-accents,
    '##' continuation pieces) from text files with the HF ``tokenizers``
    WordPiece trainer, the algorithm of the released bert-base vocabs.
    The output is a plain vocab.txt for ``data.tokenizer.BertTokenizer``
    and ``transformers.BertTokenizer`` alike."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers
    from tokenizers.trainers import WordPieceTrainer
    files = []
    for pat in args.corpus:
        files.extend(sorted(glob.glob(pat, recursive=True)))
    if not files:
        raise SystemExit("build-vocab: no corpus files matched")
    tk = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tk.normalizer = normalizers.BertNormalizer(lowercase=True,
                                               strip_accents=True)
    tk.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    trainer = WordPieceTrainer(
        vocab_size=args.size, continuing_subword_prefix="##",
        special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    tk.train(files, trainer)
    vocab = sorted(tk.get_vocab().items(), key=lambda kv: kv[1])
    with open(args.output, "w") as f:
        for tok_str, _ in vocab:
            f.write(tok_str + "\n")
    print(f"build-vocab: {len(vocab)} pieces from {len(files)} files "
          f"-> {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lavender-tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("extract-frames")
    p.add_argument("--videos", required=True, help="glob of video files")
    p.add_argument("--output", required=True, help="output .tsv")
    p.add_argument("--n-frames", type=int, default=32)
    p.set_defaults(fn=cmd_extract_frames)

    p = sub.add_parser("id2lineidx")
    p.add_argument("--tsv", required=True)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=cmd_id2lineidx)

    p = sub.add_parser("visualize")
    p.add_argument("--tsv", required=True)
    p.add_argument("--row", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=8)
    p.add_argument("--output-prefix", default="./frame_")
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("filter-videos")
    p.add_argument("--txt", required=True)
    p.add_argument("--test-jsons", nargs="+", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_filter_videos)

    p = sub.add_parser("convert-ckpt")
    p.add_argument("--pt", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_convert_ckpt)

    p = sub.add_parser("build-vocab")
    p.add_argument("--corpus", nargs="+", required=True,
                   help="glob(s) of text files to train on")
    p.add_argument("--size", type=int, default=30522)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_build_vocab)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
