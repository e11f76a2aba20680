"""Dataset bases for TSV-backed video-text tasks (port of
lavender_tpu/data/dataset.py).

Behavioral reference: dataset.py (Dataset_Base:17, get_tsv_dls:295) and the
per-task dataset subclasses in the main_*.py scripts.  Items are dicts of
numpy arrays with static shapes (text always padded to size_txt).  Each
dataset draws its random choices (frames, crops, transforms, caption
subsets) from ``self.rng``, a ``random.Random``, in the JAX package's
order: two datasets whose ``rng`` is seeded alike give the same items.
"""
from __future__ import annotations

import json
import logging
import math
import os
import os.path as op
import pickle
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from lavender_tpu_torch.config import DataConfig
from lavender_tpu_torch.data import native
from lavender_tpu_torch.data import transforms as TF
from lavender_tpu_torch.data.tokenizer import BertTokenizer
from lavender_tpu_torch.data.tsv import TSVFile

log = logging.getLogger(__name__)


class VideoTextDataset:
    """Base: tokenization, mask insertion, video decode, temporal sampling.

    Reference: Dataset_Base (dataset.py:17-276).
    """

    def __init__(self, cfg: DataConfig, tokzr: BertTokenizer,
                 split: str = "train", size_frame: Optional[int] = None):
        self.cfg = cfg
        self.split = split
        self.size_frame = size_frame or cfg.size_frame
        self.tokzr = tokzr
        self.rng = random.Random()
        t = tokzr
        self.cls_token_id, self.sep_token_id = t.cls_token_id, t.sep_token_id
        self.pad_token_id, self.mask_token_id = t.pad_token_id, t.mask_token_id
        self.unk_token_id = t.unk_token_id
        self.true_token_id = t.convert_tokens_to_ids(["true"])[0]
        self.false_token_id = t.convert_tokens_to_ids(["false"])[0]

    # ---- text ----

    def str2txt(self, s: str) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenize + pad/truncate to size_txt (dataset.py:258-276)."""
        ids = self.tokzr.encode(
            s, padding="max_length", max_length=self.cfg.size_txt,
            truncation=True)
        txt = np.asarray(ids, dtype=np.int32)
        mask = (txt != self.pad_token_id).astype(np.int32)
        return txt, mask

    def concat_txt(self, a: str, b: str) -> str:
        return f"{a} {self.tokzr.sep_token} {b}"

    def append_mask_tok2txt(self, txt, mask):
        """Append [MASK] after the padded text (dataset.py:83-87)."""
        txt = np.concatenate([txt, [self.mask_token_id]]).astype(np.int32)
        mask = np.concatenate([mask, [1]]).astype(np.int32)
        return txt, mask

    def prepend_mask_tok2txt(self, txt, mask):
        txt = np.concatenate([[self.mask_token_id], txt]).astype(np.int32)
        mask = np.concatenate([[1], mask]).astype(np.int32)
        return txt, mask

    def insert_mask_tok2txt(self, txt, mask, pos: int = 10):
        """Insert [MASK] at position 10 (dataset.py:89-93)."""
        txt = np.concatenate(
            [txt[:pos], [self.mask_token_id], txt[pos:]]).astype(np.int32)
        mask = np.concatenate([mask[:pos], [1], mask[pos:]]).astype(np.int32)
        return txt, mask

    def replace_cls_w_mask(self, txt, mask):
        txt = np.concatenate([[self.mask_token_id], txt[1:]]).astype(np.int32)
        mask = np.concatenate([[1], mask[1:]]).astype(np.int32)
        return txt, mask

    def get_prompt(self, prompt_text: Optional[str] = None):
        """Tokenize the task prompt without padding (dataset.py:72-81)."""
        if prompt_text is None:
            prompt_text = self.prompt_text
        toks = self.tokzr.tokenize(prompt_text)
        ids = ([self.cls_token_id]
               + self.tokzr.convert_tokens_to_ids(toks)
               + [self.sep_token_id])
        txt = np.asarray(ids, dtype=np.int32)
        mask = np.ones_like(txt)
        return txt, mask

    # ---- video ----

    def frames_from_b64(self, bufs: Sequence[str],
                        random_sample: Optional[bool] = None) -> np.ndarray:
        """Temporal-sample + decode + spatial transform -> uint8 [T,S,S,3]."""
        if random_sample is None:
            random_sample = self.split == "train"
        idxs = TF.temporal_sample_indices(
            len(bufs), self.size_frame, random_sample, self.rng)
        frames = [TF.str2img(bufs[i]) for i in idxs]
        train = self.split == "train"
        mode = (self.rng.choice(self.cfg.img_transform) if train
                else self._eval_transform())
        return TF.transform_clip(frames, self.cfg.size_img, mode, train,
                                 self.rng)

    def _eval_transform(self) -> str:
        # eval mapping of dataset.py:236-247
        tf = tuple(self.cfg.img_transform)
        if tf == ("vid_rand_crop",):
            return "vid_center_crop"
        if tf == ("pad_resize",):
            return "pad_resize"
        return "img_center_crop"

    def pad_frames(self, frames: np.ndarray) -> np.ndarray:
        """Zero-pad T up to size_frame so batch shapes stay static (cf.
        missing-video zero-frame fallback, main_qaoe_mlm.py:52-56)."""
        T = frames.shape[0]
        if T >= self.size_frame:
            return frames[: self.size_frame]
        pad = np.zeros((self.size_frame - T,) + frames.shape[1:],
                       dtype=frames.dtype)
        return np.concatenate([frames, pad], axis=0)


def decode_path(cfg: DataConfig) -> Tuple[str, str]:
    """(path, reason): the clip decode a ``TsvTaskDataset`` of ``cfg``
    takes, "native" (``data/native.py``) or "python" (``transforms.
    str2img`` and the PIL resizes), by the JAX package's rule
    (dataset.py:147-161): native unless ``LAVENDER_NATIVE=0`` or a
    ``pad_resize`` transform, and here also unless the native library
    cannot be built (no libjpeg header)."""
    if os.environ.get("LAVENDER_NATIVE", "1") == "0":
        return "python", "LAVENDER_NATIVE=0"
    if "pad_resize" in tuple(cfg.img_transform):
        return "python", "pad_resize has no native implementation"
    why = native.unavailable()
    if why is not None:
        return "python", f"native library not built: {why}"
    return "native", f"{native.SRC.name} built with {native.CXX}"


class TsvTaskDataset(VideoTextDataset):
    """Task dataset over one img TSV + id2lineidx pkl + txt json.

    Reference: the common pattern of get_tsv_dls (dataset.py:295-330) +
    Dataset_Retrieval_TS (main_retrieval_task_specific.py:13-54).  The clip
    decode path (:func:`decode_path`) is logged with its reason and kept in
    ``self.decode``: "native" or "python:<decoder>".
    """

    def __init__(self, cfg: DataConfig, tokzr, split: str,
                 img_tsv_path: str, id2lineidx: Dict, txt: List[Dict],
                 size_frame: Optional[int] = None):
        super().__init__(cfg, tokzr, split, size_frame)
        self.img_tsv_path = img_tsv_path
        self.id2lineidx = id2lineidx
        self.txt = list(txt)
        self._tsv = TSVFile(img_tsv_path, generate_lineidx=False)
        path, why = decode_path(cfg)
        # a native build that starts and fails raises here
        self._native = (native.NativeTSV(img_tsv_path) if path == "native"
                        else None)
        self.decode = path if path == "native" else f"python:{TF.decoder()}"
        log.info("%s %s: %s decode (%s)", type(self).__name__, split,
                 self.decode, why)
        if split == "train" and cfg.data_ratio != 1:
            self._partial_data()

    def _partial_data(self):
        """Subset train data by video (dataset.py:48-66)."""
        v2t = defaultdict(list)
        for item in self.txt:
            v2t[item["video"]].append(item)
        vids = list(v2t.keys())
        self.rng.shuffle(vids)
        r = self.cfg.data_ratio
        n = math.ceil(len(vids) * r) if r < 1 else min(int(r), len(vids))
        self.txt = [it for v in vids[:n] for it in v2t[v]]

    def __len__(self):
        return len(self.txt)

    def get_video(self, video_id) -> np.ndarray:
        if video_id not in self.id2lineidx:
            # missing video -> zero frames (main_qaoe_mlm.py:52-56)
            S = self.cfg.size_img
            return np.zeros((self.size_frame, S, S, 3), dtype=np.uint8)
        offset = self.id2lineidx[video_id]
        if self._native is not None:
            n_frames = self._native.num_fields(offset) - 2
            if n_frames > 0:
                train = self.split == "train"
                # crop mode mirrors the Python dispatch
                # (transforms.transform_clip / dataset.py:218-256): random
                # crop only for the *_rand_crop transforms in train
                rand = train and any(
                    "rand_crop" in t for t in tuple(self.cfg.img_transform))
                idxs = TF.temporal_sample_indices(
                    n_frames, self.size_frame, train, self.rng)
                return self._native.decode_clip(
                    offset, [2 + i for i in idxs], self.cfg.size_img,
                    random_crop=rand,
                    seed=self.rng.randrange(2 ** 31) if rand else 0)
        row = self._tsv.seek_offset(offset)
        return self.frames_from_b64(row[2:])

    def has_video(self, video_id) -> bool:
        return video_id in self.id2lineidx


def load_task_data(cfg: DataConfig, dataset_cls, tokzr,
                   **kwargs) -> Dict[str, "TsvTaskDataset"]:
    """Build split->dataset from the reference file layout
    (dataset.py:295-330): ``img_{dataset}.tsv`` + ``.id2lineidx.pkl`` +
    ``txt_{task}.json``."""
    img_path = op.join(cfg.data_dir, f"img_{cfg.dataset}.tsv")
    with open(op.join(cfg.data_dir, f"img_{cfg.dataset}.id2lineidx.pkl"),
              "rb") as f:
        id2lineidx = pickle.load(f)
    with open(op.join(cfg.data_dir, f"txt_{cfg.task}.json")) as f:
        txt_data = json.load(f)
    splits = ["train", "val"] + (["test"] if "test" in txt_data else [])
    return {
        split: dataset_cls(cfg, tokzr, split, img_path, id2lineidx,
                           txt_data[split], **kwargs)
        for split in splits}
