"""YAML-driven composite caption datasets (port of
lavender_tpu/data/composite.py; PyYAML is imported inside ``load_yaml``).

Reference: TsvCompositeDataset (dataset.py:347-617) + utils/load_files.py —
a dataset described by a YAML file pointing at img/label/caption TSVs with
optional caption_linelist indirection, used by captioning and pretraining
corpora (MSRVTT-cap, VATEX, COCO, CC, MERLOT/HT100M variants).
"""
from __future__ import annotations

import json
import os.path as op
from typing import Dict, List, Optional

import numpy as np

from lavender_tpu_torch.config import DataConfig
from lavender_tpu_torch.data.dataset import VideoTextDataset
from lavender_tpu_torch.data.tsv import CompositeTSVFile, TSVFile, tsv_reader


def load_yaml(path: str) -> Dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def find_file_path_in_yaml(fname: Optional[str], root: str) -> Optional[str]:
    if fname is None:
        return None
    if op.isfile(fname):
        return fname
    candidate = op.join(root, fname)
    if op.isfile(candidate):
        return candidate
    raise FileNotFoundError(f"{fname} not found (root={root})")


class CompositeCaptionDataset(VideoTextDataset):
    """Caption dataset over a YAML config (TsvCompositeDataset equivalent).

    YAML keys: ``img`` (visual tsv), ``caption`` (caption tsv),
    ``label`` (optional), ``caption_linelist`` (optional (img_line,
    cap_line) indirection), ``composite`` (bool: img is a list-file of
    shards).
    """

    def __init__(self, cfg: DataConfig, tokzr, yaml_file: str,
                 split: str = "train", size_frame: Optional[int] = None,
                 use_asr: bool = False, pred_mf_cap_only: bool = False,
                 append_pred_mf_cap: bool = False):
        super().__init__(cfg, tokzr, split, size_frame)
        if not op.isfile(yaml_file):
            yaml_file = op.join(cfg.data_dir, yaml_file)
        self.yaml_file = yaml_file
        self.root = op.dirname(yaml_file)
        self.cfg_yaml = load_yaml(yaml_file)
        self.is_composite = bool(self.cfg_yaml.get("composite", False))
        self.cap_linelist_file = find_file_path_in_yaml(
            self.cfg_yaml.get("caption_linelist"), self.root) \
            if self.cfg_yaml.get("caption_linelist") else None

        self.visual_tsv = self._get_tsv(self.cfg_yaml.get("img"))
        self.label_tsv = self._get_tsv(self.cfg_yaml.get("label"))
        self.cap_tsv = self._get_tsv(self.cfg_yaml.get("caption"))

        if self.is_composite:
            assert self.cap_linelist_file
            self.cap_line_list = [
                int(row[2]) for row in tsv_reader(self.cap_linelist_file)]
            self.img_line_list = list(range(len(self.cap_line_list)))
        elif self.cap_linelist_file:
            line_list = [list(map(int, row))
                         for row in tsv_reader(self.cap_linelist_file)]
            self.img_line_list = [r[0] for r in line_list]
            self.cap_line_list = [r[1] for r in line_list]
        else:
            n = self.cap_tsv.num_rows()
            self.img_line_list = list(range(n))
            self.cap_line_list = [0] * n

        self.use_asr = use_asr
        self.pred_mf_cap_only = pred_mf_cap_only
        self.append_pred_mf_cap = append_pred_mf_cap
        self.image_keys = self._prepare_keys()
        self.key2index = {k: i for i, k in enumerate(self.image_keys)}
        if split == "train" and cfg.data_ratio != 1:
            self._partial()

    def _get_tsv(self, name):
        if not name:
            return None
        if self.is_composite:
            return CompositeTSVFile(name, self.cap_linelist_file,
                                    root=self.root)
        return TSVFile(find_file_path_in_yaml(name, self.root))

    def _valid_tsv(self):
        return self.cap_tsv if self.cap_tsv is not None else self.visual_tsv

    def _prepare_keys(self) -> List[str]:
        tsv = self._valid_tsv()
        return [tsv.get_key(i) for i in range(tsv.num_rows())]

    def _partial(self):
        """Subset by (img,cap) line pairs (TsvCompositeDataset
        .get_partial_data, dataset.py:404-420)."""
        idx = list(range(len(self.img_line_list)))
        self.rng.shuffle(idx)
        r = self.cfg.data_ratio
        n = (int(np.ceil(len(idx) * r)) if r < 1
             else min(int(r), len(idx)))
        keep = idx[:n]
        self.img_line_list = [self.img_line_list[i] for i in keep]
        self.cap_line_list = [self.cap_line_list[i] for i in keep]

    def __len__(self):
        return len(self.img_line_list)

    def get_composite_source_idx(self) -> List[int]:
        if self.is_composite:
            return [int(row[0]) for row in tsv_reader(self.cap_linelist_file)]
        return [0] * len(self.cap_line_list)

    def get_caption(self, img_idx: int, cap_idx: int) -> str:
        row = self.cap_tsv[img_idx]
        data = json.loads(row[1])
        if isinstance(data, dict):  # MERLOT-style (dataset.py:487-506)
            if self.pred_mf_cap_only and "pred_cap_mf15" in data:
                return data["pred_cap_mf15"][0]
            cap = (data.get("captions") or [data.get("caption", "")])[0]
            if self.append_pred_mf_cap and "pred_cap_mf15" in data:
                cap += " [SEP] " + data["pred_cap_mf15"][0]
            return cap
        return data[cap_idx]["caption"]

    def get_captions_by_key(self, key: str) -> List[str]:
        img_idx = self.key2index[key]
        data = json.loads(self.cap_tsv[img_idx][1])
        if isinstance(data, dict):
            return data.get("captions") or [data.get("caption", "")]
        return [c["caption"] for c in data]

    def get_visual_frames(self, img_idx: int) -> np.ndarray:
        row = self.visual_tsv[img_idx]
        bufs = row[2:] if len(row) > 3 else [row[-1]]
        return self.frames_from_b64(bufs)

    def __getitem__(self, idx):
        img_idx = self.img_line_list[idx]
        cap_idx = self.cap_line_list[idx]
        caption = self.get_caption(img_idx, cap_idx) \
            if self.cap_tsv is not None and self.split == "train" else ""
        if self.split != "train" and self.cap_tsv is not None:
            data = json.loads(self.cap_tsv[img_idx][1])
            if isinstance(data, list) and data and "caption" in data[cap_idx]:
                caption = data[cap_idx]["caption"]
        frames = self.get_visual_frames(img_idx)
        txt, mask = self.str2txt(caption)
        return {"img": self.pad_frames(frames), "txt": txt, "mask": mask,
                "vid": self.image_keys[img_idx]}

    @property
    def prompt_text(self):
        return "write a description about the video."
