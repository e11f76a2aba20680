"""Text-to-video retrieval as video-text-matching MLM (port of
lavender_tpu/tasks/retrieval.py): the B x B (clip, text) pair product, its
training loss, the in-batch eval step and the full-corpus recall metrics.

``go_feat`` runs once per batch; the clip features are repeated and the
text features tiled to form every (clip_i, text_j) pair, which go through
the fusion encoder in one batch; the MLM head scores the appended [MASK]
(the last position) as "true" or "false".
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from lavender_tpu_torch.data.dataset import TsvTaskDataset
from lavender_tpu_torch.models.lavender import LavenderModel
from lavender_tpu_torch.tasks import common


class RetrievalDataset(TsvTaskDataset):
    """Retrieval dataset: one (video, caption) per row; train-time random
    multi-caption concat (main_retrieval_task_specific.py:44-49); MLM
    variant appends a [MASK] (main_retrieval_mlm.py:20-23)."""

    def __init__(self, cfg, tokzr, split, img_tsv_path, id2lineidx, txt,
                 mlm: bool = True, **kw):
        super().__init__(cfg, tokzr, split, img_tsv_path, id2lineidx, txt, **kw)
        self.mlm = mlm
        # eval uses one caption per video (main_retrieval_task_specific.py:25-30)
        if split != "train":
            seen, first = set(), []
            for item in self.txt:
                if item["video"] not in seen:
                    seen.add(item["video"])
                    first.append(item)
            if len(first) < len(self.txt):
                self.txt = first
        self.vid2idx = {}
        for item in self.txt:
            self.vid2idx.setdefault(item["video"], len(self.vid2idx))

    @property
    def prompt_text(self):
        return "is the video-text paired, true or false?"

    def str2txt(self, s):
        txt, mask = super().str2txt(s)
        if self.mlm:
            txt, mask = self.append_mask_tok2txt(txt, mask)
        return txt, mask

    def __getitem__(self, idx):
        item = self.txt[idx]
        vid = item["video"]
        img = self.get_video(vid)
        raw = item["caption"]
        if isinstance(raw, list):
            if self.split == "train":
                ids = self.rng.sample(
                    range(len(raw)), self.rng.randint(1, len(raw)))
            else:
                ids = range(len(raw))
            raw = " ".join(raw[i] for i in ids)
        txt, mask = self.str2txt(raw)
        return {"img": self.pad_frames(img), "txt": txt, "mask": mask,
                "vid": np.int32(self.vid2idx[vid])}


def grouped_pairs(x: torch.Tensor, group: int,
                  repeat_clip: bool) -> torch.Tensor:
    """x [B, ...] -> [B * b, ...] (b = B / group): every (i, j) pair within
    each of ``group`` batch groups at row (g*b + i)*b + j, taking x[g*b + i]
    (``repeat_clip``, the clip side) or x[g*b + j] (the text side)."""
    B = x.shape[0]
    if B % group:
        raise ValueError(f"batch {B} is not a multiple of group {group}")
    b = B // group
    g = x.reshape((group, b) + x.shape[1:])
    if repeat_clip:
        g = g.repeat_interleave(b, dim=1)
    else:
        g = g.repeat((1, b) + (1,) * (x.dim() - 1))
    return g.reshape((B * b,) + x.shape[1:])


def pairwise_mlm_logits(model: LavenderModel, img: torch.Tensor,
                        txt: torch.Tensor, mask: torch.Tensor,
                        feat_pre: Optional[torch.Tensor] = None,
                        mask_pre: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        group: int = 1) -> Tuple[torch.Tensor, int]:
    """All b x b (clip_i, text_j) pairs within each of ``group`` batch
    groups (b = B / group) -> (MLM logits at the last position [B*b, 1, V],
    pretext length).  Pair (g, i, j) is row (g*b + i)*b + j.  The head runs
    on the last position only, the appended [MASK] that the retrieval loss
    reads (the JAX ``last_only=True``)."""
    fi, mi, ft, mt = model.go_feat(img, txt, mask, generator)
    ft, mt, lp = common.prepend_pretxt(ft, mt, feat_pre, mask_pre)
    out = model.go_cross(grouped_pairs(fi, group, True),
                         grouped_pairs(mi, group, True),
                         grouped_pairs(ft, group, False),
                         grouped_pairs(mt, group, False), generator)
    return model.mlm_head(out[:, -1:]), lp


def make_eval_step(true_id: int, false_id: int,
                   pretext: Optional[Callable] = None) -> Callable:
    """In-batch retrieval eval (Agent_Retrieval_MLM.step eval branch,
    main_retrieval_mlm.py:108-118): every (clip_i, text_j) pair scored at
    the appended [MASK] by ``common.true_score``, texts ranked per clip.

    Returns ``step(model, img, txt, mask, vid) -> (score [B, B], hit [B])``
    with hit 1.0 where the best text of clip i is the first of its video;
    the model runs in ``eval()`` mode (restored after) without autograd."""

    def step(model: LavenderModel, img, txt, mask, vid):
        B = img.shape[0]
        with common.evaluating(model):
            fp, mp = common.apply_pretext(pretext, model, B)
            logits, _ = pairwise_mlm_logits(model, img, txt, mask, fp, mp)
        score = common.true_score(logits[:, -1], true_id,
                                  false_id).reshape(B, B)
        gt = (vid[:, None] == vid[None, :]).int().argmax(-1)
        return score, (score.argmax(-1) == gt).float()

    return step


def make_loss_fn(true_id: int, false_id: int,
                 pretext: Optional[Callable] = None,
                 group: int = 1) -> Callable:
    """Training loss (Agent_Retrieval_MLM.step train branch): the
    cross-entropy at the appended [MASK] against "true" for the pairs of
    the same video (``batch["vid"]``) and "false" for the others.
    ``pretext`` (a ``common.make_pretext_fn`` result) leads every text;
    ``group`` independent in-batch pools (per data shard).

    Returns ``loss_fn(model, batch, generator) -> scalar``; batch holds
    img uint8 [B, T, H, W, 3], txt and mask [B, Lt], vid [B]."""

    def loss_fn(model: LavenderModel, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        img, txt, mask, vid = (batch["img"], batch["txt"], batch["mask"],
                               batch["vid"])
        B = img.shape[0]
        b = B // group
        fp, mp = common.apply_pretext(pretext, model, B, generator)
        logits, _ = pairwise_mlm_logits(model, img, txt, mask, fp, mp,
                                        generator=generator, group=group)
        gv = vid.reshape(group, b)
        same = gv[:, :, None] == gv[:, None, :]
        labels = torch.where(same, true_id, false_id).reshape(-1)
        return common.cross_entropy_ignore(logits[:, -1, :], labels)

    return loss_fn


def recall_at_k(score: np.ndarray, gt: np.ndarray,
                ks: Sequence[int] = (1, 5, 10)) -> Dict[str, float]:
    """Full-corpus retrieval metrics (eval_retrieval_mlm.py:220-241): score
    [n_txt, n_vid], gt [n_txt] the index of each text's video ->
    {"R@k": percent of texts whose video ranks below k, "MedR": median
    rank, from 1}."""
    order = np.argsort(-score, axis=1)
    rank = np.array([int(np.where(order[i] == gt[i])[0][0])
                     for i in range(len(gt))], dtype=np.int64)
    out = {f"R@{k}": float(np.mean(rank < k) * 100) for k in ks}
    out["MedR"] = float(np.median(rank + 1))
    return out
