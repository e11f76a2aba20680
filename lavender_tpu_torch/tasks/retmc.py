"""Retrieval-style multiple choice (port of lavender_tpu/tasks/retmc.py;
reference main_retmc_mlm.py): each of O option texts is scored "true" /
"false" at its own appended [MASK]; eval picks the option with the
highest ``common.true_score``.

A batch holds img uint8 [B, T, H, W, 3], txt and mask [B, O, Lt], mask_ans
[B, O, Lt] ("true" / "false" at each option's [MASK], -1 elsewhere) and,
for eval, ans_idx [B]."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from lavender_tpu_torch.data.dataset import TsvTaskDataset
from lavender_tpu_torch.tasks import common


class RetMCDataset(TsvTaskDataset):
    """Retrieval-style MC dataset (Dataset_RetMC_MLM, main_retmc_mlm.py:
    11-69): one text per option, each with an appended [MASK] labelled
    "true" (the answer) or "false"."""
    mlm = True  # class default (subclasses/tests may bypass __init__)

    def __init__(self, cfg, tokzr, split, img_tsv_path, id2lineidx, txt,
                 mlm: bool = True, **kw):
        super().__init__(cfg, tokzr, split, img_tsv_path, id2lineidx, txt, **kw)
        # mlm=False: scalar-head baseline — no appended [MASK]
        # (Dataset_RetMC_TS, main_retmc_task_specific.py:12-39)
        self.mlm = mlm

    @property
    def prompt_text(self):
        return "is the video-text matched, true or false?"

    def str2txt(self, s):
        txt, mask = super().str2txt(s)
        if not self.mlm:
            return txt, mask
        return self.append_mask_tok2txt(txt, mask)

    def __getitem__(self, idx):
        item = self.txt[idx]
        img = self.get_video(item["video"])
        ans_idx = int(item["answer"])
        q = item.get("question", "")
        txts, masks, mask_ans = [], [], []
        for i in range(self.cfg.size_option):
            option = (q + " " + item[f"option_{i}"]) if q else item[f"option_{i}"]
            t, m = self.str2txt(option)
            ma = np.full(t.shape, -1, np.int32)
            ma[t == self.mask_token_id] = (
                self.true_token_id if i == ans_idx else self.false_token_id)
            txts.append(t), masks.append(m), mask_ans.append(ma)
        out = {"img": self.pad_frames(img),
               "txt": np.stack(txts), "mask": np.stack(masks),
               "mask_ans": np.stack(mask_ans), "ans_idx": np.int32(ans_idx)}
        if not self.mlm:
            out.pop("mask_ans")
            out["ans"] = out.pop("ans_idx")
        return out


class QAMCHeadDataset(RetMCDataset):
    """MC-QA scored per-option as VTM true/false: one (video, question +
    option) pair per option (Dataset_QAMC_MLM_Head,
    main_qamc_mlm_head.py:12-96; the TGIF flow that generates the digit
    instead is ``tasks/qamc.py``)."""


def option_logits(model, img: torch.Tensor, txt: torch.Tensor,
                  mask: torch.Tensor,
                  feat_pre: Optional[torch.Tensor] = None,
                  mask_pre: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  last_only: bool = False) -> torch.Tensor:
    """img [B, T, H, W, 3], txt / mask [B, O, Lt] -> MLM logits [B*O,
    Lp + Lt, V] (``last_only``: [B*O, 1, V], the head at the appended
    [MASK] alone) (LAVENDER_RetMC_MLM.forward, main_retmc_mlm.py:90-112):
    the clip is encoded once and its features repeated per option; the
    pretext (batch B*O) leads each option's text."""
    B, O, L = txt.shape
    fi, mi, ft, mt = model.go_feat(img, txt.reshape(B * O, L),
                                   mask.reshape(B * O, L), generator)
    ft, mt, _ = common.prepend_pretxt(ft, mt, feat_pre, mask_pre)
    out = model.go_cross(fi.repeat_interleave(O, 0),
                         mi.repeat_interleave(O, 0), ft, mt, generator)
    return model.mlm_head(out[:, -1:] if last_only else out[:, fi.shape[1]:])


def make_loss_fn(pretext: Optional[Callable] = None) -> Callable:
    """Training loss: the cross-entropy at every option's [MASK] against
    its "true" / "false".  Returns ``loss_fn(model, batch, generator)``."""

    def loss_fn(model, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, O, L = batch["txt"].shape
        fp, mp = common.apply_pretext(pretext, model, B * O, generator)
        logits = option_logits(model, batch["img"], batch["txt"],
                               batch["mask"], fp, mp, generator)
        labels = common.pad_labels_for_pretxt(
            batch["mask_ans"].reshape(B * O, L),
            0 if fp is None else fp.shape[1])
        return common.cross_entropy_ignore(logits, labels)

    return loss_fn


def make_eval_step(true_id: int, false_id: int,
                   pretext: Optional[Callable] = None) -> Callable:
    """Eval: ``step(model, img, txt, mask, mask_ans, ans_idx) -> (score
    [B, O], hit [B])``, the score of each option at its appended [MASK],
    the model in ``eval()`` mode."""

    def step(model, img, txt, mask, mask_ans, ans_idx):
        B, O, _ = txt.shape
        with common.evaluating(model):
            fp, mp = common.apply_pretext(pretext, model, B * O)
            logits = option_logits(model, img, txt, mask, fp, mp,
                                   last_only=True)
        score = common.true_score(logits[:, -1], true_id,
                                  false_id).reshape(B, O)
        return score, (score.argmax(-1) == ans_idx).float()

    return step
