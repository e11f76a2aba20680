"""Multiple-choice video QA as MLM (port of lavender_tpu/tasks/qamc.py;
reference main_qamc_mlm.py LAVENDER_QAMC_MLM / Agent_QAMC_MLM): the
question and every option in one text with a [MASK]; the answer is the
digit token of the right option at the [MASK], and eval compares the
logits of the option digits there.

A batch holds img uint8 [B, T, H, W, 3], txt and mask [B, Lt], mask_ans
[B, Lt] (the answer's digit token at the [MASK], -1 elsewhere) and, for
eval, ans_idx [B]."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from lavender_tpu_torch.data.dataset import TsvTaskDataset
from lavender_tpu_torch.tasks import common


class QAMCDataset(TsvTaskDataset):
    """QA-MC dataset (Dataset_QAMC_MLM, main_qamc_mlm.py:12-107): the
    question and its options in one text, the [MASK] placed per
    ``cfg.mask_pos``, the answer's digit token at the [MASK]."""
    mlm = True  # class default (subclasses/tests may bypass __init__)

    def __init__(self, cfg, tokzr, split, img_tsv_path, id2lineidx, txt,
                 mlm: bool = True, **kw):
        super().__init__(cfg, tokzr, split, img_tsv_path, id2lineidx, txt, **kw)
        # mlm=False: the task-specific classifier baseline — plain
        # tokenization, no inserted [MASK] (Dataset_QAMC_TS,
        # main_qamc_task_specific.py:12-65)
        self.mlm = mlm
        self.ans_tok_ids = tokzr.convert_tokens_to_ids(
            [f"{i}" for i in range(cfg.size_option)])

    @property
    def prompt_text(self):
        return ("which answer is correct, from "
                f"{list(range(self.cfg.size_option))}?")

    def str2txt(self, s):
        """Tokenize with the [MASK] placed per mask_pos
        (main_qamc_mlm.py:19-66)."""
        if not self.mlm:
            return TsvTaskDataset.str2txt(self, s)
        toks = self.tokzr.tokenize(s)[: self.cfg.size_txt - 1]
        padding = [self.tokzr.pad_token] * (self.cfg.size_txt - len(toks))
        tz = self.tokzr
        pos = self.cfg.mask_pos
        if pos == "append":
            toks = ([tz.cls_token] + toks + [tz.mask_token, tz.sep_token]
                    + padding)
        elif pos == "prepend":
            toks = ([tz.mask_token, tz.cls_token] + toks + [tz.sep_token]
                    + padding)
        elif pos == "replace":
            toks = [tz.mask_token] + toks + [tz.sep_token] + padding
        elif pos == "insert":
            base = [tz.cls_token] + toks + [tz.sep_token] + padding
            if len(base) < 10:
                toks = base + [tz.mask_token]
            else:
                toks = base[:10] + [tz.mask_token] + base[10:]
        else:
            raise ValueError(pos)
        ids = np.asarray(self.tokzr.convert_tokens_to_ids(toks), np.int32)
        mask = (ids != self.pad_token_id).astype(np.int32)
        return ids, mask

    def __getitem__(self, idx):
        item = self.txt[idx]
        img = self.get_video(item["video"])
        ans_idx = int(item["answer"])
        ans_tok = self.tokzr.convert_tokens_to_ids([f"{ans_idx}"])[0]
        q = item["question"]
        for i in range(self.cfg.size_option):
            q = self.concat_txt(q, f"option {i}: " + item[f"option_{i}"])
        txt, mask = self.str2txt(q)
        if not self.mlm:
            return {"img": self.pad_frames(img), "txt": txt, "mask": mask,
                    "ans": np.int32(ans_idx)}
        mask_ans = np.full(txt.shape, -1, np.int32)
        mask_ans[txt == self.mask_token_id] = ans_tok
        return {"img": self.pad_frames(img), "txt": txt, "mask": mask,
                "mask_ans": mask_ans, "ans_idx": np.int32(ans_idx)}


def make_loss_fn(pretext: Optional[Callable] = None) -> Callable:
    """Training loss: the MLM cross-entropy at the [MASK] against the
    answer's digit token.  Returns ``loss_fn(model, batch, generator)``."""

    def loss_fn(model, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        img = batch["img"]
        fp, mp = common.apply_pretext(pretext, model, img.shape[0],
                                      generator)
        logits, lp = common.fused_mlm_logits(
            model, img, batch["txt"], batch["mask"], fp, mp,
            generator=generator)
        labels = common.pad_labels_for_pretxt(batch["mask_ans"], lp)
        return common.cross_entropy_ignore(logits, labels)

    return loss_fn


def make_eval_step(ans_tok_ids: Sequence[int],
                   pretext: Optional[Callable] = None) -> Callable:
    """Eval (main_qamc_mlm.py:159-170): the logits of the option digits
    ``ans_tok_ids`` summed over the [MASK] positions.

    Returns ``step(model, img, txt, mask, mask_ans, ans_idx) -> (scores
    [B, n_opt] f32, hit [B])``, the model in ``eval()`` mode."""
    ans_ids = torch.as_tensor(list(ans_tok_ids))

    def step(model, img, txt, mask, mask_ans, ans_idx):
        with common.evaluating(model):
            fp, mp = common.apply_pretext(pretext, model, img.shape[0])
            logits, lp = common.fused_mlm_logits(model, img, txt, mask, fp,
                                                 mp)
        mask_ans = common.pad_labels_for_pretxt(mask_ans, lp)
        opt = logits[..., ans_ids.to(logits.device)].float()
        scores = torch.where((mask_ans != -1)[..., None], opt, 0.0).sum(1)
        return scores, (scores.argmax(-1) == ans_idx).float()

    return step
