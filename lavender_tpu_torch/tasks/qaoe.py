"""Open-ended video QA as MLM (port of lavender_tpu/tasks/qaoe.py;
reference main_qaoe_mlm.py, main_qaoe_mlm_lsmdc_fib.py): the text is the
question + "answer: [MASK]" (or a sentence with its blank as the [MASK]),
the answer a token of the whole vocabulary at the [MASK].

A batch holds img uint8 [B, T, H, W, 3], txt and mask [B, Lt] and mask_ans
[B, Lt] (the answer token at the [MASK], -1 elsewhere; a row whose answer
is unknown is -1 throughout and counts in no accuracy)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from lavender_tpu_torch.data.dataset import TsvTaskDataset
from lavender_tpu_torch.tasks import common


class QAOEDataset(TsvTaskDataset):
    """Dataset for open-ended QA-as-MLM (main_qaoe_mlm.py:13-88)."""
    mlm = True  # class default (subclasses/tests may bypass __init__)

    def __init__(self, cfg, tokzr, split, img_tsv_path, id2lineidx, txt,
                 label2ans: Optional[Dict] = None, mlm: bool = True, **kw):
        super().__init__(cfg, tokzr, split, img_tsv_path, id2lineidx, txt, **kw)
        # LSMDC-FiB: dataset 'answer' indexes a vocab remapped to tokens
        # (main_qaoe_mlm_lsmdc_fib.py:39-47)
        self.label2ans = label2ans
        # mlm=False: the size_vocab classifier baseline — plain question
        # tokenization, 'answer' as class index (Dataset_QAOE_TS,
        # main_qaoe_task_specific.py:12-62)
        self.mlm = mlm

    @property
    def prompt_text(self):
        return "answer the question about the video."

    def str2txt(self, s):
        """question + 'answer: [MASK]' + [SEP] (main_qaoe_mlm.py:22-39)."""
        toks = self.tokzr.tokenize(s)[: self.cfg.size_txt - 1]
        padding = [self.tokzr.pad_token] * (self.cfg.size_txt - len(toks))
        tz = self.tokzr
        toks = ([tz.cls_token] + toks
                + tz.tokenize("answer:") + [tz.mask_token]
                + [tz.sep_token] + padding)
        ids = np.asarray(tz.convert_tokens_to_ids(toks), np.int32)
        mask = (ids != self.pad_token_id).astype(np.int32)
        return ids, mask

    def answer_token_id(self, item) -> int:
        if self.cfg.size_vocab > 0:
            return int(item["answer"])
        if self.label2ans is not None:
            ans = self.label2ans[item["answer"]]
        else:
            ans = item["answer_text"]
        tid = self.tokzr.convert_tokens_to_ids([ans])[0]
        return -1 if tid == self.unk_token_id else tid

    def __getitem__(self, idx):
        item = self.txt[idx]
        vid = item["video"]
        img = self.get_video(vid)
        if not self.mlm:
            txt, mask = TsvTaskDataset.str2txt(self, item["question"])
            ans = int(item["answer"]) if self.has_video(vid) else -1
            return {"img": self.pad_frames(img), "txt": txt, "mask": mask,
                    "ans": np.int32(ans)}
        if "question" in item:
            txt, mask = self.str2txt(item["question"])
        else:  # LSMDC FiB: the [MASK] is already in the sentence
            txt, mask = TsvTaskDataset.str2txt(self, item["sentence"])
        ans_id = self.answer_token_id(item)
        if not self.has_video(vid):
            ans_id = -1  # missing video: don't count (main_qaoe_mlm.py:70-72)
        mask_ans = np.full(txt.shape, -1, np.int32)
        mask_ans[txt == self.mask_token_id] = ans_id
        return {"img": self.pad_frames(img), "txt": txt, "mask": mask,
                "mask_ans": mask_ans}


class QAOEFibDataset(QAOEDataset):
    """LSMDC fill-in-blank: the [MASK] is embedded in 'question' text
    (main_qaoe_mlm_lsmdc_fib.py:21-48)."""

    @property
    def prompt_text(self):
        return "fill in the mask to complete the sentence."

    def str2txt(self, s):
        # plain padded tokenization; the mask token comes with the sentence
        s = s.replace("[MASK]", self.tokzr.mask_token)
        return TsvTaskDataset.str2txt(self, s)


def make_loss_fn(pretext: Optional[Callable] = None) -> Callable:
    """Training loss: the MLM cross-entropy at the [MASK] against the
    answer token.  Returns ``loss_fn(model, batch, generator)``."""

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


def make_eval_step(topk: int = 5,
                   pretext: Optional[Callable] = None) -> Callable:
    """Top-1 and top-``topk`` accuracy at the masked position
    (main_qaoe_mlm_lsmdc_fib.py:115-126; one [MASK] a row).

    Returns ``step(model, img, txt, mask, mask_ans) -> (acc1 [B], acck [B],
    valid [B])``, acc 0 where the row has no answer, the model in
    ``eval()`` mode."""

    def step(model, img, txt, mask, mask_ans):
        with common.evaluating(model):
            fp, mp = common.apply_pretext(pretext, model, img.shape[0])
            logits, lp = common.fused_mlm_logits(model, img, txt, mask, fp,
                                                 mp)
        mask_ans = common.pad_labels_for_pretxt(mask_ans, lp)
        pos = (mask_ans != -1).int().argmax(1)  # the first masked position
        rows = torch.arange(img.shape[0], device=pos.device)
        row_logits = logits[rows, pos].float()  # [B, V]
        ans = mask_ans[rows, pos]
        hit = row_logits.topk(topk, dim=-1).indices == ans[:, None]
        valid = ans != -1
        return ((valid & hit[:, 0]).float(), (valid & hit.any(1)).float(),
                valid)

    return step
