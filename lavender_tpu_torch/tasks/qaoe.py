"""Open-ended video QA as MLM (port of lavender_tpu/tasks/qaoe.py;
reference main_qaoe_mlm.py, main_qaoe_mlm_lsmdc_fib.py): the text is the
question + "answer: [MASK]" (or a sentence with its blank as the [MASK]),
the answer a token of the whole vocabulary at the [MASK].

A batch holds img uint8 [B, T, H, W, 3], txt and mask [B, Lt] and mask_ans
[B, Lt] (the answer token at the [MASK], -1 elsewhere; a row whose answer
is unknown is -1 throughout and counts in no accuracy)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from lavender_tpu_torch.tasks import common


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
