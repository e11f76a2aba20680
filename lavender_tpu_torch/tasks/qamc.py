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

import torch

from lavender_tpu_torch.tasks import common


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
