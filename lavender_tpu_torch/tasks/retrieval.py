"""Text-to-video retrieval as video-text-matching MLM (port of
lavender_tpu/tasks/retrieval.py): the B x B (clip, text) pair product and
its training loss.

``go_feat`` runs once per batch; the clip features are repeated and the
text features tiled to form every (clip_i, text_j) pair, which go through
the fusion encoder in one batch; the MLM head scores the appended [MASK]
(the last position) as "true" or "false".
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from lavender_tpu_torch.models.lavender import LavenderModel
from lavender_tpu_torch.tasks import common


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
    B = img.shape[0]
    if B % group:
        raise ValueError(f"batch {B} is not a multiple of group {group}")
    b = B // group
    fi, mi, ft, mt = model.go_feat(img, txt, mask, generator)
    ft, mt, lp = common.prepend_pretxt(ft, mt, feat_pre, mask_pre)

    def pairs(x: torch.Tensor, repeat_clip: bool) -> torch.Tensor:
        g = x.reshape((group, b) + x.shape[1:])
        if repeat_clip:
            g = g.repeat_interleave(b, dim=1)
        else:
            g = g.repeat((1, b) + (1,) * (x.dim() - 1))
        return g.reshape((B * b,) + x.shape[1:])

    out = model.go_cross(pairs(fi, True), pairs(mi, True), pairs(ft, False),
                         pairs(mt, False), generator)
    return model.mlm_head(out[:, -1:]), lp


def make_loss_fn(true_id: int, false_id: int, group: int = 1) -> Callable:
    """Training loss (Agent_Retrieval_MLM.step train branch): the
    cross-entropy at the appended [MASK] against "true" for the pairs of
    the same video (``batch["vid"]``) and "false" for the others.

    Returns ``loss_fn(model, batch, generator) -> scalar``; batch holds
    img uint8 [B, T, H, W, 3], txt and mask [B, Lt], vid [B]."""

    def loss_fn(model: LavenderModel, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        img, txt, mask, vid = (batch["img"], batch["txt"], batch["mask"],
                               batch["vid"])
        b = img.shape[0] // group
        logits, _ = pairwise_mlm_logits(model, img, txt, mask,
                                        generator=generator, group=group)
        gv = vid.reshape(group, b)
        same = gv[:, :, None] == gv[:, None, :]
        labels = torch.where(same, true_id, false_id).reshape(-1)
        return common.cross_entropy_ignore(logits[:, -1, :], labels)

    return loss_fn
