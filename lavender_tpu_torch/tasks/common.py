"""Shared task utilities (port of lavender_tpu/tasks/common.py): the
cross-entropy with an ignore index and the pretext prepend."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1) -> torch.Tensor:
    """Mean token cross-entropy over the labels != ignore_index, in f32
    (reference agent.py:72); 0 when every label is ignored."""
    flat = logits.float().reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1)
    valid = labels != ignore_index
    nll = F.cross_entropy(flat, torch.where(valid, labels, 0),
                          reduction="none")
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def prepend_pretxt(feat_txt: torch.Tensor, mask_txt: torch.Tensor,
                   feat_pre: Optional[torch.Tensor],
                   mask_pre: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Prepend task-token/prompt features to the text stream
    (model.py:292-306).  Returns (feat, mask, pretext length)."""
    if feat_pre is None:
        return feat_txt, mask_txt, 0
    feat = torch.cat([feat_pre.to(feat_txt.dtype), feat_txt], dim=1)
    mask = torch.cat([mask_pre.to(mask_txt.dtype), mask_txt], dim=1)
    return feat, mask, feat_pre.shape[1]
