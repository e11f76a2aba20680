"""Ops of the PyTorch port: the ported TPU kernels and their layout ops."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """LayerNorm over the last dim with f32 statistics, result in x.dtype
    (flax's LayerNorm also reduces in f32 for bf16 inputs); ``weight`` and
    ``bias`` None: the pure normalize."""
    return F.layer_norm(x.float(), x.shape[-1:],
                        None if weight is None else weight.float(),
                        None if bias is None else bias.float(),
                        eps).to(x.dtype)
