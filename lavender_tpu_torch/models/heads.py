"""Task-specific heads (port of lavender_tpu/models/heads.py): the 2-layer
MLP of the reference's *_task_specific baselines (scalar match for
retrieval / RetMC / pretrain VTM, size_option for QA-MC, size_vocab for
QA-OE)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lavender_tpu_torch.models.bert import dropout


class MLPHead(nn.Module):
    """Dropout -> Linear(H, 2H) -> ReLU -> Linear(2H, out); the dropout in
    ``train()`` mode only, its mask drawn from ``generator``."""

    def __init__(self, hidden_size: int, out_dim: int, p: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(hidden_size, 2 * hidden_size)
        self.fc2 = nn.Linear(2 * hidden_size, out_dim)
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(x, self.p, self.training, generator)
        return self.fc2(F.relu(self.fc1(x)))
