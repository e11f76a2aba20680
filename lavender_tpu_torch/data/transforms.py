"""Frame transforms (port of lavender_tpu/data/transforms.py): so far the
device-side normalize that the patch embed's general path takes."""
from __future__ import annotations

from typing import Optional

import torch

from lavender_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD


def device_normalize(frames_u8: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> (u / 255 - mean) / std in f32 on the
    tensor's device, cast to ``dtype`` when given (JAX
    ``device_normalize``, transforms.py:182): the host-to-device copy stays
    uint8."""
    x = frames_u8.float() / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    x = (x - mean) / std
    return x if dtype is None else x.to(dtype)
