"""Frame decode + clip transforms (port of lavender_tpu/data/transforms.py).

Behavioral reference: dataset.py:107-186 (pad_resize / img_center_crop /
img_rand_crop / vid_*_crop) and visbackbone/video_transform.py (Resize,
CenterCrop, RandomCrop, ClipToTensor, Normalize).

Two paths:
* **host path** (base64 -> JPEG decode -> PIL bilinear resize -> crop, exact
  torchvision semantics): uint8 frames, the numpy functions below;
* **device path** (:func:`device_normalize`): uint8 frames already sized go
  to the card, which normalizes them there, so the host-to-device copy stays
  uint8 (4x fewer bytes than f32).

The host path's JPEG decoder is picked once, explicitly, and logged
(:func:`decoder`): OpenCV where ``cv2`` imports, else PIL, the order of the
JAX package's ``str2img``.  PIL and cv2 are imported inside the functions,
so importing this module needs neither.
"""
from __future__ import annotations

import base64
import io
import logging
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from lavender_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

log = logging.getLogger(__name__)

_DECODER: Optional[str] = None


def decoder() -> str:
    """The host path's JPEG decoder, "cv2" or "pil", picked at first use
    and logged with the reason: cv2 where it imports (JAX ``str2img``
    tries it first), else PIL.  Raises ImportError when neither imports."""
    global _DECODER
    if _DECODER is None:
        try:
            import cv2  # noqa: F401
            _DECODER = "cv2"
            log.info("JPEG decode: cv2 %s", cv2.__version__)
        except ImportError as e:
            import PIL  # raises when neither decoder is installed
            _DECODER = "pil"
            log.warning("JPEG decode: PIL %s (cv2 does not import: %s)",
                        PIL.__version__, e)
    return _DECODER


def str2img(b: str) -> np.ndarray:
    """base64 JPEG -> RGB uint8 HWC (reference dataset.py:177-186), with
    :func:`decoder`'s library; bytes it cannot decode raise ValueError."""
    raw = base64.b64decode(b)
    if decoder() == "cv2":
        import cv2
        arr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        if arr is None:
            raise ValueError("cv2 cannot decode the frame")
        return arr[:, :, ::-1].copy()  # BGR -> RGB
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def _pil(img: np.ndarray):
    from PIL import Image
    return Image.fromarray(img)


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the shorter side == size, keep aspect (torchvision Resize)."""
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = size, max(1, int(round(size * w / h)))
    else:
        nh, nw = max(1, int(round(size * h / w))), size
    if (nh, nw) == (h, w):
        return img
    from PIL import Image
    return np.asarray(_pil(img).resize((nw, nh), Image.BILINEAR))


def resize_exact(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image
    return np.asarray(_pil(img).resize((size_hw[1], size_hw[0]), Image.BILINEAR))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return img[top:top + size, left:left + size]


def random_crop(img: np.ndarray, size: int,
                rng: Optional[random.Random] = None) -> np.ndarray:
    rng = rng or random
    h, w = img.shape[:2]
    top = rng.randint(0, max(0, h - size))
    left = rng.randint(0, max(0, w - size))
    return img[top:top + size, left:left + size]


def pad_to_square(img: np.ndarray) -> np.ndarray:
    """Symmetric zero-pad to square (reference pad_resize, dataset.py:107-118)."""
    h, w = img.shape[:2]
    if h == w:
        return img
    if w > h:
        pad = (w - h) // 2
        return np.pad(img, ((pad, w - h - pad), (0, 0), (0, 0)))
    pad = (h - w) // 2
    return np.pad(img, ((0, 0), (pad, h - w - pad), (0, 0)))


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in ImageNet-normalized space."""
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def img_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    return center_crop(resize_shorter(img, size), size)


def img_rand_crop(img: np.ndarray, size: int,
                  rng: Optional[random.Random] = None) -> np.ndarray:
    return random_crop(resize_shorter(img, size), size, rng)


def pad_resize(img: np.ndarray, size: int) -> np.ndarray:
    return resize_exact(pad_to_square(img), (size, size))


def transform_clip(frames: Sequence[np.ndarray], size: int, mode: str,
                   train: bool, rng: Optional[random.Random] = None
                   ) -> np.ndarray:
    """Apply a per-clip spatial transform; returns uint8 [T, size, size, 3].

    Mirrors the dispatch in dataset.py:218-256.  For ``vid_*_crop`` the same
    crop window is used for all frames of the clip (torch_videovision
    semantics); the ``img_*`` variants crop each frame independently.
    """
    rng = rng or random
    if mode in ("vid_rand_crop", "vid_center_crop"):
        frames = [resize_shorter(f, size) for f in frames]
        h, w = frames[0].shape[:2]
        if mode == "vid_rand_crop" and train:
            top = rng.randint(0, max(0, h - size))
            left = rng.randint(0, max(0, w - size))
        else:
            top, left = int(round((h - size) / 2.0)), int(round((w - size) / 2.0))
        out = [f[top:top + size, left:left + size] for f in frames]
    elif mode == "pad_resize":
        out = [pad_resize(f, size) for f in frames]
    elif mode == "img_rand_crop" and train:
        out = [img_rand_crop(f, size, rng) for f in frames]
    else:  # img_center_crop (and eval fallback)
        out = [img_center_crop(f, size) for f in frames]
    return np.stack(out, axis=0)


# ---- temporal sampling (reference dataset.py:188-216) ----

def uniform_indices(start: int, end: int, n: int) -> List[int]:
    """n indices evenly spread over [start, end] inclusive (dataset.py:188)."""
    if n == 1:
        return [int(round((start + end) / 2.0))]
    step = (end - start) / float(n - 1)
    return [int(round(start + i * step)) for i in range(n)]


def temporal_sample_indices(num_available: int, size_frame: int,
                            random_sample: bool = False,
                            rng: Optional[random.Random] = None) -> List[int]:
    """Sparse frame sampling (dataset.py:196-216): eval takes a uniform
    spread over the whole clip; train picks a random strided offset."""
    rng = rng or random
    if num_available == 1 or size_frame == num_available:
        return list(range(num_available))
    n = min(size_frame, num_available)
    size_clips = int(np.ceil(num_available / n))
    if random_sample:
        start = rng.randrange(size_clips)
        end = min(start + (n - 1) * size_clips, num_available - 1)
    else:
        start, end = 0, num_available - 1
    return uniform_indices(start, end, n)


def multi_clip_indices(num_available: int, size_frame: int,
                       max_clips: int = 8) -> List[List[int]]:
    """Multi-clip eval sampling (eval_retrieval_task_specific.py:24-58):
    split the video into ceil(N/size_frame) strided clips."""
    if num_available <= size_frame:
        return [list(range(num_available))]
    size_clips = int(np.ceil(num_available / size_frame))
    size_clips = min(size_clips, max_clips)
    clips = []
    for start in range(size_clips):
        end = min(start + (size_frame - 1) * size_clips, num_available - 1)
        clips.append(uniform_indices(start, end, size_frame))
    return clips


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
