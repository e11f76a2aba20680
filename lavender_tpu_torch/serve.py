"""Serving entry of the port: uint8 clips + text -> MLM logits.

The counterpart of the forward that ``bench.py`` times for the JAX
package: build ``LavenderModel`` on the card (or the CPU when asked),
load the weights (converted from JAX params with ``convert.from_flax``,
or a seeded random init), cast to bf16, precompute the serving caches
once (the rel-pos biases and shift masks and, under ``LVT_FOLDCACHE=1``,
the default, the LN-folded qkv and fc1 weights of the window-major
blocks), then answer requests ``(img_u8 [B, T, H, W, 3], txt [B, Lt], mask [B, Lt]) -> logits
[B, Lt, vocab]`` under the "full" mask or, for captioning, the "seq2seq"
one.  The caption decoder runs on the same model:

    server = LavenderServer(seed=0)  # Swin-B + BERT-base, on "cuda"
    logits = server(img_u8, txt, mask)
    logits = server(img_u8, txt, mask, attn_mask_type="seq2seq")
    generate = captioning.make_generate_fn(server.model, cls, sep, pad, msk)
    ids, logprob = generate(img_u8)
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from lavender_tpu_torch.config import ModelConfig
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models.lavender import LavenderModel, init_weights


class LavenderServer:
    """A loaded, cast and precomputed ``LavenderModel`` answering requests.

    ``config``: a ``lavender_tpu_torch.config.ModelConfig``, by default
    ``ModelConfig()`` (Swin-B + BERT-base).  ``device``: "cuda" unless
    the caller asks for "cpu" (the plain versions).  ``params``: the JAX
    package's params (nested dict of float32 arrays); without them the
    weights come from ``seed``.  The serving caches are
    built for clips of ``frames`` x ``size`` x ``size``; other clip sizes
    are served too, with the caches computed per call.

    A stale cache is never served: each request first compares a host
    record of the cache's source parameters (``data_ptr``, ``_version``);
    where weights changed (``load_state_dict``, an optimizer step on
    ``server.model``), the stages whose fingerprint moved are rebuilt
    before anything runs (``VideoSwin3D.refresh_serving_cache``, called by
    the backbone's forward, so the caption decoders on ``server.model``
    are guarded too).  An unchanged model costs no device work."""

    def __init__(self, config: Optional[ModelConfig] = None, *,
                 device="cuda",
                 params: Optional[Mapping] = None, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16, frames: int = 5,
                 size: int = 224):
        self.config = config if config is not None else ModelConfig()
        self.device = torch.device(device)
        model = LavenderModel(self.config)
        if params is not None:
            model.load_state_dict(from_flax(params), strict=True)
        else:
            init_weights(model, torch.Generator().manual_seed(seed))
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.model.build_serving_cache(frames, size, size)

    @torch.inference_mode()
    def __call__(self, img_u8, txt, mask,
                 attn_mask_type: str = "full") -> torch.Tensor:
        """img_u8 uint8 [B, T, H, W, 3] (or float frames already
        normalized, e.g. by ``data.transforms.device_normalize``, which the
        patch embed's general path takes); txt int [B, Lt]; mask [B, Lt]
        (1 = token, 0 = padding); ``attn_mask_type`` "full" or "seq2seq".
        Arrays or tensors; returns logits [B, Lt, vocab] on the server's
        device, in its dtype."""
        img = torch.as_tensor(img_u8, device=self.device)
        if not (img.dtype == torch.uint8 or img.is_floating_point()):
            raise ValueError(f"clips must be uint8 or float, got {img.dtype}")
        txt = torch.as_tensor(txt, device=self.device).long()
        mask = torch.as_tensor(mask, device=self.device).long()
        return self.model(img, txt, mask, attn_mask_type)
