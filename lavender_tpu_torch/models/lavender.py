"""LAVENDER core model (port of lavender_tpu/models/lavender.py): Video
Swin + adapter over uint8 clips, BERT text embeddings (``go_feat``), the
fusion encoder over [video; (pretext); text] (``go_cross``) and the MLM
head (``mlm_head``), plus the pretext features (``task_feat``,
``encode_prompt``).  ``forward`` is the serving composition; the task
losses call the parts separately (``tasks/``, ``models/captioning.py``).
In ``train()`` mode dropout and drop-path draw from the ``generator`` the
parts take.

Ported variants: EncVideo with the frame-order (``odr``) and per-frame
visual mask (``vt_mask``) inputs of pretraining, and the SwinBERT adapter
(``ModelConfig.swinbert``: fc to 512, ``img_embedding`` to the hidden
size, a zero [CLS] per frame whose mask entry is 0), EncTxt embeddings-only or with its text transformer
(``txt_backbone_embed_only=False``, under a full or a causal mask), and
the "full" and "seq2seq" cross masks.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lavender_tpu_torch.config import TASK_TOK2ID
from lavender_tpu_torch.models.bert import (
    BertEmbeddings, BertEncoder, BertMLMHead, extended_attention_mask)
from lavender_tpu_torch.models.swin3d import VideoSwin3D
from lavender_tpu_torch.ops import layer_norm


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``: LayerNorms at unit scale and zero
    shift, every other parameter N(0, 0.02^2) (BERT's initializer range)."""
    for mod in model.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            continue
        for p in mod.parameters(recurse=False):
            p.normal_(0.0, 0.02, generator=generator)
    return model


def build_cross_mask(mask_img: torch.Tensor, mask_txt: torch.Tensor,
                     attn_mask_type: str = "full",
                     mask_pretxt: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Joint mask over [video; (pretext); text] (reference model.py:194-221):
    the key mask [B, L] for "full"; for "seq2seq" [B, L, L] int32, where
    every row sees the video and pretext keys that their masks keep and
    the text rows see the text causally (video and pretext rows see no
    text; the text's own mask is not read, as in the reference)."""
    full = mask_img if mask_pretxt is None else torch.cat(
        [mask_img, mask_pretxt.to(mask_img.dtype)], dim=1)
    if attn_mask_type == "full":
        return torch.cat([full, mask_txt.to(full.dtype)], dim=1)
    if attn_mask_type != "seq2seq":
        raise ValueError(f"attn_mask_type must be 'full' or 'seq2seq', got "
                         f"{attn_mask_type!r}")
    B, Lf = full.shape
    Lt = mask_txt.shape[1]
    mask = torch.zeros(B, Lf + Lt, Lf + Lt, dtype=torch.int32,
                       device=full.device)
    mask[:, :, :Lf] = full[:, None, :].to(torch.int32)
    mask[:, Lf:, Lf:] = torch.ones(Lt, Lt, dtype=torch.int32,
                                   device=full.device).tril()
    return mask


class EncVideo(nn.Module):
    """Swin features -> BERT token space: fc, a per-frame [CLS], spatial
    and temporal position embeddings, LN, flattened to [B, T*(1+hw), H].

    ``ModelConfig.swinbert`` (reference model.py:32-35, 52-67): fc to 512,
    then ``img_embedding`` to the hidden size, and a zero [CLS] per frame
    whose mask entry is 0; no position or length embeddings, no LN, and
    ``odr`` / ``vt_mask`` are not read."""

    def __init__(self, config):
        super().__init__()
        self.swin = VideoSwin3D(config.swin)
        hidden = config.hidden_size
        latent = config.swin.num_features
        self.swinbert = config.swinbert
        if self.swinbert:
            self.fc = nn.Linear(latent, 512)
            self.img_embedding = nn.Linear(512, hidden)
            return
        self.fc = nn.Linear(latent, hidden) if latent != hidden else None
        self.emb_cls = nn.Parameter(torch.zeros(1, 1, 1, hidden))
        self.emb_pos = nn.Parameter(
            torch.zeros(1, 1, 1 + config.max_size_patch ** 2, hidden))
        self.emb_len = nn.Parameter(
            torch.zeros(1, config.max_size_frame, 1, hidden))
        self.emb_odr = nn.Parameter(torch.zeros(1, 1, 1, hidden))
        self.norm = nn.LayerNorm(hidden, eps=1e-5)

    def forward(self, img: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                odr: Optional[torch.Tensor] = None,
                vt_mask: Optional[torch.Tensor] = None):
        """img [B, T, H, W, 3], uint8 or normalized float -> (features
        [B, Lv, H], mask [B, Lv]).

        ``odr`` [B, T] (frame-order pretraining, reference model.py:72-81):
        frame t takes its ``emb_len`` row where odr[b, t] == t, else
        ``emb_odr``.  ``vt_mask`` (broadcast to [B, T, 1 + hw]) multiplies
        the visual mask."""
        B, T = img.shape[:2]
        f = self.swin(img, generator)
        hw = f.shape[2] * f.shape[3]  # H/32 x W/32, rounded up by the pads
        f = f.reshape(B, T, hw, -1)
        if self.swinbert:
            f = self.img_embedding(self.fc(f))
            f = torch.cat([f.new_zeros(B, T, 1, f.shape[-1]), f], dim=2)
            m = torch.ones(B, T, 1 + hw, dtype=torch.long, device=img.device)
            m[:, :, 0] = 0
            return f.reshape(B, T * (1 + hw), -1), m.reshape(B, T * (1 + hw))
        if self.fc is not None:
            f = self.fc(f)
        cls = self.emb_cls.to(f.dtype).expand(B, T, 1, f.shape[-1])
        f = torch.cat([cls, f], dim=2)
        f = f + self.emb_pos[:, :, :1 + hw]
        emb_len = self.emb_len[:, :T]
        if odr is not None:
            match = (odr == torch.arange(T, device=odr.device)).to(
                f.dtype)[:, :, None, None]
            emb_len = match * emb_len + (1.0 - match) * self.emb_odr
        f = layer_norm(f + emb_len, self.norm.weight, self.norm.bias,
                       self.norm.eps)
        m = torch.ones(B, T, 1 + hw, dtype=torch.long, device=img.device)
        if vt_mask is not None:
            m = m * vt_mask.long()
        return f.reshape(B, T * (1 + hw), -1), m.reshape(B, T * (1 + hw))


class EncTxt(nn.Module):
    """Text encoder: BERT embeddings, then with
    ``txt_backbone_embed_only=False`` a BERT encoder ``txt_trsfr`` (the
    fusion encoder's layers, its own weights) under the text mask, or
    causally under "seq2seq" (reference model.py:96-142)."""

    def __init__(self, config):
        super().__init__()
        self.emb_txt = BertEmbeddings(config.bert)
        self.txt_trsfr = (None if config.txt_backbone_embed_only
                          else BertEncoder(config.bert))

    def forward(self, txt: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                mask_txt: Optional[torch.Tensor] = None,
                attn_mask_type: str = "full") -> torch.Tensor:
        f = self.emb_txt(txt, generator)
        if self.txt_trsfr is None:
            return f
        if attn_mask_type == "seq2seq":
            B, Lt = txt.shape
            m = torch.ones(Lt, Lt, dtype=torch.long,
                           device=txt.device).tril().expand(B, Lt, Lt)
        else:
            m = torch.ones_like(txt) if mask_txt is None else mask_txt
        return self.txt_trsfr(f, extended_attention_mask(m), generator)


class LavenderModel(nn.Module):
    """All tasks as MLM through one head: uint8 clips [B, T, H, W, 3],
    token ids [B, Lt] and their mask [B, Lt] -> logits [B, Lt, vocab]."""

    def __init__(self, config):
        super().__init__()
        self.enc_txt = EncTxt(config)
        self.trsfr = BertEncoder(config.bert)
        self.enc_img = EncVideo(config)
        self.fc_mtm = BertMLMHead(config.bert)
        self.emb_task = nn.Parameter(
            torch.zeros(config.num_task_tokens, config.hidden_size))

    def build_serving_cache(self, frames: int, height: int, width: int):
        """Precompute the Swin stages' rel-pos biases and shift masks for
        clips [*, frames, height, width, 3], on the weights' device and
        dtype (call after ``.to``; rebuild after changing the weights)."""
        self.enc_img.swin.build_serving_cache(frames, height, width)

    def go_feat(self, img: torch.Tensor, txt: torch.Tensor,
                mask: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                odr: Optional[torch.Tensor] = None,
                vt_mask: Optional[torch.Tensor] = None,
                attn_mask_type: str = "full"):
        """Encode both modalities -> (feat_img [B, Lv, H], mask_img [B, Lv],
        feat_txt [B, Lt, H], mask [B, Lt]) (reference model.py:185-192);
        ``odr`` and ``vt_mask`` go to ``EncVideo``, ``attn_mask_type`` to
        the text transformer."""
        feat_img, mask_img = self.enc_img(img, generator, odr=odr,
                                          vt_mask=vt_mask)
        feat_txt = self.enc_txt(txt, generator, mask_txt=mask,
                                attn_mask_type=attn_mask_type)
        return feat_img, mask_img, feat_txt, mask

    def go_cross(self, feat_img: torch.Tensor, mask_img: torch.Tensor,
                 feat_txt: torch.Tensor, mask_txt: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 attn_mask_type: str = "full",
                 feat_pretxt: Optional[torch.Tensor] = None,
                 mask_pretxt: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """The fusion encoder over [video; (pretext); text] under the
        ``attn_mask_type`` mask (reference model.py:223-243).  Pretext
        features given alone are counted in ``mask_txt``; with
        ``mask_pretxt`` they already lead ``feat_txt`` and their mask joins
        the video's (the seq2seq prefix)."""
        parts = [feat_img, feat_txt]
        if feat_pretxt is not None and mask_pretxt is None:
            parts.insert(1, feat_pretxt)
            mask = build_cross_mask(mask_img, mask_txt, attn_mask_type)
        else:
            mask = build_cross_mask(mask_img, mask_txt, attn_mask_type,
                                    mask_pretxt)
        feat = torch.cat([t.to(feat_img.dtype) for t in parts], dim=1)
        if feat.shape[1] != mask.shape[-1]:
            raise ValueError(f"features ({feat.shape[1]}) and mask "
                             f"({mask.shape[-1]}) differ in length")
        return self.trsfr(feat, extended_attention_mask(mask), generator)

    def mlm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.fc_mtm(hidden)

    def task_feat(self, task_name: str, batch_size: int):
        """The learned task token of ``task_name`` and its mask: ([B, 1, H],
        [B, 1]) (reference model.py:248-265)."""
        feat = self.emb_task[TASK_TOK2ID[task_name]]
        feat = feat.expand(batch_size, 1, feat.shape[-1])
        return feat, torch.ones(batch_size, 1, dtype=torch.long,
                                device=feat.device)

    def encode_prompt(self, prompt_txt: torch.Tensor, batch_size: int,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Prompt token ids [Lp] or [1, Lp] (or [B, Lp]) through the text
        encoder, broadcast over the batch (reference model.py:266-288)."""
        if prompt_txt.dim() == 1:
            prompt_txt = prompt_txt[None]
        feat = self.enc_txt(prompt_txt, generator)
        if feat.shape[0] == 1 and batch_size > 1:
            feat = feat.expand(batch_size, *feat.shape[1:])
        return feat

    def forward(self, img: torch.Tensor, txt: torch.Tensor,
                mask: torch.Tensor, attn_mask_type: str = "full"
                ) -> torch.Tensor:
        """MLM logits on the text slice [B, Lt, vocab] under the "full" or
        "seq2seq" mask."""
        feat_img, mask_img, feat_txt, mask_txt = self.go_feat(
            img, txt, mask, attn_mask_type=attn_mask_type)
        out = self.go_cross(feat_img, mask_img, feat_txt, mask_txt,
                            attn_mask_type=attn_mask_type)
        return self.mlm_head(out[:, feat_img.shape[1]:])
