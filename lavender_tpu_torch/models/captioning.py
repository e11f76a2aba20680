"""Captioning (port of lavender_tpu/models/captioning.py): the MLM loss
under the seq2seq mask, and caption decoding with a static KV cache.

Training (``make_caption_loss_fn``): ``caption_masking`` hides 15% of the
caption's tokens, the model reads [video; (pretext); text] under the
seq2seq mask (video rows blind to text, text causal), and the loss is
the label-smoothed KL at the hidden tokens.  In ``train()`` mode the fusion
encoder takes its train route under that [B, L, L] mask (K10a/K10b + K11
on the default ``fused_attn_train=True``).

Decoding (``make_generate_fn``), as the JAX package runs it: the video
prefix (plus a task token or prompt) goes through the encoder once
(``BertEncoder.prefill``, serving route: K4 + K5 per layer), then each of
``max_gen_length - 1`` steps feeds two positions, the previous token and
[MASK], at text positions (t-1, t) against the cache (module-math
attention, K5 FFN), and takes the next token from the MLM logits at the
[MASK]: greedy, or sampled from ``top_k_top_p_filter``'s support with an
explicit ``torch.Generator`` (the bits cannot be ``jax.random``'s), with
the CTRL repetition penalty.  Under the causal text mask this is exactly
the reference's re-encode decoder (model_for_captioning.py:239-296), which
``rencode_generate_reference`` runs for comparison: the whole [video;
text] sequence again for every token, through the full-mask sub-block K6.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lavender_tpu_torch.models.bert import extended_attention_mask
from lavender_tpu_torch.tasks import common


def caption_masking(txt: np.ndarray, pad_token_id: int, mask_token_id: int,
                    p_mask: float = 0.15,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Caption-train text masking (reference main_caption.py:62-79): each
    token that is neither pad nor [MASK] becomes [MASK] with probability
    ``p_mask`` (CLS and SEP too).  Returns (masked ids, labels: the hidden
    token where masked, else -1), both int32."""
    rng = rng or np.random
    special = (txt == pad_token_id) | (txt == mask_token_id)
    hit = (rng.rand(*txt.shape) < p_mask) & ~special
    ans_mtm = np.where(hit, txt, -1).astype(np.int32)
    masked = np.where(hit, mask_token_id, txt).astype(np.int32)
    return masked, ans_mtm


def make_caption_loss_fn(label_smoothing: float = 0.1,
                         drop_worst_ratio: float = 0.0,
                         pretext: Optional[Callable] = None) -> Callable:
    """Training loss (model_for_captioning.py:61-93): the MLM under the
    seq2seq mask + ``common.label_smoothed_kl_loss``.

    Returns ``loss_fn(model, batch, generator) -> scalar`` (the signature
    ``train.trainer.make_train_step`` takes); batch holds img uint8
    [B, T, H, W, 3], txt (masked ids) and mask [B, Lt], ans_mtm [B, Lt]
    (-1 = not a target); ``pretext`` a ``common.make_pretext_fn`` result."""

    def loss_fn(model, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        img = batch["img"]
        fp, mp = common.apply_pretext(pretext, model, img.shape[0], generator)
        logits, lp = common.fused_mlm_logits(
            model, img, batch["txt"], batch["mask"], fp, mp,
            attn_mask_type="seq2seq", generator=generator)
        labels = common.pad_labels_for_pretxt(batch["ans_mtm"], lp)
        return common.label_smoothed_kl_loss(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
            label_smoothing, drop_worst_ratio)

    return loss_fn


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 0,
                       top_p: float = 1.0,
                       min_tokens_to_keep: int = 1) -> torch.Tensor:
    """The top-k / nucleus filter (model_for_captioning.py:502-534) in f32:
    logits outside the k largest, and outside the smallest prefix of the
    sorted probabilities whose sum exceeds ``top_p``, become -inf."""
    logits = logits.float()
    V = logits.shape[-1]
    if top_k > 0:
        k = min(max(top_k, min_tokens_to_keep), V)
        kth = torch.topk(logits, k).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits, idx = torch.sort(logits, dim=-1, descending=True,
                                        stable=True)
        remove = torch.softmax(sorted_logits, dim=-1).cumsum(-1) > top_p
        if min_tokens_to_keep > 1:
            remove[..., :min_tokens_to_keep] = False
        # shift right: the token that crosses the threshold stays
        remove = torch.cat([torch.zeros_like(remove[..., :1]),
                            remove[..., :-1]], dim=-1)
        logits = logits.masked_fill(
            torch.zeros_like(remove).scatter(-1, idx, remove), float("-inf"))
    return logits


class GenerateConfig(NamedTuple):
    max_gen_length: int = 20
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0


def _go_feat_video(model, img: torch.Tensor):
    """The video features and mask of ``img`` (go_feat with a dummy text)."""
    B = img.shape[0]
    dummy = torch.ones(B, 1, dtype=torch.long, device=img.device)
    fi, mi, _, _ = model.go_feat(img, dummy, dummy)
    return fi, mi


def make_generate_fn(model, cls_token_id: int, sep_token_id: int,
                     pad_token_id: int, mask_token_id: int,
                     gen: GenerateConfig = GenerateConfig(),
                     use_task_token: bool = False) -> Callable:
    """A caption decoder with a static KV cache (model_for_captioning.py:
    374-498 with the cache path enabled).

    Returns ``generate(img, generator=None, prompt_txt=None) -> (ids
    [B, max_gen_length] int64, mean log-prob [B] f32)``: img uint8
    [B, T, H, W, 3]; ``generator`` the sampling stream (``do_sample``);
    ``prompt_txt`` prompt token ids [Lp] prefixed to the video unless
    ``use_task_token`` prefixes the "cap" task token.  ``model`` is a
    ``LavenderModel`` in ``eval()`` mode (the serving route, e.g.
    ``serve.LavenderServer(...).model``); the ids start with [CLS], a
    finished caption is padded after its [SEP], and one still running
    after the last step ends in a forced [SEP]."""
    max_len = gen.max_gen_length

    @torch.inference_mode()
    def generate(img, generator: Optional[torch.Generator] = None,
                 prompt_txt=None):
        if model.training:
            raise ValueError("make_generate_fn: the model must be in eval() "
                             "mode (the serving route)")
        dev = model.emb_task.device
        img = torch.as_tensor(img, device=dev)
        B = img.shape[0]
        fi, mi = _go_feat_video(model, img)
        fp = mp = None
        if use_task_token:
            fp, mp = model.task_feat("cap", B)
        elif prompt_txt is not None:
            fp = model.encode_prompt(
                torch.as_tensor(prompt_txt, device=dev).long(), B)
            mp = torch.ones(fp.shape[:2], dtype=torch.long, device=dev)
        if fp is not None:
            prefix = torch.cat([fi, fp.to(fi.dtype)], dim=1)
            prefix_mask = torch.cat([mi, mp.to(mi.dtype)], dim=1)
        else:
            prefix, prefix_mask = fi, mi
        Lp = prefix.shape[1]
        # prefix rows see the prefix only (the seq2seq mask's video block)
        _, caches = model.trsfr.prefill(
            prefix, extended_attention_mask(prefix_mask), Lp + max_len)

        text_pos = torch.arange(max_len, device=dev)
        tok = torch.full((B,), cls_token_id, dtype=torch.long, device=dev)
        unfinished = torch.ones(B, dtype=torch.long, device=dev)
        seen = torch.zeros(B, model.fc_mtm.predictions.decoder.out_features,
                           dtype=torch.bool, device=dev)
        seen[:, cls_token_id] = True
        toks, scores, weights = [tok], [], []
        for t in range(1, max_len):
            pos = text_pos[t - 1:t + 1]  # on the device: no host round trip
            # rows at text positions (t-1, t): the prefix, and text <= row
            cols = torch.cat([prefix_mask[:, None, :].expand(B, 2, Lp),
                              (text_pos[None, :] <= pos[:, None]).to(
                                  prefix_mask.dtype).expand(B, 2, max_len)],
                             dim=2)
            feed = torch.stack([tok, torch.full_like(tok, mask_token_id)], 1)
            x = model.enc_txt.emb_txt(feed, position_ids=pos[None])
            out = model.trsfr.decode_step(x.to(prefix.dtype), caches,
                                          Lp + t - 1,
                                          extended_attention_mask(cols))
            logits = model.mlm_head(out[:, 1:2])[:, 0].float()
            if gen.repetition_penalty != 1.0:
                # CTRL-style penalty on the tokens already generated
                pen = torch.where(logits < 0,
                                  logits * gen.repetition_penalty,
                                  logits / gen.repetition_penalty)
                logits = torch.where(seen, pen, logits)
            if gen.do_sample:
                filtered = top_k_top_p_filter(logits / gen.temperature,
                                              gen.top_k, gen.top_p)
                nxt = torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                                        generator=generator)[:, 0]
            else:
                nxt = logits.argmax(dim=-1)
            score = F.log_softmax(logits, dim=-1).gather(
                1, nxt[:, None])[:, 0]
            tok = nxt * unfinished + pad_token_id * (1 - unfinished)
            weight = unfinished.float()
            unfinished = unfinished * (tok != sep_token_id).long()
            seen[torch.arange(B, device=dev), tok] = True
            toks.append(tok)
            scores.append(score * weight)
            weights.append(weight)
        ids = torch.stack(toks, dim=1)
        # a caption still running after the last step ends in [SEP]
        ids[:, -1] = torch.where(unfinished == 1, sep_token_id, ids[:, -1])
        n = torch.stack(weights, 1).sum(1).clamp_min(1.0)
        return ids, torch.stack(scores, 1).sum(1) / n

    return generate


def rencode_logits(model, feat_img: torch.Tensor, mask_img: torch.Tensor,
                   ids: torch.Tensor, mask_token_id: int) -> torch.Tensor:
    """One step of the re-encode decoder: the MLM logits [B, V] (f32) at a
    [MASK] appended to the caption ids [B, cur], from [video; ids; MASK]
    through the whole encoder under the seq2seq mask (in ``eval()``
    mode, the full-mask sub-block K6 in every layer)."""
    B, cur = ids.shape
    feed = torch.cat([ids, torch.full_like(ids[:, :1], mask_token_id)], 1)
    ft = model.enc_txt(feed)
    ones = torch.ones_like(feed)
    out = model.go_cross(feat_img, mask_img, ft, ones,
                         attn_mask_type="seq2seq")
    lv = feat_img.shape[1]
    return model.mlm_head(out[:, lv + cur:lv + cur + 1])[:, 0].float()


@torch.inference_mode()
def rencode_generate_reference(model, img, cls_token_id: int,
                               sep_token_id: int, pad_token_id: int,
                               mask_token_id: int,
                               max_gen_length: int = 20) -> torch.Tensor:
    """The greedy decoder that re-encodes the whole sequence for every
    token, as the reference's enabled path does (model_for_captioning.py:
    239-296 + :374-450): the oracle of ``make_generate_fn``.  Returns the
    ids [B, max_gen_length] (int64): stops when every caption has its
    [SEP] and pads the rest, else forces a final [SEP]."""
    dev = model.emb_task.device
    img = torch.as_tensor(img, device=dev)
    B = img.shape[0]
    fi, mi = _go_feat_video(model, img)
    ids = torch.full((B, 1), cls_token_id, dtype=torch.long, device=dev)
    unfinished = torch.ones(B, dtype=torch.long, device=dev)
    while ids.shape[1] < max_gen_length:
        nxt = rencode_logits(model, fi, mi, ids, mask_token_id).argmax(-1)
        tok = nxt * unfinished + pad_token_id * (1 - unfinished)
        ids = torch.cat([ids, tok[:, None]], dim=1)
        unfinished = unfinished * (tok != sep_token_id).long()
        if int(unfinished.max()) == 0:
            break
    if ids.shape[1] < max_gen_length:
        return torch.cat([ids, ids.new_full(
            (B, max_gen_length - ids.shape[1]), pad_token_id)], dim=1)
    ids[:, -1] = torch.where(unfinished == 1, sep_token_id, ids[:, -1])
    return ids
