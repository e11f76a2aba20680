"""Shared task utilities (port of lavender_tpu/tasks/common.py): the
cross-entropy with an ignore index, the bidirectional InfoNCE of the
task-specific retrieval head, the captioning loss (label-smoothed KL), the
pretext (task token or prompt) and the shared MLM forward."""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1) -> torch.Tensor:
    """Mean token cross-entropy over the labels != ignore_index, in f32
    (reference agent.py:72); 0 when every label is ignored.  Labels of any
    integer dtype (the loader's are int32)."""
    flat = logits.float().reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1)
    valid = labels != ignore_index
    nll = F.cross_entropy(flat, torch.where(valid, labels, 0).long(),
                          reduction="none")
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def norm_softmax_loss(sim: torch.Tensor,
                      temperature: float = 0.05) -> torch.Tensor:
    """Bidirectional InfoNCE over a square similarity matrix, in f32
    (reference agent.py:46-65): minus the mean log-softmax of the diagonal
    over rows and over columns."""
    sim = sim.float() / temperature
    return -(F.log_softmax(sim, dim=1).diagonal().mean()
             + F.log_softmax(sim, dim=0).diagonal().mean())


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


def label_smoothed_kl_loss(logits: torch.Tensor, labels: torch.Tensor,
                           label_smoothing: float = 0.1,
                           drop_worst_ratio: float = 0.0) -> torch.Tensor:
    """Captioning loss (reference model_for_captioning.py:10-37): per token
    KL(target || softmax(logits)) with the target 1 - eps on the label and
    eps / (V - 1) elsewhere, in f32; labels [N] int, ignored where < 0.
    The mean over the valid tokens, or with ``drop_worst_ratio`` the mean
    of the smallest (1 - ratio) share of all N per-token losses (ignored
    ones count as 0, as in the JAX package)."""
    logits = logits.float()
    n_class = logits.shape[-1]
    eps = label_smoothing
    valid = labels >= 0
    one_hot = F.one_hot(torch.where(valid, labels, 0).long(),
                        n_class).float()
    target = one_hot * (1 - eps) + (1 - one_hot) * eps / (n_class - 1)
    logp = F.log_softmax(logits, dim=-1)
    # the entropy term is constant but orders the drop-worst selection
    ent = torch.where(target > 0, target * target.clamp_min(1e-30).log(),
                      0.0).sum(-1)
    loss = torch.where(valid, ent - (target * logp).sum(-1), 0.0)
    if drop_worst_ratio > 0:
        keep = int(loss.shape[0] * (1 - drop_worst_ratio))
        return torch.topk(loss, keep, largest=False).values.mean()
    return loss.sum() / valid.sum().clamp(min=1)


def pad_labels_for_pretxt(labels: torch.Tensor,
                          pretxt_len: int) -> torch.Tensor:
    """Labels [B, Lt] with ``pretxt_len`` ignored (-1) positions in front."""
    if pretxt_len == 0:
        return labels
    pad = labels.new_full((labels.shape[0], pretxt_len), -1)
    return torch.cat([pad, labels], dim=1)


def make_pretext_fn(config, task_name: Optional[str] = None,
                    prompt: Optional[Tuple] = None) -> Optional[Callable]:
    """The per-step pretext producer of a ``ModelConfig``, or None
    (reference model.py:248-290): with ``enable_task_token`` the learned
    ``emb_task`` row of ``task_name``; with ``enable_prompt`` the prompt
    (token ids [Lp], mask [Lp]) through the text encoder, broadcast over
    the batch.  Returns ``fn(model, batch_size, generator=None) ->
    (feat_pre [B, Lp, H], mask_pre [B, Lp])``."""
    if config.enable_task_token and task_name is not None:
        def task_fn(model, batch_size, generator=None):
            return model.task_feat(task_name, batch_size)
        return task_fn
    if config.enable_prompt and prompt is not None:
        ids = torch.as_tensor(prompt[0]).long()
        mask = torch.as_tensor(prompt[1]).long()

        def prompt_fn(model, batch_size, generator=None):
            dev = model.emb_task.device
            feat = model.encode_prompt(ids.to(dev), batch_size, generator)
            return feat, mask.to(dev)[None].expand(batch_size, -1)
        return prompt_fn
    return None


def apply_pretext(pretext: Optional[Callable], model, batch_size: int,
                  generator: Optional[torch.Generator] = None):
    """(feat_pre, mask_pre) from a ``make_pretext_fn`` result, or
    (None, None)."""
    if pretext is None:
        return None, None
    return pretext(model, batch_size, generator)


def fused_mlm_logits(model, img: torch.Tensor, txt: torch.Tensor,
                     mask: torch.Tensor,
                     feat_pre: Optional[torch.Tensor] = None,
                     mask_pre: Optional[torch.Tensor] = None,
                     attn_mask_type: str = "full",
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, int]:
    """The shared QA / caption forward: go_feat -> (pretext) -> go_cross ->
    MLM logits on the [pretext; text] slice.  The pretext rides the text
    stream and its mask joins the video's, so that under "seq2seq" it is
    part of the fully visible prefix.  Returns (logits [B, Lp + Lt, V],
    Lp)."""
    fi, mi, ft, mt = model.go_feat(img, txt, mask, generator,
                                   attn_mask_type=attn_mask_type)
    lp = 0
    if feat_pre is not None:
        lp = feat_pre.shape[1]
        ft = torch.cat([feat_pre.to(ft.dtype), ft], dim=1)
    out = model.go_cross(fi, mi, ft, mt, generator,
                         attn_mask_type=attn_mask_type,
                         mask_pretxt=mask_pre if feat_pre is not None
                         else None)
    return model.mlm_head(out[:, fi.shape[1]:]), lp


@contextlib.contextmanager
def evaluating(model: torch.nn.Module):
    """The eval steps' context: ``model`` in ``eval()`` mode (the serving
    route, no dropout: JAX ``deterministic=True``) under ``no_grad`` and,
    on a CUDA device, bf16 autocast (the train step's precision over its
    f32 weights); its mode restored after."""
    dev = next(model.parameters()).device.type
    was = model.training
    model.eval()
    try:
        with torch.no_grad(), torch.autocast(dev, dtype=torch.bfloat16,
                                             enabled=dev == "cuda"):
            yield
    finally:
        model.train(was)


def true_score(logits: torch.Tensor, true_id: int,
               false_id: int) -> torch.Tensor:
    """The VTM score of MLM logits [..., V] at the [MASK]: the "true" logit
    over the sum of the "true" and "false" logits (the reference's, on
    logits, not probabilities), in f32."""
    logits = logits.float()
    p_true, p_false = logits[..., true_id], logits[..., false_id]
    return p_true / (p_true + p_false)
