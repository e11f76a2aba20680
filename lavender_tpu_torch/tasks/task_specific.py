"""Task-specific-head baselines (port of lavender_tpu/tasks/task_specific.py;
the reference's *_task_specific family: main_retrieval_task_specific.py,
main_qamc_task_specific.py, main_qaoe_task_specific.py,
main_retmc_task_specific.py, main_pretrain_task_specific.py and
main_multi_task_multi_head.py).

Each variant scores the fused text-[CLS] position ``out[:, Lv]`` with a
2-layer MLP head (``models.heads.MLPHead``) instead of the unified MLM
head: ``LavenderTS`` carries one head ``fc`` (1 output for retrieval,
RetMC and pretraining's VTM, size_option for QA-MC, size_vocab for
QA-OE), ``LavenderMultiHead`` also one ``fc_<task>`` per task.  Every loss
keeps the trainer's convention ``loss_fn(model, batch, generator)``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from lavender_tpu_torch.models.captioning import make_caption_loss_fn
from lavender_tpu_torch.models.heads import MLPHead
from lavender_tpu_torch.models.lavender import LavenderModel
from lavender_tpu_torch.tasks import common
from lavender_tpu_torch.parallel import dist as pdist
from lavender_tpu_torch.tasks.pretrain import (batch_negatives,
                                               global_token_mean)
from lavender_tpu_torch.tasks.retrieval import grouped_pairs


class LavenderTS(LavenderModel):
    """``LavenderModel`` + the task-specific MLP head ``fc`` (``head_out``
    outputs)."""

    def __init__(self, config, head_out: int = 1):
        super().__init__(config)
        self.fc = MLPHead(config.hidden_size, head_out)

    def cross_cls(self, img, txt, mask, generator=None) -> torch.Tensor:
        """The fused feature of the text's first position (its [CLS]):
        go_feat -> go_cross -> out[:, Lv] [B, H]."""
        fi, mi, ft, mt = self.go_feat(img, txt, mask, generator)
        return self.go_cross(fi, mi, ft, mt, generator)[:, fi.shape[1]]

    def cls_head(self, img, txt, mask,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """``fc`` on the text [CLS]: [B, head_out]."""
        return self.fc(self.cross_cls(img, txt, mask, generator), generator)


class LavenderMultiHead(LavenderTS):
    """The multi-task baseline (main_multi_task_multi_head.py:80-105): the
    shared scalar head ``fc`` and one MLP head ``fc_<name>`` (a '-' in the
    name becomes '_') per (name, out_dim) of ``heads``."""

    def __init__(self, config, heads: Sequence[Tuple[str, int]] = (),
                 head_out: int = 1):
        super().__init__(config, head_out)
        self.head_names = {}
        for name, out in heads:
            attr = f"fc_{name.replace('-', '_')}"
            self.add_module(attr, MLPHead(config.hidden_size, out))
            self.head_names[name] = attr

    def head_forward(self, head: str, img, txt, mask,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Head ``fc_<head>`` on the text [CLS]: [B, out_dim]."""
        fc = getattr(self, self.head_names[head])
        return fc(self.cross_cls(img, txt, mask, generator), generator)


@torch.no_grad()
def reinit_head(model: nn.Module, name: str = "fc",
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-randomise the MLP head ``name`` of ``model`` in place (the
    reference's ``reinit_head``, after a checkpoint load), as the JAX
    package initialises a fresh head: weights from flax's ``lecun_normal``
    (a normal of variance 1 / fan_in truncated at two standard deviations,
    rescaled to keep that variance), biases 0."""
    head = getattr(model, name, None)
    if not isinstance(head, MLPHead):
        raise ValueError(f"no MLP head {name!r} in the model")
    for lin in (head.fc1, head.fc2):
        std = math.sqrt(1.0 / lin.in_features) / 0.87962566103423978
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        lin.bias.zero_()
    return model


def retrieval_ts_scores(model: LavenderTS, img, txt, mask, temp: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        group: int = 1) -> torch.Tensor:
    """The b x b scalar match matrix of each batch group (b = B / group;
    LAVENDER_Retrieval_TS.forward:77-104), over ``temp``: [B, B] for
    group 1, else [group, b, b]."""
    B = img.shape[0]
    fi, mi, ft, mt = model.go_feat(img, txt, mask, generator)
    out = model.go_cross(grouped_pairs(fi, group, True),
                         grouped_pairs(mi, group, True),
                         grouped_pairs(ft, group, False),
                         grouped_pairs(mt, group, False), generator)
    score = model.fc(out[:, fi.shape[1]], generator)
    b = B // group
    return score.reshape((B, B) if group == 1 else (group, b, b)) / temp


def make_retrieval_ts_loss(temp: float, group: int = 1) -> Callable:
    """NormSoftmax InfoNCE (``common.norm_softmax_loss``) over each group's
    b x b matrix, averaged over the groups."""

    def loss_fn(model, batch, generator=None):
        score = retrieval_ts_scores(model, batch["img"], batch["txt"],
                                    batch["mask"], generator=generator,
                                    group=group)
        if group == 1:
            return common.norm_softmax_loss(score, temp)
        return torch.stack([common.norm_softmax_loss(s, temp)
                            for s in score]).mean()

    return loss_fn


def _eval(fn: Callable) -> Callable:
    """``fn(model, *args)`` with the model in ``eval()`` mode, no autograd."""

    def step(model, *args):
        with common.evaluating(model):
            return fn(model, *args)

    return step


def make_retrieval_ts_eval() -> Callable:
    """``step(model, img, txt, mask, vid) -> (score [B, B], hit [B])``."""

    def step(model, img, txt, mask, vid):
        score = retrieval_ts_scores(model, img, txt, mask)
        gt = (vid[:, None] == vid[None, :]).int().argmax(-1)
        return score, (score.argmax(-1) == gt).float()

    return _eval(step)


def make_cls_eval() -> Callable:
    """QA-MC / QA-OE classification eval: ``step(model, img, txt, mask,
    ans) -> (logits [B, head_out], hit [B])``."""

    def step(model, img, txt, mask, ans):
        logits = model.cls_head(img, txt, mask)
        return logits, (logits.float().argmax(-1) == ans).float()

    return _eval(step)


def make_cls_loss() -> Callable:
    """The cross-entropy of ``fc`` on the text [CLS] against ``ans``."""

    def loss_fn(model, batch, generator=None):
        logits = model.cls_head(batch["img"], batch["txt"], batch["mask"],
                                generator)
        return common.cross_entropy_ignore(logits, batch["ans"])

    return loss_fn


def retmc_ts_scores(model: LavenderTS, img, txt, mask,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Per-option scalar scores [B, O] (LAVENDER_RetMC_TS.forward:49-66):
    the clip encoded once, repeated per option."""
    B, O, L = txt.shape
    fi, mi, ft, mt = model.go_feat(img, txt.reshape(B * O, L),
                                   mask.reshape(B * O, L), generator)
    out = model.go_cross(fi.repeat_interleave(O, 0),
                         mi.repeat_interleave(O, 0), ft, mt, generator)
    return model.fc(out[:, fi.shape[1]], generator).reshape(B, O)


def make_retmc_ts_eval() -> Callable:
    """``step(model, img, txt, mask, ans) -> (score [B, O], hit [B])``."""

    def step(model, img, txt, mask, ans):
        score = retmc_ts_scores(model, img, txt, mask)
        return score, (score.argmax(-1) == ans).float()

    return _eval(step)


def make_retmc_ts_loss() -> Callable:
    """The cross-entropy of the option scores against ``ans``."""

    def loss_fn(model, batch, generator=None):
        score = retmc_ts_scores(model, batch["img"], batch["txt"],
                                batch["mask"], generator)
        return common.cross_entropy_ignore(score, batch["ans"])

    return loss_fn


def make_head_cls_loss(name: str) -> Callable:
    """The cross-entropy of head ``fc_<name>`` against ``ans``."""

    def loss_fn(model, batch, generator=None):
        logits = model.head_forward(name, batch["img"], batch["txt"],
                                    batch["mask"], generator)
        return common.cross_entropy_ignore(logits, batch["ans"])

    return loss_fn


def make_multi_head_losses(temp: float, kinds: Dict[str, str],
                           label_smoothing: float = 0.1,
                           group: int = 1) -> Dict[str, Callable]:
    """The loss of each entry of the multi-head baseline
    (main_multi_task_multi_head.py:110-242), by its kind: "retrieval" the
    shared scalar ``fc`` + NormSoftmax, "captioning" the MLM head + the
    caption loss, any other ("qamc", "qaoe") its own ``fc_<name>`` + the
    cross-entropy."""
    losses = {}
    for name, kind in kinds.items():
        if kind == "retrieval":
            losses[name] = make_retrieval_ts_loss(temp, group=group)
        elif kind == "captioning":
            losses[name] = make_caption_loss_fn(label_smoothing)
        else:
            losses[name] = make_head_cls_loss(name)
    return losses


def make_head_cls_eval(name: str) -> Callable:
    """Eval of head ``fc_<name>``: ``step(model, img, txt, mask, ans) ->
    (logits, hit [B])``, hit 0 where ans is -1."""

    def step(model, img, txt, mask, ans):
        logits = model.head_forward(name, img, txt, mask)
        hit = (ans != -1) & (logits.float().argmax(-1) == ans)
        return logits, hit.float()

    return _eval(step)


def make_pretrain_ts_loss(temp: float = 1.0, vtm_batch: int = 4) -> Callable:
    """Pretraining with the scalar VTM head (LAVENDER_Pretrain.forward,
    main_pretrain_task_specific.py:138-180): the MLM loss of the unified
    head plus the cross-entropy of ``fc``'s scores over each clip's 1
    positive and O - 1 negatives (O = min(B, vtm_batch), B every rank's
    batch: ``tasks.pretrain.batch_negatives``), the positive in column 0.
    Returns ``loss_fn(model, batch, generator) -> (loss, {"mtm",
    "vtm"})``."""
    def loss_fn(model, batch, generator=None):
        img, ans_mtm = batch["img"], batch["ans_mtm"]
        B = img.shape[0]
        O = min(B * pdist.data_count(), vtm_batch)
        neg_idx = batch_negatives(generator, B, O - 1)
        fi, mi, ft, mt = model.go_feat(img, batch["txt"], batch["mask"],
                                       generator)
        Lv = fi.shape[1]
        out = model.go_cross(fi, mi, ft, mt, generator)
        ls_mtm = global_token_mean(common.cross_entropy_ignore(
            model.mlm_head(out[:, Lv:]), ans_mtm), ans_mtm)
        own = pdist.data_index() * B + torch.arange(
            B, device=neg_idx.device)[:, None]
        flat = torch.cat([own, neg_idx], 1).reshape(-1).to(ft.device)
        ft, mt = pdist.gather_rows(ft), pdist.gather_rows(mt)
        out = model.go_cross(fi.repeat_interleave(O, 0),
                             mi.repeat_interleave(O, 0), ft[flat], mt[flat],
                             generator)
        score = model.fc(out[:, Lv], generator).reshape(B, O) / temp
        ls_vtm = common.cross_entropy_ignore(
            score, torch.zeros(B, dtype=torch.long, device=score.device))
        return ls_mtm + ls_vtm, {"mtm": ls_mtm, "vtm": ls_vtm}

    return loss_fn
