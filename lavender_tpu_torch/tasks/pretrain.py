"""Unified pretraining, MLM + video-text matching as MLM (port of
lavender_tpu/tasks/pretrain.py; reference main_pretrain_mlm.py
LAVENDER_Pretrain_MLM.forward :55-119, Agent_Pretrain_MLM.masking
:178-200).

One step runs the fusion encoder twice: an MLM pass over the B (clip,
masked text) pairs, then a VTM pass over B * O pairs, each clip with its
own text and O - 1 other texts of the batch, the MLM head applied at the
appended [MASK] alone.  Negatives come from an explicit
``torch.Generator`` (the JAX package draws them with ``top_k`` of
``jax.random`` noise; the two cannot give the same indices).  Under a
process group the negatives are drawn, as in the JAX package's global
batch, from the texts of every rank's batch (every data shard's under
tensor parallelism) (``batch_negatives``: one
draw on rank 0; the texts gathered with gradients flowing back,
``parallel.dist.gather_rows``), and the MLM mean is over every rank's
masked tokens.

A batch holds img uint8 [B, T, H, W, 3], txt (after ``mask_tokens``) and
mask [B, Lt], ans_mtm [B, Lt] (-1 = not a target) and optionally vt_mask
[B, T, 1]."""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lavender_tpu_torch.config import DataConfig
from lavender_tpu_torch.data.dataset import VideoTextDataset
from lavender_tpu_torch.data.tsv import TSVFile
from lavender_tpu_torch.parallel import dist as pdist
from lavender_tpu_torch.tasks import common

log = logging.getLogger(__name__)

IMAGE_DATASETS = ("cc3m", "coco", "vg", "cc12m")


class PretrainDataset(VideoTextDataset):
    """One shard (part) of a pretraining corpus.

    The reference hardcodes per-corpus path patterns
    (main_pretrain_task_specific.py:29-71); here a shard is just
    (tsv_path, txt dict video->list[caption]).  Image corpora use 1 frame.
    """

    def __init__(self, cfg: DataConfig, tokzr, split: str, tsv_path: str,
                 txt: Dict[str, List[str]], dataset_name: str = "",
                 mlm: bool = True, meta_cols: int = 2):
        size_frame = 1 if dataset_name in IMAGE_DATASETS else cfg.size_frame
        super().__init__(cfg, tokzr, split, size_frame)
        self.tsv = TSVFile(tsv_path)
        self.txt = txt
        self.mlm = mlm
        self.meta_cols = meta_cols  # frames start at this column

    def __len__(self):
        return len(self.tsv)

    @property
    def vtm_prompt_text(self):
        return "is the video-text paired, true or false?"

    @property
    def cap_prompt_text(self):
        return "write a description about the video."

    def str2txt(self, s):
        txt, mask = super().str2txt(s)
        if self.mlm:
            txt, mask = self.append_mask_tok2txt(txt, mask)
        return txt, mask

    def __getitem__(self, idx):
        row = self.tsv.seek(idx)
        vid, bufs = row[0], row[self.meta_cols:]
        raw_txt = ""
        if vid in self.txt:
            entry = self.txt[vid]
            raw_txt = entry[0] if isinstance(entry, (list, tuple)) else entry
        try:
            img = self.frames_from_b64(bufs)
        except Exception as e:  # an undecodable row trains on zero frames
            log.warning("PretrainDataset row %d (%s): zero frames (%s)",
                        idx, vid, e)
            S = self.cfg.size_img
            img = np.zeros((self.size_frame, S, S, 3), np.uint8)
        txt, mask = self.str2txt(raw_txt)
        return {"img": self.pad_frames(img), "txt": txt, "mask": mask}


def mask_tokens(txt: np.ndarray, special_ids: Sequence[int],
                mask_token_id: int, p_mask: float = 0.15,
                rng: Optional[np.random.RandomState] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Token masking (Agent_Pretrain_MLM.masking, vectorised): each token
    not in ``special_ids`` becomes [MASK] with probability ``p_mask``.
    Returns (masked ids, ans_mtm: the hidden token where masked, else -1),
    both int32."""
    rng = rng or np.random
    special = np.isin(txt, np.asarray(special_ids))
    hit = (rng.rand(*txt.shape) < p_mask) & ~special
    ans_mtm = np.where(hit, txt, -1).astype(np.int32)
    masked = np.where(hit, mask_token_id, txt).astype(np.int32)
    return masked, ans_mtm


def sample_negatives(generator: Optional[torch.Generator], B: int,
                     n_neg: int) -> torch.Tensor:
    """For each i, ``n_neg`` distinct texts j != i of the batch, uniformly
    (the reference's permutation loop, main_pretrain_mlm.py:92-94, for all
    i at once): int64 [B, n_neg] on the generator's device."""
    if not 0 <= n_neg < B:
        raise ValueError(f"{n_neg} negatives need a batch of more than "
                         f"{n_neg}, got {B}")
    dev = "cpu" if generator is None else generator.device
    noise = torch.rand(B, B, generator=generator, device=dev)
    noise.fill_diagonal_(2.0)  # above every draw: never the pair's own
    return noise.topk(n_neg, dim=1, largest=False).indices


def batch_negatives(generator: Optional[torch.Generator], B: int,
                    n_neg: int) -> torch.Tensor:
    """The negatives of this rank's B clips among the texts of every
    rank's batch (world * B, rank after rank): ``sample_negatives`` over
    that global batch drawn on rank 0 and broadcast, this rank's rows
    (``sample_negatives(generator, B, n_neg)`` in one process)."""
    world = pdist.data_count()
    if world == 1:
        return sample_negatives(generator, B, n_neg)
    rank = pdist.data_index()
    if rank == 0:
        idx = sample_negatives(generator, B * world, n_neg)
    else:
        idx = torch.empty(B * world, n_neg, dtype=torch.long,
                          device="cpu" if generator is None
                          else generator.device)
    return pdist.broadcast_main(idx)[rank * B:(rank + 1) * B]


def pretrain_forward(model, img: torch.Tensor, txt: torch.Tensor,
                     mask: torch.Tensor, neg_idx: torch.Tensor,
                     vt_mask: Optional[torch.Tensor] = None,
                     feat_pre: Optional[torch.Tensor] = None,
                     mask_pre: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLM pass and the VTM pass (LAVENDER_Pretrain_MLM.forward):
    neg_idx [B, O - 1] the negative texts of each clip, indices into every
    rank's batch (``batch_negatives``; into this batch in one process);
    feat_pre / mask_pre (batch B) the VTM pass's pretext (the reference
    gives the MLM pass none).  Returns (out_mtm [B, Lt, V], out_vtm [B*O,
    1, V]), pair (i, 0) the positive and (i, o > 0) text neg_idx[i, o -
    1]."""
    B = img.shape[0]
    fi, mi, ft, mt = model.go_feat(img, txt, mask, generator,
                                   vt_mask=vt_mask)
    out = model.go_cross(fi, mi, ft, mt, generator)
    out_mtm = model.mlm_head(out[:, fi.shape[1]:])

    vft, vmt, _ = common.prepend_pretxt(ft, mt, feat_pre, mask_pre)
    vft, vmt = pdist.gather_rows(vft), pdist.gather_rows(vmt)
    O = neg_idx.shape[1] + 1
    own = pdist.data_index() * B + torch.arange(
        B, device=neg_idx.device)[:, None]
    flat = torch.cat([own, neg_idx], dim=1).reshape(-1).to(vft.device)
    out = model.go_cross(fi.repeat_interleave(O, 0),
                         mi.repeat_interleave(O, 0), vft[flat], vmt[flat],
                         generator)
    return out_mtm, model.mlm_head(out[:, -1:])


def make_loss_fn(true_id: int, false_id: int, vtm_batch: int = 4,
                 pretext: Optional[Callable] = None) -> Callable:
    """The pretraining loss ls_mtm + ls_vtm (main_pretrain_mlm.py:158-163)
    over O = min(B, vtm_batch) VTM pairs a clip (B: every rank's batch);
    the negatives are drawn from the step's generator before the dropout.
    Under more than one rank ls_mtm is the rank's share of the mean over
    every rank's masked tokens (``parallel.dist.mean_weight``).  Returns
    ``loss_fn(model, batch, generator) -> (loss, {"mtm", "vtm"})``, for
    ``make_train_step(..., has_aux=True)``."""

    def loss_fn(model, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        img, txt = batch["img"], batch["txt"]
        B = img.shape[0]
        O = min(B * pdist.data_count(), vtm_batch)
        neg_idx = batch_negatives(generator, B, O - 1)
        fp, mp = common.apply_pretext(pretext, model, B, generator)
        out_mtm, out_vtm = pretrain_forward(
            model, img, txt, batch["mask"], neg_idx, batch.get("vt_mask"),
            fp, mp, generator)
        ls_mtm = global_token_mean(
            common.cross_entropy_ignore(out_mtm, batch["ans_mtm"]),
            batch["ans_mtm"])
        # "true" for each clip's own text (column 0), "false" for the rest
        labels = torch.full((B, O), false_id, device=img.device)
        labels[:, 0] = true_id
        ls_vtm = common.cross_entropy_ignore(out_vtm[:, -1],
                                             labels.reshape(-1))
        return ls_mtm + ls_vtm, {"mtm": ls_mtm, "vtm": ls_vtm}

    return loss_fn


def global_token_mean(loss: torch.Tensor,
                      ans_mtm: torch.Tensor) -> torch.Tensor:
    """``loss``, the mean over this rank's targets of ``ans_mtm`` (>= 0),
    as its share of the mean over every rank's (itself in one process)."""
    if pdist.data_count() == 1:
        return loss
    return loss * pdist.mean_weight((ans_mtm >= 0).sum()).to(loss.device)


def make_eval_step(true_id: int, false_id: int,
                   vtm_batch: int = 4) -> Callable:
    """Eval: the MLM accuracy over the masked tokens (-1 where there are
    none) and the in-batch VTM accuracy (the positive ranked first among
    each clip's O pairs by ``common.true_score``).

    Returns ``step(model, img, txt, mask, ans_mtm, generator) -> (ac_mtm,
    ac_vtm)``, the negatives drawn from ``generator``, the model in
    ``eval()`` mode."""

    def step(model, img, txt, mask, ans_mtm, generator=None):
        B = img.shape[0]
        O = min(B * pdist.data_count(), vtm_batch)
        neg_idx = batch_negatives(generator, B, O - 1)
        with common.evaluating(model):
            out_mtm, out_vtm = pretrain_forward(model, img, txt, mask,
                                                neg_idx)
        valid = ans_mtm != -1
        n = valid.sum()
        hits = (valid & (out_mtm.float().argmax(-1) == ans_mtm)).sum()
        ac_mtm = torch.where(n > 0, hits / n.clamp(min=1), -1.0)
        score = common.true_score(out_vtm[:, -1], true_id,
                                  false_id).reshape(B, O)
        return ac_mtm, (score.argmax(-1) == 0).float().mean()

    return step
