"""Two-phase full-corpus retrieval evaluation (port of
lavender_tpu/tasks/eval_retrieval.py).

Reference: eval_retrieval_mlm.py (feat phase :152-183, Dataset_Product
:76-113, cross phase :195-218, metrics :220-241) and
eval_retrieval_task_specific.py (multi-clip sampling :24-58).

Phase "feat" (:func:`feat_phase`) encodes every clip (multi-clip
mean-pool) and every text once; the batches come through the loader's
pinned staging (``data.loader.device_prefetch``), the frames are
normalized on the card in the model's dtype, and the features stay there.
Phase "cross" (:func:`cross_phase`) scores the (text, video) pairs through
the fusion encoder at the appended [MASK], chunk by chunk, each chunk
gathered from the device-resident feature banks with ``index_select``.
Both run in ``eval()`` mode without autograd (bf16 autocast on the card,
``tasks.common.evaluating``):

    metrics = full_retrieval_eval(model, RetrievalEvalDataset(...))

Under a process group of more than one rank (``parallel.dist``) each rank
encodes its share of the feat batches (batch i on rank i mod world, JAX
``_shard_feat``) and scores its share of the pair chunks (chunk c on rank
c mod world, JAX ``_shard_pair_chunks``); the shares are all-gathered, so
every rank ends with the one process's features, scores and metrics.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lavender_tpu_torch.data import transforms as TF
from lavender_tpu_torch.data.dataset import TsvTaskDataset
from lavender_tpu_torch.data.loader import DataLoader, device_prefetch
from lavender_tpu_torch.parallel import dist as pdist
from lavender_tpu_torch.tasks import common
from lavender_tpu_torch.tasks.retrieval import recall_at_k

log = logging.getLogger(__name__)


class RetrievalEvalDataset(TsvTaskDataset):
    """Eval dataset: all (text, video) with multi-clip frame sampling.

    Reference: Dataset_RetrievalMlmEval (eval_retrieval_mlm.py:50-73) +
    get_clips_with_temporal_sampling (eval_retrieval_task_specific.py:24-58).
    """

    def __init__(self, cfg, tokzr, split, img_tsv_path, id2lineidx, txt,
                 multi_clip: bool = False, max_clips: int = 4, **kw):
        super().__init__(cfg, tokzr, split, img_tsv_path, id2lineidx, txt, **kw)
        self.multi_clip = multi_clip
        self.max_clips = max_clips
        self.gt_txt2vid = {i: item["video"] for i, item in enumerate(self.txt)}

    def str2txt(self, s):
        txt, mask = super().str2txt(s)
        return self.append_mask_tok2txt(txt, mask)

    @property
    def prompt_text(self):
        return "is the video-text paired, true or false?"

    def get_clips(self, video_id) -> np.ndarray:
        """uint8 [Clips, T, S, S, 3]."""
        row = self._tsv.seek_offset(self.id2lineidx[video_id])
        bufs = row[2:]
        if self.multi_clip:
            idx_sets = TF.multi_clip_indices(
                len(bufs), self.size_frame, self.max_clips)
        else:
            idx_sets = [TF.temporal_sample_indices(
                len(bufs), self.size_frame, False)]
        clips = []
        decoded = {}
        for idxs in idx_sets:
            frames = []
            for i in idxs:
                if i not in decoded:
                    decoded[i] = TF.str2img(bufs[i])
                frames.append(decoded[i])
            clip = TF.transform_clip(
                frames, self.cfg.size_img, self._eval_transform(), False)
            clips.append(self.pad_frames(clip))
        # pad clip count so batch shapes stay static
        while self.multi_clip and len(clips) < self.max_clips:
            clips.append(clips[-1])
        return np.stack(clips, axis=0)

    def __getitem__(self, idx):
        item = self.txt[idx]
        raw = item["caption"]
        if isinstance(raw, list):
            raw = " ".join(raw)
        txt, mask = self.str2txt(raw)
        return {"img": self.get_clips(item["video"]), "txt": txt,
                "mask": mask, "tid": idx, "vid": item["video"]}


def make_feat_fn(model, pretext=None):
    """Phase "feat": encode clips (mean-pooled) + text
    (LAVENDER_RetrievalMlmEval.forward typ='feat',
    eval_retrieval_mlm.py:21-37).  Returns ``feat_fn(img [B, C, T, S, S,
    3], txt, mask) -> (feat_img [B, Lv, H], mask_img [B, Lv], feat_txt,
    mask_txt)``; call it inside ``common.evaluating(model)``.

    ``pretext`` (a ``tasks.common.make_pretext_fn`` result) injects the
    prompt/task-token features into the cached text features, mirroring the
    reference's feat-phase ``prepro_txt_inputs`` call
    (eval_retrieval_mlm.py:33-35, model.py:292-306).  The appended [MASK]
    stays the LAST text position, so the cross-phase score read is
    unchanged."""

    def feat_fn(img, txt, mask):
        B, C = img.shape[:2]
        fi, mi, ft, mt = model.go_feat(img.reshape((B * C,) + img.shape[2:]),
                                       txt, mask)
        H = fi.shape[-1]
        fi = fi.reshape(B, C, -1, H).mean(dim=1)
        mi = mi.reshape(B, C, -1)[:, 0]
        if pretext is not None:
            fp, mp = common.apply_pretext(pretext, model, B)
            ft, mt, _ = common.prepend_pretxt(ft, mt, fp, mp)
        return fi, mi, ft, mt

    return feat_fn


def _pair_score(model, feat_img, mask_img, feat_txt, mask_txt,
                true_id: int, false_id: int, head: str
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fuse one pair batch -> (score [P] f32, the [MASK] logits at the
    "true" and "false" ids [P, 2] f32, or None for the scalar head): MLM
    p_true/(p_true+p_false) at the appended [MASK]
    (eval_retrieval_mlm.py:39-47) or the scalar match head
    (eval_retrieval_task_specific.py:39-47)."""
    Lv = feat_img.shape[1]
    out = model.go_cross(feat_img, mask_img, feat_txt, mask_txt)
    if head == "ts":
        return model.fc(out[:, Lv]).float()[:, 0], None
    # the head on the final ([MASK]) position only
    last = model.mlm_head(out[:, -1:])[:, -1].float()
    return (common.true_score(last, true_id, false_id),
            last[:, [true_id, false_id]])


def make_cross_fn(model, true_id: int, false_id: int, mask_pos: int = -1,
                  head: str = "mlm"):
    """Phase "cross", one pair batch per call: ``cross_fn(feat_img,
    mask_img, feat_txt, mask_txt) -> score [P]`` (kept for tests / small
    corpora; call it inside ``common.evaluating(model)``)."""

    def cross_fn(feat_img, mask_img, feat_txt, mask_txt):
        return _pair_score(model, feat_img, mask_img, feat_txt, mask_txt,
                           true_id, false_id, head)[0]

    return cross_fn


def make_cross_scan_fn(model, true_id: int, false_id: int,
                       head: str = "mlm"):
    """Phase "cross" over every pair chunk from device-resident feature
    banks: ``scan_fn(FV, MV, FT, MT, t_idx [n, c], v_idx [n, c]) ->
    (scores [n, c], logits [n, c, 2] or None)``, each chunk's rows gathered
    with ``index_select`` on the banks' device (JAX: one ``lax.scan`` over
    the chunks)."""

    def scan_fn(FV, MV, FT, MT, t_idx, v_idx):
        scores, logits = [], []
        for ti, vi in zip(t_idx, v_idx):
            s, lg = _pair_score(
                model, FV.index_select(0, vi), MV.index_select(0, vi),
                FT.index_select(0, ti), MT.index_select(0, ti),
                true_id, false_id, head)
            scores.append(s)
            logits.append(lg)
        return (torch.stack(scores),
                None if logits[0] is None else torch.stack(logits))

    return scan_fn


def dual_encoder_scores(featv: Dict, featt: Dict, vids, tids) -> np.ndarray:
    """Cheap two-tower prefilter: cosine similarity between mean-pooled
    video tokens and mean-pooled text tokens, in f32 on the features'
    device.  Not in the reference — used to shortlist candidates before the
    expensive fusion pass."""

    def pool(feat, mask):
        m = mask.float()[..., None]
        return (feat.float() * m).sum(0) / m.sum(0).clamp_min(1.0)

    v = torch.stack([pool(featv[x]["feat_img"], featv[x]["mask_img"])
                     for x in vids])
    t = torch.stack([pool(featt[x]["feat_txt"], featt[x]["mask_txt"])
                     for x in tids])
    v = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    t = t / t.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    return (t @ v.T).cpu().numpy()  # [n_t, n_v]


def _device(model) -> torch.device:
    return next(model.parameters()).device


class _Items:
    """The items ``idx`` of a dataset, in that order."""

    def __init__(self, dataset, idx):
        self.dataset, self.idx = dataset, list(idx)

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.dataset[self.idx[i]]


def _shard_feat(dataset, batch_size: int):
    """The rank's share of the feat phase (JAX ``_shard_feat``): the items
    of the batches i = rank mod world of the one-process loader, so that
    each batch holds what it holds in one process.  One process: the
    dataset itself."""
    world, rank = pdist.data_count(), pdist.data_index()
    if world == 1:
        return dataset
    return _Items(dataset, [i for i in range(len(dataset))
                            if (i // batch_size) % world == rank])


def _gather_feats(featv: Dict, featt: Dict, first: Dict, dev):
    """Every rank's features on every rank (through the CPU): the videos
    in the order of their first text, as one process lists them."""
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    parts = pdist.all_gather_obj((
        {v: cpu(d) for v, d in featv.items()},
        {t: cpu(d) for t, d in featt.items()}, first))
    allv, allt, allfirst = {}, {}, {}
    for fv, ft, fi in parts:
        for v, d in fv.items():
            if v not in allfirst or fi[v] < allfirst[v]:
                allv[v], allfirst[v] = d, fi[v]
        allt.update(ft)
    to_dev = lambda d: {k: t.to(dev) for k, t in d.items()}
    return ({v: to_dev(allv[v]) for v in sorted(allv, key=allfirst.get)},
            {t: to_dev(allt[t]) for t in sorted(allt)})


def feat_phase(model, dataset: RetrievalEvalDataset, batch_size: int = 16,
               loader=None, pretext=None) -> Tuple[Dict, Dict]:
    """Encode the corpus: ({video id: {"feat_img", "mask_img"}}, {text id:
    {"feat_txt", "mask_txt"}}), tensors on the model's device.

    The serving caches (rel-pos biases, shift masks, LN folds) are built
    once up front for the dataset's clip size; a build that fails is
    logged, and the forward then computes them per call.  Under more than
    one rank (and no ``loader``) each rank encodes its share of the
    batches and the features are gathered."""
    dev = _device(model)
    dtype = next(model.parameters()).dtype
    T, S = dataset.size_frame, dataset.cfg.size_img
    sharded = loader is None and pdist.data_count() > 1
    dl = loader or DataLoader(_shard_feat(dataset, batch_size), batch_size,
                              shuffle=False, num_workers=4,
                              pin_memory=dev.type == "cuda")
    featv: Dict[str, Dict] = {}
    featt: Dict[int, Dict] = {}
    first: Dict[str, int] = {}  # each video's first text
    feat_fn = make_feat_fn(model, pretext=pretext)
    with common.evaluating(model):
        try:
            model.build_serving_cache(T, S, S)
        except Exception:
            log.exception("serving cache for %d x %d x %d clips not built; "
                          "the forward computes the biases per call",
                          T, S, S)
        for batch in device_prefetch(dl, dev, keys=("img", "txt", "mask")):
            img = TF.device_normalize(batch["img"], dtype)
            fi, mi, ft, mt = feat_fn(img, batch["txt"].long(),
                                     batch["mask"].long())
            for i, (tid, vid) in enumerate(zip(batch["tid"], batch["vid"])):
                if vid not in featv:
                    featv[vid] = {"feat_img": fi[i], "mask_img": mi[i]}
                    first[vid] = int(tid)
                featt[int(tid)] = {"feat_txt": ft[i], "mask_txt": mt[i]}
    if sharded:
        return _gather_feats(featv, featt, first, dev)
    return featv, featt


def cross_phase(model, dataset: RetrievalEvalDataset, featv: Dict,
                featt: Dict, pair_batch: int = 64, rerank_top_k: int = 0,
                head: str = "mlm") -> Dict[str, np.ndarray]:
    """Score the (text, video) pairs: {"score": [n_t, n_v] f32, "gt":
    [n_t] each text's video column, "t_rows" / "v_cols": the scored pairs,
    "logits": the [MASK] logits at the "true" / "false" ids of each scored
    pair [n_pairs, 2] (None for ``head="ts"``)}.  ``rerank_top_k``: see
    :func:`full_retrieval_eval`."""
    dev = _device(model)
    vids = list(featv.keys())
    vid2idx = {v: i for i, v in enumerate(vids)}
    tids = sorted(featt.keys())
    n_t, n_v = len(tids), len(vids)

    if rerank_top_k and rerank_top_k < n_v:
        pre = dual_encoder_scores(featv, featt, vids, tids)
        # prefilter scores land strictly below the fusion range [0, 1]
        score = (pre.astype(np.float32) - pre.max() - 1.0) * 1e-3
        top = np.argsort(-pre, axis=1)[:, :rerank_top_k]
        t_rows = np.repeat(np.arange(n_t), rerank_top_k)
        v_cols = top.reshape(-1)
    else:
        score = np.zeros((n_t, n_v), np.float32)
        t_rows = np.repeat(np.arange(n_t), n_v)
        v_cols = np.tile(np.arange(n_v), n_t)

    # device-resident feature banks; each chunk gathered on the device
    FV = torch.stack([featv[v]["feat_img"] for v in vids])
    MV = torch.stack([featv[v]["mask_img"] for v in vids])
    FT = torch.stack([featt[t]["feat_txt"] for t in tids])
    MT = torch.stack([featt[t]["mask_txt"] for t in tids])
    n_pairs = len(t_rows)
    n_chunks = (n_pairs + pair_batch - 1) // pair_batch
    pad = n_chunks * pair_batch - n_pairs
    t_idx = np.concatenate([t_rows, np.zeros(pad, np.int64)]).reshape(
        n_chunks, pair_batch)
    v_idx = np.concatenate([v_cols, np.zeros(pad, np.int64)]).reshape(
        n_chunks, pair_batch)
    scan_fn = make_cross_scan_fn(
        model, dataset.true_token_id, dataset.false_token_id, head=head)
    mine = _shard_pair_chunks(n_chunks)
    s = lg = None
    if len(mine):
        with common.evaluating(model):
            s, lg = scan_fn(FV, MV, FT, MT,
                            torch.as_tensor(t_idx[mine], device=dev),
                            torch.as_tensor(v_idx[mine], device=dev))
        s = s.float().cpu().numpy()
        lg = None if lg is None else lg.float().cpu().numpy()
    if len(mine) < n_chunks:  # every rank's chunks, in chunk order
        s_all = np.zeros((n_chunks, pair_batch), np.float32)
        lg_all = None if head == "ts" else np.zeros((n_chunks, pair_batch, 2),
                                                    np.float32)
        for idx, s_r, lg_r in pdist.all_gather_obj((mine, s, lg)):
            if len(idx):
                s_all[idx] = s_r
                if lg_all is not None:
                    lg_all[idx] = lg_r
        s, lg = s_all, lg_all
    score[t_rows, v_cols] = s.reshape(-1)[:n_pairs]
    gt = np.asarray([vid2idx[dataset.gt_txt2vid[t]] for t in tids])
    logits = None if lg is None else lg.reshape(-1, 2)[:n_pairs]
    return {"score": score, "gt": gt, "t_rows": t_rows, "v_cols": v_cols,
            "logits": logits}


def _shard_pair_chunks(n_chunks: int) -> np.ndarray:
    """The rank's pair chunks (JAX ``_shard_pair_chunks``): chunk c on rank
    c mod world; every chunk in one process."""
    world, rank = pdist.data_count(), pdist.data_index()
    return np.arange(rank, n_chunks, world)


def full_retrieval_eval(model, dataset: RetrievalEvalDataset,
                        batch_size: int = 16,
                        pair_batch: int = 64,
                        loader=None,
                        rerank_top_k: int = 0,
                        head: str = "mlm",
                        pretext=None) -> Dict[str, float]:
    """Run both phases and compute R@1/5/10 + MedR
    (eval_retrieval_mlm.py:138-241; head="ts" gives the scalar-head variant,
    eval_retrieval_task_specific.py:133-244).  ``model``: a
    ``LavenderModel`` (``LavenderTS`` for ``head="ts"``) on its device.

    rerank_top_k > 0 enables the two-tower prefilter: only each text's top-k
    videos by pooled cosine go through the fusion scorer (the rest keep the
    prefilter score, offset below the fusion range).  Cuts the O(T*V) fusion
    cost to O(T*k); an explicit opt-in — the default (0) is the reference's
    full T x V product (eval_retrieval_mlm.py:184-218), because the
    two-tower and fusion rankings CAN disagree.
    """
    featv, featt = feat_phase(model, dataset, batch_size, loader, pretext)
    out = cross_phase(model, dataset, featv, featt, pair_batch,
                      rerank_top_k, head)
    return recall_at_k(out["score"], out["gt"])
