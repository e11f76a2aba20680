"""Unified CLI (port of lavender_tpu/cli/main.py): one task registry in
place of the reference's 17 main_*.py scripts, on the port's data plane,
train state and kernels.

    python -m lavender_tpu_torch.cli.main --task retrieval_mlm \\
        --config _args/args_msrvtt-retrieval.json [--path_ckpt ckpt.pt ...]

Runs on the card ("cuda") unless ``--device cpu``; without a CUDA device
and without ``--device cpu`` it raises.  Under ``WORLD_SIZE`` / ``RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT`` (torchrun) or OpenMPI's variables each
process drives one GPU (``LOCAL_RANK``) and the run is data-parallel:
``size_batch`` per GPU, the loaders split by rank, the gradients averaged
over the ranks, ZeRO-1 optimizer state (``parallel.dist``,
``train.trainer``).  ``"tp": 2`` or ``4`` in the config (tensor
parallelism, ``parallel.mesh``) splits the ranks into ``world / tp``
data shards of ``tp`` GPUs, which hold one batch of ``size_batch`` clips
and a Megatron slice each of the weights (the loaders split by data
shard; the logs and checkpoints written once, in the full layout).  A
world that ``tp`` does not divide, or fewer GPUs on a host than its
ranks, raises.  In-batch pairs (retrieval, NormSoftmax) stay per rank, as the
JAX package keeps them per data shard: each rank holds its own share of
the batch, so the losses take ``group=1``.

Task = (dataset adapter, loss fn, eval step) per the reference's
(Dataset_X, LAVENDER_X, Agent_X) triples.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as op
import zlib
from datetime import datetime
from typing import Callable, Dict, Optional

import numpy as np
import torch

from lavender_tpu_torch.config import RunConfig, load_run_config
from lavender_tpu_torch.data.dataset import load_task_data
from lavender_tpu_torch.data.loader import DataLoader
from lavender_tpu_torch.data.tokenizer import BertTokenizer
from lavender_tpu_torch.models.lavender import LavenderModel
from lavender_tpu_torch.parallel import dist as pdist
from lavender_tpu_torch.parallel import mesh
from lavender_tpu_torch.tasks import common
from lavender_tpu_torch.train.agent import Agent, gather_mean, run_finetune
from lavender_tpu_torch.train.trainer import (create_train_state,
                                              label_count)
from lavender_tpu_torch.utils.logging import LOGGER

TASKS: Dict[str, Callable] = {}


def register(name):
    def deco(fn):
        TASKS[name] = fn
        return fn
    return deco


def _device(cfg: RunConfig) -> torch.device:
    return torch.device(cfg.extra.get("device", "cuda"))


def _build_model(cfg: RunConfig, tok, model_cls=None, **kw):
    """The train state of the task's model (JAX ``_build_model``): the
    vocabulary widened to the tokenizer's, a seeded init
    (``cfg.train.seed``), f32 on the run's device, then the reference
    checkpoint ``cfg.path_ckpt`` merged in where it exists.  Set
    ``cfg.train.max_iter`` first: the schedule is built here."""
    from lavender_tpu_torch.train.checkpoint import load_reference_checkpoint
    bert = dataclasses.replace(cfg.model.bert, vocab_size=max(
        cfg.model.bert.vocab_size, len(tok)))
    mcfg = dataclasses.replace(cfg.model, bert=bert)
    state = create_train_state(
        mcfg, cfg.train, device=_device(cfg), seed=cfg.train.seed,
        model=(model_cls or LavenderModel)(mcfg, **kw))
    if cfg.path_ckpt and op.exists(cfg.path_ckpt):
        load_reference_checkpoint(
            cfg.path_ckpt, state.model, max_size_frame=mcfg.max_size_frame,
            max_size_patch=mcfg.max_size_patch)
        LOGGER.info(f"loaded checkpoint {cfg.path_ckpt}")
    return state


def _pretext(cfg: RunConfig, ds, task_name: str):
    """The pretext producer of a task (the reference's per-step
    prompt/task-token injection in go_dl, main_retrieval_mlm.py:127-136),
    or None when both flags are off."""
    prompt = ds.get_prompt() if cfg.model.enable_prompt else None
    return common.make_pretext_fn(cfg.model, task_name=task_name,
                                  prompt=prompt)


def _train_batch(cfg: RunConfig) -> int:
    """Per-process train loader batch: ``size_batch`` per data shard (the
    reference's per-GPU semantics, README.md:91, and JAX's ``_train_batch``
    per data-axis row): one GPU a process, and under tensor parallelism
    the ``tp`` ranks of a data shard load the same batch."""
    return cfg.train.size_batch


def _loader(cfg: RunConfig, ds, train: bool, seed: Optional[int] = None):
    """The data shard's loader over ``ds`` (shuffled and full batches only
    for training), collating into page-locked memory on the card."""
    return DataLoader(
        ds, _train_batch(cfg) if train else cfg.train.size_batch,
        shuffle=train, num_workers=cfg.data.n_workers,
        seed=cfg.train.seed if seed is None else seed,
        rank=pdist.data_index(), world=pdist.data_count(),
        drop_last=train, pin_memory=_device(cfg).type == "cuda")


def install_mesh(tp: int, device: str):
    """The run's (data, model) mesh (JAX ``maybe_make_mesh``): under
    ``tp`` > 1 the process group's ranks split into data shards of ``tp``
    model ranks.  Raises where ``tp`` does not divide the world, and on
    the card where a host has fewer GPUs than its ranks (NCCL refuses two
    ranks on one GPU)."""
    if tp <= 1:
        mesh.set_global_mesh(None)
        return
    world = pdist.process_count()
    if world % tp:
        raise ValueError(f"tp={tp} does not divide the {world} processes "
                         f"(launch a multiple of tp, one GPU each)")
    if device == "cuda" and pdist.local_rank() >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {pdist.local_rank()} has no GPU of "
                           f"its own ({torch.cuda.device_count()} visible)")
    m = mesh.make_mesh(tp)
    mesh.set_global_mesh(m)
    LOGGER.info(f"tensor parallel: {m.dp} data shards x tp {m.tp}, data "
                f"rank {m.data_rank}, model rank {m.model_rank}")


def _loaders(cfg: RunConfig, datasets):
    return (_loader(cfg, datasets["train"], True),
            _loader(cfg, datasets["val"], False),
            _loader(cfg, datasets["test"], False)
            if "test" in datasets else None)


def _wrap_eval(step, keys):
    """Adapt a positional eval step to ``(model, batch)`` (JAX
    ``_wrap_eval``; the batch is already the rank's share, so the eval
    needs no placement)."""

    def eval_step(model, batch):
        return step(model, *[batch[k] for k in keys])
    return eval_step


@register("retrieval_mlm")
def run_retrieval_mlm(cfg: RunConfig, tok):
    from lavender_tpu_torch.tasks import retrieval
    datasets = load_task_data(cfg.data, retrieval.RetrievalDataset, tok)
    dl_tr, dl_vl, dl_ts = _loaders(cfg, datasets)
    cfg.train.max_iter = max(1, len(dl_tr) * cfg.train.size_epoch)
    state = _build_model(cfg, tok)
    ds = datasets["val"]
    pre = _pretext(cfg, ds, "vtm")
    agent = Agent(
        cfg, state,
        loss_fn=retrieval.make_loss_fn(ds.true_token_id, ds.false_token_id,
                                       pretext=pre, group=1),
        eval_step=_wrap_eval(retrieval.make_eval_step(
            ds.true_token_id, ds.false_token_id, pretext=pre),
            ["img", "txt", "mask", "vid"]))
    return run_finetune(agent, dl_tr, dl_vl, dl_ts, cfg.train.size_epoch,
                        zero_shot=bool(cfg.path_ckpt))


@register("qamc_mlm")
def run_qamc_mlm(cfg: RunConfig, tok):
    from lavender_tpu_torch.tasks import qamc
    datasets = load_task_data(cfg.data, qamc.QAMCDataset, tok)
    dl_tr, dl_vl, dl_ts = _loaders(cfg, datasets)
    cfg.train.max_iter = max(1, len(dl_tr) * cfg.train.size_epoch)
    state = _build_model(cfg, tok)
    ds = datasets["val"]
    pre = _pretext(cfg, ds, "mc")
    agent = Agent(
        cfg, state, loss_fn=qamc.make_loss_fn(pretext=pre),
        count_fn=label_count("mask_ans"),
        eval_step=_wrap_eval(
            qamc.make_eval_step(ds.ans_tok_ids, pretext=pre),
            ["img", "txt", "mask", "mask_ans", "ans_idx"]))
    return run_finetune(agent, dl_tr, dl_vl, dl_ts, cfg.train.size_epoch,
                        zero_shot=bool(cfg.path_ckpt))


def _qaoe_top1(step):
    """QA-OE's eval read at its top-1 accuracy (the step's first output;
    JAX's run_qaoe_mlm reads the last, the rows' valid flag)."""

    def top1(*args):
        return step(*args)[0]
    return top1


def _run_qaoe(cfg: RunConfig, tok, datasets):
    from lavender_tpu_torch.tasks import qaoe
    dl_tr, dl_vl, dl_ts = _loaders(cfg, datasets)
    cfg.train.max_iter = max(1, len(dl_tr) * cfg.train.size_epoch)
    state = _build_model(cfg, tok)
    pre = _pretext(cfg, datasets["val"], "oe")
    agent = Agent(
        cfg, state, loss_fn=qaoe.make_loss_fn(pretext=pre),
        count_fn=label_count("mask_ans"),
        eval_step=_wrap_eval(_qaoe_top1(qaoe.make_eval_step(pretext=pre)),
                             ["img", "txt", "mask", "mask_ans"]))
    return agent, run_finetune(agent, dl_tr, dl_vl, dl_ts,
                               cfg.train.size_epoch,
                               zero_shot=bool(cfg.path_ckpt))


@register("qaoe_mlm")
def run_qaoe_mlm(cfg: RunConfig, tok):
    from lavender_tpu_torch.tasks import qaoe
    datasets = load_task_data(cfg.data, qaoe.QAOEDataset, tok)
    agent, log = _run_qaoe(cfg, tok, datasets)
    # "adjusted" test accuracy for datasets with missing test videos
    # (main_qaoe_mlm.py:178-188): scale by actual/size_test
    if "test" in datasets and cfg.extra.get("size_test"):
        actual = len(datasets["test"])
        ratio = actual / float(cfg.extra["size_test"])
        log["ac_ts_adjusted"] = [a * ratio for a in log.get("ac_ts", [])]
        agent.logger.info(f"adjusted test acc (x{ratio:.4f}): "
                          f"{log['ac_ts_adjusted']}")
    return log


def _run_retmc(cfg: RunConfig, tok, dataset_cls):
    from lavender_tpu_torch.tasks import retmc
    datasets = load_task_data(cfg.data, dataset_cls, tok)
    dl_tr, dl_vl, dl_ts = _loaders(cfg, datasets)
    cfg.train.max_iter = max(1, len(dl_tr) * cfg.train.size_epoch)
    state = _build_model(cfg, tok)
    ds = datasets["val"]
    pre = _pretext(cfg, ds, "vtm")  # lsmdc-mc uses the vtm token
    agent = Agent(
        cfg, state, loss_fn=retmc.make_loss_fn(pretext=pre),
        count_fn=label_count("mask_ans"),
        eval_step=_wrap_eval(retmc.make_eval_step(
            ds.true_token_id, ds.false_token_id, pretext=pre),
            ["img", "txt", "mask", "mask_ans", "ans_idx"]))
    return run_finetune(agent, dl_tr, dl_vl, dl_ts, cfg.train.size_epoch,
                        zero_shot=bool(cfg.path_ckpt))


@register("retmc_mlm")
def run_retmc_mlm(cfg: RunConfig, tok):
    from lavender_tpu_torch.tasks import retmc
    return _run_retmc(cfg, tok, retmc.RetMCDataset)


@register("qamc_mlm_head")
def run_qamc_mlm_head(cfg: RunConfig, tok):
    """MC-QA scored per option as VTM true/false at each option's appended
    [MASK] (main_qamc_mlm_head.py:12-121): the RetMC machinery over
    QAMCHeadDataset."""
    from lavender_tpu_torch.tasks import retmc
    return _run_retmc(cfg, tok, retmc.QAMCHeadDataset)


@register("qaoe_mlm_fib")
def run_qaoe_mlm_fib(cfg: RunConfig, tok):
    """LSMDC fill-in-blank: the [MASK] sits in the sentence; the answers
    index a label2ans vocabulary (main_qaoe_mlm_lsmdc_fib.py), from the
    sibling ``txt_{task}_label2ans.json`` (list or dict)."""
    from lavender_tpu_torch.tasks import qaoe
    la_path = op.join(cfg.data.data_dir,
                      f"txt_{cfg.data.task}_label2ans.json")
    label2ans = None
    if op.exists(la_path):
        with open(la_path) as f:
            label2ans = json.load(f)
    if isinstance(label2ans, dict):
        label2ans = {int(k): v for k, v in label2ans.items()}
    datasets = load_task_data(cfg.data, qaoe.QAOEFibDataset, tok,
                              label2ans=label2ans)
    return _run_qaoe(cfg, tok, datasets)[1]


def _video_keys(ds) -> Callable:
    """Batch "vid" entry -> the video id its captions are keyed by: the
    TSV datasets carry the video's index (``vid2idx``), the composite ones
    the key itself."""
    idx2vid = {i: v for v, i in getattr(ds, "vid2idx", {}).items()}

    def key(v):
        v = v.item() if isinstance(v, torch.Tensor) else v
        return str(idx2vid.get(int(v), v) if idx2vid else v)
    return key


def _caption_refs(ds, keys) -> Dict:
    """Reference captions of ``keys`` (the dataset's own lookup where it
    has one, else its txt items)."""
    refs = {}
    if hasattr(ds, "get_captions_by_key"):
        for key in keys:
            try:
                refs[key] = ds.get_captions_by_key(key)
            except KeyError:
                pass
    else:
        for item in ds.txt:
            refs.setdefault(str(item["video"]), []).append(
                item["caption"] if isinstance(item["caption"], str)
                else " ".join(item["caption"]))
    return refs


def _decode_captions(agent: Agent, generate, dl, tok, prompt_ids=None):
    """Greedy captions of the rank's clips, gathered from every rank:
    ({video id: caption}, {video id: exp(mean log-prob)})."""
    cands, confs = {}, {}
    key = _video_keys(dl.dataset)
    with agent.evaluating() as model, common.evaluating(model):
        for batch in agent.batches(dl):
            ids, logp = generate(batch["img"], prompt_txt=prompt_ids)
            for v, row, lp_ in zip(batch["vid"], ids.cpu().numpy(),
                                   logp.float().cpu().numpy()):
                cands[key(v)] = tok.decode(row.tolist())
                confs[key(v)] = float(np.exp(lp_))
    out_c, out_p = {}, {}
    for c, p in pdist.all_gather_obj((cands, confs)):
        out_c.update(c)
        out_p.update(p)
    return out_c, out_p


@register("caption")
def run_caption(cfg: RunConfig, tok):
    from lavender_tpu_torch.models import captioning as cap
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.utils.metrics import coco_caption_metrics
    raw = {}
    if cfg.extra.get("config_path"):
        with open(cfg.extra["config_path"]) as f:
            raw = json.load(f)
    if "train_yaml" in raw:
        # YAML-driven composite corpora (Dataset_Caption, main_caption.py:17)
        from lavender_tpu_torch.data.composite import CompositeCaptionDataset
        datasets = {
            split: CompositeCaptionDataset(
                cfg.data, tok, raw[f"{split}_yaml"], split)
            for split in ("train", "val", "test") if f"{split}_yaml" in raw}
    else:
        datasets = load_task_data(cfg.data, retrieval.RetrievalDataset, tok,
                                  mlm=False)
    dl_tr, dl_vl, dl_ts = _loaders(cfg, datasets)
    cfg.train.max_iter = max(1, len(dl_tr) * cfg.train.size_epoch)
    state = _build_model(cfg, tok)
    ds_vl = datasets["val"]
    # caption prompt text (main_caption.py:33-34)
    cap_prompt = (ds_vl.get_prompt("write a description about the video.")
                  if cfg.model.enable_prompt else None)
    pre = common.make_pretext_fn(cfg.model, task_name="cap",
                                 prompt=cap_prompt)

    def train_prep(batch):
        masked, ans = cap.caption_masking(
            batch["txt"], tok.pad_token_id, tok.mask_token_id,
            p_mask=cfg.train.p_mask)
        batch = dict(batch)
        batch["txt"] = masked
        batch["ans_mtm"] = ans
        return batch

    agent = Agent(
        cfg, state,
        loss_fn=cap.make_caption_loss_fn(
            label_smoothing=cfg.train.label_smoothing, pretext=pre),
        count_fn=label_count("ans_mtm"), train_prep=train_prep)
    generate = cap.make_generate_fn(
        agent.model, tok.cls_token_id, tok.sep_token_id, tok.pad_token_id,
        tok.mask_token_id, use_task_token=cfg.model.enable_task_token)
    prompt_ids = cap_prompt[0] if cap_prompt is not None else None

    def eval_captions(dl, predict_file=None):
        """Decode -> gather -> predictions TSV -> COCO metrics
        (Agent_Captioning.test + evaluate, main_caption.py:81-217)."""
        cands, confs = _decode_captions(agent, generate, dl, tok, prompt_ids)
        if predict_file and pdist.is_main_process():
            from lavender_tpu_torch.data.tsv import tsv_writer
            rows = [[k, json.dumps([{"caption": v,
                                     "conf": confs.get(k, 0.0)}])]
                    for k, v in sorted(cands.items())]
            tsv_writer(rows, predict_file)
        refs = _caption_refs(dl.dataset, cands)
        cands = {k: v for k, v in cands.items() if k in refs and refs[k]}
        return coco_caption_metrics(cands, {k: refs[k] for k in cands})

    agent.save_training_meta()
    for e in range(cfg.train.size_epoch):
        ls = agent.train_epoch(e + 1, dl_tr)
        metrics = eval_captions(
            dl_vl, predict_file=op.join(cfg.path_output,
                                        f"predictions_ep{e + 1}.tsv"))
        agent.log["ls_tr"].append(ls)
        agent.log["metrics_vl"].append(metrics)
        # the reference evaluates the test split each epoch too
        # (main_caption.py:182-217, val_yaml AND test_yaml)
        metrics_ts = None
        if dl_ts is not None:
            metrics_ts = eval_captions(
                dl_ts, predict_file=op.join(
                    cfg.path_output, f"predictions_test_ep{e + 1}.tsv"))
            agent.log["metrics_ts"].append(metrics_ts)
        agent.save_model(e + 1)
        agent.logger.info(
            f"Ep {e + 1}: loss {ls:.4f} vl {metrics} ts {metrics_ts}")
    return dict(agent.log)


def _pretrain_mask_prep(cfg: RunConfig, tok):
    from lavender_tpu_torch.tasks import pretrain as pt
    special = [tok.cls_token_id, tok.sep_token_id, tok.pad_token_id,
               tok.mask_token_id]

    def train_prep(batch):
        masked, ans = pt.mask_tokens(
            batch["txt"], special, tok.mask_token_id, cfg.train.p_mask)
        b = dict(batch)
        b["txt"], b["ans_mtm"] = masked, ans
        return b
    return train_prep


def _pretrain_epochs(cfg: RunConfig, tok, agent: Agent, mlm: bool):
    """Shard-by-shard epochs over ``{data_dir}/{dataset}_train_*.tsv``
    with ``txt_{dataset}.json`` (main_pretrain_mlm.py:235-328)."""
    import glob as globmod
    from lavender_tpu_torch.tasks import pretrain as pt
    agent.train_prep = _pretrain_mask_prep(cfg, tok)
    agent.save_training_meta()
    ds_name = cfg.data.dataset
    with open(op.join(cfg.data.data_dir, f"txt_{ds_name}.json")) as f:
        txt_data = json.load(f)
    parts = sorted(globmod.glob(
        op.join(cfg.data.data_dir, f"{ds_name}_train_*.tsv")))
    for e in range(cfg.train.size_epoch):
        for part, tsv_path in enumerate(parts):
            ds = pt.PretrainDataset(
                cfg.data, tok, "train", tsv_path,
                txt_data.get("train", txt_data), dataset_name=ds_name,
                mlm=mlm)
            dl = _loader(cfg, ds, True, seed=cfg.train.seed + e)
            ls = agent.train_epoch(e + 1, dl)
            agent.log[f"{ds_name}-p{part}"].append(ls)
            agent.save_model(e + 1)
            agent.logger.info(f"Ep {e + 1} part {part}: loss {ls:.4f}")
    return dict(agent.log)


@register("pretrain_mlm")
def run_pretrain_mlm(cfg: RunConfig, tok):
    """Unified pretraining over shard-partitioned corpora
    (main_pretrain_mlm.py:235-328): per-dataset shard files
    ``{data_dir}/{dataset}_train_{part}.tsv`` + ``txt_{dataset}.json``."""
    from lavender_tpu_torch.data.dataset import VideoTextDataset
    from lavender_tpu_torch.tasks import pretrain as pt
    state = _build_model(cfg, tok)
    # VTM prompt/task-token for the pretrain VTM pass
    # (main_pretrain_mlm.py:78-80,217-219)
    vtm_prompt = None
    if cfg.model.enable_prompt:
        vtm_prompt = VideoTextDataset(cfg.data, tok).get_prompt(
            "is the video-text paired, true or false?")
    pre = common.make_pretext_fn(cfg.model, task_name="vtm",
                                 prompt=vtm_prompt)
    loss_fn = pt.make_loss_fn(
        tok.convert_tokens_to_ids(["true"])[0],
        tok.convert_tokens_to_ids(["false"])[0],
        vtm_batch=min(cfg.train.size_batch, 4), pretext=pre)
    agent = Agent(cfg, state, loss_fn=loss_fn, has_aux=True)
    return _pretrain_epochs(cfg, tok, agent, mlm=True)


def _run_eval_retrieval(cfg: RunConfig, tok, head: str):
    from lavender_tpu_torch.tasks import eval_retrieval as er
    datasets = load_task_data(
        cfg.data, er.RetrievalEvalDataset, tok,
        multi_clip=cfg.multi_clip_testing)
    kw = {}
    if head == "ts":
        from lavender_tpu_torch.tasks.task_specific import LavenderTS
        kw = {"model_cls": LavenderTS, "head_out": 1}
    state = _build_model(cfg, tok, **kw)
    # feat-phase pretext injection (eval_retrieval_mlm.py:33-35): without
    # it a task-token/prompt-finetuned checkpoint evaluates wrong
    any_split = next(s for s in ("val", "test") if s in datasets)
    pre = _pretext(cfg, datasets[any_split], "vtm")
    results = {}
    for split in [s for s in ("val", "test") if s in datasets]:
        res = er.full_retrieval_eval(
            state.model, datasets[split],
            batch_size=cfg.train.size_batch, head=head, pretext=pre,
            rerank_top_k=int(cfg.extra.get("rerank_top_k", 0)))
        results[split] = res
        LOGGER.info(f"{split}: {res}")
    if cfg.path_ckpt and pdist.is_main_process():
        out = op.splitext(cfg.path_ckpt)[0] + "_results.json"
        with open(out, "w") as f:
            json.dump(results, f, indent=2)
    return results


@register("eval_retrieval")
def run_eval_retrieval(cfg: RunConfig, tok):
    """Two-phase full-corpus retrieval eval (eval_retrieval_mlm.py)."""
    return _run_eval_retrieval(cfg, tok, head="mlm")


@register("eval_retrieval_ts")
def run_eval_retrieval_ts(cfg: RunConfig, tok):
    """Scalar-head full-corpus retrieval eval
    (eval_retrieval_task_specific.py:133-244)."""
    return _run_eval_retrieval(cfg, tok, head="ts")


# task-token name per multi-task kind (add_prompt_or_task_token,
# main_multi_task_mlm.py:254-275; lsmdc-mc -> retmc -> "vtm")
_KIND2TASKTOK = {"retrieval": "vtm", "qamc": "mc", "qaoe": "oe",
                 "retmc": "vtm", "captioning": "cap"}
# the labels each kind's loss averages over (None: a fixed count)
_KIND2LABELS = {"retrieval": None, "qamc": "mask_ans", "qaoe": "mask_ans",
                "retmc": "mask_ans", "captioning": "ans_mtm"}


def _multi_task_prep(cfg: RunConfig, tok, kind: str, batch):
    """A multi-task batch for its kind: caption masking, and "vid" kept
    (as a process-stable int) only for retrieval."""
    from lavender_tpu_torch.models import captioning as cap
    if kind == "captioning":
        masked, ans = cap.caption_masking(
            batch["txt"], tok.pad_token_id, tok.mask_token_id,
            p_mask=cfg.train.p_mask)
        batch = dict(batch)
        batch["txt"], batch["ans_mtm"] = masked, ans
    batch = {k: v for k, v in batch.items() if k != "vid" or
             kind == "retrieval"}
    if kind == "retrieval":
        batch["vid"] = np.asarray(
            [_stable_vid(v) for v in batch["vid"]], np.int32)
    return batch


def _multi_task_loaders(cfg: RunConfig, tok, entries, ds_cls, names,
                        mlm_false=()):
    loaders, val_loaders, test_loaders, ratios = {}, {}, {}, {}
    for name, ent in zip(names, entries):
        dcfg = dataclasses.replace(cfg.data, dataset=ent["dataset"],
                                   task=ent["task"])
        kind = ent["type"]
        kw = {"mlm": False} if kind in mlm_false else {}
        dss = load_task_data(dcfg, ds_cls[kind], tok, **kw)
        loaders[name] = _loader(cfg, dss["train"], True)
        val_loaders[name] = _loader(cfg, dss["val"], False)
        if "test" in dss:
            test_loaders[name] = _loader(cfg, dss["test"], False)
        ratios[name] = int(ent.get("ratio", 1))
    return loaders, val_loaders, test_loaders, ratios


def _caption_metrics(agent, generate, dl, tok):
    from lavender_tpu_torch.utils.metrics import coco_caption_metrics
    cands, _ = _decode_captions(agent, generate, dl, tok)
    refs = _caption_refs(dl.dataset, cands)
    cands = {k: v for k, v in cands.items() if k in refs and refs[k]}
    if not cands:
        return {"CIDEr": 0.0}
    return coco_caption_metrics(cands, {k: refs[k] for k in cands})


def _multi_task_loop(cfg: RunConfig, agent: Agent, raw, loaders, ratios,
                     prep, steps, eval_all):
    """The MetaLoader loop: ``max_steps`` steps, each on the task the
    shared seeded draw picks, an eval + snapshot every ``iter_per_ep``."""
    from lavender_tpu_torch.data.loader import MetaLoader
    ml = MetaLoader(loaders, ratios=ratios, seed=cfg.train.seed)
    max_steps = int(raw.get("max_steps", 100))
    iter_per_ep = int(raw.get("iter_per_ep", max_steps))
    agent.save_training_meta()
    ep = 0
    it = iter(ml)
    for step_i in range(max_steps):
        name, batch = next(it)
        batch = next(iter(agent.batches([batch],
                                        lambda b: prep(name, b))))
        loss = steps[name](batch)
        if step_i % 20 == 0:
            agent.logger.info(f"step {step_i} [{name}] loss {float(loss):.4f}")
        if step_i and step_i % iter_per_ep == 0:
            ep = step_i // iter_per_ep
            eval_all(ep)
            agent.save_model(ep)
    eval_all(ep + 1)
    agent.save_model(ep + 1)
    return max_steps


@register("multi_task_mlm")
def run_multi_task_mlm(cfg: RunConfig, tok):
    """Unified multi-task finetune (main_multi_task_mlm.py): the config's
    ``multi_task_datasets`` (list of {type, task, dataset, ratio}); the
    MetaLoader picks a task per step from a shared seeded draw; every
    ``iter_per_ep`` steps every task is evaluated (caption CIDEr too) and
    a snapshot saved; the best epochs per task are reported
    (Agent_Multi_Task.run, main_multi_task_mlm.py:404-486)."""
    from lavender_tpu_torch.models import captioning as cap
    from lavender_tpu_torch.tasks import multi_task, qamc, qaoe, retmc
    from lavender_tpu_torch.tasks import retrieval
    with open(cfg.extra["config_path"]) as f:
        raw = json.load(f)
    entries = raw.get("multi_task_datasets", [])
    state = _build_model(cfg, tok)
    true_id = tok.convert_tokens_to_ids(["true"])[0]
    false_id = tok.convert_tokens_to_ids(["false"])[0]
    pretexts = {kind: common.make_pretext_fn(cfg.model, task_name=tt)
                for kind, tt in _KIND2TASKTOK.items()}
    losses = multi_task.build_multi_task_losses(
        true_id, false_id, label_smoothing=cfg.train.label_smoothing,
        pretexts=pretexts, group=1)
    agent = Agent(cfg, state, loss_fn=losses["retrieval"])
    steps = multi_task.make_multi_task_train_steps(
        losses, agent.state,
        {k: label_count(v) for k, v in _KIND2LABELS.items() if v})
    ans_tok_ids = tok.convert_tokens_to_ids(
        [f"{i}" for i in range(cfg.data.size_option)])
    evals = multi_task.build_multi_task_evals(
        true_id, false_id, ans_tok_ids=ans_tok_ids, pretexts=pretexts)
    generate = cap.make_generate_fn(
        agent.model, tok.cls_token_id, tok.sep_token_id, tok.pad_token_id,
        tok.mask_token_id, use_task_token=cfg.model.enable_task_token)
    ds_cls = {"retrieval": retrieval.RetrievalDataset,
              "qamc": qamc.QAMCDataset, "qaoe": qaoe.QAOEDataset,
              "retmc": retmc.RetMCDataset,
              "captioning": retrieval.RetrievalDataset}
    eval_keys = {
        "retrieval": ["img", "txt", "mask", "vid"],
        "qamc": ["img", "txt", "mask", "mask_ans", "ans_idx"],
        "qaoe": ["img", "txt", "mask", "mask_ans"],
        "retmc": ["img", "txt", "mask", "mask_ans", "ans_idx"],
    }
    names = [f'{e["type"]}-{e["dataset"]}' for e in entries]
    kinds = {n: e["type"] for n, e in zip(names, entries)}
    loaders, val_loaders, test_loaders, ratios = _multi_task_loaders(
        cfg, tok, entries, ds_cls, names, mlm_false=("captioning",))

    def evaluate_task(name, dl):
        """Per-task eval -> metric dict (Agent_Multi_Task.evaluate)."""
        kind = kinds[name]
        if kind == "captioning":
            return _caption_metrics(agent, generate, dl, tok)
        accs = []
        with agent.evaluating() as model:
            for db in agent.batches(dl, lambda b: _multi_task_prep(
                    cfg, tok, kind, b)):
                out = evals[kind](model, *[db[k] for k in eval_keys[kind]])
                ac = out[0] if kind == "qaoe" else out[-1]
                accs.extend(ac.double().cpu().ravel().tolist())
        key = "ac_1" if kind == "qaoe" else "ac"
        mean = gather_mean(accs)
        return {key: mean if mean == mean else 0.0}

    def eval_all(ep):
        for split, dls in (("vl", val_loaders), ("ts", test_loaders)):
            for name, dl in dls.items():
                res = evaluate_task(name, dl)
                for k, v in res.items():
                    agent.log[f"{name}_{split}_{k}"].append(v)
                agent.logger.info(f"Ep {ep} {name} {split}: {res}")

    max_steps = _multi_task_loop(
        cfg, agent, raw, loaders, ratios,
        lambda name, b: _multi_task_prep(cfg, tok, kinds[name], b),
        {n: steps[kinds[n]] for n in names}, eval_all)

    # best epochs per task (Agent_Multi_Task.best_epoch :481-486)
    best = {}
    for name in val_loaders:
        metric = "CIDEr" if kinds[name] == "captioning" else (
            "ac_1" if kinds[name] == "qaoe" else "ac")
        hist = agent.log.get(f"{name}_vl_{metric}", [])
        if hist:
            i = int(np.argmax(hist))
            best[name] = (i, hist[i])
            agent.logger.info(
                f"Best {metric} on {name} val @ ep {i + 1}, "
                f"{hist[i] * 100:.2f}")
    out = dict(agent.log)
    out["best"] = best
    out["steps"] = max_steps
    return out


@register("multi_task_multi_head")
def run_multi_task_multi_head(cfg: RunConfig, tok):
    """Multi-task baseline with per-task heads (main_multi_task_multi_head.py):
    the shared scalar ``fc`` + NormSoftmax for retrieval, one
    ``fc_<name>`` classifier per qamc/qaoe entry, the MLM head for
    captioning.  Entry options: {type, task, dataset, ratio,
    size_option|size_vocab}."""
    from lavender_tpu_torch.models import captioning as cap
    from lavender_tpu_torch.tasks import qamc, qaoe, retrieval
    from lavender_tpu_torch.tasks import task_specific as ts
    from lavender_tpu_torch.tasks.multi_task import (
        make_multi_task_train_steps)
    with open(cfg.extra["config_path"]) as f:
        raw = json.load(f)
    entries = raw.get("multi_task_datasets", [])
    names = [f'{e["type"]}-{e["dataset"]}' for e in entries]
    kinds = {n: e["type"] for n, e in zip(names, entries)}
    heads = tuple(
        (n, int(e.get("size_option", cfg.data.size_option))
         if e["type"] == "qamc" else int(e.get("size_vocab", 1000)))
        for n, e in zip(names, entries) if e["type"] in ("qamc", "qaoe"))
    state = _build_model(cfg, tok, model_cls=ts.LavenderMultiHead,
                         head_out=1, heads=heads)
    losses = ts.make_multi_head_losses(
        cfg.train.temp, kinds, label_smoothing=cfg.train.label_smoothing,
        group=1)
    agent = Agent(cfg, state, loss_fn=losses[names[0]])
    counts = {n: label_count("ans_mtm" if k == "captioning" else "ans")
              for n, k in kinds.items() if k != "retrieval"}
    steps = make_multi_task_train_steps(losses, agent.state, counts)
    generate = cap.make_generate_fn(
        agent.model, tok.cls_token_id, tok.sep_token_id, tok.pad_token_id,
        tok.mask_token_id)
    ds_cls = {"retrieval": retrieval.RetrievalDataset,
              "qamc": qamc.QAMCDataset, "qaoe": qaoe.QAOEDataset,
              "captioning": retrieval.RetrievalDataset}
    loaders, val_loaders, _, ratios = _multi_task_loaders(
        cfg, tok, entries, ds_cls, names, mlm_false=tuple(ds_cls))
    evals = {}
    for name in names:
        if kinds[name] == "retrieval":
            evals[name] = _wrap_eval(ts.make_retrieval_ts_eval(),
                                     ["img", "txt", "mask", "vid"])
        elif kinds[name] in ("qamc", "qaoe"):
            evals[name] = _wrap_eval(ts.make_head_cls_eval(name),
                                     ["img", "txt", "mask", "ans"])

    def prep(name, batch):
        return _multi_task_prep(cfg, tok, kinds[name], batch)

    def eval_all(ep):
        for name, dl in val_loaders.items():
            if kinds[name] == "captioning":
                res = _caption_metrics(agent, generate, dl, tok)
            else:
                accs = []
                with agent.evaluating() as model:
                    for db in agent.batches(dl, lambda b: prep(name, b)):
                        out = evals[name](model, db)
                        ac = out[-1] if isinstance(out, tuple) else out
                        accs.extend(ac.double().cpu().ravel().tolist())
                mean = gather_mean(accs)
                res = {"ac": mean if mean == mean else 0.0}
            for k, v in res.items():
                agent.log[f"{name}_vl_{k}"].append(v)
            agent.logger.info(f"Ep {ep} {name} vl: {res}")

    _multi_task_loop(cfg, agent, raw, loaders, ratios, prep, steps,
                     eval_all)
    return dict(agent.log)


def _run_ts(cfg: RunConfig, tok, dataset_cls, head_out: int, loss_fn,
            eval_step, keys, count_fn=None):
    """The *_task_specific fine-tuning mains: ``LavenderTS`` with a
    ``head_out`` head, re-randomized after a checkpoint load under
    ``reinit_head``."""
    from lavender_tpu_torch.tasks import task_specific as ts
    datasets = load_task_data(cfg.data, dataset_cls, tok, mlm=False)
    dl_tr, dl_vl, dl_ts = _loaders(cfg, datasets)
    cfg.train.max_iter = max(1, len(dl_tr) * cfg.train.size_epoch)
    state = _build_model(cfg, tok, model_cls=ts.LavenderTS,
                         head_out=head_out)
    _maybe_reinit_head(cfg, state)
    agent = Agent(cfg, state, loss_fn=loss_fn, count_fn=count_fn,
                   eval_step=_wrap_eval(eval_step, keys))
    return run_finetune(agent, dl_tr, dl_vl, dl_ts, cfg.train.size_epoch,
                        zero_shot=bool(cfg.path_ckpt))


@register("retrieval_ts")
def run_retrieval_ts(cfg: RunConfig, tok):
    """Scalar-head retrieval baseline + NormSoftmax InfoNCE
    (main_retrieval_task_specific.py)."""
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.tasks import task_specific as ts
    return _run_ts(cfg, tok, retrieval.RetrievalDataset, 1,
                   ts.make_retrieval_ts_loss(cfg.train.temp, group=1),
                   ts.make_retrieval_ts_eval(),
                   ["img", "txt", "mask", "vid"])


@register("qamc_ts")
def run_qamc_ts(cfg: RunConfig, tok):
    """size_option classifier-head MC-QA (main_qamc_task_specific.py)."""
    from lavender_tpu_torch.tasks import qamc
    from lavender_tpu_torch.tasks import task_specific as ts
    return _run_ts(cfg, tok, qamc.QAMCDataset, cfg.data.size_option,
                   ts.make_cls_loss(), ts.make_cls_eval(),
                   ["img", "txt", "mask", "ans"], label_count("ans"))


@register("qaoe_ts")
def run_qaoe_ts(cfg: RunConfig, tok):
    """size_vocab classifier-head OE-QA (main_qaoe_task_specific.py)."""
    from lavender_tpu_torch.tasks import qaoe
    from lavender_tpu_torch.tasks import task_specific as ts
    assert cfg.data.size_vocab > 0, "qaoe_ts needs size_vocab"
    return _run_ts(cfg, tok, qaoe.QAOEDataset, cfg.data.size_vocab,
                   ts.make_cls_loss(), ts.make_cls_eval(),
                   ["img", "txt", "mask", "ans"], label_count("ans"))


@register("retmc_ts")
def run_retmc_ts(cfg: RunConfig, tok):
    """Scalar-head LSMDC-MC baseline (main_retmc_task_specific.py)."""
    from lavender_tpu_torch.tasks import retmc
    from lavender_tpu_torch.tasks import task_specific as ts
    return _run_ts(cfg, tok, retmc.RetMCDataset, 1,
                   ts.make_retmc_ts_loss(), ts.make_retmc_ts_eval(),
                   ["img", "txt", "mask", "ans"], label_count("ans"))


@register("pretrain_ts")
def run_pretrain_ts(cfg: RunConfig, tok):
    """Baseline pretraining: MLM + binary scalar-VTM head over shard parts
    (main_pretrain_task_specific.py)."""
    from lavender_tpu_torch.tasks import task_specific as ts
    state = _build_model(cfg, tok, model_cls=ts.LavenderTS, head_out=1)
    loss_fn = ts.make_pretrain_ts_loss(
        temp=cfg.train.temp, vtm_batch=min(cfg.train.size_batch, 4))
    agent = Agent(cfg, state, loss_fn=loss_fn, has_aux=True)
    return _pretrain_epochs(cfg, tok, agent, mlm=False)


def _stable_vid(v) -> int:
    """Process-stable int id for a video key (``hash(str)`` is salted per
    process; crc32 is not)."""
    if isinstance(v, str):
        return zlib.crc32(v.encode("utf-8")) % (2 ** 31)
    return int(v)


def _maybe_reinit_head(cfg: RunConfig, state):
    """``args.reinit_head`` (utils/args.py:71): re-randomize the task head
    after a checkpoint load, as every *_task_specific main does
    (e.g. main_qaoe_task_specific.py:169-170)."""
    if not (cfg.extra.get("reinit_head") and cfg.path_ckpt):
        return state
    from lavender_tpu_torch.tasks import task_specific as ts
    dev = next(state.model.parameters()).device
    ts.reinit_head(state.model, "fc", generator=torch.Generator(
        dev).manual_seed(cfg.train.seed))
    LOGGER.info("reinit_head: task head re-randomized")
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", required=True, choices=sorted(TASKS))
    ap.add_argument("--config", required=True,
                    help="JSON config (reference _args/*.json key names)")
    ap.add_argument("--path_ckpt", default=None)
    ap.add_argument("--path_output", default=None)
    ap.add_argument("--vocab", default=None, help="WordPiece vocab.txt")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the run goes (default: the GPU; nothing "
                         "falls back to the CPU)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lavender_tpu_torch.cli.main: no CUDA device "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to run on the CPU")

    with open(args.config) as f:
        _raw = json.load(f)
    if args.path_ckpt:
        # set before load so ckpt-args inheritance (config.inherit_ckpt_args)
        # sees the checkpoint directory (utils/args.py:245-293)
        _raw["path_ckpt"] = args.path_ckpt
    cfg = load_run_config(_raw)
    cfg.extra["config_path"] = args.config
    cfg.extra["device"] = args.device
    for key in ("size_test", "rerank_top_k"):
        if key in _raw:
            cfg.extra[key] = _raw[key]
    if "reinit_head" in _raw:
        cfg.extra["reinit_head"] = bool(_raw["reinit_head"])
    if args.path_ckpt:
        cfg.path_ckpt = args.path_ckpt
    if args.path_output:
        cfg.path_output = args.path_output
    if args.vocab:
        cfg.data.vocab_path = args.vocab
    cfg.path_output = "%s/_%s_%s" % (
        cfg.path_output, cfg.data.task or args.task,
        datetime.now().strftime("%Y%m%d%H%M%S"))

    # the reference runs every main under DDP (utils/dist.py:20-75,
    # agent.py:252-265): the process group from the environment, if any
    if pdist.distributed_init(device=args.device):
        LOGGER.info(f"data parallel: {pdist.process_count()} processes, "
                    f"rank {pdist.process_index()}")
    install_mesh(cfg.tp, args.device)
    tok = BertTokenizer(cfg.data.vocab_path)
    return TASKS[args.task](cfg, tok)


if __name__ == "__main__":
    main()
