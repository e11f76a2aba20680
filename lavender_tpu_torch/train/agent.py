"""Generic training/eval agent (port of lavender_tpu/train/agent.py): the
reference's Agent_Base and per-task go_dl loops (agent.py:68,
main_retrieval_mlm.py:120-148): iterate the loader, run the step, gather
the metrics over the ranks, log loss, throughput and memory on a cadence,
snapshot per epoch, track the best epoch.

Batches reach the card through ``data.loader``: the loader collates into
page-locked memory (``pin_memory=True`` on the card) and
``device_prefetch`` copies each batch on a side stream ahead of its step.
Under a process group (``parallel.dist.distributed_init``) the state is
placed by ``trainer.shard_train_state`` (ZeRO-1) and the step averages
the gradients over the ranks; each rank evaluates its loader shard and the
metrics are gathered with ``all_gather_obj`` (once per data shard under
tensor parallelism); rank 0 alone writes files, the weights in the full
layout.

    agent = Agent(cfg, state, loss_fn, eval_step=_wrap_eval(step, keys))
    log = run_finetune(agent, dl_tr, dl_vl, dl_ts, cfg.train.size_epoch)
"""
from __future__ import annotations

import contextlib
import os.path as op
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from lavender_tpu_torch.config import RunConfig
from lavender_tpu_torch.data.loader import device_prefetch
from lavender_tpu_torch.models import swin3d
from lavender_tpu_torch.parallel import dist as pdist
from lavender_tpu_torch.parallel import mesh
from lavender_tpu_torch.tasks import common
from lavender_tpu_torch.train import checkpoint as ckpt_lib
from lavender_tpu_torch.train import trainer
from lavender_tpu_torch.utils.logging import RunningMeter, main_logger
from lavender_tpu_torch.utils.profiling import log_memory_string


def host_prep(batch: Dict, prep: Callable) -> Dict:
    """``prep`` (a host-side hook on numpy arrays, e.g. MLM masking) on a
    collated batch; the entries it passes through unchanged keep their
    (page-locked) tensors."""
    views = {k: v.numpy() if isinstance(v, torch.Tensor) else v
             for k, v in batch.items()}
    out = prep(views)
    return {k: batch[k] if k in views and v is views[k] else v
            for k, v in out.items()}


def gather_mean(values: Iterable[float]) -> float:
    """The mean of every rank's ``values`` (nan when all are empty)."""
    gathered = []
    for per_rank in pdist.all_gather_obj(np.asarray(list(values),
                                                    np.float64)):
        gathered.extend(np.ravel(per_rank).tolist())
    return float(np.mean(gathered)) if gathered else float("nan")


class Agent:
    """Drives train/eval epochs for one task.

    ``state``: a ``trainer.TrainState`` (``create_train_state``), placed
    here for data parallelism.  ``loss_fn(model, batch, generator)`` as
    ``trainer.make_train_step`` takes it, with its ``has_aux`` and
    ``count_fn``.  ``eval_step(model, batch)`` -> per-sample metric (or a
    tuple whose last entry is).  ``train_prep``: a host-side batch hook on
    numpy arrays (e.g. MLM masking)."""

    def __init__(self, run_cfg: RunConfig, state: trainer.TrainState,
                 loss_fn: Callable, eval_step: Optional[Callable] = None,
                 train_prep: Optional[Callable] = None,
                 has_aux: bool = False,
                 count_fn: Optional[Callable] = None):
        self.cfg = run_cfg
        self.tcfg = run_cfg.train
        self.state = trainer.shard_train_state(state, seed=self.tcfg.seed)
        self.model = self.state.model
        self.device = next(self.model.parameters()).device
        self.log: Dict[str, List] = defaultdict(list)
        self.logger = main_logger()
        self.has_aux = has_aux
        self.train_step = trainer.make_train_step(
            loss_fn, self.state, has_aux=has_aux, count_fn=count_fn)
        self.eval_step = eval_step
        self.train_prep = train_prep
        self.logging_steps = 20
        # serving-cache builds: fresh ones, and failed ones (the eval then
        # ran without the cache)
        self.cache_builds = self.cache_failures = 0
        # the last train epoch: steps, clips and host seconds
        self.epoch_stats: Dict[str, float] = {}
        # optional TensorBoard scalars (reference utils/logger.py:119-161):
        # rank 0 only
        self.tb = None
        if run_cfg.extra.get("tensorboard") and pdist.is_main_process():
            from lavender_tpu_torch.utils.tb import TensorboardLogger
            self.tb = TensorboardLogger(run_cfg.path_output)

    def batches(self, dl, prep: Optional[Callable] = None):
        """The loader's batches on the device, ``prep`` applied on the
        host first; copied ahead of the consumer (``device_prefetch``).
        Under tensor parallelism each batch is then broadcast from model
        rank 0 of the data shard (``mesh.broadcast_batch``): the host's
        frame sampling and masking are per-process draws."""
        def host():
            for b in dl:
                yield b if prep is None else host_prep(b, prep)
        staged = device_prefetch(host(), self.device)
        if not mesh.tp_active():
            return staged
        return (mesh.broadcast_batch(b) for b in staged)

    # ---- loops (go_dl equivalent) ----

    def train_epoch(self, ep: int, dl) -> float:
        dl.set_epoch(ep)
        meter = RunningMeter("ls_tr")
        losses = []
        t0 = time.time()
        n_clips = 0
        for idx, batch in enumerate(self.batches(dl, self.train_prep)):
            out = self.train_step(batch)
            loss = out[0] if self.has_aux else out
            if idx % self.logging_steps == 0:
                loss_v = float(loss)
                meter(loss_v)
                lrs = self.state.scheduler.get_last_lr()
                self.logger.info(
                    f"ep {ep} step {idx + 1} loss {loss_v:.4f} "
                    f"({self.throughput(n_clips, t0)}; "
                    f"{log_memory_string(self.state.step, lrs[0], lrs[-1])})")
                if self.tb is not None:
                    self.tb.set_step(self.state.step)
                    self.tb.add_scalar("ls_tr", loss_v)
            losses.append(loss)
            n_clips += len(next(iter(batch.values())))
        vals = (torch.stack(losses).double().cpu().tolist() if losses
                else [])
        self.epoch_stats = {"steps": len(vals), "clips": n_clips,
                            "seconds": time.time() - t0}
        return gather_mean(vals)

    def eval_variables(self):
        """Build the model's serving caches (rel-pos biases, shift masks,
        LN folds) ONCE per eval epoch from the CURRENT weights (JAX
        ``eval_variables``), so that the eval steps read them instead of
        gathering per call; the staleness guard then checks them.  A build
        that fails is logged as a warning and counted in
        ``cache_failures``, and the eval runs without the cache.  Call with
        the model in ``eval()`` mode (``evaluating``): ``train()`` drops
        the cache."""
        S, T = self.cfg.data.size_img, self.cfg.data.size_frame
        try:
            with common.evaluating(self.model):
                self.model.build_serving_cache(T, S, S)
            self.cache_builds += int(swin3d.check_serving_cache(self.model))
        except Exception as e:  # the cache is an optimization, not a crash
            self.cache_failures += 1
            self.logger.warning(f"serving cache skipped: {e}")
            self.model.enc_img.swin.clear_serving_cache()
        return self.model

    @contextlib.contextmanager
    def evaluating(self):
        """The model in ``eval()`` mode with its serving caches built
        (``eval_variables``) for the block's eval steps, back in its mode
        after (training drops the caches)."""
        was = self.model.training
        self.model.eval()
        try:
            yield self.eval_variables()
        finally:
            self.model.train(was)

    def eval_epoch(self, dl, **kw) -> float:
        assert self.eval_step is not None
        accs: List[float] = []
        with self.evaluating() as model:
            for batch in self.batches(dl):
                out = self.eval_step(model, batch, **kw)
                ac = out[-1] if isinstance(out, tuple) else out
                accs.extend(ac.double().cpu().ravel().tolist())
        return gather_mean(accs)

    @staticmethod
    def throughput(n: int, t0: float) -> str:
        dt = max(time.time() - t0, 1e-9)
        return f"{n / dt:.1f} clips/s"

    # ---- checkpointing (agent.py:155-182 equivalents) ----

    def save_training_meta(self):
        if pdist.is_main_process():
            ckpt_lib.save_training_meta(self.cfg, self.cfg.path_output)

    def save_model(self, ep: int):
        """Rank 0 writes the weights (``ckpt_<task>_<ep>.pt``, the
        reference's per-epoch snapshot, in the full layout: every rank
        calls, a collective under tensor parallelism) and ``log.json``."""
        weights = mesh.full_state_dict(self.model)
        if pdist.is_main_process():
            path = op.join(self.cfg.path_output,
                           f"ckpt_{self.cfg.data.task or 'model'}_{ep}.pt")
            ckpt_lib.save_params(weights, path)
            ckpt_lib.save_log(dict(self.log), self.cfg.path_output)

    def best_epoch(self):
        """(best val, best test) epochs (agent.py:267-276)."""
        vl = self.log["ac_vl"]
        ts = self.log["ac_ts"]
        iv, it = int(np.argmax(vl)), int(np.argmax(ts))
        return (iv, vl[iv]), (it, ts[it])

    def save_state(self, path: str):
        """Full train-state snapshot (optimizer + step) for a resume; every
        rank calls it (ZeRO-1 consolidates on rank 0, which writes)."""
        ckpt_lib.save_train_state(self.state, path)

    def maybe_resume(self, path: str) -> bool:
        """Restore a full train state if a snapshot exists; returns True on
        resume.  Data shards other than 0 re-seed their random stream from
        (seed + step, data rank): the file holds shard 0's."""
        if not op.exists(path):
            return False
        ckpt_lib.restore_train_state(path, self.state)
        rank = pdist.data_index()
        if rank:
            self.state.generator.manual_seed(trainer.rank_seed(
                self.tcfg.seed + self.state.step, rank))
        self.logger.info(f"resumed train state from {path} "
                         f"(step {self.state.step})")
        return True


def run_finetune(agent: Agent, dl_tr, dl_vl, dl_ts, size_epoch: int,
                 zero_shot: bool = False):
    """The shared main-script epoch loop (main_retrieval_mlm.py:183-208)."""
    logger = agent.logger
    agent.save_training_meta()
    if zero_shot:
        ac_vl = agent.eval_epoch(dl_vl)
        ac_ts = agent.eval_epoch(dl_ts) if dl_ts is not None else float("nan")
        logger.info(f"ZS: {ac_vl * 100:.2f} {ac_ts * 100:.2f}")
    for e in range(size_epoch):
        ls_tr = agent.train_epoch(e + 1, dl_tr)
        ac_vl = agent.eval_epoch(dl_vl)
        ac_ts = agent.eval_epoch(dl_ts) if dl_ts is not None else float("nan")
        agent.log["ls_tr"].append(ls_tr)
        agent.log["ac_vl"].append(ac_vl)
        agent.log["ac_ts"].append(ac_ts)
        if agent.tb is not None:
            agent.tb.add_scalars(
                {"ls_tr": ls_tr, "ac_vl": ac_vl, "ac_ts": ac_ts}, step=e + 1)
            agent.tb.flush()
        agent.save_model(e + 1)
        logger.info(f"Ep {e + 1}: {ls_tr:.6f} {ac_vl:.6f} {ac_ts:.6f}")
    if size_epoch:
        best_vl, best_ts = agent.best_epoch()
        logger.info(f"Best val @ ep {best_vl[0] + 1}, {best_vl[1]:.6f}")
        logger.info(f"Best test @ ep {best_ts[0] + 1}, {best_ts[1]:.6f}")
    return agent.log
