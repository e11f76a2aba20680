"""The train step (port of lavender_tpu/train/trainer.py, the step that
``bench.py --train`` times).

``create_train_state`` builds the model with float32 master weights, its
AdamW groups and schedule, and the seeded random stream of dropout and
drop-path; ``make_train_step`` returns ``step(batch) -> loss`` (with
``has_aux``, ``(loss, metrics)``): the loss
and its backward under ``torch.autocast(bfloat16)`` on the card (the JAX
CLI's f32 params with bf16 modules; the kernels' autograd Functions take
their inputs cast to bf16), the global-norm clip, the AdamW update and the
scheduler step.  Nothing inside a step syncs with the host: the loss
comes back as a device tensor.

    state = create_train_state(config, TrainConfig(max_iter=1000,
                                                   max_grad_norm=1.0), seed=0)
    step = make_train_step(retrieval.make_loss_fn(true_id, false_id), state)
    loss = step({"img": img_u8, "txt": txt, "mask": mask, "vid": vid})

Data parallel (the JAX package's sharded step, DDP + ZeRO-1): under a
process group (``parallel.dist.distributed_init``) ``shard_train_state``
places a fresh state (the weights broadcast from rank 0, the AdamW state
sharded over the ranks, the random stream seeded per rank) and the step
averages the gradients over the ranks after the backward, in the same
order on every rank, before the clip and the update.  The task losses
call model methods other than ``forward`` (``go_feat``, the pair
functions, the heads), so DDP's forward-armed hooks would miss them; the
all-reduce is explicit.  A loss that is a mean over a variable number of
labels (``count_fn``) is scaled by ``world * local / global`` count first,
so that the ranks together compute the global batch's mean, as the JAX
step does.  The eval forward needs no placement (JAX
``make_eval_forward``): each rank scores its own loader shard on its
replica and the metrics are gathered (``parallel.dist.all_gather_obj``).

Tensor parallel (``parallel.mesh``, a mesh installed with ``tp`` > 1):
``shard_train_state`` first slices the weights onto this rank's model
slice (``mesh.shard_model``), then broadcasts them within its data group,
builds ZeRO-1 over the data group and seeds the random stream by the DATA
rank, so that the ``tp`` ranks of one data shard draw the same dropout and
drop-path masks (the attention kernels offset their streams by head).  The
loss of a data shard is the same on its ``tp`` ranks; the loss mean and
the gradient average run over the data group, and the clip's norm sums
the sharded gradients' squares over the model group.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from lavender_tpu_torch.config import ModelConfig, TrainConfig
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models.lavender import LavenderModel, init_weights
from lavender_tpu_torch.parallel import dist as pdist
from lavender_tpu_torch.parallel import mesh
from lavender_tpu_torch.train.optimizer import (build_optimizer,
                                                clip_by_global_norm)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator  # dropout and drop-path masks
    config: TrainConfig
    step: int = 0


def create_train_state(config: ModelConfig, train_config: TrainConfig, *,
                       device="cuda", seed: int = 0,
                       params: Optional[Mapping] = None,
                       model: Optional[nn.Module] = None) -> TrainState:
    """A ``LavenderModel`` (or ``model``, a subclass such as
    ``tasks.task_specific.LavenderTS``, built on the CPU) in train mode on
    ``device`` ("cuda" unless the caller asks for "cpu"), float32, with the
    JAX package's params (``convert.from_flax``) or a seeded random init,
    and its optimizer.  The fusion encoder trains on the route
    ``config.bert`` names, as the JAX package does: ``fused_attn_train``
    (default True) K10 + K11 (K13 + K11 under ``LVT_ATTNLANES=0``),
    ``fused_ffn_train`` (default False) K12, else the module math."""
    device = torch.device(device)
    model = LavenderModel(config) if model is None else model
    if params is not None:
        model.load_state_dict(from_flax(params), strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=torch.float32).train()
    optimizer, scheduler = build_optimizer(model, train_config)
    generator = torch.Generator(device).manual_seed(seed)
    return TrainState(model, optimizer, scheduler, generator, train_config)


def rank_seed(seed: int, rank: int) -> int:
    """The random stream's seed of ``rank``: ``seed`` on rank 0 (so one
    rank draws what a single process draws), distinct on the others."""
    return seed + (rank << 32)


def shard_train_state(state: TrainState, seed: int = 0) -> TrainState:
    """Place a freshly created state for data-parallel training (JAX
    ``shard_train_state``): under a process group, the weights sliced to
    this rank's model slice where a mesh with tp > 1 is installed
    (``mesh.shard_model``), the weights and buffers broadcast from data
    shard 0 of this rank's data group, AdamW rebuilt as ZeRO-1 over the
    data group (``build_optimizer(..., zero1=True)``) with a fresh
    schedule, and the generator seeded from ``(seed, data rank)``
    (``rank_seed``).  Without a group the state is returned as it is."""
    if not pdist.is_initialized():
        return state
    mesh.shard_model(state.model)
    pdist.broadcast_module(state.model)
    state.optimizer, state.scheduler = build_optimizer(
        state.model, state.config, zero1=True)
    state.generator.manual_seed(rank_seed(seed, pdist.data_index()))
    return state


def label_count(key: str) -> Callable:
    """``count_fn`` of a loss that averages over the labels of
    ``batch[key]`` that are >= 0 (``tasks.common.cross_entropy_ignore``,
    ``label_smoothed_kl_loss``)."""

    def count(batch):
        return (batch[key] >= 0).sum()

    return count


def make_train_step(loss_fn: Callable, state: TrainState,
                    has_aux: bool = False,
                    count_fn: Optional[Callable] = None) -> Callable:
    """``step(batch) -> loss`` (a detached device scalar) that advances
    ``state`` by one update.  ``loss_fn(model, batch, generator)`` returns
    the loss or, with ``has_aux``, ``(loss, metrics)`` (a dict of scalars,
    JAX ``value_and_grad(has_aux=True)``), and the step then returns
    ``(loss, metrics)``, each detached.  On a CUDA device the loss and its
    backward run under bf16 autocast; on the CPU (the parity tests) in
    float32.

    Under a process group the gradients are averaged over the data shards
    before the clip, and the returned loss is the shards' mean; with
    ``count_fn(batch)`` (the number of terms the loss averages, e.g.
    ``label_count("mask_ans")``) and more than one rank, each rank's loss
    is first weighted by ``world * count / global count``, so the returned
    loss and the gradients are the global batch's mean (the metrics of
    ``has_aux`` stay the rank's own)."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    device_type = params[0].device.type

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        with torch.autocast(device_type, dtype=torch.bfloat16,
                            enabled=device_type == "cuda"):
            out = loss_fn(state.model, batch, state.generator)
        loss, aux = out if has_aux else (out, None)
        data_parallel = pdist.is_initialized()
        world = pdist.data_count()
        if data_parallel and world > 1 and count_fn is not None:
            loss = loss * pdist.mean_weight(count_fn(batch)).to(loss.device)
        loss.backward()
        if data_parallel:
            pdist.all_reduce_grads(params)
        if state.config.max_grad_norm and state.config.max_grad_norm > 0:
            clip_by_global_norm(params, state.config.max_grad_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        loss = loss.detach()
        if data_parallel and world > 1:
            loss = pdist.all_reduce_sum(loss.clone()) / world
        if has_aux:
            return loss, {k: v.detach() for k, v in aux.items()}
        return loss

    return step
