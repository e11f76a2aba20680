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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from lavender_tpu_torch.config import ModelConfig, TrainConfig
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models.lavender import LavenderModel, init_weights
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


def make_train_step(loss_fn: Callable, state: TrainState,
                    has_aux: bool = False) -> Callable:
    """``step(batch) -> loss`` (a detached device scalar) that advances
    ``state`` by one update.  ``loss_fn(model, batch, generator)`` returns
    the loss or, with ``has_aux``, ``(loss, metrics)`` (a dict of scalars,
    JAX ``value_and_grad(has_aux=True)``), and the step then returns
    ``(loss, metrics)``, each detached.  On a CUDA device the loss and its
    backward run under bf16 autocast; on the CPU (the parity tests) in
    float32."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    device_type = params[0].device.type

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        with torch.autocast(device_type, dtype=torch.bfloat16,
                            enabled=device_type == "cuda"):
            out = loss_fn(state.model, batch, state.generator)
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        if state.config.max_grad_norm and state.config.max_grad_norm > 0:
            clip_by_global_norm(params, state.config.max_grad_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        if has_aux:
            return loss.detach(), {k: v.detach() for k, v in aux.items()}
        return loss.detach()

    return step
