"""Optimizer and LR schedule (port of lavender_tpu/train/optimizer.py;
reference agent.py Agent_Base.build_optimizer).

The reference's 4-group AdamW, {swin, other} x {decay, no-decay}, with the
Swin groups' LR scaled by ``vis_backbone_lr_mul``, and the per-iteration
warmup-linear schedule floored at ``min_lr``.  ``torch.optim.AdamW`` under
a ``LambdaLR`` computes what the JAX package's optax chain
``scale_by_adam -> add_decayed_weights -> scale_by_learning_rate`` does:
p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), with the schedule
read at the update's index (0 for the first).  The optional global-norm
clip is optax's ``clip_by_global_norm``.  Under a process group
``build_optimizer(..., zero1=True)`` shards the AdamW state over the ranks
(``torch.distributed.optim.ZeroRedundancyOptimizer``: the JAX package's
``opt_state_pspecs``, the reference's DeepSpeed stage 1) with the same
groups and schedule; under tensor parallelism over the data group only,
each model slice's moments split over its data shards.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

from lavender_tpu_torch.config import TrainConfig
from lavender_tpu_torch.parallel import mesh

GROUPS = ("swin_decay", "swin_nodecay", "other_decay", "other_nodecay")


def warmup_linear_schedule(base_lr: float, max_iter: int,
                           warmup_ratio: float = 0.1,
                           min_lr: float = 1e-8) -> Callable[[int], float]:
    """LR at step: linear 0 -> base_lr over the warmup, then linear to 0 at
    max_iter (agent.py:28-43), never below min_lr."""
    warmup = int(warmup_ratio * max_iter)

    def schedule(step: int) -> float:
        if step < warmup:
            factor = step / max(warmup, 1)
        else:
            factor = (max_iter - min(step, max_iter)) / max(max_iter - warmup,
                                                            1)
        return max(base_lr * factor, min_lr)

    return schedule


def param_group_labels(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> one of ``GROUPS``.  Swin: the name contains
    "swin".  No decay (agent.py:98): the leaf name contains "bias" (the
    rel-pos tables included) or the parameter is a LayerNorm weight."""
    ln_weights = {id(m.weight) for m in model.modules()
                  if isinstance(m, nn.LayerNorm)}
    labels = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        no_decay = "bias" in leaf or id(p) in ln_weights
        labels[name] = (("swin_" if "swin" in name else "other_")
                        + ("nodecay" if no_decay else "decay"))
    return labels


def build_optimizer(model: nn.Module, cfg: TrainConfig, zero1: bool = False
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over the four groups and its per-iteration schedule (step the
    scheduler once after every optimizer step); ``zero1``: each rank of
    its data group keeps the AdamW state of its share of the parameters
    only, and the updated parameters are broadcast from their owners
    after each step."""
    max_iter = max(cfg.max_iter, 1)
    labels = param_group_labels(model)
    members: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        members[labels[name]].append(p)
    groups, lambdas = [], []
    for g in GROUPS:
        if not members[g]:
            continue
        lr = cfg.lr * (cfg.vis_backbone_lr_mul if g.startswith("swin")
                       else 1.0)
        groups.append({"params": members[g], "lr": lr,
                       "weight_decay": cfg.decay if g.endswith("_decay")
                       else 0.0, "name": g})
        sched = warmup_linear_schedule(lr, max_iter, cfg.warmup_ratio,
                                       cfg.min_lr)
        lambdas.append(lambda step, sched=sched, lr=lr: sched(step) / lr)
    if zero1:
        from torch.distributed.optim import ZeroRedundancyOptimizer
        opt = ZeroRedundancyOptimizer(
            groups, optimizer_class=torch.optim.AdamW,
            process_group=mesh.data_group(), betas=tuple(cfg.betas),
            eps=1e-8)
    else:
        opt = torch.optim.AdamW(groups, betas=tuple(cfg.betas), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambdas)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[nn.Parameter],
                        max_norm: float) -> torch.Tensor:
    """Scale every gradient by max_norm / max(norm, max_norm), norm being
    the global L2 norm of all of them (optax ``clip_by_global_norm``), on
    the device and without a host sync.  Returns the norm.  Under tensor
    parallelism the squares of the sharded gradients are summed over the
    model ranks and each replicated gradient counted once."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    sharded = [mesh.is_sharded(p) for p in params]
    if any(sharded):
        split = torch.tensor(sharded, device=norms.device)
        sq = (norms.square() * split).sum()
        torch.distributed.all_reduce(sq, group=mesh.model_group())
        norm = (sq + (norms.square() * ~split).sum()).sqrt()
    else:
        norm = torch.linalg.vector_norm(norms)
    torch._foreach_mul_(grads, max_norm / torch.maximum(
        norm, torch.tensor(max_norm, device=norm.device)))
    return norm
