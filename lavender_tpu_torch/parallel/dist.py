"""The process layer of data-parallel training over ``torch.distributed``
(port of the process helpers of lavender_tpu/parallel/mesh.py; reference
utils/dist.py).

One process drives one GPU (``LOCAL_RANK``); the process group is NCCL on
the card and gloo on the CPU.  Each data shard holds its own share of the
batch (``data.loader.DataLoader(rank=data_index(), world=data_count())``)
and a replica of the weights; after the backward the gradients are
averaged over the data shards by hand (``all_reduce_grads``) and the
optimizer state is sharded ZeRO-1 style over them
(``train.trainer.shard_train_state``).  Under tensor parallelism
(``parallel.mesh``: the JAX package's mesh, ``_PARAM_RULES`` and model
axis) a data shard is ``tp`` processes that hold the same batch and a
slice each of the weights: every helper here then works within this
rank's data group (the ranks of the same model slice), so that the loss,
the gradients, the negatives and the gathered metrics count each data
shard once.  Without a mesh the data group is the whole process group.

    distributed_init()          # WORLD_SIZE / RANK / MASTER_* or OpenMPI
    preds = all_gather_obj(my_preds)   # one entry per data shard
"""
from __future__ import annotations

import os
import pickle
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from lavender_tpu_torch.parallel import mesh


def local_rank() -> int:
    """The process's GPU on its host: ``LOCAL_RANK`` (torchrun) or
    OpenMPI's ``OMPI_COMM_WORLD_LOCAL_RANK``, else 0."""
    env = os.environ
    return int(env.get("LOCAL_RANK",
                       env.get("OMPI_COMM_WORLD_LOCAL_RANK", "0")))


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> bool:
    """Process-group init (the reference's dist_init, utils/dist.py:20-75),
    with JAX ``distributed_init``'s env detection order: explicit args
    ("host:port", size, rank), then OpenMPI's ``OMPI_COMM_WORLD_*``, then
    ``WORLD_SIZE`` > 1 with ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``,
    else single process (nothing initialized).  ``device`` "cuda": NCCL,
    this process on GPU ``local_rank()``; "cpu": gloo.  Returns True when
    a group of more than one process is up.  Safe to call twice."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    master = (f'{env.get("MASTER_ADDR", "127.0.0.1")}:'
              f'{env.get("MASTER_PORT", "29500")}')
    if coordinator_address is None:
        if "OMPI_COMM_WORLD_SIZE" in env:
            num_processes = int(env["OMPI_COMM_WORLD_SIZE"])
            process_id = int(env["OMPI_COMM_WORLD_RANK"])
        elif int(env.get("WORLD_SIZE", "1")) > 1:
            num_processes = int(env["WORLD_SIZE"])
            process_id = int(env["RANK"])
        else:
            return False
        coordinator_address = master
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_init: device 'cuda' asked for "
                               "but torch.cuda.is_available() is False")
        torch.cuda.set_device(local_rank())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


# this rank's data shard and the number of shards (the process rank and
# count without a mesh)
data_index, data_count = mesh.data_rank, mesh.data_size


def global_dp() -> int:
    """The data-parallel world size: the data shards.  The losses'
    in-batch ``group`` stays 1 on each rank, which holds only its own
    share of the batch (JAX passes ``global_dp()`` because its batch is
    global)."""
    return data_count()


def _comm_device() -> torch.device:
    """Where the collectives' tensors live: the process's GPU under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_obj(obj) -> List:
    """Gather a picklable from every data shard -> list, one entry per
    shard, in shard order (the reference's byte-tensor all_gather,
    utils/dist.py:187-227): pickled, the lengths gathered, zero-padded to
    the longest, gathered, unpickled.  Single shard: ``[obj]``.  Tensors
    inside ``obj`` should be on the CPU."""
    world = data_count()
    if world == 1:
        return [obj]
    dev, group = _comm_device(), mesh.data_group()
    data = pickle.dumps(obj)
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    size = torch.tensor([buf.numel()], dtype=torch.long, device=dev)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size, group=group)
    lengths = [int(s) for s in sizes]
    padded = torch.zeros(max(lengths), dtype=torch.uint8, device=dev)
    padded[:buf.numel()] = buf
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded, group=group)
    return [pickle.loads(g[:n].cpu().numpy().tobytes())
            for g, n in zip(gathered, lengths)]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data shards, in place (a no-op without a
    group)."""
    if is_initialized() and data_count() > 1:
        dist.all_reduce(t, group=mesh.data_group())
    return t


def mean_weight(count) -> torch.Tensor:
    """``world * count / (count summed over the data shards)``: the factor
    that makes a shard's mean over its ``count`` terms its share of the
    mean over every shard's terms, once the shards' gradients are averaged
    (the JAX package's global-batch mean).  A sum over 0 terms weighs 0."""
    local = torch.as_tensor(count).float()
    total = all_reduce_sum(local.clone().to(_comm_device()))
    return data_count() * local / total.to(local.device).clamp(min=1)


def broadcast_main(t: torch.Tensor) -> torch.Tensor:
    """``t`` as data shard 0 holds it, on every rank of this rank's data
    group (in place where ``t`` lives on the collectives' device)."""
    if data_count() == 1:
        return t
    buf = t.to(_comm_device())
    dist.broadcast(buf, mesh.data_src(), group=mesh.data_group())
    return buf.to(t.device)


class _GatherRows(torch.autograd.Function):
    """Every data shard's rows along dim 0, in shard order; the backward
    sums the shards' gradients of the whole and keeps this shard's rows."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(data_count())]
        dist.all_gather(parts, x.contiguous(), group=mesh.data_group())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=mesh.data_group())
        n = grad.shape[0] // data_count()
        return grad[data_index() * n:(data_index() + 1) * n]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of ``x`` from every data shard (each the same shape), shard
    after shard, with gradients back to each shard's own rows (the text
    side of pretraining's in-batch negatives); ``x`` with one shard."""
    return x if data_count() == 1 else _GatherRows.apply(x)


@torch.no_grad()
def all_reduce_grads(params: Iterable[nn.Parameter]) -> None:
    """Average the gradients over the data shards, in place, after
    ``backward``: one flat buffer per dtype, reduced in the parameters'
    order, so that every rank calls the same collectives (under tp the
    ranks of one data group hold the same model slice).  A parameter whose
    gradient is None on one rank takes part as zeros; it keeps None only
    where it has none on any rank (AdamW then skips it, as in one
    process)."""
    if not is_initialized():
        return
    params = list(params)
    world, group = data_count(), mesh.data_group()
    dev = params[0].device
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.int32, device=dev)
    dist.all_reduce(has, group=group)
    live = [p for p, h in zip(params, has.tolist()) if h]
    by_dtype = {}
    for p in live:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        if world > 1:
            flat.div_(world)
        for g, f in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(f.view_as(g))


@torch.no_grad()
def broadcast_module(module: nn.Module) -> None:
    """Every parameter and buffer of ``module`` from data shard 0 of this
    rank's data group, in place (the replicas of each model slice start
    equal)."""
    if not is_initialized() or data_count() == 1:
        return
    for t in module.state_dict().values():
        dist.broadcast(t, mesh.data_src(), group=mesh.data_group())
