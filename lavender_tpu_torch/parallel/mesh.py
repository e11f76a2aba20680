"""The (data, model) layout of tensor parallelism over ``torch.distributed``
(port of lavender_tpu/parallel/mesh.py's model axis).

The JAX package lays its devices out as a ``(data, model)`` mesh, attaches
Megatron partition specs to the weights (``_PARAM_RULES``) and lets XLA's
GSPMD insert the collectives.  PyTorch has no such compiler, so here:

- ``make_mesh(tp)`` splits the ranks of the process group into ``dp = world
  // tp`` data shards of ``tp`` model ranks each, rank ``r = d * tp + m`` at
  (data ``d``, model ``m``), as JAX's ``reshape(n // tp, tp)`` lays them
  out, and returns the two process groups of this rank; ``set_global_mesh``
  installs it for the run (``tp_active``, ``data_rank``, ``model_rank``);
- ``_PARAM_RULES`` name the split of each weight over the port's (torch)
  parameter names.  Torch ``Linear.weight`` is [out, in], so a
  column-parallel layer (JAX ``P(None, model)``) splits dim 0 of its weight
  and its bias, a row-parallel one (JAX ``P(model, None)``) dim 1 of its
  weight and keeps its bias whole, added once after the all-reduce.  Two
  rules are the port's own: ``attn.qkv`` ([3C, C], rows laid out [3, nH,
  hd]) is split by heads inside each of q, k and v, not as one block of
  rows, and each block's ``relative_position_bias_table`` [n, nH] is split
  by heads with it (a replicated table sliced per rank would give each
  rank the gradient of its own columns only).  The vocab matrices
  (``word_embeddings``, the MLM ``decoder``) split dim 0 into
  ``ceil(V / tp)`` rows a rank, the last padded with zeros.  An attention
  whose heads do not divide ``tp`` stays replicated (its qkv, proj and
  table whole on every rank, no collective); GSPMD would run uneven
  shards there;
- ``shard_model`` replaces a model's parameters by this rank's slices,
  ``shard_state_dict`` / ``full_state_dict`` carry weights between the
  full layout (``convert.from_flax``'s, every checkpoint's) and any ``tp``;
- three autograd Functions are the only communication inside the model:
  ``copy_to_model`` (identity forward, all-reduce backward) at the input of
  every column-parallel product, ``reduce_from_model`` (all-reduce forward,
  identity backward) after every row-parallel product, and
  ``gather_from_model`` (all-gather of the last dim, the backward keeps
  this rank's slice) after the vocab-parallel decoder.  The all-reduces
  sum in f32 and cast back to the partials' dtype.

    pdist.distributed_init()
    mesh.set_global_mesh(mesh.make_mesh(tp=2))
    state = trainer.shard_train_state(trainer.create_train_state(cfg, tc))
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, model) layout: the extents, its
    coordinates and its two process groups (None without a process
    group)."""
    dp: int
    tp: int
    data_rank: int
    model_rank: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    data_ranks: Tuple[int, ...]   # the global ranks of this rank's data group
    model_ranks: Tuple[int, ...]  # ... and of its model group


def make_mesh(tp: int = 1) -> Mesh:
    """The (data, model) layout over the initialized process group (one
    process, no group: a mesh of one).  Every rank must call it, in the
    same order: it creates every group of the layout."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if tp < 1 or world % tp:
        raise ValueError(f"{world} ranks are not divisible by tp={tp}")
    dp = world // tp
    d, m = divmod(rank, tp)
    groups = {}
    for axis, members in (
            (MODEL_AXIS, [[e * tp + k for k in range(tp)] for e in range(dp)]),
            (DATA_AXIS, [[e * tp + k for e in range(dp)] for k in range(tp)])):
        for ranks in members:
            g = dist.new_group(ranks) if dist.is_initialized() else None
            if rank in ranks:
                groups[axis] = (g, tuple(ranks))
    return Mesh(dp, tp, d, m, groups[DATA_AXIS][0], groups[MODEL_AXIS][0],
                groups[DATA_AXIS][1], groups[MODEL_AXIS][1])


# The run-wide mesh the CLI installs (JAX ``set_global_mesh``).
_GLOBAL_MESH: Optional[Mesh] = None


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def global_mesh() -> Optional[Mesh]:
    return _GLOBAL_MESH


def tp_active() -> bool:
    """Whether the installed mesh has a model axis > 1: the models then take
    the tensor-parallel route (JAX ``tp_active``, which gates its kernels
    off; the port keeps the attention cores on each rank's own heads)."""
    return _GLOBAL_MESH is not None and _GLOBAL_MESH.tp > 1


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_rank() -> int:
    """This rank's data shard: the mesh's data coordinate, else the process
    rank (one process a shard)."""
    m = _GLOBAL_MESH
    return m.data_rank if m is not None else _world()[0]


def data_size() -> int:
    m = _GLOBAL_MESH
    return m.dp if m is not None else _world()[1]


def model_rank() -> int:
    m = _GLOBAL_MESH
    return m.model_rank if m is not None else 0


def model_size() -> int:
    m = _GLOBAL_MESH
    return m.tp if m is not None else 1


def data_group() -> Optional[dist.ProcessGroup]:
    """The group of this rank's data axis (None: the whole process group
    when no mesh is installed)."""
    m = _GLOBAL_MESH
    return m.data_group if m is not None else None


def model_group() -> Optional[dist.ProcessGroup]:
    m = _GLOBAL_MESH
    return m.model_group if m is not None else None


def data_src() -> int:
    """The global rank of data shard 0 in this rank's data group (the
    source of a broadcast within it)."""
    m = _GLOBAL_MESH
    return m.data_ranks[0] if m is not None else 0


# --------------------------------------------------------------------------
# The collectives inside the model.
# --------------------------------------------------------------------------


def _sum_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group, in f32 (a new tensor)."""
    y = t.float().contiguous()
    if y.data_ptr() == t.data_ptr():
        y = y.clone()
    dist.all_reduce(y, group=model_group())
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g).to(g.dtype)


class _ReduceFromModel(torch.autograd.Function):
    """The f32 sum over the model group (its backward casts back)."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return _sum_f32(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(model_size())]
        dist.all_gather(parts, x, group=model_group())
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(model_size(), dim=-1)[model_rank()].contiguous()


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: identity forward, the
    gradient summed over the model ranks in the backward."""
    return _CopyToModel.apply(x) if model_size() > 1 else x


def reduce_from_model(x: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The partial output of a row-parallel product summed over the model
    ranks, then + ``bias`` (added once), in f32 and cast to x's dtype;
    identity backward."""
    y = _ReduceFromModel.apply(x) if model_size() > 1 else x.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def row_parallel(x: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
    """``linear(x)`` of a row-parallel layer: this rank's slice of the
    product, summed over the model ranks, then the bias.  A layer the plan
    left whole (a replicated attention) is ``linear(x)``."""
    if not is_sharded(linear.weight):
        return linear(x)
    return reduce_from_model(nn.functional.linear(x, linear.weight),
                             linear.bias)


def column_parallel(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The product of a column-parallel layer (this rank's output columns),
    its input through ``copy_to_model`` where the weight is sharded."""
    if is_sharded(weight):
        x = copy_to_model(x)
    return nn.functional.linear(x, weight, bias)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """Every model rank's slice of the last dim, in rank order; the
    backward keeps this rank's slice."""
    return _GatherFromModel.apply(x) if model_size() > 1 else x


@torch.no_grad()
def broadcast_batch(batch: Mapping) -> Mapping:
    """The batch's tensors as model rank 0 holds them, on every rank of its
    model group, in place (the ranks of one data shard must see the same
    batch, and the host's sampling and masking draw from per-process
    streams).  Without a model axis the batch is returned as it is."""
    if model_size() == 1:
        return batch
    m = _GLOBAL_MESH
    for k in sorted(batch):
        t = batch[k]
        if isinstance(t, torch.Tensor):
            if not t.is_contiguous():
                raise ValueError(f"broadcast_batch: {k} is not contiguous")
            dist.broadcast(t, m.model_ranks[0], group=m.model_group)
    return batch


# --------------------------------------------------------------------------
# The rules.
# --------------------------------------------------------------------------

COLUMN, ROW, QKV, HEADS, VOCAB = "column", "row", "qkv", "heads", "vocab"
_SPLIT_DIM = {COLUMN: 0, ROW: 1, QKV: 0, HEADS: 1, VOCAB: 0}

# (name regex, kind) -- first match wins; the JAX package's rules
# (lavender_tpu/parallel/mesh.py:45-64) over the torch names, and the
# port's rel-pos table rule
_PARAM_RULES = (
    # fusion / text transformer
    (re.compile(r"\.(query|key|value)\.(weight|bias)$"), COLUMN),
    (re.compile(r"attention\.output\.dense\.weight$"), ROW),
    (re.compile(r"intermediate\.dense\.(weight|bias)$"), COLUMN),
    (re.compile(r"(?<!attention\.)output\.dense\.weight$"), ROW),
    # swin window attention / mlp
    (re.compile(r"attn\.qkv\.(weight|bias)$"), QKV),
    (re.compile(r"attn\.proj\.weight$"), ROW),
    (re.compile(r"attn\.relative_position_bias_table$"), HEADS),  # port's
    (re.compile(r"mlp\.fc1\.(weight|bias)$"), COLUMN),
    (re.compile(r"mlp\.fc2\.weight$"), ROW),
    # big vocab matrices
    (re.compile(r"word_embeddings\.weight$"), VOCAB),
    (re.compile(r"fc_mtm\.predictions\.decoder\.(weight|bias)$"), VOCAB),
)

def rule_kind(name: str) -> Optional[str]:
    """The kind of split the rules give parameter ``name`` (None:
    replicated)."""
    for pat, kind in _PARAM_RULES:
        if pat.search(name):
            return kind
    return None


def shard_spec(name: str, shape: Sequence[int]) -> Optional[int]:
    """The dimension the rules split parameter ``name`` of ``shape`` along
    (None: replicated).  A 1-D parameter splits dim 0 (the bias of a
    column-parallel layer)."""
    kind = rule_kind(name)
    if kind is None:
        return None
    return min(_SPLIT_DIM[kind], len(shape) - 1)


def attention_heads(model: nn.Module) -> Dict[str, int]:
    """{module name: heads} of every attention of ``model`` (the Swin
    blocks' ``attn`` and the BERT layers' ``attention``)."""
    return {name: mod.num_heads for name, mod in model.named_modules()
            if name.rsplit(".", 1)[-1] in ("attn", "attention")
            and hasattr(mod, "num_heads")}


def _attention_of(name: str, heads: Mapping[str, int]) -> Optional[str]:
    for leaf in ("attn", "attention"):
        i = name.find(f".{leaf}.")
        if i >= 0 or name.startswith(f"{leaf}."):
            prefix = name[:i + len(leaf) + 1] if i >= 0 else leaf
            return prefix if prefix in heads else None
    return None


def param_plan(names_shapes: Mapping[str, Sequence[int]], tp: int,
               heads: Mapping[str, int]) -> Dict[str, Optional[str]]:
    """{parameter name: kind or None} at ``tp``: the rules, with the
    attentions whose heads do not divide ``tp`` replicated."""
    plan = {}
    for name in names_shapes:
        kind = rule_kind(name) if tp > 1 else None
        att = _attention_of(name, heads)
        if kind is not None and att is not None and heads[att] % tp:
            kind = None
        plan[name] = kind
    return plan


def _heads_from_tables(full: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    return {k[:-len(".relative_position_bias_table")]: t.shape[1]
            for k, t in full.items()
            if k.endswith("attn.relative_position_bias_table")}


def shard_tensor(t: torch.Tensor, kind: Optional[str], rank: int,
                 tp: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the full tensor ``t`` under ``kind``."""
    if kind is None or tp == 1:
        return t
    if kind == VOCAB:
        per = -(-t.shape[0] // tp)
        pad = per * tp - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        return t.narrow(0, rank * per, per)
    if kind == QKV:
        t3 = t.reshape(3, -1, *t.shape[1:])
        per = t3.shape[1] // tp
        return t3.narrow(1, rank * per, per).reshape(-1, *t.shape[1:])
    dim = min(_SPLIT_DIM[kind], t.dim() - 1)
    per = t.shape[dim] // tp
    return t.narrow(dim, rank * per, per)


def join_tensors(parts: Sequence[torch.Tensor], kind: Optional[str],
                 full_shape: Sequence[int]) -> torch.Tensor:
    """The full tensor of shape ``full_shape`` from every rank's slice, in
    rank order (the inverse of ``shard_tensor``)."""
    if kind is None:
        return parts[0]
    if kind == VOCAB:
        return torch.cat(list(parts))[:full_shape[0]]
    if kind == QKV:
        rest = tuple(full_shape[1:])
        return torch.cat([p.reshape(3, -1, *rest) for p in parts],
                         dim=1).reshape(full_shape)
    dim = min(_SPLIT_DIM[kind], len(full_shape) - 1)
    return torch.cat(list(parts), dim=dim)


def shard_state_dict(full: Mapping[str, torch.Tensor], model_rank: int,
                     tp: int, heads: Optional[Mapping[str, int]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Model rank ``model_rank``'s state dict at ``tp`` from a full one.
    ``heads`` ({attention: heads}, ``attention_heads``) decides which
    attentions stay replicated; without it, the Swin blocks' heads are
    read off their tables and every BERT attention is taken as divisible."""
    heads = dict(_heads_from_tables(full), **(heads or {}))
    plan = param_plan({k: v.shape for k, v in full.items()}, tp, heads)
    return {k: shard_tensor(v, plan[k], model_rank, tp).clone()
            for k, v in full.items()}


def _plan_of(model: nn.Module) -> Dict[str, Tuple[Optional[str], tuple]]:
    return getattr(model, "tp_plan", {})


def shard_model(model: nn.Module, mesh: Optional[Mesh] = None) -> nn.Module:
    """Replace ``model``'s parameters by this model rank's slices (in place,
    before its optimizer is built) and record the plan on it
    (``model.tp_plan``: {name: (kind, full shape)}; each sliced parameter
    also carries its ``tp_kind``).  Serving caches are dropped (they hold
    the full tables; rebuild them with ``build_serving_cache``).  A model
    already sharded, or a mesh without a model axis, is left as it is."""
    mesh = mesh or _GLOBAL_MESH
    if mesh is None or mesh.tp == 1 or _plan_of(model):
        return model
    named = dict(model.named_parameters())
    plan = param_plan({k: p.shape for k, p in named.items()}, mesh.tp,
                      attention_heads(model))
    record = {}
    for name, p in named.items():
        kind = plan[name]
        record[name] = (kind, tuple(p.shape))
        if kind is None:
            continue
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        local = nn.Parameter(shard_tensor(p.detach(), kind, mesh.model_rank,
                                          mesh.tp).clone(),
                             requires_grad=p.requires_grad)
        local.tp_kind = kind
        setattr(mod, leaf, local)
    model.tp_plan = record
    for mod in model.modules():
        if hasattr(mod, "clear_serving_cache"):
            mod.clear_serving_cache()
    return model


def is_sharded(param: torch.Tensor) -> bool:
    return getattr(param, "tp_kind", None) is not None


@torch.no_grad()
def gather_full(t: torch.Tensor, kind: Optional[str],
                full_shape: Sequence[int]) -> torch.Tensor:
    """The full tensor from every model rank's slice ``t`` (a collective of
    the model group)."""
    if kind is None or model_size() == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(model_size())]
    dist.all_gather(parts, t, group=model_group())
    return join_tensors(parts, kind, full_shape)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state dict in the full layout (on every model rank; a
    collective of the model group where the model is sharded)."""
    plan = _plan_of(model)
    out = {}
    for k, v in model.state_dict().items():
        kind, shape = plan.get(k, (None, None))
        out[k] = gather_full(v, kind, shape)
    return out


def load_full_state_dict(model: nn.Module, full: Mapping[str, torch.Tensor],
                         strict: bool = True):
    """Load a full-layout state dict into ``model``, sharded or not."""
    plan = _plan_of(model)
    if plan:
        full = {k: shard_tensor(v, plan.get(k, (None,))[0], model_rank(),
                                model_size())
                for k, v in full.items()}
    return model.load_state_dict(full, strict=strict)


def head_offset(num_heads: int, held: int) -> int:
    """The first head this model rank holds (0 where it holds all)."""
    return 0 if held == num_heads else model_rank() * held


def names_in_order(params: List[nn.Parameter], model: nn.Module
                   ) -> List[str]:
    """The names of ``params`` (parameters of ``model``) in their order."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    return [by_id[id(p)] for p in params]
