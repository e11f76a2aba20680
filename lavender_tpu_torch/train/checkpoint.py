"""Checkpoints (port of lavender_tpu/train/checkpoint.py): params and
full train states with ``torch.save``, the training meta and log JSON, and
the reference's ``.pt`` import.

- ``save_params`` / ``load_params``: a model's state dict in one file
  (the JAX package writes an Orbax directory; the reference's per-epoch
  ``ckpt_violet_{task}_{ep}.pt``, agent.py:164-182).
- ``save_train_state`` / ``restore_train_state``: the model, the AdamW
  state, the LR scheduler, the step and the ``torch.Generator`` state of
  dropout and drop-path (the JAX package's stored ``rng``), so that a
  resumed run continues bit for bit.  The JAX package's cross-PRNG-impl
  branch (a stored key of another shape re-seeds the stream) has no
  counterpart: torch has one generator implementation per device type.
  A generator saved on one device restores onto a generator on the same
  device type only; anything else raises (no silent re-seed).  Under
  ZeRO-1 (``trainer.shard_train_state``) every rank calls
  ``save_train_state``: the sharded AdamW state is consolidated on rank
  0, which alone writes; the file restores into a state of any world
  size, one process's plain AdamW included.  Under tensor parallelism
  (``parallel.mesh``) the consolidation runs within each data group, the
  weights and the AdamW moments are gathered into the full layout over
  the model group (``mesh.full_state_dict``), and global rank 0 writes:
  the file is the one a single process writes, and restores at any
  ``tp`` (``restore_train_state`` slices it onto a sharded state).
- ``save_training_meta`` / ``save_log``: ``args.json`` and ``log.json``
  (agent.py:155-162), the same files as the JAX functions write for equal
  configs.
- ``load_reference_checkpoint``: a released LAVENDER or SwinBERT ``.pt``
  into a model (model.py:352-429): the file-name dispatch on "swinbert"
  (model.py:364-366), the key conversion, then the tolerant merge
  (``convert.merge_state_dict``).

    save_train_state(state, "out/state.pt")
    state = restore_train_state("out/state.pt", create_train_state(cfg, tc))
    load_reference_checkpoint("ckpt_swinbert.pt", server.model)
"""
from __future__ import annotations

import dataclasses
import json
import os
import os.path as op
from typing import Dict, Mapping, Optional, Union

import torch
from torch import nn

from lavender_tpu_torch.convert import (
    convert_lavender_checkpoint, load_torch_checkpoint, merge_state_dict,
    remap_swinbert_keys)
from lavender_tpu_torch.parallel import dist as pdist
from lavender_tpu_torch.parallel import mesh

_MOMENTS = ("exp_avg", "exp_avg_sq")


def _state_dict(obj) -> Mapping[str, torch.Tensor]:
    return obj.state_dict() if isinstance(obj, nn.Module) else obj


def save_params(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                path: str):
    """Write a model's (or a state dict's) tensors to ``path``."""
    os.makedirs(op.dirname(op.abspath(path)), exist_ok=True)
    torch.save(dict(_state_dict(params)), path)


def load_params(path: str, like: Optional[nn.Module] = None
                ) -> Dict[str, torch.Tensor]:
    """The state dict at ``path`` (on the CPU); with ``like``, also loaded
    into that model (``strict=True``, onto its device and dtype)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if like is not None:
        like.load_state_dict(sd, strict=True)
    return sd


def _optimizer_names(state):
    """The parameter name of each index of the optimizer's state dict."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    return mesh.names_in_order(params, state.model)


def _map_moments(opt_sd, names, fn):
    """``opt_sd`` with each AdamW moment replaced by ``fn(name, moment)``,
    in index order."""
    out = dict(opt_sd)
    out["state"] = {i: {k: fn(names[i], v) if k in _MOMENTS else v
                        for k, v in opt_sd["state"][i].items()}
                    for i in sorted(opt_sd["state"])}
    return out


def save_train_state(state, path: str):
    """Write a ``trainer.TrainState`` for an exact resume: model,
    optimizer, scheduler, step and the generator's state with its device
    type.  A ZeRO-1 optimizer (and a model sharded by tensor parallelism)
    is a collective: call on every rank; global rank 0 writes, in the full
    layout."""
    model_sd = mesh.full_state_dict(state.model)
    if hasattr(state.optimizer, "consolidate_state_dict"):
        state.optimizer.consolidate_state_dict(to=0)
        if pdist.data_index() != 0:
            return
    opt_sd = state.optimizer.state_dict()
    plan = getattr(state.model, "tp_plan", {})
    if plan:  # data shard 0's model ranks gather the moments
        dev = pdist._comm_device()
        opt_sd = _map_moments(
            opt_sd, _optimizer_names(state),
            lambda n, v: mesh.gather_full(v.to(dev), *plan[n]).cpu())
    if pdist.process_index() != 0:
        return
    os.makedirs(op.dirname(op.abspath(path)), exist_ok=True)
    torch.save({"step": int(state.step),
                "model": model_sd,
                "optimizer": opt_sd,
                "scheduler": state.scheduler.state_dict(),
                "generator": state.generator.get_state(),
                "generator_device": state.generator.device.type}, path)


def restore_train_state(path: str, like_state):
    """Restore the state written by ``save_train_state`` into
    ``like_state`` (a freshly created ``TrainState`` of the same config,
    e.g. ``create_train_state``) and return it; a state sharded by tensor
    parallelism takes its slices of the weights and moments.  Raises
    ValueError when its generator lives on another device type than the
    saved one."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    saved, have = payload["generator_device"], like_state.generator.device.type
    if saved != have:
        raise ValueError(f"restore_train_state: the generator was saved on "
                         f"{saved!r} and cannot continue on {have!r}")
    mesh.load_full_state_dict(like_state.model, payload["model"])
    opt_sd = payload["optimizer"]
    plan = getattr(like_state.model, "tp_plan", {})
    if plan:
        opt_sd = _map_moments(
            opt_sd, _optimizer_names(like_state),
            lambda n, v: mesh.shard_tensor(v, plan[n][0], mesh.model_rank(),
                                           mesh.model_size()).clone())
    like_state.optimizer.load_state_dict(opt_sd)
    like_state.scheduler.load_state_dict(payload["scheduler"])
    like_state.generator.set_state(payload["generator"])
    like_state.step = payload["step"]
    return like_state


def save_training_meta(cfg, path_output: str):
    """args.json (agent.py:155-162): the config's dataclass fields, nested,
    tuples as lists."""
    os.makedirs(path_output, exist_ok=True)

    def to_dict(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: to_dict(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        if isinstance(obj, (list, tuple)):
            return [to_dict(v) for v in obj]
        return obj

    with open(op.join(path_output, "args.json"), "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def save_log(log: Dict, path_output: str):
    with open(op.join(path_output, "log.json"), "w") as f:
        json.dump(log, f, indent=2)


def load_reference_checkpoint(pt_path: str,
                              init: Union[nn.Module,
                                          Mapping[str, torch.Tensor]],
                              max_size_frame: Optional[int] = None,
                              max_size_patch: Optional[int] = None
                              ) -> Dict[str, torch.Tensor]:
    """A released LAVENDER (or, by its file name, SwinBERT) ``.pt`` merged
    over ``init``: a model, which then holds the result (its devices and
    dtypes kept), or its state dict.  Returns the merged state dict
    (LAVENDER_Base.load_ckpt, model.py:352-429)."""
    sd = load_torch_checkpoint(pt_path)
    if "swinbert" in op.basename(pt_path).lower():
        sd = remap_swinbert_keys(sd)  # model.py:364-366
    loaded = convert_lavender_checkpoint(
        sd, max_size_frame=max_size_frame, max_size_patch=max_size_patch)
    merged = merge_state_dict(_state_dict(init), loaded)
    if isinstance(init, nn.Module):
        init.load_state_dict(merged, strict=True)
    return merged
