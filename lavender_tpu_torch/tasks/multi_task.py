"""Unified multi-task fine-tuning (port of lavender_tpu/tasks/multi_task.py;
reference main_multi_task_mlm.py): one model, one train step per task kind
over a shared train state, each step's task picked by the caller (the JAX
package's MetaLoader: ``data.loader.MetaLoader``, driven by
``cli.main``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from lavender_tpu_torch.models.captioning import make_caption_loss_fn
from lavender_tpu_torch.tasks import qamc, qaoe, retmc, retrieval
from lavender_tpu_torch.train.trainer import make_train_step


def build_multi_task_losses(true_id: int, false_id: int,
                            label_smoothing: float = 0.1,
                            pretexts: Optional[Dict[str, Callable]] = None,
                            group: int = 1) -> Dict[str, Callable]:
    """The loss of each task kind (LAVENDER_Multi_Task.forward dispatch,
    main_multi_task_mlm.py:82-103); ``pretexts`` maps a kind to its
    pretext producer, ``group`` is retrieval's number of negative pools."""
    p = pretexts or {}
    return {
        "retrieval": retrieval.make_loss_fn(
            true_id, false_id, pretext=p.get("retrieval"), group=group),
        "qamc": qamc.make_loss_fn(pretext=p.get("qamc")),
        "qaoe": qaoe.make_loss_fn(pretext=p.get("qaoe")),
        "retmc": retmc.make_loss_fn(pretext=p.get("retmc")),
        "captioning": make_caption_loss_fn(
            label_smoothing, pretext=p.get("captioning")),
    }


def build_multi_task_evals(true_id: int, false_id: int,
                           ans_tok_ids: Optional[Sequence[int]] = None,
                           pretexts: Optional[Dict[str, Callable]] = None
                           ) -> Dict[str, Callable]:
    """The eval step of each task kind (QA-MC's only with its option
    digits ``ans_tok_ids``)."""
    p = pretexts or {}
    evals = {
        "retrieval": retrieval.make_eval_step(true_id, false_id,
                                              pretext=p.get("retrieval")),
        "qaoe": qaoe.make_eval_step(pretext=p.get("qaoe")),
        "retmc": retmc.make_eval_step(true_id, false_id,
                                      pretext=p.get("retmc")),
    }
    if ans_tok_ids is not None:
        evals["qamc"] = qamc.make_eval_step(ans_tok_ids,
                                            pretext=p.get("qamc"))
    return evals


def make_multi_task_train_steps(losses: Dict[str, Callable], state,
                                count_fns: Optional[Dict[str, Callable]]
                                = None) -> Dict[str, Callable]:
    """One train step per task (``train.trainer.make_train_step``), all
    updating the one ``state``: its model, optimizer and schedule;
    ``count_fns``: the ``count_fn`` of the tasks whose loss averages over a
    variable number of labels (the data-parallel global mean)."""
    counts = count_fns or {}
    return {name: make_train_step(fn, state, count_fn=counts.get(name))
            for name, fn in losses.items()}
