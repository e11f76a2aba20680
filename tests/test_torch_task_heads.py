"""The task-specific-head baselines of the port (tasks/task_specific.py,
models/heads.py) against the JAX package, f32 on the CPU, on the model,
params and batches of tests/test_torch_tasks.py: the MLP head on the
text [CLS] of ``LavenderTS`` (QA classification, head_out 3), the scalar
head with NormSoftmax retrieval and RetMC option scores, a
``LavenderMultiHead``'s ``fc_qamc``, pretraining with the scalar VTM head,
and ``reinit_head``.  Each head's dropout is 0 on both sides (see there).
Loss within 1e-3 relative, every gradient within relative L2 1e-3, the
eval steps' scores within 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavender_tpu.tasks import task_specific as jts
from lavender_tpu_torch.tasks import task_specific
from tests.test_torch_convert import port_config
from tests.test_torch_tasks import (CFG, HEADS, LT, _check_loss_and_grads,
                                    _clips, _draw_params, _jax_model,
                                    _port_batch, _port_model, _run, _text,
                                    check_pretrain)


TS_CASES = {
    "cls": (3, lambda m: jts.make_cls_loss(m), task_specific.make_cls_loss,
            lambda m: jts.make_cls_eval(m), task_specific.make_cls_eval),
    "retrieval": (1, lambda m: jts.make_retrieval_ts_loss(m, 0.05),
                  lambda: task_specific.make_retrieval_ts_loss(0.05),
                  lambda m: jts.make_retrieval_ts_eval(m),
                  task_specific.make_retrieval_ts_eval),
    "retmc": (1, lambda m: jts.make_retmc_ts_loss(m),
              task_specific.make_retmc_ts_loss,
              lambda m: jts.make_retmc_ts_eval(m),
              task_specific.make_retmc_ts_eval),
    "head-qamc": (1, lambda m: jts.make_multi_head_losses(
        m, 0.05, {"qamc": "qamc"})["qamc"],
        lambda: task_specific.make_multi_head_losses(
            0.05, {"qamc": "qamc"})["qamc"],
        lambda m: jts.make_head_cls_eval(m, "qamc"),
        lambda: task_specific.make_head_cls_eval("qamc")),
}


@pytest.fixture(scope="module")
def head_params():
    """The JAX twin and its parameter draw per head width, drawn once for
    the module (the cases of one width share them)."""
    twins = {}

    def get(head_out):
        if head_out not in twins:
            jm = _jax_model(head_out)
            twins[head_out] = jm, _draw_params(jm, seed=1)
        return twins[head_out]
    return get


@pytest.mark.parametrize("name", list(TS_CASES))
def test_task_specific_head_losses_and_evals_match_jax(head_params, name):
    """The heads on the text [CLS]: QA classification through ``fc``
    (head_out 3), NormSoftmax retrieval through the scalar ``fc``, RetMC
    option scores, and a multi-head model's ``fc_qamc``."""
    head_out, jloss, tloss, jeval, teval = TS_CASES[name]
    jm, params = head_params(head_out)
    B = 3
    if name == "retmc":
        txt, mask = _text(B * 2, 6)
        txt, mask = txt.reshape(B, 2, LT), mask.reshape(B, 2, LT)
    else:
        txt, mask = _text(B, 6)
    batch = {"img": _clips(B, 6), "txt": txt, "mask": mask,
             "ans": np.array([1, -1, 0], np.int32)}
    if name == "retrieval":
        batch["ans"] = np.array([0, 1, 0], np.int32)  # the eval's vid
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, je = jloss(jm), jeval(jm)

    def both(p, b):
        return (jax.value_and_grad(jl)(p, b, jax.random.PRNGKey(0)),
                je({"params": p}, b["img"], b["txt"], b["mask"], b["ans"]))

    (want_loss, want_grads), want_eval = _run(both, params, jb)
    model = _port_model(params, task_specific.LavenderMultiHead,
                        heads=HEADS, head_out=head_out)
    tb = _port_batch(batch)
    loss = tloss()(model, tb, torch.Generator().manual_seed(0))
    loss.backward()
    _check_loss_and_grads(model, loss, float(want_loss), want_grads)
    got_eval = teval()(model, tb["img"], tb["txt"], tb["mask"], tb["ans"])
    for a, b in zip(got_eval, want_eval):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=1e-3)



def test_pretrain_with_the_scalar_head_matches_jax(monkeypatch):
    check_pretrain(_draw_params(_jax_model()), monkeypatch, ts=True)


def test_reinit_head_redraws_the_head_alone():
    """``reinit_head`` redraws the MLP head's weights as flax's
    lecun_normal does (std 1 / sqrt(fan_in)) and zeroes its biases; every
    other parameter stays; a name without an MLP head raises."""
    model = task_specific.LavenderTS(port_config(CFG), head_out=4)
    keep = {n: p.detach().clone() for n, p in model.named_parameters()}
    task_specific.reinit_head(model, generator=torch.Generator().manual_seed(0))
    for n, p in model.named_parameters():
        assert torch.equal(keep[n], p) != n.startswith("fc."), n
    assert not model.fc.fc1.bias.any() and not model.fc.fc2.bias.any()
    std = float(model.fc.fc1.weight.detach().std()) * 64 ** 0.5
    assert 0.9 < std < 1.1
    with pytest.raises(ValueError):
        task_specific.reinit_head(model, "fc_none")
