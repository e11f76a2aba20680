"""Data-parallel training of the port across real processes: two ranks of
``torch.distributed`` on gloo, on the CPU (the port's counterpart of
tests/test_multihost.py), launched once for the module by OpenMPI's
variables (with ``WORLD_SIZE=3`` beside them, which must lose).

- ``all_gather_obj`` of dicts of different sizes and of arrays;
- ``distributed_init``'s env detection (OpenMPI before ``WORLD_SIZE``,
  explicit args first, no env -> one process);
- the retrieval-MLM step on the two halves of a batch of 4 (rates 0):
  the all-reduced gradients within 1e-5 of one process's on the whole
  batch; the loss and every parameter after 2 steps within 1e-5 of one process
  stepping the whole batch with ``group=2``, whose first loss is within
  1e-3 of JAX's with ``group=2``;
- QA-OE, a token mean, with 2 valid labels on one rank and 1 on the
  other: one step equal to one process's within 1e-5 (the mean of the
  ranks' means is not);
- pretraining (both heads): the negatives drawn from both ranks' texts,
  the MLM mean over both ranks' tokens: loss and gradients within 1e-5
  of one process's;
- ZeRO-1: each rank keeps about half of the AdamW moments; the rank-0
  consolidated save, restored in one process and stepped once, equals
  the two ranks' next step within 1e-5;
- ``full_retrieval_eval`` split over the ranks: the same recall as one
  process, scores within 1e-6;
- ``cli.main`` (retrieval_mlm, qaoe_mlm, caption) on both ranks: one
  log, the files written once.

Adam divides each gradient by its own magnitude, so an entry whose
gradient is zero in exact arithmetic (the attention key biases: softmax
ignores a per-row constant) moves by +-lr on rounding noise whose sign
depends on the summation order.  Those entries (gradient below 1e-6 of
the global norm) are held to the most Adam can move them, 2 lr a step;
the rest of each parameter to 1e-5 relative L2.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lavender_tpu_torch.config import (BertConfig, DataConfig, ModelConfig,
                                       SwinConfig, TrainConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
TRUE_ID, FALSE_ID, MASK_ID = 5, 6, 4
LR = 1e-3
CFG = ModelConfig(
    swin=SwinConfig(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
                    drop_path_rate=0.0),
    bert=BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=64, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0))
TC = TrainConfig(lr=LR, max_iter=10, warmup_ratio=0.0, max_grad_norm=1.0)


def _batches():
    """Three retrieval batches of 4 clips (2 x 64 x 64) and one QA-OE
    batch whose last row has no answer."""
    g = np.random.RandomState(0)

    def one():
        mask = np.ones((4, 8), np.int32)
        mask[1, 5:-1] = 0
        return {"img": g.randint(0, 256, (4, 2, 64, 64, 3)).astype(np.uint8),
                "txt": g.randint(7, 128, (4, 8)).astype(np.int32) * mask,
                "mask": mask, "vid": np.array([0, 1, 1, 2], np.int32)}
    ret = [one() for _ in range(3)]
    qa = one()
    del qa["vid"]
    qa["txt"][:, 6] = MASK_ID
    qa["mask_ans"] = np.full((4, 8), -1, np.int32)
    qa["mask_ans"][:3, 6] = [9, 17, 33]
    return ret, qa


def _pretrain_batch():
    """A pretraining batch of 4: 3 masked-token targets in the first half,
    1 in the second."""
    g = np.random.RandomState(1)
    txt = g.randint(7, 128, (4, 8)).astype(np.int32)
    ans = np.full((4, 8), -1, np.int32)
    for i, j in ((0, 1), (0, 3), (1, 2), (3, 5)):
        ans[i, j], txt[i, j] = txt[i, j], MASK_ID
    return {"img": g.randint(0, 256, (4, 2, 64, 64, 3)).astype(np.uint8),
            "txt": txt, "mask": np.ones((4, 8), np.int32), "ans_mtm": ans}


def _pretrain_losses():
    from lavender_tpu_torch.tasks import pretrain, task_specific
    return {"pretrain": (False, pretrain.make_loss_fn(TRUE_ID, FALSE_ID,
                                                      vtm_batch=4)),
            "pretrain_ts": (True, task_specific.make_pretrain_ts_loss(
                temp=0.5, vtm_batch=4))}


def _half(batch, rank):
    return {k: torch.from_numpy(v[2 * rank:2 * rank + 2])
            for k, v in batch.items()}


def _whole(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _state(sd, ts=False):
    """A train state of CFG (with ``ts`` the scalar-head ``LavenderTS``,
    its head from the seeded init and its dropout 0, as every rate here)
    holding ``sd``."""
    from lavender_tpu_torch.tasks.task_specific import LavenderTS
    from lavender_tpu_torch.train.trainer import create_train_state
    state = create_train_state(CFG, TC, device="cpu", seed=0,
                               model=LavenderTS(CFG, 1) if ts else None)
    state.model.load_state_dict(sd, strict=not ts)
    if ts:
        state.model.fc.p = 0.0
    return state


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}


def _params(state):
    return {k: v.detach().clone()
            for k, v in state.model.named_parameters()}


def _eval_data():
    from lavender_tpu_torch.data.dataset import load_task_data
    from lavender_tpu_torch.data.tokenizer import (BertTokenizer,
                                                   build_test_vocab)
    from lavender_tpu_torch.tasks import eval_retrieval as er
    tok = BertTokenizer(build_test_vocab())  # within CFG's 128 ids
    cfg = DataConfig(data_dir=DATA, dataset="fixture", task="retrieval",
                     size_img=64, size_frame=2, size_txt=8)
    return load_task_data(cfg, er.RetrievalEvalDataset, tok)["val"]


def _eval(sd):
    """(recall, score) of the fixture's val split, one process or split."""
    from lavender_tpu_torch.models.lavender import LavenderModel
    from lavender_tpu_torch.tasks import eval_retrieval as er
    from lavender_tpu_torch.tasks.retrieval import recall_at_k
    model = LavenderModel(CFG)
    model.load_state_dict(sd)
    ds = _eval_data()
    featv, featt = er.feat_phase(model, ds, batch_size=4)
    out = er.cross_phase(model, ds, featv, featt, pair_batch=64)
    return recall_at_k(out["score"], out["gt"]), out["score"]


def _worker(out_dir):
    """One rank: every scenario, its results to ``out_dir/rank<r>.pt``."""
    from lavender_tpu_torch.parallel import dist as pdist
    from lavender_tpu_torch.tasks import qaoe, retrieval
    from lavender_tpu_torch.train import checkpoint
    from lavender_tpu_torch.train.trainer import (label_count,
                                                  make_train_step,
                                                  shard_train_state)
    torch.set_num_threads(1)
    out = {"init": pdist.distributed_init(device="cpu")}
    rank = pdist.process_index()
    out.update(rank=rank, world=pdist.process_count(),
               global_dp=pdist.global_dp())
    out["gather"] = pdist.all_gather_obj(
        {"rank": rank, "preds": {f"vid{rank}_{i}": "x" * (rank + 1)
                                 for i in range(rank + 2)}})
    out["gather_arr"] = pdist.all_gather_obj(np.full(3 + rank, float(rank)))

    sd = torch.load(os.path.join(out_dir, "init.pt"))
    ret, qa = _batches()
    state = shard_train_state(_state(sd), seed=0)
    loss_fn = retrieval.make_loss_fn(TRUE_ID, FALSE_ID)
    loss_fn(state.model, _half(ret[0], rank)).backward()
    pdist.all_reduce_grads(list(state.model.parameters()))
    out["grads"] = _grads(state.model)
    state = shard_train_state(_state(sd), seed=0)
    step = make_train_step(loss_fn, state)
    out["losses"] = [float(step(_half(b, rank))) for b in ret[:2]]
    out["params2"] = _params(state)
    local = state.optimizer.optim.state
    out["moments"] = sum(t.numel() for st in local.values()
                         for k, t in st.items()
                         if k in ("exp_avg", "exp_avg_sq"))
    checkpoint.save_train_state(state, os.path.join(out_dir, "state.pt"))
    out["loss3"] = float(step(_half(ret[2], rank)))
    out["params3"] = _params(state)

    state = shard_train_state(_state(sd), seed=0)
    loss_fn = qaoe.make_loss_fn()
    with torch.no_grad():
        out["qa_local"] = float(loss_fn(state.model, _half(qa, rank)))
    step = make_train_step(loss_fn, state, count_fn=label_count("mask_ans"))
    out["qa_loss"] = float(step(_half(qa, rank)))
    out["qa_params"] = _params(state)

    for name, (ts, loss_fn) in _pretrain_losses().items():
        state = shard_train_state(_state(sd, ts), seed=0)
        loss, _ = loss_fn(state.model, _half(_pretrain_batch(), rank),
                          state.generator)
        loss.backward()
        pdist.all_reduce_grads(list(state.model.parameters()))
        out[name] = (float(pdist.all_reduce_sum(loss.detach())) / 2,
                     _grads(state.model))

    out["recall"], out["score"] = _eval(sd)

    from lavender_tpu_torch.cli.main import main
    for task in CLI_TASKS:
        out[task] = dict(main([
            "--task", task, "--config",
            os.path.join(out_dir, "data", f"args_{task}.json"),
            "--path_output", os.path.join(out_dir, "cli", task),
            "--device", "cpu"]))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# the CLI's tasks run on both ranks, on tests/test_torch_cli.py's demo
# dataset at 3 clips a rank: {task: its txt_{task}.json}
CLI_TASKS = {"retrieval_mlm": "toyret", "qaoe_mlm": "toyoe",
             "caption": "toyret"}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def init_sd(tmp_path_factory):
    """JAX params of the tiny model and the port's state dict of them."""
    import jax
    import jax.numpy as jnp
    from lavender_tpu.models.lavender import LavenderModel as JaxLavender
    from lavender_tpu_torch.convert import from_flax
    jcfg = _jax_cfg()
    img = jnp.zeros((1, 2, 64, 64, 3), jnp.uint8)
    txt = jnp.ones((1, 8), jnp.int32)
    params = jax.jit(JaxLavender(jcfg).init)(jax.random.PRNGKey(3), img, txt,
                                             txt)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, from_flax(params)


def _jax_cfg():
    """The JAX twin of CFG, on its module math ("xla": the JAX "wm" path
    shrinks the window's bias index at this geometry, ROADMAP queue 3)."""
    import dataclasses
    from lavender_tpu import config as jcfg
    return jcfg.ModelConfig(
        swin=jcfg.SwinConfig(**dict(dataclasses.asdict(CFG.swin),
                                    attn_impl="xla")),
        bert=jcfg.BertConfig(**dataclasses.asdict(CFG.bert)))


@pytest.fixture(scope="module")
def ranks(init_sd, tmp_path_factory):
    """Both ranks' results (the two processes run once for the module)."""
    import pathlib
    from tests.test_torch_cli import _config, build_demo_data_dir
    out_dir = str(tmp_path_factory.mktemp("dist"))
    torch.save(init_sd[1], os.path.join(out_dir, "init.pt"))
    data = pathlib.Path(out_dir) / "data"
    data.mkdir()
    build_demo_data_dir(data)
    for task, txt in CLI_TASKS.items():  # the ranks read, never write them
        _config(data, txt, name=task)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "LOCAL_RANK")}
        env.update({"OMPI_COMM_WORLD_SIZE": "2",
                    "OMPI_COMM_WORLD_RANK": str(rank),
                    "WORLD_SIZE": "3", "MASTER_ADDR": "127.0.0.1",
                    "MASTER_PORT": str(port), "PYTHONPATH": REPO})
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             f"from tests.test_torch_dist import _worker; "
             f"_worker({out_dir!r})"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{err[-4000:]}"
    return out_dir, [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                                weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def single(init_sd):
    """One process on the whole batches, ``group=2``: the losses, the
    parameters after 2 steps and each parameter's first gradient."""
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train.trainer import make_train_step
    ret, _ = _batches()
    loss_fn = retrieval.make_loss_fn(TRUE_ID, FALSE_ID, group=2)
    grads = _first_grads(init_sd[1], loss_fn, ret[0])
    state = _state(init_sd[1])
    step = make_train_step(loss_fn, state)
    losses = [float(step(_whole(b))) for b in ret[:2]]
    return losses, _params(state), grads


def _first_grads(sd, loss_fn, batch):
    """Each trained parameter's gradient on the whole batch at the start."""
    state = _state(sd)
    loss_fn(state.model, _whole(batch)).backward()
    return {k: p.grad.detach().clone()
            for k, p in state.model.named_parameters() if p.grad is not None}


def _assert_params(got, want, grads, steps):
    """``grads``: each trained parameter's first gradient (a parameter
    without one does not move).  Entries whose gradient is below 1e-6 of
    the global gradient norm may differ by Adam's largest move, 2 lr a
    step; the rest of each tensor within 1e-5 relative L2."""
    total = float(torch.stack([g.norm() for g in grads.values()]).norm())
    for k, w in want.items():
        g = grads.get(k, torch.zeros_like(w))
        live = g.abs() >= 1e-6 * total
        diff = (got[k] - w).abs()
        if (~live).any():
            assert float(diff[~live].max()) <= 2 * LR * steps, k
        err = float(diff[live].norm())
        assert err <= 1e-5 * float(w.norm()), (k, err, float(w.norm()))


def _assert_grads(got, want):
    """Each gradient within 1e-5 relative L2, floored at 1e-2 of the
    global norm: a gradient that is zero in exact arithmetic (the key
    biases, the scalar head's output bias under a softmax over its
    options) is f32 rounding noise on both sides."""
    assert got.keys() == want.keys()
    total = float(torch.stack([g.norm() for g in want.values()]).norm())
    for k, w in want.items():
        err = float((got[k] - w).norm())
        assert err <= 1e-5 * max(float(w.norm()), 1e-2 * total), k


def test_gather_and_env_detection(ranks):
    _, (r0, r1) = ranks
    for rank, r in enumerate((r0, r1)):
        # OpenMPI's variables won over WORLD_SIZE=3
        assert r["init"] is True and r["rank"] == rank
        assert r["world"] == 2 and r["global_dp"] == 2
        assert [g["rank"] for g in r["gather"]] == [0, 1]
        assert len(r["gather"][1]["preds"]) == 3
        assert r["gather"][0]["preds"] == {"vid0_0": "x", "vid0_1": "x"}
        assert [a.tolist() for a in r["gather_arr"]] == [[0.0] * 3,
                                                         [1.0] * 4]


def test_env_detection_in_one_process(monkeypatch):
    from lavender_tpu_torch.parallel import dist as pdist
    for k in ("WORLD_SIZE", "RANK", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.distributed_init(device="cpu") is False
    assert not pdist.is_initialized() and pdist.process_count() == 1
    assert pdist.all_gather_obj({"a": 1}) == [{"a": 1}]
    # explicit args come first, whatever the environment says
    monkeypatch.setenv("WORLD_SIZE", "4")
    try:
        assert pdist.distributed_init(f"127.0.0.1:{_free_port()}", 1, 0,
                                      device="cpu") is False
        assert pdist.is_initialized() and pdist.process_count() == 1
        assert pdist.distributed_init() is False  # safe to call twice
    finally:
        torch.distributed.destroy_process_group()


def test_gradients_are_the_global_batch_mean(ranks, single):
    """The two halves' gradients, all-reduced, against one process's on
    the whole batch (``_assert_grads``)."""
    _, (r0, r1) = ranks
    _, _, want = single
    for r in (r0, r1):
        _assert_grads(r["grads"], want)
    for k in want:  # the ranks hold the same average
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k


def test_retrieval_step_equals_one_process_and_jax(ranks, single, init_sd):
    _, (r0, r1) = ranks
    losses, params, grads = single
    for r in (r0, r1):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        _assert_params(r["params2"], params, grads, 2)
    # the one-process grouped loss against JAX's
    import jax
    import jax.numpy as jnp
    from lavender_tpu.data.transforms import device_normalize
    from lavender_tpu.models.lavender import LavenderModel as JaxLavender
    from lavender_tpu.tasks import retrieval as jretrieval
    ret, _ = _batches()
    batch = dict(ret[0], img=device_normalize(jnp.asarray(ret[0]["img"])))
    loss_fn = jretrieval.make_loss_fn(JaxLavender(_jax_cfg()), TRUE_ID,
                                      FALSE_ID, group=2)
    want = float(jax.jit(loss_fn)(init_sd[0], batch, jax.random.PRNGKey(0)))
    np.testing.assert_allclose(losses[0], want, rtol=1e-3)


def test_token_mean_is_the_global_mean(ranks, init_sd):
    from lavender_tpu_torch.tasks import qaoe
    from lavender_tpu_torch.train.trainer import make_train_step
    _, (r0, r1) = ranks
    _, qa = _batches()
    loss_fn = qaoe.make_loss_fn()
    grads = _first_grads(init_sd[1], loss_fn, qa)
    state = _state(init_sd[1])
    want = float(make_train_step(loss_fn, state)(_whole(qa)))
    for r in (r0, r1):
        np.testing.assert_allclose(r["qa_loss"], want, rtol=1e-5)
        _assert_params(r["qa_params"], _params(state), grads, 1)
    # 2 labels on rank 0, 1 on rank 1: the mean of means is another number
    naive = (r0["qa_local"] + r1["qa_local"]) / 2
    assert abs(naive - want) > 1e-3 * abs(want)


def test_zero1_shards_moments_and_resumes_in_one_process(ranks, single,
                                                         init_sd):
    from lavender_tpu_torch.tasks import retrieval
    from lavender_tpu_torch.train import checkpoint
    from lavender_tpu_torch.train.trainer import make_train_step
    out_dir, (r0, r1) = ranks
    _, _, grads = single
    total = 2 * sum(g.numel() for g in grads.values())
    assert r0["moments"] + r1["moments"] == total
    for r in (r0, r1):
        assert 0.25 * total < r["moments"] < 0.75 * total
    ret, _ = _batches()
    state = checkpoint.restore_train_state(
        os.path.join(out_dir, "state.pt"), _state(init_sd[1]))
    assert state.step == 2
    step = make_train_step(
        retrieval.make_loss_fn(TRUE_ID, FALSE_ID, group=2), state)
    loss = float(step(_whole(ret[2])))
    for r in (r0, r1):
        np.testing.assert_allclose(r["loss3"], loss, rtol=1e-5)
        _assert_params(r["params3"], _params(state), grads, 1)


@pytest.mark.parametrize("name", ["pretrain", "pretrain_ts"])
def test_pretraining_negatives_span_the_ranks(ranks, init_sd, name):
    """Pretraining (the MLM head's VTM, or the scalar head's) on the two
    halves: the texts of both ranks in each clip's negatives (O = 4 of 4
    texts), drawn once by rank 0, and the MLM mean over both ranks'
    masked tokens (3 and 1): the mean loss and the all-reduced gradients
    within 1e-5 of one process's on the whole batch."""
    _, (r0, r1) = ranks
    ts, loss_fn = _pretrain_losses()[name]
    state = _state(init_sd[1], ts)
    loss, _ = loss_fn(state.model, _whole(_pretrain_batch()),
                      state.generator)
    loss.backward()
    for r in (r0, r1):
        got_loss, got = r[name]
        np.testing.assert_allclose(got_loss, float(loss.detach()),
                                   rtol=1e-5)
        _assert_grads(got, _grads(state.model))


@pytest.mark.parametrize("task", ["retrieval_mlm", "qaoe_mlm", "caption"])
def test_cli_runs_data_parallel(ranks, task):
    """``cli.main`` on both ranks (24 train items, 3 a rank a step: 4
    steps): the same log on both (the loss and metrics gathered), finite;
    rank 0 alone wrote the run's files."""
    import glob
    out_dir, (r0, r1) = ranks
    assert r0[task] == r1[task]
    (ls,) = r0[task]["ls_tr"]
    assert np.isfinite(ls)
    (run,) = glob.glob(os.path.join(out_dir, "cli", task, "_*"))
    names = set(os.listdir(run))
    assert {"args.json", "log.json"} <= names
    assert any(n.startswith("ckpt_") for n in names)
    if task == "caption":
        with open(os.path.join(run, "predictions_ep1.tsv")) as f:
            keys = sorted(line.split("\t")[0] for line in f)
        assert keys == [f"vid{i}" for i in range(6)]  # both ranks' clips


def test_eval_split_gives_the_same_recall(ranks, init_sd):
    _, (r0, r1) = ranks
    recall, score = _eval(init_sd[1])
    for r in (r0, r1):
        assert r["recall"] == recall
        np.testing.assert_allclose(r["score"], score, rtol=0, atol=1e-6)
