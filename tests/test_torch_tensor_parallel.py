"""Tensor parallelism of the port (``parallel.mesh``) across real processes:
four ranks of ``torch.distributed`` on gloo, on the CPU, launched once for
the module (the pattern of tests/test_torch_dist.py), laid out as
``dp = 2 x tp = 2`` and as ``tp = 4``.

The tiny config is test_torch_dist.py's with the vocab at 130 (padded to
4 x 33 at tp = 4) and a window of (2, 4, 4), so that stages 1-2 run
window-major and stages 3-4 the module path; stage 1 has 2 heads, which
tp = 4 does not divide: it keeps its attention whole on every rank.

- the rules: ``shard_spec`` against the JAX package's ``param_pspecs``
  leaf for leaf, through ``convert.from_flax``'s names.  The port differs
  in two stated ways: torch's [out, in] weights split the transposed dim,
  and the rel-pos tables split by heads (JAX keeps them whole);
- ``shard_state_dict`` -> the ranks' slices joined back, bitwise, at tp 2
  and 4; qkv split by heads inside q, k and v;
- the retrieval-MLM step at dp 2 x tp 2 (``fused_attn_train`` on, also
  under ``LVT_ATTNLANES=0``, and off) and at tp 4 (on), at rates 0 and
  0.1 (attention, hidden and drop-path): the loss, the gathered first
  gradients and every parameter after 2 AdamW steps within 1e-5 of one
  process (each data shard's half with that shard's random stream, the
  gradients averaged); the first loss at rates 0 within 1e-3 of the JAX
  package's; the replicated parameters' gradients equal on the tp peers;
  the clip's global norm equal to one process's;
- the padded vocab: tp 4's MLM logits equal one process's, V columns;
- the plain versions of K10a / K13a with a head offset: a rank's keep
  masks are the slices of one process's;
- pretraining's negatives at dp 2 x tp 2, from both data shards;
- ZeRO-1's moments split over the data group only;
- a dp 2 x tp 2 checkpoint restores in one process and steps equal; a
  one-process checkpoint restores at dp 2 x tp 2 and steps equal;
- ``full_retrieval_eval`` at dp 2 x tp 2: one process's recall;
- the caption greedy decode at tp 2: one process's tokens;
- ``cli.main`` with ``"tp": 2`` (retrieval_mlm, caption) on the four
  ranks: the loaders split by data shard, one log, the files written once.

Adam divides each gradient by its own magnitude, so an entry whose
gradient is zero in exact arithmetic moves by +-lr on rounding noise:
``test_torch_dist._assert_params`` holds those to 2 lr a step.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lavender_tpu_torch.config import (BertConfig, ModelConfig, SwinConfig,
                                       TrainConfig)
from tests.test_torch_dist import (CLI_TASKS, FALSE_ID, LR, REPO, TRUE_ID,
                                   _assert_grads, _assert_params, _batches,
                                   _free_port, _half, _pretrain_batch,
                                   _whole)

TC = TrainConfig(lr=LR, max_iter=10, warmup_ratio=0.0, max_grad_norm=1.0)
# the one-process references run beside the four single-threaded ranks
# (tests/test_torch_convert.py sets the same for the suite's workers)
torch.set_num_threads(1)


def _cfg(rate=0.0, fused=True):
    return ModelConfig(
        swin=SwinConfig(embed_dim=8, depths=(2, 2, 1, 1),
                        num_heads=(2, 4, 4, 4), window_size=(2, 4, 4),
                        drop_path_rate=rate),
        bert=BertConfig(vocab_size=130, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        max_position_embeddings=64, hidden_dropout_prob=rate,
                        attention_probs_dropout_prob=rate,
                        fused_attn_train=fused))


# the routes of the step: (fused_attn_train, LVT_ATTNLANES), at rates 0
# and 0.1, each at dp 2 x tp 2; tp 4 on the default route
ROUTES = {"lanes": (True, "1"), "heads": (True, "0"), "module": (False, "1")}
SCENARIOS = [(tp, route, rate) for tp, routes in ((2, ROUTES), (4, ["lanes"]))
             for route in routes for rate in (0.0, 0.1)]


def _state(cfg, sd):
    from lavender_tpu_torch.train.trainer import create_train_state
    state = create_train_state(cfg, TC, device="cpu", seed=0)
    state.model.load_state_dict(sd)
    return state


def _shards(tp):
    """Each data shard's batches: the halves at dp 2, the whole at dp 1."""
    ret, _ = _batches()
    if tp == 4:
        return [[_whole(b) for b in ret]]
    return [[_half(b, d) for b in ret] for d in range(2)]


def _loss_fn():
    from lavender_tpu_torch.tasks import retrieval
    return retrieval.make_loss_fn(TRUE_ID, FALSE_ID)


def _full_grads(model):
    """Every parameter's gradient in the full layout (a collective)."""
    from lavender_tpu_torch.parallel import mesh
    plan = getattr(model, "tp_plan", {})
    return {k: mesh.gather_full(p.grad, *plan.get(k, (None, None))).clone()
            for k, p in model.named_parameters() if p.grad is not None}


def _full_params(model):
    from lavender_tpu_torch.parallel import mesh
    return {k: v.clone() for k, v in mesh.full_state_dict(model).items()}


def _run_steps(cfg, sd, batches):
    """On this rank: the first gradients (all-reduced, gathered), the
    replicated ones as held, the clip norm; then 2 steps' losses and the
    parameters after them."""
    from lavender_tpu_torch.parallel import dist as pdist
    from lavender_tpu_torch.parallel import mesh
    from lavender_tpu_torch.train.optimizer import clip_by_global_norm
    from lavender_tpu_torch.train.trainer import (make_train_step,
                                                  shard_train_state)
    out = {}
    state = shard_train_state(_state(cfg, sd), seed=0)
    params = list(state.model.parameters())
    _loss_fn()(state.model, batches[0], state.generator).backward()
    pdist.all_reduce_grads(params)
    out["norm"] = float(clip_by_global_norm(params, 1e9))
    out["grads"] = _full_grads(state.model)
    out["replicated"] = {k: p.grad.clone()
                         for k, p in state.model.named_parameters()
                         if p.grad is not None and not mesh.is_sharded(p)}
    state = shard_train_state(_state(cfg, sd), seed=0)
    step = make_train_step(_loss_fn(), state)
    out["losses"] = [float(step(b)) for b in batches[:2]]
    out["params"] = _full_params(state.model)
    return out, state


def _worker(out_dir):
    """One rank: every scenario, its results to ``out_dir/rank<r>.pt``."""
    from lavender_tpu_torch.parallel import dist as pdist
    from lavender_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    pdist.distributed_init(device="cpu")
    rank = pdist.process_index()
    sd = torch.load(os.path.join(out_dir, "init.pt"))
    meshes = {tp: mesh.make_mesh(tp) for tp in (2, 4)}
    out = {"rank": rank}
    for tp, route, rate in SCENARIOS:
        mesh.set_global_mesh(meshes[tp])
        fused, lanes = ROUTES[route]
        os.environ["LVT_ATTNLANES"] = lanes
        out[(tp, route, rate)] = _run_steps(
            _cfg(rate, fused), sd, _shards(tp)[mesh.data_rank()])[0]
        os.environ["LVT_ATTNLANES"] = "1"
        if tp == 4 and rate == 0.0:
            out["tp4_logits"] = _logits(sd)

    m = meshes[2]
    mesh.set_global_mesh(m)
    out.update(data_rank=m.data_rank, model_rank=m.model_rank,
               data_index=pdist.data_index(), data_count=pdist.data_count())
    # ZeRO-1 and the checkpoint: rates 0, lanes
    res, state = _run_steps(_cfg(), sd, _shards(2)[m.data_rank])
    local = state.optimizer.optim.state
    out["moments"] = sum(t.numel() for st in local.values()
                         for k, t in st.items()
                         if k in ("exp_avg", "exp_avg_sq"))
    out["local_numel"] = sum(p.numel() for p in state.model.parameters()
                             if p.grad is not None)
    from lavender_tpu_torch.train import checkpoint
    from lavender_tpu_torch.train.trainer import (make_train_step,
                                                  shard_train_state)
    checkpoint.save_train_state(state, os.path.join(out_dir, "tp.pt"))
    step = make_train_step(_loss_fn(), state)
    b3 = _shards(2)[m.data_rank][2]
    out["loss3"] = float(step(b3))
    out["params3"] = _full_params(state.model)
    # a one-process checkpoint at dp 2 x tp 2
    state = shard_train_state(_state(_cfg(), sd), seed=0)
    checkpoint.restore_train_state(os.path.join(out_dir, "one.pt"), state)
    step = make_train_step(_loss_fn(), state)
    out["resumed_loss"] = float(step(b3))
    out["resumed_params"] = _full_params(state.model)

    # pretraining's negatives over both data shards (rates 0)
    from lavender_tpu_torch.tasks import pretrain
    state = shard_train_state(_state(_cfg(), sd), seed=0)
    loss, _ = pretrain.make_loss_fn(TRUE_ID, FALSE_ID, vtm_batch=4)(
        state.model, _half(_pretrain_batch(), m.data_rank), state.generator)
    loss.backward()
    pdist.all_reduce_grads(list(state.model.parameters()))
    out["pretrain"] = (float(pdist.all_reduce_sum(loss.detach())) / 2,
                       _full_grads(state.model))

    out["recall"], out["score"] = _eval(sd, shard=True)
    out["greedy"] = _caption(sd, shard=True)

    from lavender_tpu_torch.cli import main as cli
    out["loader"] = _loader_split(cli)
    for task in ("retrieval_mlm", "caption"):
        out[task] = dict(cli.main([
            "--task", task, "--config",
            os.path.join(out_dir, "data", f"args_{task}.json"),
            "--path_output", os.path.join(out_dir, "cli", task),
            "--device", "cpu"]))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _model(sd, shard):
    """The model in ``eval()`` at rates 0.1, which serving must not draw."""
    from lavender_tpu_torch.models.lavender import LavenderModel
    from lavender_tpu_torch.parallel import mesh
    model = LavenderModel(_cfg(0.1))
    model.load_state_dict(sd)
    if shard:
        mesh.shard_model(model)
    return model.eval()


def _logits(sd, shard=True):
    """MLM logits of the first retrieval batch (eval)."""
    b = _whole(_batches()[0][0])
    with torch.no_grad():
        return _model(sd, shard)(b["img"], b["txt"], b["mask"])


def _eval(sd, shard=False):
    from lavender_tpu_torch.tasks import eval_retrieval as er
    from lavender_tpu_torch.tasks.retrieval import recall_at_k
    from tests.test_torch_dist import _eval_data
    model = _model(sd, shard)
    ds = _eval_data()
    featv, featt = er.feat_phase(model, ds, batch_size=4)
    out = er.cross_phase(model, ds, featv, featt, pair_batch=64)
    return recall_at_k(out["score"], out["gt"]), out["score"]


def _caption(sd, shard=False):
    """Greedy ids of 2 clips (tp 2 where sharded)."""
    from lavender_tpu_torch.models.captioning import (GenerateConfig,
                                                      make_generate_fn)
    model = _model(sd, shard)
    gen = make_generate_fn(model, 1, 2, 0, 4, GenerateConfig(max_gen_length=6))
    ids, _ = gen(torch.from_numpy(_batches()[0][0]["img"][:2]))
    return ids


def _loader_split(cli):
    """(rank, world) of the CLI's train loader on this rank."""
    from lavender_tpu_torch.config import RunConfig
    dl = cli._loader(RunConfig(), list(range(8)), True)
    return dl.sampler.rank, dl.sampler.world


@pytest.fixture(scope="module")
def init_sd():
    """The port's seeded weights of the tiny model (every bias, the
    LayerNorms' too, drawn N(0, 0.02): a parameter that starts at 0 would
    be Adam's first moves alone after 2 steps, and its relative L2 would
    measure nothing but their rounding) and the JAX package's params of
    the same weights (``lavender_tpu.convert``, the reference loader's
    path; ``convert.from_flax`` of them gives the state dict back)."""
    from lavender_tpu.convert import convert_state_dict, lavender_to_scan_layout
    from lavender_tpu_torch.models.lavender import LavenderModel, init_weights
    g = torch.Generator().manual_seed(3)
    model = init_weights(LavenderModel(_cfg()), g)
    sd = {}
    for k, v in model.state_dict().items():
        noise = torch.randn(v.shape, generator=g) * 0.02
        sd[k] = v + noise if k.endswith(".bias") else v.clone()
    params = lavender_to_scan_layout(convert_state_dict(sd),
                                     _cfg().swin.depths)
    return params, sd


def _jax_cfg():
    from lavender_tpu import config as jcfg
    cfg = _cfg()
    return jcfg.ModelConfig(
        swin=jcfg.SwinConfig(**dict(dataclasses.asdict(cfg.swin),
                                    attn_impl="xla")),
        bert=jcfg.BertConfig(**dataclasses.asdict(cfg.bert)))


def _one_process(cfg, sd, shards, steps=2, state=None):
    """One process: each data shard's batch with that shard's stream
    (``rank_seed``), the gradients averaged, clipped, stepped."""
    from lavender_tpu_torch.train.optimizer import clip_by_global_norm
    from lavender_tpu_torch.train.trainer import rank_seed
    state = state or _state(cfg, sd)
    gens = [torch.Generator().manual_seed(rank_seed(0, d))
            for d in range(len(shards))]
    if state.step:  # resumed: shard 0 continues the saved stream
        gens[0] = state.generator
    params = [p for p in state.model.parameters() if p.requires_grad]
    losses, grads, norm = [], None, None
    for i in range(steps):
        state.optimizer.zero_grad(set_to_none=True)
        loss = 0.0
        for d, shard in enumerate(shards):
            ls = _loss_fn()(state.model, shard[state.step], gens[d])
            (ls / len(shards)).backward()
            loss += float(ls.detach()) / len(shards)
        if i == 0:
            grads = {k: p.grad.clone() for k, p in
                     state.model.named_parameters() if p.grad is not None}
            norm = float(torch.linalg.vector_norm(torch.stack(
                [g.norm() for g in grads.values()])))
        clip_by_global_norm(params, TC.max_grad_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        losses.append(loss)
    params = {k: p.detach().clone()
              for k, p in state.model.named_parameters()}
    return losses, params, grads, norm, state


@pytest.fixture(scope="module")
def launched(init_sd, tmp_path_factory):
    """The four ranks, started once for the module: (out_dir, processes);
    ``references`` runs while they do."""
    import pathlib
    from tests.test_torch_cli import _config, build_demo_data_dir
    from lavender_tpu_torch.train import checkpoint
    out_dir = str(tmp_path_factory.mktemp("tp"))
    torch.save(init_sd[1], os.path.join(out_dir, "init.pt"))
    *_, state = _one_process(_cfg(), init_sd[1], _shards(2))
    checkpoint.save_train_state(state, os.path.join(out_dir, "one.pt"))
    data = pathlib.Path(out_dir) / "data"
    data.mkdir()
    build_demo_data_dir(data)
    for task in ("retrieval_mlm", "caption"):
        _config(data, CLI_TASKS[task], name=task, tp=2)
    port = _free_port()
    procs = []
    for rank in range(4):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "LOCAL_RANK", "OMPI_COMM_WORLD_SIZE")}
        env.update({"WORLD_SIZE": "4", "RANK": str(rank),
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "PYTHONPATH": REPO})
        with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 f"from tests.test_torch_tensor_parallel import _worker; "
                 f"_worker({out_dir!r})"], cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT))
    yield out_dir, procs
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def ranks(launched, references):
    """The four ranks' results (after the one-process references)."""
    out_dir, procs = launched
    try:
        for p in procs:
            p.wait(timeout=400)
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        with open(os.path.join(out_dir, f"rank{rank}.log")) as f:
            assert p.returncode == 0, f"rank {rank}:\n{f.read()[-4000:]}"
    return out_dir, [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                                weights_only=False) for r in range(4)]


# --------------------------------------------------------------------------
# In one process.
# --------------------------------------------------------------------------


def test_rules_match_jax_param_pspecs(init_sd):
    """``shard_spec`` against JAX's ``_rule_spec`` leaf for leaf."""
    from lavender_tpu.parallel.mesh import MODEL_AXIS, _rule_spec
    from lavender_tpu_torch.convert import _leaves, _torch_key, _unscan
    from lavender_tpu_torch.parallel import mesh
    params, sd = init_sd
    seen = 0
    for path, leaf in _leaves(params):
        jspec = tuple(_rule_spec("/".join(path), leaf.ndim))
        jaxis = jspec.index(MODEL_AXIS) if MODEL_AXIS in jspec else None
        scanned = "blocks_scan" in path
        for p, v in _unscan(path, leaf):
            name, t = _torch_key(p, v)
            got = mesh.shard_spec(name, tuple(t.shape))
            want = None if jaxis is None else jaxis - int(scanned)
            if want is not None and path[-1] == "kernel" and t.ndim == 2:
                want = 1 - want  # torch's [out, in]
            if name.endswith("relative_position_bias_table"):
                assert want is None and got == 1, name  # the port's rule
            else:
                assert got == want, (name, got, want)
            seen += 1
    assert seen == len(sd)


def test_shard_state_dict_round_trips(init_sd):
    """The ranks' slices joined back are the full tensors, bitwise; qkv
    rows of a rank are its heads inside each of q, k and v; an attention
    whose heads do not divide tp stays whole."""
    from lavender_tpu_torch.models.lavender import LavenderModel
    from lavender_tpu_torch.parallel import mesh
    full = init_sd[1]
    heads = mesh.attention_heads(LavenderModel(_cfg()))
    for tp in (2, 4):
        shards = [mesh.shard_state_dict(full, r, tp, heads)
                  for r in range(tp)]
        plan = mesh.param_plan({k: v.shape for k, v in full.items()}, tp,
                               heads)
        for k, v in full.items():
            got = mesh.join_tensors([s[k] for s in shards], plan[k], v.shape)
            assert torch.equal(got, v), (tp, k)
        qkv = "enc_img.swin.layers.1.blocks.0.attn.qkv.weight"
        C = full[qkv].shape[1]
        held = C // tp
        for r in range(tp):
            want = full[qkv].view(3, C, C)[:, r * held:(r + 1) * held]
            assert torch.equal(shards[r][qkv], want.reshape(-1, C))
        stage1 = "enc_img.swin.layers.0.blocks.0.attn"
        assert (plan[f"{stage1}.qkv.weight"] is None) == (tp == 4)
        assert (plan[f"{stage1}.relative_position_bias_table"] is None) \
            == (tp == 4)
        assert plan["enc_img.swin.layers.0.blocks.0.mlp.fc1.weight"]
    dec = "fc_mtm.predictions.decoder.weight"
    last = mesh.shard_state_dict(full, 3, 4)[dec]
    assert last.shape[0] == 33 and not last[-2:].any()  # 130 = 4 x 33 - 2


def test_head_offset_keep_masks_are_slices():
    """K10a's / K13a's plain versions with head0: a rank's outputs and keep
    masks are the heads' slices of one process's."""
    from lavender_tpu_torch.ops import dropout
    from lavender_tpu_torch.ops.encoder_attention import (
        _heads_train_plain, _lanes_plain)
    seed = torch.tensor([1234])
    full = dropout.attention_keep(seed, 3, 4, 5, 0.3)
    for h0, held in ((0, 2), (2, 2), (3, 1)):
        part = dropout.attention_keep(seed, 3, held, 5, 0.3, h0, 4)
        assert torch.equal(part, full[:, h0:h0 + held])
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 6, 16, generator=g) for _ in range(3))
    mask = torch.zeros(2, 6, 6)
    one = _lanes_plain(q, k, v, mask, seed, 0.5, 0.2, 4)
    two = _lanes_plain(q[..., 8:], k[..., 8:], v[..., 8:], mask, seed, 0.5,
                       0.2, 2, 2, 4)
    torch.testing.assert_close(two, one[..., 8:], rtol=0, atol=0)
    heads = [t.view(2, 6, 4, 4).transpose(1, 2) for t in (q, k, v)]
    one = _heads_train_plain(*heads, mask, seed, 0.5, 0.2)
    two = _heads_train_plain(*(t[:, 1:3] for t in heads), mask, seed, 0.5,
                             0.2, 1, 4)
    torch.testing.assert_close(two, one[:, 1:3], rtol=0, atol=0)


# --------------------------------------------------------------------------
# Across the four ranks.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def references(init_sd, launched):
    """One process for every scenario: (losses, params, grads, norm),
    while the ranks run."""
    out = {}
    for tp, route, rate in SCENARIOS:
        fused, lanes = ROUTES[route]
        os.environ["LVT_ATTNLANES"] = lanes
        try:
            out[(tp, route, rate)] = _one_process(
                _cfg(rate, fused), init_sd[1], _shards(tp))[:4]
        finally:
            os.environ["LVT_ATTNLANES"] = "1"
    return out


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f"tp{t}-{r}-rate{p}" for t, r, p in SCENARIOS])
def test_step_equals_one_process(ranks, references, scenario):
    _, rs = ranks
    losses, params, grads, norm = references[scenario]
    tp = scenario[0]
    for r in rs:
        got = r[scenario]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["norm"], norm, rtol=1e-5)
        _assert_grads(got["grads"], grads)
        _assert_params(got["params"], params, grads, 2)
    # the tp peers of a data shard hold equal replicated gradients
    for d in range(4 // tp):
        peers = [rs[d * tp + m][scenario]["replicated"] for m in range(tp)]
        for k, g in peers[0].items():
            for other in peers[1:]:
                assert torch.equal(g, other[k]), (scenario, k)


def test_first_loss_matches_jax(references, init_sd):
    """tp 4's one-process twin (the whole batch, rates 0) against the JAX
    package's unsharded loss (the ranks equal it, above)."""
    import jax
    import jax.numpy as jnp
    from lavender_tpu.data.transforms import device_normalize
    from lavender_tpu.models.lavender import LavenderModel as JaxLavender
    from lavender_tpu.tasks import retrieval as jretrieval
    ret, _ = _batches()
    batch = dict(ret[0], img=device_normalize(jnp.asarray(ret[0]["img"])))
    loss_fn = jretrieval.make_loss_fn(JaxLavender(_jax_cfg()), TRUE_ID,
                                      FALSE_ID)
    want = float(jax.jit(loss_fn)(init_sd[0], batch, jax.random.PRNGKey(0)))
    got = references[(4, "lanes", 0.0)][0][0]
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_padded_vocab_logits(ranks, init_sd):
    _, rs = ranks
    want = _logits(init_sd[1], shard=False)
    assert want.shape[-1] == 130
    for r in rs:
        assert r["tp4_logits"].shape == want.shape
        torch.testing.assert_close(r["tp4_logits"], want, rtol=1e-5,
                                   atol=1e-5)


def test_mesh_layout_and_loader_split(ranks):
    _, rs = ranks
    for rank, r in enumerate(rs):
        assert (r["data_rank"], r["model_rank"]) == divmod(rank, 2)
        assert (r["data_index"], r["data_count"]) == (rank // 2, 2)
        assert r["loader"] == (rank // 2, 2)


def test_zero1_moments_split_over_the_data_group(ranks):
    """The two data shards of one model slice hold the moments of its
    trained parameters once between them."""
    _, rs = ranks
    for m in range(2):
        peers = [rs[d * 2 + m] for d in range(2)]
        assert peers[0]["local_numel"] == peers[1]["local_numel"]
        assert sum(p["moments"] for p in peers) == 2 * peers[0]["local_numel"]
        assert all(p["moments"] < peers[0]["local_numel"] * 1.5
                   for p in peers)


def test_checkpoints_cross_layouts(ranks, init_sd):
    """dp 2 x tp 2's file, restored in one process, steps as the ranks
    step; one process's file, restored at dp 2 x tp 2, steps as one
    process steps."""
    from lavender_tpu_torch.train import checkpoint
    out_dir, rs = ranks
    for name, loss_key, params_key in (("tp.pt", "loss3", "params3"),
                                       ("one.pt", "resumed_loss",
                                        "resumed_params")):
        state = checkpoint.restore_train_state(
            os.path.join(out_dir, name), _state(_cfg(), init_sd[1]))
        losses, params, grads, _, _ = _one_process(
            _cfg(), init_sd[1], _shards(2), steps=1, state=state)
        for r in rs:
            np.testing.assert_allclose(r[loss_key], losses[0], rtol=1e-5)
            _assert_params(r[params_key], params, grads, 1)


def test_pretraining_negatives_span_the_data_shards(ranks, init_sd):
    from lavender_tpu_torch.tasks import pretrain
    _, rs = ranks
    state = _state(_cfg(), init_sd[1])
    loss, _ = pretrain.make_loss_fn(TRUE_ID, FALSE_ID, vtm_batch=4)(
        state.model, _whole(_pretrain_batch()), state.generator)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in state.model.named_parameters()
             if p.grad is not None}
    for r in rs:
        np.testing.assert_allclose(r["pretrain"][0], float(loss.detach()),
                                   rtol=1e-5)
        _assert_grads(r["pretrain"][1], grads)


def test_retrieval_eval_and_caption(ranks, init_sd):
    """The same recall and greedy tokens; the scores within 1e-4 of their
    largest magnitude (one process's own serving routes, the LN fold on
    and off, differ here by 1.8e-5 of it: the scores sum many logits)."""
    _, rs = ranks
    recall, score = _eval(init_sd[1])
    ids = _caption(init_sd[1])
    for r in rs:
        assert r["recall"] == recall
        np.testing.assert_allclose(r["score"], score,
                                   atol=1e-4 * np.abs(score).max())
        assert torch.equal(r["greedy"], ids)


def test_cli_writes_one_log(ranks):
    out_dir, rs = ranks
    for task in ("retrieval_mlm", "caption"):
        runs = os.listdir(os.path.join(out_dir, "cli", task))
        assert len(runs) == 1, runs  # one run directory: rank 0 wrote
        files = os.listdir(os.path.join(out_dir, "cli", task, runs[0]))
        assert "log.json" in files and "args.json" in files
        assert sum(f.startswith("ckpt_") for f in files) == 1
        for rank, r in enumerate(rs):  # the tp peers of a data shard agree
            assert np.isfinite(r[task]["ls_tr"]).all()
            assert r[task]["ls_tr"] == rs[rank - rank % 2][task]["ls_tr"]
