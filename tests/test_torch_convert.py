"""The PyTorch port's packaging: its own copy of the config (equal to the
JAX package's), JAX params -> state dict, no import of the JAX package, no
CPU fallback for a tensor that is not on the CPU, and the switch that
sends the models to the plain versions.

``port_config`` is the one place where the tests turn a JAX config into
the port's."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavender_tpu import config as jcfg
from lavender_tpu.data import transforms as jtransforms
from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu_torch import config as tcfg
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models.bert import BertEncoder
from lavender_tpu_torch.models.lavender import LavenderModel
from lavender_tpu_torch.ops import _build
from lavender_tpu_torch.ops.encoder_attention import (
    encoder_attention_train_bwd, encoder_attention_train_lanes_bwd,
    fused_bert_attn_block, fused_bert_attn_block_kmask,
    fused_encoder_attention, fused_encoder_attention_train,
    fused_encoder_attention_train_lanes)
from lavender_tpu_torch.ops.fused_mlp import (
    fused_ffn_post_ln, fused_ffn_post_ln_train, fused_ln_mlp,
    fused_ln_mlp_chunked, fused_out_ln_train)
from lavender_tpu_torch.ops.swin_block_attn import (
    fused_swin_block_attn, fused_swin_block_full, fused_swin_block_wm)
from lavender_tpu_torch.ops.swin_core_attn import (
    swin_core_attn, swin_core_attn_bwd)
from lavender_tpu_torch.ops.window_attention import fused_window_attention
from lavender_tpu_torch.ops.wm_permute import wm_shift_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The Tier-1 suite runs six pytest workers on a machine of a few cores, and
# torch's default of one intra-op thread per core in each of them
# oversubscribes it: the port's tests took about three times the worker
# time.  Every worker imports this module when it collects the suite, and
# the port's tests import it for ``port_config``: one thread each.
torch.set_num_threads(1)


def port_config(cfg):
    """The port's config equal to the JAX package's ``cfg`` (a
    ModelConfig, SwinConfig, BertConfig or TrainConfig)."""
    d = dataclasses.asdict(cfg)
    if isinstance(cfg, jcfg.ModelConfig):
        d["swin"] = tcfg.SwinConfig(**d["swin"])
        d["bert"] = tcfg.BertConfig(**d["bert"])
    return getattr(tcfg, type(cfg).__name__)(**d)


@pytest.mark.parametrize("name", ["SwinConfig", "BertConfig", "ModelConfig",
                                  "TrainConfig", "DataConfig",
                                  "SWIN_PRESETS",
                                  "IMAGENET", "TASK_TOK2ID"])
def test_port_config_equals_jax(name):
    """The port's copy: same defaults and presets as the JAX package."""
    if name == "TASK_TOK2ID":
        assert tcfg.TASK_TOK2ID == jcfg.TASK_TOK2ID
        return
    if name == "IMAGENET":
        for k in ("IMAGENET_MEAN", "IMAGENET_STD"):
            np.testing.assert_array_equal(getattr(tcfg, k),
                                          getattr(jtransforms, k))
        return
    if name == "SWIN_PRESETS":
        assert tcfg.SWIN_PRESETS.keys() == jcfg.SWIN_PRESETS.keys()
        pairs = [(tcfg.SWIN_PRESETS[k], jcfg.SWIN_PRESETS[k])
                 for k in jcfg.SWIN_PRESETS]
    else:
        pairs = [(getattr(tcfg, name)(), getattr(jcfg, name)())]
    for mine, theirs in pairs:
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert port_config(theirs) == mine


def random_params(module, *example_args, seed: int = 0):
    """Params of a flax ``module`` drawn with numpy (no JAX init compile):
    LayerNorm scales 1 + N(0, 0.1^2), every other leaf N(0, 0.05^2)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            *example_args)["params"]
    g = np.random.RandomState(seed)

    def draw(path, leaf):
        x = g.randn(*leaf.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * x
        return 0.05 * x
    return jax.tree_util.tree_map_with_path(draw, shapes)


TINY = jcfg.ModelConfig(
    swin=jcfg.SwinConfig(embed_dim=16, depths=(2, 2, 2, 2),
                         num_heads=(1, 2, 2, 4), window_size=(8, 7, 7),
                         drop_path_rate=0.0, attn_impl="xla"),
    bert=jcfg.BertConfig(vocab_size=1024, hidden_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         intermediate_size=128))


@pytest.fixture(scope="module")
def tiny_params():
    # parameter shapes do not depend on the clip size: init on a small one
    img = jnp.zeros((1, 2, 64, 64, 3), jnp.uint8)
    txt = jnp.ones((1, 6), jnp.int32)
    params = jax.jit(JaxLavender(TINY).init)(jax.random.PRNGKey(0), img, txt,
                                            txt)
    return jax.tree_util.tree_map(np.asarray, params["params"])


def test_from_flax_consumes_every_leaf_and_loads_strict(tiny_params):
    sd = from_flax(tiny_params)
    leaves = jax.tree_util.tree_leaves(tiny_params)
    assert sum(t.numel() for t in sd.values()) == sum(l.size for l in leaves)
    LavenderModel(port_config(TINY)).load_state_dict(sd, strict=True)

    swin = tiny_params["enc_img"]["swin"]
    scan = swin["layers_2"]["blocks_scan"]
    for k in range(scan["a"]["norm1"]["scale"].shape[0]):  # unstacked pairs
        np.testing.assert_array_equal(
            sd[f"enc_img.swin.layers.2.blocks.{2 * k + 1}.attn.qkv.weight"],
            scan["b"]["attn"]["qkv"]["kernel"][k].T)
        np.testing.assert_array_equal(
            sd[f"enc_img.swin.layers.2.blocks.{2 * k}.norm1.weight"],
            scan["a"]["norm1"]["scale"][k])
        np.testing.assert_array_equal(
            sd[f"enc_img.swin.layers.2.blocks.{2 * k}."
               "attn.relative_position_bias_table"],
            scan["a"]["attn"]["relative_position_bias_table"][k])
    np.testing.assert_array_equal(  # DHWIO -> OIDHW
        sd["enc_img.swin.patch_embed.proj.weight"],
        swin["patch_embed"]["proj"]["kernel"].transpose(4, 3, 0, 1, 2))
    bert = tiny_params["trsfr"]["layer_1"]
    np.testing.assert_array_equal(
        sd["trsfr.layer.1.intermediate.dense.weight"],
        bert["intermediate_dense"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["trsfr.layer.1.output.LayerNorm.weight"],
        bert["output_LayerNorm"]["scale"])
    np.testing.assert_array_equal(
        sd["trsfr.layer.1.attention.self.key.bias"],
        bert["attention"]["self"]["key"]["bias"])
    np.testing.assert_array_equal(
        sd["enc_txt.emb_txt.word_embeddings.weight"],
        tiny_params["enc_txt"]["emb_txt"]["word_embeddings"]["embedding"])
    np.testing.assert_array_equal(
        sd["fc_mtm.predictions.decoder.weight"],
        tiny_params["fc_mtm"]["decoder"]["kernel"].T)


def test_from_flax_carries_the_task_trees():
    """The task-specific heads (``fc``, ``fc_<task>`` with '-' as '_') and
    the text transformer ``enc_txt.txt_trsfr`` of the JAX multi-head model
    map leaf for leaf and load strictly into the port's; q, k and v stay
    three Linears (the heads route takes one product of them)."""
    from lavender_tpu.tasks import task_specific as jts
    from lavender_tpu_torch.tasks.task_specific import LavenderMultiHead

    cfg = dataclasses.replace(TINY, txt_backbone_embed_only=False)
    heads = (("qamc", 3), ("tgif-action", 5))
    model = jts.LavenderMultiHead(cfg, head_out=2, heads=heads)
    img = jnp.zeros((1, 2, 64, 64, 3), jnp.uint8)
    txt = jnp.ones((1, 6), jnp.int32)
    shapes = jax.eval_shape(lambda r: model.init(
        r, img, txt, txt, method=jts.LavenderMultiHead.init_forward),
        jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(
        lambda s: np.random.RandomState(s.size % 97).randn(*s.shape).astype(
            np.float32), shapes)
    sd = from_flax(params)
    leaves = jax.tree_util.tree_leaves(params)
    assert sum(t.numel() for t in sd.values()) == sum(l.size for l in leaves)
    LavenderMultiHead(port_config(cfg), heads=heads, head_out=2
                      ).load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(sd["fc_tgif_action.fc2.weight"],
                                  params["fc_tgif_action"]["fc2"]["kernel"].T)
    np.testing.assert_array_equal(sd["fc.fc1.bias"],
                                  params["fc"]["fc1"]["bias"])
    layer = params["enc_txt"]["txt_trsfr"]["layer_0"]["attention"]["self"]
    np.testing.assert_array_equal(
        sd["enc_txt.txt_trsfr.layer.0.attention.self.value.weight"],
        layer["value"]["kernel"].T)


def test_from_flax_rejects_colliding_leaves():
    x = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="two JAX leaves"):
        from_flax({"a_0": {"kernel": x}, "a": {"0": {"kernel": x}}})


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py loads JAX or any module of the
    JAX package (not even its framework-free ones)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lavender_tpu_torch\n"
        "for m in pkgutil.walk_packages(lavender_tpu_torch.__path__,\n"
        "                               'lavender_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('models.captioning', 'tasks.common', 'tasks.retrieval',\n"
        "          'ops.encoder_attention', 'ops.window_attention', 'serve',\n"
        "          'train.trainer', 'models.heads', 'tasks.qamc',\n"
        "          'tasks.qaoe', 'tasks.retmc', 'tasks.pretrain',\n"
        "          'tasks.task_specific', 'tasks.multi_task',\n"
        "          'train.checkpoint', 'data.transforms',\n"
        "          'data.tokenizer', 'data.tsv', 'data.native',\n"
        "          'data.dataset', 'data.loader', 'tasks.eval_retrieval',\n"
        "          'parallel.dist', 'train.agent', 'train.optimizer',\n"
        "          'cli.main', 'cli.tools', 'utils.logging', 'utils.misc',\n"
        "          'utils.profiling', 'utils.tb', 'utils.metrics'):\n"
        "    assert 'lavender_tpu_torch.' + m in sys.modules, m\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'lavender_tpu'))\n"
        "assert 'jax' not in sys.modules and not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _ffn_args(device):
    x = torch.zeros(16, 32, dtype=torch.bfloat16, device=device)
    w1 = torch.zeros(64, 32, dtype=torch.bfloat16, device=device)
    w2 = torch.zeros(32, 64, dtype=torch.bfloat16, device=device)
    b1 = torch.zeros(64, dtype=torch.bfloat16, device=device)
    b2 = torch.zeros(32, dtype=torch.bfloat16, device=device)
    return x, w1, b1, w2, b2, b2, b2


def test_non_cpu_tensor_never_falls_back_to_plain():
    before = fused_ffn_post_ln.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_ffn_post_ln(*_ffn_args("meta"))
    assert fused_ffn_post_ln.launches == before
    # the same call on the CPU is the plain version
    out = fused_ffn_post_ln(*_ffn_args("cpu"))
    assert out.shape == (16, 32) and fused_ffn_post_ln.launches == before


def _meta_args(op):
    """Small well-formed bf16 arguments for ``op`` on the meta device."""
    t = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16, device="meta")
    C, HD, nH = 32, 64, 2
    x, ln, w1, w2 = t(16, C), (t(C), t(C)), t(HD, C), t(C, HD)
    mlp = (*ln, w1, t(HD), w2, t(C))
    if op is fused_swin_block_wm:
        return (t(1, 2, 8, C), *ln, t(3 * C, C), t(3 * C), t(C, C), t(C),
                t(nH, 8, 8), None, nH, 0.25, 1e-5), {"mlp": mlp}
    if op in (fused_ln_mlp_chunked, fused_ln_mlp):
        return (x, *mlp, 1e-5), {}
    if op is wm_shift_rows:
        idx = torch.zeros(16, dtype=torch.int32, device="meta")
        return (t(1, 2, 8, C), idx, idx), {}
    if op is swin_core_attn:
        return (t(1, 2, 8, 3 * C), t(nH, 8, 8), None, nH, 0.25), {}
    if op is swin_core_attn_bwd:
        lse = torch.zeros(2, nH, 8, device="meta")
        return (t(1, 2, 8, 3 * C), lse, t(1, 2, 8, C), t(nH, 8, 8), None, nH,
                0.25), {"out": t(1, 2, 8, C)}
    if op is fused_bert_attn_block_kmask:
        keep = torch.ones(2, 8, dtype=torch.bool, device="meta")
        return (t(2, 8, C), t(C, C), t(C, C), t(C, C), t(C), t(C), t(C),
                t(C, C), t(C), *ln, keep, nH, 0.25, 1e-12), {}
    if op is fused_bert_attn_block:
        return (t(2, 8, C), t(C, C), t(C, C), t(C, C), t(C), t(C), t(C),
                t(C, C), t(C), *ln, t(2, 8, 8).float(), nH, 0.25, 1e-12), {}
    if op is fused_encoder_attention:
        q = t(2, nH, 8, C // nH)
        return (q, q, q, t(2, 8, 8).float(), 0.25), {}
    if op in (fused_swin_block_attn, fused_swin_block_full):
        blk = (t(1, 2, 7, 7, C), *ln, t(3 * C, C), t(3 * C), t(C, C), t(C),
               t(nH, 98, 98), None)
        mlp_args = mlp if op is fused_swin_block_full else ()
        return (*blk, *mlp_args, (2, 7, 7), (0, 0, 0), nH, 0.25, 1e-5), {}
    if op is fused_window_attention:
        q = t(4, nH, 98, C // nH)
        return (q, q, q, t(nH, 98, 98), t(2, 98, 98).float(), 0.25), {}
    seed = torch.zeros(1, dtype=torch.int64, device="meta")
    if op is fused_encoder_attention_train_lanes:
        return (t(2, 8, C), t(2, 8, C), t(2, 8, C), t(2, 8, 8), seed, 0.25,
                0.1, nH), {}
    if op is encoder_attention_train_lanes_bwd:
        lse = torch.zeros(2, nH, 8, device="meta")
        return (t(2, 8, C), t(2, 8, C), t(2, 8, C), t(2, 8, 8), seed,
                t(2, 8, C), 0.25, 0.1, nH), {"lse": lse, "o": t(2, 8, C)}
    q = t(2, nH, 8, C // nH)
    if op is fused_encoder_attention_train:
        return (q, q, q, t(2, 8, 8).float(), seed, 0.25, 0.1), {}
    if op is encoder_attention_train_bwd:
        lse = torch.zeros(2, nH, 8, device="meta")
        return (q, q, q, t(2, 8, 8).float(), seed, q, 0.25, 0.1), {
            "lse": lse, "dmask": True}
    if op is fused_out_ln_train:
        return (x, x, t(C, C), t(C), *ln, seed, 1e-12, 0.1), {}
    if op is fused_ffn_post_ln_train:
        return (x, w1, t(HD), w2, t(C), *ln, seed, 1e-12, 0.1), {}
    return (x, w1, t(HD), w2, t(C), *ln, 1e-12), {}


@pytest.mark.parametrize("op", [
    fused_swin_block_wm, fused_ln_mlp_chunked, fused_bert_attn_block_kmask,
    fused_ffn_post_ln, wm_shift_rows, swin_core_attn, swin_core_attn_bwd,
    fused_ln_mlp, fused_encoder_attention_train_lanes,
    encoder_attention_train_lanes_bwd, fused_out_ln_train,
    fused_ffn_post_ln_train, fused_bert_attn_block, fused_encoder_attention,
    fused_swin_block_attn, fused_swin_block_full, fused_window_attention,
    fused_encoder_attention_train, encoder_attention_train_bwd],
    ids=lambda op: op.name.split()[0] + (
        "-full" if op is fused_swin_block_full else ""))
def test_every_kernel_wrapper_launches_or_raises_off_the_cpu(op):
    args, kw = _meta_args(op)
    before = op.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        op(*args, **kw)
    with _build.plain_path():  # the switch is the models', not the wrapper's
        with pytest.raises(ValueError, match="CUDA tensor"):
            op(*args, **kw)
    assert op.launches == before


def _grad_args(op):
    """Small f32 CPU arguments of ``op`` (the float tensors its leaves)."""
    g = torch.Generator().manual_seed(0)
    t = lambda *shape: torch.randn(*shape, generator=g) * 0.5
    C, nH = 16, 2
    ln, mlp = (1 + t(C), t(C)), (1 + t(C), t(C), t(4 * C, C), t(4 * C),
                                 t(C, 4 * C), t(C))
    if op in (fused_ln_mlp_chunked, fused_ln_mlp):
        return (t(10, C), *mlp, 1e-5)
    mask = torch.where(torch.rand(2, 6, 6, generator=g) < 0.3,
                       torch.finfo(torch.float32).min, 0.0)
    mask[:, :, 0] = 0.0  # an open key in every row
    if op is fused_bert_attn_block:
        return (t(2, 6, C), t(C, C), t(C, C), t(C, C), t(C), t(C), t(C),
                t(C, C), t(C), *ln, mask, nH, (C // nH) ** -0.5, 1e-12)
    if op is fused_encoder_attention:
        return (t(2, nH, 6, 8), t(2, nH, 6, 8), t(2, nH, 6, 8), mask,
                8 ** -0.5)
    if op is fused_ffn_post_ln:
        return (t(10, C), *mlp[2:], *ln, 1e-12)
    if op is fused_bert_attn_block_kmask:
        keep = torch.ones(2, 6, dtype=torch.bool)
        keep[1, 4:] = False
        return (t(2, 6, C), t(C, C), t(C, C), t(C, C), t(C), t(C), t(C),
                t(C, C), t(C), *ln, keep, nH, (C // nH) ** -0.5, 1e-12)
    if op is fused_window_attention:
        return (t(4, nH, 18, 8), t(4, nH, 18, 8), t(4, nH, 18, 8),
                t(nH, 18, 18), t(2, 18, 18), 8 ** -0.5)
    return (t(2, 2, 6, 6, C), *ln, t(3 * C, C), t(3 * C), t(C, C), t(C),
            t(nH, 18, 18), t(4, 18, 18), *mlp, (2, 3, 3), (0, 1, 1), nH,
            (C // nH) ** -0.5, 1e-5)


@pytest.mark.parametrize("op", [
    fused_ln_mlp_chunked, fused_bert_attn_block_kmask, fused_ffn_post_ln,
    fused_bert_attn_block, fused_encoder_attention, fused_ln_mlp,
    fused_swin_block_full, fused_window_attention],
    ids=lambda op: op.name.split()[0])
def test_raw_launch_gets_gradients_through_recompute_vjp(op, monkeypatch):
    """K3, K4, K5 (and K6, K7, K9, K14's full block, K15) launch raw CUDA,
    which autograd cannot see into: their kernel path runs the launch inside
    ``RecomputeVjp``.  With the launch replaced by the plain version under
    ``torch.no_grad()`` (what a raw launch is to autograd) the kernel path
    still gives every input its gradient, equal to autograd of the plain
    version (1e-5), as a model in ``eval()`` mode under autograd needs."""
    args = _grad_args(op)
    monkeypatch.setattr(op, "_launch", torch.no_grad()(op.plain))
    leaves = [a for a in args if torch.is_tensor(a) and a.is_floating_point()]
    for a in leaves:
        a.requires_grad_(True)
    out = op.launch(*args)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(out, leaves, cot)
    want = torch.autograd.grad(op.plain(*args), leaves, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_plain_path_sends_the_models_to_the_plain_versions():
    """Inside ``plain_path()`` the modules call each op's plain version on
    any device; outside it they call the wrapper."""
    cfg = tcfg.BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                          num_attention_heads=2, intermediate_size=64)
    enc = BertEncoder(cfg).to(device="meta", dtype=torch.bfloat16).eval()
    x = torch.zeros(2, 8, 32, dtype=torch.bfloat16, device="meta")
    bias = torch.zeros(2, 1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        enc(x, bias)
    with _build.plain_path():
        assert (_build.select(fused_ffn_post_ln)
                == fused_ffn_post_ln.plain_as_launched)
        assert enc(x, bias).shape == x.shape
    assert _build.select(fused_ffn_post_ln) is fused_ffn_post_ln


def test_plain_as_launched_casts_keyword_arguments(monkeypatch):
    """Under CUDA autocast the plain reference takes its inputs cast as the
    kernel's autograd Function takes them, keyword arguments included
    (K1's ``mlp=``, a tuple of weights): ``_build.autocast_inputs`` and
    ``plain_as_launched`` walk tuples and dicts alike."""
    monkeypatch.setattr(torch, "is_autocast_enabled",
                        lambda device=None: device == "cuda")
    monkeypatch.setattr(torch, "get_autocast_dtype",
                        lambda device=None: torch.bfloat16)
    seen = []
    op = _build.KernelOp("K0 probe", lambda x, mlp=None: seen.append(
        (x.dtype, [t.dtype for t in mlp])), lambda *a, **k: None)
    t, i = torch.zeros(2), torch.zeros(2, dtype=torch.long)
    try:
        op.plain_as_launched(t, mlp=(t, i))
    finally:
        # autocast's exit restores the state the patched query reported:
        # without this the process keeps CUDA autocast on, and the next
        # test file's spatial Swin stages cast their biases to bf16
        torch.set_autocast_enabled("cuda", False)
    assert seen == [(torch.bfloat16, [torch.bfloat16, torch.long])]
    x, mlp = _build.autocast_inputs(t, (t, None))
    assert x.dtype == mlp[0].dtype == torch.bfloat16 and mlp[1] is None


def test_kernel_path_without_nvcc_raises(monkeypatch, tmp_path):
    """Past the device check, a machine without the CUDA toolkit fails at
    the build; nothing falls back to the plain version."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)  # no library built
    monkeypatch.setattr(_build, "_check", lambda *a, **k: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_ffn_post_ln(*_ffn_args("meta"))
