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
    encoder_attention_train_lanes_bwd, fused_bert_attn_block_kmask,
    fused_encoder_attention_train_lanes)
from lavender_tpu_torch.ops.fused_mlp import (
    fused_ffn_post_ln, fused_ffn_post_ln_train, fused_ln_mlp,
    fused_ln_mlp_chunked, fused_out_ln_train)
from lavender_tpu_torch.ops.swin_block_attn import fused_swin_block_wm
from lavender_tpu_torch.ops.swin_core_attn import (
    swin_core_attn, swin_core_attn_bwd)
from lavender_tpu_torch.ops.wm_permute import wm_shift_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_config(cfg):
    """The port's config equal to the JAX package's ``cfg`` (a
    ModelConfig, SwinConfig, BertConfig or TrainConfig)."""
    d = dataclasses.asdict(cfg)
    if isinstance(cfg, jcfg.ModelConfig):
        d["swin"] = tcfg.SwinConfig(**d["swin"])
        d["bert"] = tcfg.BertConfig(**d["bert"])
    return getattr(tcfg, type(cfg).__name__)(**d)


@pytest.mark.parametrize("name", ["SwinConfig", "BertConfig", "ModelConfig",
                                  "TrainConfig", "SWIN_PRESETS",
                                  "IMAGENET"])
def test_port_config_equals_jax(name):
    """The port's copy: same defaults and presets as the JAX package."""
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
                0.25), {}
    if op is fused_bert_attn_block_kmask:
        keep = torch.ones(2, 8, dtype=torch.bool, device="meta")
        return (t(2, 8, C), t(C, C), t(C, C), t(C, C), t(C), t(C), t(C),
                t(C, C), t(C), *ln, keep, nH, 0.25, 1e-12), {}
    seed = torch.zeros(1, dtype=torch.int64, device="meta")
    if op is fused_encoder_attention_train_lanes:
        return (t(2, 8, C), t(2, 8, C), t(2, 8, C), t(2, 8, 8), seed, 0.25,
                0.1, nH), {}
    if op is encoder_attention_train_lanes_bwd:
        lse = torch.zeros(2, nH, 8, device="meta")
        return (t(2, 8, C), t(2, 8, C), t(2, 8, C), t(2, 8, 8), seed,
                t(2, 8, C), 0.25, 0.1, nH), {"lse": lse}
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
    fused_ffn_post_ln_train], ids=lambda op: op.name.split()[0])
def test_every_kernel_wrapper_launches_or_raises_off_the_cpu(op):
    args, kw = _meta_args(op)
    before = op.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        op(*args, **kw)
    with _build.plain_path():  # the switch is the models', not the wrapper's
        with pytest.raises(ValueError, match="CUDA tensor"):
            op(*args, **kw)
    assert op.launches == before


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
