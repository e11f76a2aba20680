"""The port's weight import and checkpoints against the JAX package, on the
CPU: a reference-layout ``.pt`` (LAVENDER, with the tied MLM bias, the
recomputed buffers and ``emb_len`` / ``emb_pos`` of other sizes; and a
SwinBERT one) through the JAX ``load_reference_checkpoint`` then
``from_flax``, and through the port's, gives equal tensors key for key;
the 2D -> 3D Swin inflation equals JAX's (1e-6, a bias table that needs
the bicubic resize); a train state resumed after 2 steps takes its 3rd
step exactly as 3 straight steps do (parameters, AdamW moments, LR,
step, generator state, bitwise); ``args.json`` / ``log.json`` equal the
JAX functions' files.  The state dicts are drawn from seeds, none is
downloaded.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lavender_tpu import config as jcfg
from lavender_tpu import convert as jconvert
from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu.train import checkpoint as jckpt
from lavender_tpu_torch import convert as tconvert
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models.lavender import LavenderModel
from lavender_tpu_torch.tasks import retrieval
from lavender_tpu_torch.train import checkpoint as tckpt
from lavender_tpu_torch.train.trainer import (create_train_state,
                                              make_train_step)
from tests.test_torch_convert import TINY, port_config, random_params

SWINBERT = dataclasses.replace(TINY, swinbert=True)


def _init(cfg, seed):
    """(JAX params in scan layout, the port's state dict of them)."""
    import jax.numpy as jnp
    params = random_params(JaxLavender(cfg), jnp.zeros((1, 2, 64, 64, 3),
                                                       jnp.uint8),
                           jnp.ones((1, 6), jnp.int32),
                           jnp.ones((1, 6), jnp.int32), seed=seed)
    return params, from_flax(params)


@pytest.fixture(scope="module")
def tiny():
    return _init(TINY, 0), _init(TINY, 1)


def _reference_layout(sd, frames, patch):
    """A port state dict written as the reference's ``.pt``: the MLM bias
    as the tied ``predictions.bias``, the buffers the models recompute,
    and emb_len / emb_pos with ``frames`` frames / 1 + ``patch``^2
    positions."""
    g = torch.Generator().manual_seed(frames)
    out = dict(sd)
    out["fc_mtm.predictions.bias"] = out.pop(
        "fc_mtm.predictions.decoder.bias")
    H = out["enc_img.emb_len"].shape[-1]
    out["enc_img.emb_len"] = torch.randn(1, frames, 1, H, generator=g)
    out["enc_img.emb_pos"] = torch.randn(1, 1, 1 + patch ** 2, H,
                                         generator=g)
    out["enc_img.swin.layers.0.blocks.1.attn.relative_position_index"] = (
        torch.zeros(98, 98, dtype=torch.long))
    out["enc_img.swin.layers.0.blocks.1.attn_mask"] = torch.zeros(4, 98, 98)
    out["enc_txt.emb_txt.position_ids"] = torch.arange(512)[None]
    return out


def _both(path, init_params, init_sd, **sizes):
    want = from_flax(jckpt.load_reference_checkpoint(path, init_params,
                                                     **sizes))
    got = tckpt.load_reference_checkpoint(path, init_sd, **sizes)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)
    return got


@pytest.mark.parametrize("frames,patch", [(8, 16), (4, 10)],
                         ids=["truncated", "padded"])
def test_reference_checkpoint_loads_as_jax_loads_it(tiny, tmp_path, frames,
                                                    patch):
    """convert + merge, exactly (0 tolerance): emb_len / emb_pos cut to the
    init's 6 frames and 1 + 14^2 positions, or copied into its front."""
    (init_params, init_sd), (_, ckpt_sd) = tiny
    path = str(tmp_path / "ckpt_violet_test.pt")
    torch.save(_reference_layout(ckpt_sd, frames, patch), path)
    got = _both(path, init_params, init_sd, max_size_frame=6,
                max_size_patch=14)
    n = min(frames, 6)
    torch.testing.assert_close(got["enc_img.emb_len"][:, :n],
                               torch.load(path)["enc_img.emb_len"][:, :n])
    if frames < 6:  # the rest keeps the init
        torch.testing.assert_close(got["enc_img.emb_len"][:, n:],
                                   init_sd["enc_img.emb_len"][:, n:])
    torch.testing.assert_close(got["fc_mtm.predictions.decoder.bias"],
                               ckpt_sd["fc_mtm.predictions.decoder.bias"])
    LavenderModel(port_config(TINY)).load_state_dict(got, strict=True)


def test_swinbert_checkpoint_loads_as_jax_loads_it(tmp_path):
    """A SwinBERT-layout ``.pt`` (the inverse of ``remap_swinbert_keys``,
    plus keys the remap drops) into ``ModelConfig(swinbert=True)``: every
    mapped tensor as written, ``emb_task`` (unmapped) at its init, equal to
    the JAX package's load key for key; a model passed in holds the
    result."""
    init_params, init_sd = _init(SWINBERT, 0)
    _, ckpt_sd = _init(SWINBERT, 1)
    layout = tconvert.swinbert_layout_keys(ckpt_sd)
    assert "fc.weight" in layout and "swin.backbone.norm.weight" in layout
    layout["trans_encoder.bert.pooler.dense.weight"] = torch.ones(3, 3)
    path = str(tmp_path / "ckpt_SwinBERT_vatex.pt")
    torch.save({"model": layout}, path)
    got = _both(path, init_params, init_sd)
    model = LavenderModel(port_config(SWINBERT))
    model.load_state_dict(init_sd, strict=True)
    tckpt.load_reference_checkpoint(path, model)
    for k, v in model.state_dict().items():
        want = init_sd[k] if k == "emb_task" else ckpt_sd[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
        torch.testing.assert_close(got[k], want, rtol=0, atol=0, msg=k)
    assert tconvert.remap_swinbert_keys(layout).keys() == (
        set(ckpt_sd) - {"emb_task"}) | {"fc_mtm.predictions.bias"}


def test_swin2d_inflation_matches_jax():
    """A 2D Swin (window 12: 23^2-row bias tables, bicubic-resized to the
    3D window's 13 x 13 and tiled over 2 * 8 - 1 temporal offsets; 4x4
    patch repeated over pd = 2): within 1e-6 of JAX, then converted to the
    port's VideoSwin3D keys as the JAX tree converts with ``from_flax``."""
    g = np.random.RandomState(5)
    sd = {"patch_embed.proj.weight": g.randn(16, 3, 4, 4).astype(np.float32),
          "patch_embed.proj.bias": g.randn(16).astype(np.float32),
          "head.weight": g.randn(10, 128).astype(np.float32)}
    for i, nH in enumerate((1, 2)):
        pre = f"layers.{i}.blocks.1.attn."
        sd[pre + "relative_position_bias_table"] = g.randn(
            23 * 23, nH).astype(np.float32)
        sd[pre + "relative_position_index"] = np.zeros((144, 144), np.int64)
        sd[pre + "qkv.weight"] = g.randn(48, 16).astype(np.float32)
    sd["layers.0.blocks.1.attn_mask"] = np.zeros((4, 144, 144), np.float32)
    cfg = jcfg.SwinConfig(embed_dim=16, depths=(2, 2), num_heads=(1, 2))
    want = jconvert.inflate_swin2d_state_dict(sd, cfg.window_size, 2)
    got = tconvert.inflate_swin2d_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg.window_size, 2)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    assert got["layers.1.blocks.1.attn.relative_position_bias_table"].shape \
        == (15 * 13 * 13, 2)
    want_sd = from_flax(jconvert.convert_swin2d_checkpoint({"model": sd}, cfg))
    got_sd = tconvert.convert_swin2d_checkpoint({"model": sd}, cfg)
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        torch.testing.assert_close(got_sd[k], want_sd[k], rtol=1e-6,
                                   atol=1e-6, msg=k)


# the resume check: a small clip (stages 1-2 on the module path, 3-4 on
# the wm route), drop-path and dropout on, a schedule that moves the LR
RESUME = dataclasses.replace(TINY, swin=dataclasses.replace(
    TINY.swin, attn_impl="auto", drop_path_rate=0.3))


def _batch():
    g = np.random.RandomState(2)
    return {"img": torch.from_numpy(g.randint(0, 256, (2, 2, 64, 64, 3)
                                              ).astype(np.uint8)),
            "txt": torch.from_numpy(g.randint(1, 1024, (2, 8))),
            "mask": torch.ones(2, 8, dtype=torch.long),
            "vid": torch.arange(2)}


def _state(params):
    return create_train_state(
        port_config(RESUME), port_config(jcfg.TrainConfig(
            lr=1e-3, max_iter=10, warmup_ratio=0.2)), device="cpu",
        params=params, seed=7)


def _run(state, n):
    step = make_train_step(retrieval.make_loss_fn(5, 6), state)
    return [step(_batch()) for _ in range(n)]


def test_resume_is_bitwise(tiny, tmp_path):
    params = tiny[0][0]
    straight = _state(params)
    losses = _run(straight, 3)
    first = _state(params)
    _run(first, 2)
    path = str(tmp_path / "state" / "train_state.pt")
    tckpt.save_train_state(first, path)
    resumed = tckpt.restore_train_state(path, _state(params))
    assert resumed.step == 2
    last = _run(resumed, 1)
    assert torch.equal(last[0], losses[2])
    assert resumed.step == straight.step == 3
    for (n, p), q in zip(straight.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(p, q), n
    a, b = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, s in a["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[k], b["state"][i][k]), (i, k)
    assert [g["lr"] for g in a["param_groups"]] == [
        g["lr"] for g in b["param_groups"]]
    assert straight.scheduler.get_last_lr() == resumed.scheduler.get_last_lr()
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())


def test_restore_refuses_another_generator_device(tiny, tmp_path):
    state = _state(tiny[0][0])
    path = str(tmp_path / "s.pt")
    tckpt.save_train_state(state, path)
    payload = torch.load(path, weights_only=True)
    payload["generator_device"] = "cuda"
    torch.save(payload, path)
    with pytest.raises(ValueError, match="cannot continue"):
        tckpt.restore_train_state(path, _state(tiny[0][0]))


def test_params_round_trip(tiny, tmp_path):
    model = LavenderModel(port_config(TINY))
    model.load_state_dict(tiny[0][1], strict=True)
    path = str(tmp_path / "p" / "params.pt")
    tckpt.save_params(model, path)
    other = LavenderModel(port_config(TINY))
    sd = tckpt.load_params(path, like=other)
    for k, v in other.state_dict().items():
        assert torch.equal(v, tiny[0][1][k]) and torch.equal(sd[k], v), k


def test_meta_and_log_json_equal_jax(tmp_path):
    log = {"ep_1": {"loss": 1.25, "acc": [0.5, 0.25]}}
    for cfg in (jcfg.ModelConfig(), RESUME, jcfg.TrainConfig(max_iter=3)):
        jdir, tdir = tmp_path / "jax", tmp_path / "port"
        jckpt.save_training_meta(cfg, str(jdir))
        tckpt.save_training_meta(port_config(cfg), str(tdir))
        jckpt.save_log(log, str(jdir))
        tckpt.save_log(log, str(tdir))
        for name in ("args.json", "log.json"):
            assert (tdir / name).read_text() == (jdir / name).read_text()
        assert json.loads((tdir / "log.json").read_text()) == log
        os.remove(tdir / "args.json")
