"""The port's Video Swin backbone on every route against the JAX backbone,
f32 on the CPU, on the same converted weights, at 1e-3 (4 stages in f32,
other summation orders).

Routes: ``attn_impl`` "fused" (K14's plain versions), "pallas" (K15's),
"xla", ``remat=True``, ``scan_blocks=False`` and odd depths (the port's
"auto" -> "wm" falling back to "fused" stage by stage).  The JAX side runs
its module math ("xla", or "auto", which is "xla" off the TPU): its own
suite holds its "fused" and "pallas" backbones equal to it
(tests/test_swin_block_fused.py, tests/test_pallas_attention.py), and the
kernels themselves are held against the port's in Pallas interpret mode in
tests/test_torch_swin_spatial.py and tests/test_torch_window_attention.py
(the latter also on the whole model under "pallas").  A clip of
2 x 56 x 56 runs stages of 14 x 14 and 7 x 7 (the window tiles them) and
of 4 x 4 and 2 x 2 (the window shrinks in H and W, so the bias is the full
window's index sliced [:N, :N]); a clip of 2 x 64 x 64 a 16 x 16 and an
8 x 8 stage that the window does not tile (the module path, zero-padded
after LN1).  The random weights are drawn with numpy into the JAX tree
(one per layout); ``convert.from_flax`` maps the per-block tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavender_tpu import config as jcfg
from lavender_tpu.models import swin3d as jswin
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models import swin3d as tswin
from tests.test_torch_convert import port_config, random_params


SWIN = jcfg.SwinConfig(embed_dim=16, depths=(2, 2, 2, 2),
                       num_heads=(1, 2, 2, 4), window_size=(8, 7, 7),
                       drop_path_rate=0.0)
# XLA compiles without LLVM's optimisations: on these tiny shapes the
# compile is most of the time and the run a fraction of a second
_FAST = {"xla_backend_optimization_level": 0}
_PARAMS = {}
_OUTPUTS = {}


def _backbone_params(cfg):
    """JAX params of ``cfg``'s tree (one draw per depths / scan layout)."""
    key = (cfg.depths, cfg.scan_blocks)
    if key not in _PARAMS:
        _PARAMS[key] = random_params(
            jswin.VideoSwin3D(cfg), jnp.zeros((1, 2, 56, 56, 3), jnp.uint8),
            seed=len(_PARAMS))
    return _PARAMS[key]


def _jax_output(cfg, size):
    """(clip, JAX backbone output on its module math), one compile per
    tree layout and clip size (the routes of one layout share it)."""
    key = (cfg.depths, cfg.scan_blocks, size)
    if key not in _OUTPUTS:
        img = np.random.RandomState(3).randint(
            0, 256, (1, 2, size, size, 3)).astype(np.uint8)
        jax_cfg = dataclasses.replace(cfg, attn_impl="xla", remat=False)
        variables = {"params": _backbone_params(cfg)}
        apply = jax.jit(jswin.VideoSwin3D(jax_cfg).apply)
        _OUTPUTS[key] = img, np.asarray(apply.lower(variables, img).compile(
            _FAST)(variables, img))
    return _OUTPUTS[key]


@pytest.mark.parametrize("impl,size,kw", [
    ("fused", 56, {}), ("pallas", 56, {}), ("pallas", 64, {}),
    ("xla", 64, {}), ("fused", 64, {}), ("auto", 56, {"remat": True}),
    ("fused", 56, {"scan_blocks": False}),
    ("auto", 56, {"depths": (1, 3, 2, 1)}),
], ids=["fused", "pallas", "pallas-untiled", "xla-untiled", "fused-untiled",
        "auto-remat", "fused-no-scan", "auto-odd-depth"])
def test_video_swin_matches_jax(impl, size, kw):
    """A uint8 clip [1, 2, size, size, 3] through both backbones on the
    same weights; the JAX side on its module math."""
    cfg = dataclasses.replace(SWIN, attn_impl=impl, **kw)
    img, want = _jax_output(cfg, size)
    params = _backbone_params(cfg)
    model = tswin.VideoSwin3D(port_config(cfg)).eval()
    model.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_from_flax_maps_the_per_block_tree():
    """scan_blocks=False: JAX ``layers_i/blocks_j`` -> torch
    ``layers.i.blocks.j``."""
    cfg = dataclasses.replace(SWIN, scan_blocks=False, depths=(1, 3, 2, 1))
    params = _backbone_params(cfg)
    sd = from_flax(params)
    tswin.VideoSwin3D(port_config(cfg)).load_state_dict(sd, strict=True)
    blk = params["layers_1"]["blocks_2"]
    np.testing.assert_array_equal(sd["layers.1.blocks.2.attn.qkv.weight"],
                                  blk["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["layers.1.blocks.2.attn.relative_position_bias_table"],
        blk["attn"]["relative_position_bias_table"])
    np.testing.assert_array_equal(sd["layers.1.blocks.2.norm2.weight"],
                                  blk["norm2"]["scale"])
