"""The port's serving slice against the JAX package on the same converted
weights, f32 on the CPU: the whole model through ``LavenderServer``, the
Video Swin backbone alone and the fusion BertEncoder alone.

The JAX side runs ``attn_impl="xla"`` (its module math; the Pallas kernels
only lower on a TPU), the port its default route ("auto": the window-major
blocks K1 / K2 / K3, the same function) in its plain PyTorch versions.
Tolerance 1e-3 on the MLM logits (24 ops deep in f32 with different summation orders and
the uint8 normalize folded into the patch-embed weights on both sides),
1e-4 on the backbone and encoder outputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavender_tpu import config as jcfg
from lavender_tpu.models.bert import BertEncoder as JaxBertEncoder
from lavender_tpu.models.bert import extended_attention_mask as jax_ext_mask
from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu.models.swin3d import VideoSwin3D as JaxSwin
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.models.bert import BertEncoder, extended_attention_mask
from lavender_tpu_torch.models.swin3d import VideoSwin3D
from lavender_tpu_torch.serve import LavenderServer
from tests.test_torch_convert import port_config

SWIN = jcfg.SwinConfig(embed_dim=16, depths=(2, 2, 2, 2),
                       num_heads=(1, 2, 2, 4), window_size=(8, 7, 7),
                       drop_path_rate=0.0, attn_impl="xla")
# the port's side of SWIN: its default (window-major) route
PORT_SWIN = dataclasses.replace(SWIN, attn_impl="auto")
BERT = jcfg.BertConfig(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128)


def _np_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def test_serving_slice_matches_jax_lavender():
    """uint8 clips [2, 5, 224, 224, 3] + 26 tokens (one padded) -> MLM
    logits; 128 Swin features != 64 hidden exercises EncVideo.fc."""
    cfg = jcfg.ModelConfig(swin=SWIN, bert=BERT)
    g = np.random.RandomState(0)
    img = g.randint(0, 256, (2, 5, 224, 224, 3)).astype(np.uint8)
    mask = np.ones((2, 26), np.int32)
    mask[1, 17:] = 0
    txt = g.randint(1, BERT.vocab_size, (2, 26)).astype(np.int32) * mask
    jm = JaxLavender(cfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), img[:1], txt[:1],
                                 mask[:1])
    want = np.asarray(jax.jit(jm.apply)(variables, img, txt, mask))

    server = LavenderServer(port_config(dataclasses.replace(
                                cfg, swin=PORT_SWIN)), device="cpu",
                            params=_np_params(variables),
                            dtype=torch.float32, frames=5, size=224)
    got = server(img, txt, mask)
    assert got.shape == (2, 26, BERT.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)
    for layer in server.model.enc_img.swin.layers:  # serving caches built
        assert len(layer._cache) == 1


def test_video_swin_matches_jax_and_serves_uncached_geometry():
    """Clips of 5 x 112 x 112: stage 4 is 4 x 4, so its window shrinks in
    H and W too (N = 80, no pad).  The serving cache is built for 224, so
    this geometry runs the cacheless path."""
    img = np.random.RandomState(1).randint(0, 256, (2, 5, 112, 112, 3)
                                           ).astype(np.uint8)
    jm = JaxSwin(SWIN)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), img[:1])
    want = np.asarray(jax.jit(jm.apply)(variables, img))
    model = VideoSwin3D(port_config(PORT_SWIN)).eval()
    model.load_state_dict(from_flax(_np_params(variables)), strict=True)
    model.build_serving_cache(5, 224, 224)
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 5, 4, 4, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("padded", [False, True])
def test_bert_encoder_matches_jax(padded):
    g = np.random.RandomState(2)
    B, L = 2, 30
    x = g.randn(B, L, BERT.hidden_size).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    if padded:
        mask[0, 22:] = 0
    jm = JaxBertEncoder(BERT)
    bias = jax_ext_mask(jnp.asarray(mask))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(2), x, bias)
    want = np.asarray(jax.jit(jm.apply)(variables, x, bias))
    model = BertEncoder(port_config(BERT)).eval()
    model.load_state_dict(from_flax(_np_params(variables)), strict=True)
    t_bias = extended_attention_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(t_bias.numpy(), np.asarray(bias))
    with torch.no_grad():
        got = model(torch.from_numpy(x), t_bias).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("attn,ffn", [(False, False), (True, False),
                                      (False, True)])
def test_bert_serving_follows_the_fused_flags(monkeypatch, attn, ffn):
    """``BertConfig.fused_attn`` / ``fused_ffn`` pick the serving kernels
    (K4, K5) or the module math, as in JAX; either way the encoder equals
    JAX's (1e-4).  The kernels' plain versions are counted."""
    from lavender_tpu_torch.ops import encoder_attention, fused_mlp
    cfg = dataclasses.replace(BERT, fused_attn=attn, fused_ffn=ffn)
    calls = {"K4": 0, "K5": 0}
    for name, op in (("K4", encoder_attention.fused_bert_attn_block_kmask),
                     ("K5", fused_mlp.fused_ffn_post_ln)):
        def counted(*a, _name=name, _plain=op.plain):
            calls[_name] += 1
            return _plain(*a)
        monkeypatch.setattr(op, "plain", counted)
    g = np.random.RandomState(3)
    x = g.randn(2, 14, BERT.hidden_size).astype(np.float32)
    mask = np.ones((2, 14), np.int32)
    mask[1, 9:] = 0
    jm = JaxBertEncoder(cfg)
    bias = jax_ext_mask(jnp.asarray(mask))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3), x, bias)
    want = np.asarray(jax.jit(jm.apply)(variables, x, bias))
    model = BertEncoder(port_config(cfg)).eval()
    model.load_state_dict(from_flax(_np_params(variables)), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    extended_attention_mask(torch.from_numpy(mask))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    layers = BERT.num_hidden_layers
    assert calls == {"K4": layers * attn, "K5": layers * ffn}
