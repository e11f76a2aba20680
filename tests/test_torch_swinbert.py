"""The SwinBERT adapter (``ModelConfig(swinbert=True)``) of the port against
the JAX package, f32 on the CPU, on the same converted weights: the
EncVideo features and mask (fc to 512, ``img_embedding``, a zero [CLS] a
frame whose mask entry is 0: masked keys INSIDE the video part of the
fusion sequence), the serving logits under the "full" mask and under
"seq2seq"; and on the port alone, greedy captions of the KV-cache decoder
equal to the re-encode decoder's (the prefill's key mask has those zeros
in it).

The tiny config of tests/test_torch_model.py on clips of 2 x 224 x 224:
the JAX side runs ``attn_impl="xla"`` (its module math), the port its
default window-major route in its plain versions.  Tolerances as in
tests/test_torch_model.py: 1e-4 on the features, 1e-3 on the logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavender_tpu import config as jcfg
from lavender_tpu.models.lavender import LavenderModel as JaxLavender
from lavender_tpu_torch.models import captioning
from lavender_tpu_torch.serve import LavenderServer
from tests.test_torch_convert import port_config, random_params
from tests.test_torch_model import BERT, PORT_SWIN, SWIN

CFG = jcfg.ModelConfig(swin=SWIN, bert=BERT, swinbert=True)
PORT_CFG = port_config(dataclasses.replace(CFG, swin=PORT_SWIN))
CLS, SEP, PAD, MASK = 101, 102, 0, 103


@pytest.fixture(scope="module")
def setup():
    """(img, txt, mask, params, the port's server)."""
    g = np.random.RandomState(4)
    img = g.randint(0, 256, (2, 2, 224, 224, 3)).astype(np.uint8)
    mask = np.ones((2, 26), np.int32)
    mask[1, 17:] = 0
    txt = g.randint(1, BERT.vocab_size, (2, 26)).astype(np.int32) * mask
    params = random_params(JaxLavender(CFG), jnp.zeros((1, 2, 64, 64, 3),
                                                       jnp.uint8),
                           jnp.ones((1, 6), jnp.int32),
                           jnp.ones((1, 6), jnp.int32), seed=3)
    params = jax.tree_util.tree_map(np.asarray, params)
    server = LavenderServer(PORT_CFG, device="cpu", params=params,
                            dtype=torch.float32, frames=2, size=224)
    return img, txt, mask, params, server


def test_swinbert_encvideo_matches_jax(setup):
    img, _, _, params, server = setup
    jf, jm = jax.jit(lambda p, x: JaxLavender(CFG).apply(
        {"params": p}, x, method=lambda m, v: m.enc_img(v)))(params, img)
    with torch.inference_mode():
        f, m = server.model.enc_img(torch.from_numpy(img))
    assert f.shape == (2, 2 * 50, BERT.hidden_size)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert (m.numpy()[:, ::50] == 0).all() and m.sum() == 2 * 2 * 49
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(f.numpy()[:, ::50], 0.0)


@pytest.mark.parametrize("attn_mask_type", ["full", "seq2seq"])
def test_swinbert_logits_match_jax(setup, attn_mask_type):
    img, txt, mask, params, server = setup
    want = np.asarray(jax.jit(
        lambda p, *a: JaxLavender(CFG).apply(
            {"params": p}, *a, attn_mask_type=attn_mask_type))(
        params, img, txt, mask))
    got = server(img, txt, mask, attn_mask_type)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


def test_swinbert_kv_decoder_equals_reencode(setup):
    img, _, _, _, server = setup
    gen = captioning.GenerateConfig(max_gen_length=6)
    ids, logprob = captioning.make_generate_fn(
        server.model, CLS, SEP, PAD, MASK, gen)(torch.from_numpy(img))
    want = captioning.rencode_generate_reference(
        server.model, torch.from_numpy(img), CLS, SEP, PAD, MASK, 6)
    assert torch.equal(ids, want)
    assert ids.shape == (2, 6) and torch.isfinite(logprob).all()
