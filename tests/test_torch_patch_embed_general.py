"""The patch embed's general path in the port against the JAX package, f32
on the CPU (JAX swin3d.py:1248-1275): float (already normalized) clips,
uint8 clips with a spatial pad (normalized on the device first), and a
temporal patch of 1 (the reference's end pad of one frame makes T + 1
output frames), each within 1e-5 of JAX's ``PatchEmbed3D`` (its XLA conv)
on the same converted weights.  Then the whole tiny backbone: the float
clip normalized by ``device_normalize`` gives the uint8 clip's features
(the folded fast path) within 1e-4, and a geometry the patch does not
divide runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavender_tpu.models.swin3d import PatchEmbed3D as JaxPatchEmbed
from lavender_tpu_torch.convert import from_flax
from lavender_tpu_torch.data.transforms import device_normalize
from lavender_tpu_torch.models.swin3d import PatchEmbed3D, VideoSwin3D
from tests.test_torch_convert import port_config, random_params
from tests.test_torch_model import PORT_SWIN

CASES = {  # clip shape, dtype, patch
    "float": ((2, 3, 32, 32, 3), np.float32, (2, 4, 4)),
    "uint8_pad": ((2, 3, 30, 34, 3), np.uint8, (2, 4, 4)),
    "pd1": ((2, 3, 32, 32, 3), np.uint8, (1, 4, 4)),
    "float_pad_pd1": ((1, 2, 29, 31, 3), np.float32, (1, 4, 4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_general_patch_embed_matches_jax(case):
    shape, dtype, patch = CASES[case]
    g = np.random.RandomState(len(case))
    x = (g.randn(*shape).astype(np.float32) if dtype == np.float32
         else g.randint(0, 256, shape).astype(np.uint8))
    jm = JaxPatchEmbed(patch_size=patch, embed_dim=24)
    params = random_params(jm, jnp.zeros((1, 2, 32, 32, 3), jnp.float32))
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    pe = PatchEmbed3D(patch, 3, 24).eval()
    pe.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray,
                                                        params)), strict=True)
    with torch.no_grad():
        got = pe(torch.from_numpy(x)).numpy()
    D = shape[1] + 2 - patch[0]
    assert got.shape == want.shape == (
        shape[0], D, -(-shape[2] // 4), -(-shape[3] // 4), 24)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_backbone_float_clip_equals_uint8_and_pads():
    model = VideoSwin3D(port_config(PORT_SWIN)).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    u8 = torch.randint(0, 256, (1, 2, 112, 112, 3), generator=gen,
                       dtype=torch.uint8)
    with torch.no_grad():
        want = model(u8)
        got = model(device_normalize(u8))
        odd = model(torch.randint(0, 256, (1, 2, 98, 98, 3), generator=gen,
                                  dtype=torch.uint8))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    assert odd.shape == (1, 2, 4, 4, 128) and torch.isfinite(odd).all()
