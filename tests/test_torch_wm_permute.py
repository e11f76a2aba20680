"""K2, the window-major cyclic shift as one row permutation: the port's
index and its plain version against the JAX package's Pallas kernel
``wm_shift_pallas`` (interpret mode, as tests/test_wm_permute.py runs it)
and its run table, f32 on the CPU.  A permutation moves values without
arithmetic, so every comparison is exact, gradients included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavender_tpu.ops import wm_permute as jperm
from lavender_tpu.ops.swin_block_attn import wm_partition as jpartition
from lavender_tpu_torch.ops import wm_permute as tperm

GEOMS = [
    # (window, D, H, W, C, Npad, shift): the Swin-B stage maps at T=5
    # (small C), a d-shift, a non-square map and the no-tail-pad case
    ((5, 7, 7), 5, 56, 56, 8, 248, (0, 3, 3)),
    ((5, 7, 7), 5, 14, 14, 8, 248, (0, 3, 3)),
    ((2, 7, 7), 2, 14, 21, 8, 104, (1, 3, 3)),
    ((1, 12, 12), 1, 24, 24, 8, 144, (0, 6, 6)),
]


def _wm(window, D, H, W, C, Npad, B=2, seed=0):
    x = np.random.RandomState(seed).randn(B, D, H, W, C).astype(np.float32)
    return np.array(jpartition(jnp.asarray(x), window, Npad))


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("inverse", [False, True])
def test_shift_index_matches_jax_runs(geom, inverse):
    window, D, H, W, _, Npad, shift = geom
    runs, pads = jperm._perm_runs(window, D, H, W, Npad, shift, inverse)
    want = np.full(len(tperm.shift_index(window, D, H, W, Npad, shift,
                                         inverse)), -2, np.int64)
    for dst, src, n in runs:
        want[dst:dst + n] = np.arange(src, src + n)
    for dst, n in pads:
        want[dst:dst + n] = -1
    np.testing.assert_array_equal(
        tperm.shift_index(window, D, H, W, Npad, shift, inverse), want)


@pytest.mark.parametrize("geom", GEOMS[1:])  # the 64-window map is slow
@pytest.mark.parametrize("inverse", [False, True])  # to interpret
def test_shift_and_gradient_match_jax_kernel(geom, inverse):
    window, D, H, W, C, Npad, shift = geom
    t = _wm(window, D, H, W, C, Npad)
    N = int(np.prod(window))
    t[:, :, N:] = 1e9  # pad-row garbage must not reach the output
    w = _wm(window, D, H, W, C, Npad, seed=1)

    def loss(t):
        return jnp.sum(jperm.wm_shift_pallas(t, window, D, H, W, shift,
                                             inverse) * w)

    with pltpu.force_tpu_interpret_mode():
        want = jperm.wm_shift_pallas(jnp.asarray(t), window, D, H, W, shift,
                                     inverse)
        g_want = jax.grad(loss)(jnp.asarray(t))
    tt = torch.from_numpy(t).requires_grad_(True)
    got = tperm.wm_shift(tt, window, D, H, W, shift, inverse)
    (g_got,) = torch.autograd.grad(got, tt, torch.from_numpy(w))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert not got[:, :, N:].detach().any()
    np.testing.assert_array_equal(g_got.numpy(), np.asarray(g_want))


def test_inverse_undoes_the_shift_on_real_rows():
    window, D, H, W, C, Npad, shift = GEOMS[0]
    t = torch.from_numpy(_wm(window, D, H, W, C, Npad))
    back = tperm.wm_shift(tperm.wm_shift(t, window, D, H, W, shift),
                          window, D, H, W, shift, inverse=True)
    N = int(np.prod(window))
    assert torch.equal(back[:, :, :N], t[:, :, :N])
