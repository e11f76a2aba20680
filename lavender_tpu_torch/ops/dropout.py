"""The counter-based dropout mask of the port's train kernels.

The JAX train kernels (K10, K11, K12) draw their dropout bits inside the
kernel from the TPU's own generator (``pltpu.prng_random_bits``), which the
card has no counterpart of.  The port draws them from a hash of each
element's coordinates, ``bits = H(seed, stream, index)`` (a uint32), which
the CUDA kernels (``csrc/dropout.cuh``) and the plain PyTorch versions here
compute alike: a kernel and its plain version given the same seed drop the
same elements, and a backward kernel regenerates its forward's mask from
the seed.  The stream is (sequence, head) for attention probabilities and
the row for hidden activations; the index is the position inside it.

    key(seed, stream) = fmix32(fmix32(seed ^ SEED_SALT) ^ stream * STREAM_MUL)
    bits(key, index)  = fmix32(key ^ index * INDEX_MUL)

(fmix32: MurmurHash3's finaliser; products modulo 2^32.)  Keep rule, as in
the JAX kernels: keep iff ``bits >= min(floor(rate * 2^32), 2^32 - 1)``,
kept values scaled by ``1 / (1 - rate)``; at rate 0 nothing is drawn.

PyTorch has no uint32 arithmetic, and a 32 x 32-bit product overflows
int64, so the values here are int64 in [0, 2^32) and every product is
formed modulo 2^32 from the constant's 16-bit halves (each partial product
< 2^48).  The seed is a one-element int64 tensor on the device of the data
(drawn with ``draw_seed``), so nothing syncs with the host.
"""
from __future__ import annotations

from typing import Optional

import torch

SEED_SALT = 0x3C6EF372
STREAM_MUL = 0x85EBCA77
INDEX_MUL = 0x9E3779B9
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def stream_key(seed: torch.Tensor, stream: torch.Tensor) -> torch.Tensor:
    """key(seed, stream); seed int64 [1] (its low 32 bits), stream int64."""
    s = seed.to(torch.int64) & _M32
    return fmix32(fmix32(s ^ SEED_SALT) ^ _mul32(stream, STREAM_MUL))


def bits(seed: torch.Tensor, stream: torch.Tensor,
         index: torch.Tensor) -> torch.Tensor:
    """The uint32 bits (as int64) of every (stream, index), broadcast."""
    return fmix32(stream_key(seed, stream) ^ _mul32(index, INDEX_MUL))


def threshold(rate: float) -> int:
    """The smallest kept value of the bits."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def keep_mask(seed: torch.Tensor, stream: torch.Tensor, index: torch.Tensor,
              rate: float) -> torch.Tensor:
    """Bool keep mask of the broadcast (stream, index) grid."""
    return bits(seed, stream, index) >= threshold(rate)


def attention_keep(seed: torch.Tensor, n_seq: int, n_heads: int, n_tok: int,
                   rate: float) -> torch.Tensor:
    """[n_seq, nH, N, N] keep mask of attention probabilities: stream
    seq * nH + head, index row * N + col (the K10 kernels' counter)."""
    dev = seed.device
    stream = torch.arange(n_seq * n_heads, device=dev).view(n_seq, n_heads,
                                                            1, 1)
    index = torch.arange(n_tok * n_tok, device=dev).view(1, 1, n_tok, n_tok)
    return keep_mask(seed, stream, index, rate)


def row_keep(seed: torch.Tensor, rows: int, cols: int,
             rate: float) -> torch.Tensor:
    """[rows, cols] keep mask of hidden activations: stream row, index col
    (the K11 / K12 row kernel's counter)."""
    dev = seed.device
    if rate == 0.0:
        return torch.ones(rows, cols, dtype=torch.bool, device=dev)
    return keep_mask(seed, torch.arange(rows, device=dev)[:, None],
                     torch.arange(cols, device=dev)[None], rate)


def draw_seed(generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """One kernel call's seed: an int64 [1] in [0, 2^31 - 1) on ``device``
    from ``generator`` (the JAX model's ``randint(rng, 0, 2^31 - 1)``),
    left on the device."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=device)
