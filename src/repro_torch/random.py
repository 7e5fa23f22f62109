"""Counter-based PRNG keys, bit-exact with ``jax.random`` (threefry2x32).

The only randomness on the L-PCN path is random hub selection
(``core.sampling.index_uniform``), and its keys are derived by ``split`` /
``fold_in`` chains from one key per cloud.  Reproducing JAX's threefry2x32
bit for bit keeps a :class:`~repro_torch.engine.params.Batch`'s ``keys``
meaning what they mean in the JAX package, so a cloud picks the same hubs
in both, and keeps index_uniform's per-index property (a padded cloud picks
the same hubs as its unpadded prefix) that a ``torch.Generator`` stream
cannot give.

Keys are int64 tensors of shape ``(..., 2)`` holding the two uint32 key
words; every function here broadcasts over the leading axes (JAX needs
``vmap`` for that).  The uint32 arithmetic runs in int64 masked with
``0xFFFFFFFF`` (PyTorch has no uint32 add on every device).  Matches the
``jax_threefry_partitionable=True`` layout of ``split`` and random bits.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on int64-held uint32
    words; all four operands broadcast.  -> (y1, y2)."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & MASK)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` -> (2,) int64 key words.  Seeds are
    32-bit as in JAX without x64: the high word is 0."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: (..., 2) key, integer data broadcasting
    against the key's leading axes -> (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def bits32(key: torch.Tensor) -> torch.Tensor:
    """32 random bits of a scalar draw (``random_bits(key, 32, ())``)."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    return y1 ^ y2


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, ())`` in float32, broadcast over the
    key's leading axes: the 23 high bits become the mantissa of a float
    in [1, 2), minus 1."""
    mant = (bits32(key) >> 9) | 0x3F800000          # < 2**31: fits int32
    return mant.to(torch.int32).view(torch.float32) - 1.0
