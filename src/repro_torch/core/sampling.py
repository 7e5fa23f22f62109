"""Sampling Module — central-point selection (paper Fig. 6).

Every function takes clouds with leading batch axes.  Selection is
shape-stable under padding: a padded cloud with ``n_valid = n`` picks the
same indices as the unpadded (n, 3) prefix.
"""
from __future__ import annotations

import torch

from .. import random


def index_uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 2) keys -> (..., n) uniform scores where score i depends only
    on ``(key, i)`` (``fold_in`` per index), so masked selection over a
    padded array matches the unpadded prefix bit for bit."""
    idx = torch.arange(n, device=key.device)
    return random.uniform(random.fold_in(key[..., None, :], idx))


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance over the last axis, summed x, y, z in order (the
    JAX package's ``jnp.sum(d ** 2, -1)``)."""
    d = a - b
    d = d * d
    return d[..., 0] + d[..., 1] + d[..., 2]


def farthest_point_sampling(points: torch.Tensor, n_samples: int,
                            start: int = 0,
                            valid: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """FPS over (..., N, 3) -> (..., n_samples) int64 indices.

    ``valid`` (..., N) pins padding distances at -inf so they are never
    picked; with more samples than valid points the argmax saturates and
    valid indices repeat.  ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    lead = points.shape[:-2]
    min_d = torch.full(points.shape[:-1], float("inf"), dtype=points.dtype,
                       device=points.device)
    if valid is not None:
        min_d = torch.where(valid, min_d, float("-inf"))
    idx = torch.empty(lead + (n_samples,), dtype=torch.int64,
                      device=points.device)
    idx[..., 0] = start
    last = idx[..., 0:1]
    for i in range(1, n_samples):
        p = torch.gather(points, -2, last[..., None].expand(
            lead + (1, 3)))                                    # (..., 1, 3)
        min_d = torch.minimum(min_d, sqdist(points, p))
        last = torch.argmax(min_d, dim=-1, keepdim=True)
        idx[..., i:i + 1] = last
    return idx
