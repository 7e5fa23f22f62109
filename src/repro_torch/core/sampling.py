"""Sampling Module — central-point selection (paper Fig. 6).

Farthest Point Sampling is the standard PCN sampler; random and
Morton-strided sampling serve the approximate-DS baselines.  Every
function takes clouds with leading batch axes.  Selection is shape-stable
under padding: a padded cloud with ``n_valid = n`` picks the same indices
as the unpadded (n, 3) prefix.
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


def random_sampling(key: torch.Tensor, n_points: int, n_samples: int,
                    n_valid=None) -> torch.Tensor:
    """Uniform draw without replacement: keys (..., 2) -> (..., n_samples)
    int64 indices, the ``n_samples`` smallest :func:`index_uniform`
    scores (a stable sort, as ``jnp.argsort``).  With ``n_valid`` (...)
    padding scores +inf, and slots past the valid count repeat the first
    pick."""
    scores = index_uniform(key, n_points)
    if n_valid is None:
        return torch.sort(scores, dim=-1, stable=True).indices[..., :n_samples]
    count = torch.as_tensor(n_valid, device=key.device)[..., None]
    scores = torch.where(torch.arange(n_points, device=key.device) < count,
                         scores, float("inf"))
    pick = torch.sort(scores, dim=-1, stable=True).indices[..., :n_samples]
    ok = torch.arange(n_samples, device=key.device) < count
    return torch.where(ok, pick, pick[..., :1])


def morton_strided_sampling(sorted_order: torch.Tensor, n_samples: int,
                            n_valid=None) -> torch.Tensor:
    """EdgePC-style sampler: ``n_samples`` evenly strided positions of the
    Morton order (..., N) -> (..., n_samples) int64.  With ``n_valid``
    (...) the stride runs over the valid prefix of a valid-first order
    (``octree.build(..., n_valid=...)``), never touching padding."""
    n = sorted_order.shape[-1]
    count = n if n_valid is None else torch.as_tensor(
        n_valid, device=sorted_order.device)[..., None]
    pos = (torch.arange(n_samples, device=sorted_order.device)
           * count) // n_samples
    pos = torch.clamp(pos, 0, n - 1).expand(sorted_order.shape[:-1]
                                            + (n_samples,))
    return torch.gather(sorted_order, -1, pos)
