"""Neighbor Search Module — the accurate brute-force kNN (PointACC's
ranking), the ``"pointacc"`` neighbor of the registry.

Ragged contract: with ``n_valid`` a padding row is never returned; slots
that cannot be filled with a valid point are ``-1``.
"""
from __future__ import annotations

import torch

from .sampling import sqdist


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., S, 3), (..., N, 3) -> (..., S, N) squared distances."""
    return sqdist(a[..., :, None, :], b[..., None, :, :])


def masked_sqdist(centers: torch.Tensor, points: torch.Tensor,
                  n_valid=None) -> torch.Tensor:
    """(..., S, N) squared distances, padding columns pinned to +inf."""
    d = pairwise_sqdist(centers, points)
    if n_valid is None:
        return d
    col_ok = (torch.arange(points.shape[-2], device=points.device)
              < torch.as_tensor(n_valid, device=points.device)[..., None])
    return torch.where(col_ok[..., None, :], d, float("inf"))


def knn_bruteforce(points: torch.Tensor, centers: torch.Tensor, k: int,
                   n_valid=None) -> torch.Tensor:
    """(..., S, k) int64 indices into ``points``, nearest first, ties to
    the lower index (a stable sort, like ``lax.top_k``); ``-1`` beyond the
    valid count."""
    d = masked_sqdist(centers, points, n_valid)
    dk, idx = torch.sort(d, dim=-1, stable=True)
    dk, idx = dk[..., :k], idx[..., :k]
    if n_valid is not None:
        idx = torch.where(torch.isfinite(dk), idx, -1)
    return idx
