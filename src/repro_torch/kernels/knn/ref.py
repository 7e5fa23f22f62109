"""Plain PyTorch version of the knn kernel."""
from __future__ import annotations

import torch


def knn_ref(centers, points, k: int):
    """(S,3) centers, (N,3) points -> ((S,k) float32 squared distances,
    (S,k) int32 indices), nearest first, ties to the lower index.

    Distances are the expanded form ``(|c|² + |p|²) − 2·c·p`` in float32,
    as the kernel computes them; the order is a stable sort of them, so
    lexicographic in (distance, index)."""
    c, p = centers.float(), points.float()
    d = ((c * c).sum(-1, keepdim=True) + (p * p).sum(-1)) - 2.0 * (c @ p.T)
    dk, idx = torch.sort(d, dim=-1, stable=True)
    return dk[:, :k].contiguous(), idx[:, :k].to(torch.int32)
