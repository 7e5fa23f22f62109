"""Plain PyTorch version of the hub_reuse kernel."""
from __future__ import annotations

import torch

BIG = 3.4e38


def hub_reuse_ref(pool_in, slot, comp, w1, b1, w2=None, b2=None, live=None):
    """pool_in (…, H, C, D), slot (…, H, M, K) (-1 = not cached), comp
    (…, H, M, F) -> (…, H, M, F): pool MLP, relu(pool_in·w1 + b1)·w2 +
    b2, or pool_in·w1 + b1 where ``w2`` and ``b2`` are None (one layer);
    y[slot] + comp, max over the live slots (``slot >= 0`` and ``live``);
    ``-BIG`` where none is."""
    y = pool_in @ w1 + b1                                  # (…, H, C, F)
    if w2 is not None:
        y = torch.relu(y) @ w2 + b2
    c, f = y.shape[-2:]
    m, k = slot.shape[-2:]
    safe = torch.clamp(slot, 0, c - 1).long().reshape(
        slot.shape[:-2] + (m * k,))
    g = torch.gather(y, -2, safe[..., None].expand(safe.shape + (f,)))
    g = g.reshape(slot.shape + (f,)) + comp[..., None, :]
    ok = slot >= 0 if live is None else (slot >= 0) & (live != 0)
    return torch.where(ok[..., None], g, -BIG).amax(-2)
