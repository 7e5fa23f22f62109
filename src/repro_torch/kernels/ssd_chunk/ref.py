"""Plain PyTorch version of the ssd_chunk kernel."""
from __future__ import annotations

import torch


def ssd_chunk_ref(x, B, C, dt, cum):
    """x (bs, nc, q, H, P); B, C (bs, nc, q, S); dt, cum (bs, nc, q, H) ->
    (y_in (bs, nc, q, H, P), states (bs, nc, H, P, S)), float32.

    Step by step, so that no (…, q, q, H, P) intermediate is formed:
    CB = C·Bᵀ; L = exp(cum_i − cum_j) where i >= j, else 0 (the exponential
    is taken only there: above the diagonal it can overflow); M = CB ⊙ L ⊙
    dt_j; y_in = M·x per head; states = (x ⊙ exp(cum_end − cum)·dt)ᵀ·B."""
    q = x.shape[2]
    cb = C @ B.transpose(-1, -2)                          # (bs, nc, i, j)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (bs, nc, i, j, H)
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    tril = tril[:, :, None]
    L = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
    M = cb[..., None] * L * dt[:, :, None, :, :]
    y_in = torch.einsum("bnijh,bnjhp->bnihp", M, x)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt           # (bs, nc, j, H)
    states = torch.einsum("bnjhp,bnjs->bnhps", x * w[..., None], B)
    return y_in, states
