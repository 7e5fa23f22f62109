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


def ssd_chunk_bwd_ref(x, B, C, dt, cum, dy, dst):
    """The gradient of :func:`ssd_chunk_ref`: its inputs and the outputs'
    gradients dy (bs, nc, q, H, P) and dst (bs, nc, H, P, S) -> (dx, dB,
    dC, ddt, dcum), float32, in the inputs' shapes.

    The closed form, step by step, so that no (…, q, q, H, P) intermediate
    is formed and the exponential is taken only where i >= j.  Per chunk
    and head, with L = tril(exp(cum_i − cum_j)), M = CB ⊙ L ⊙ dt_j,
    w_end = exp(cum_end − cum), w = w_end ⊙ dt and E = B·dstᵀ (q, P):
    dM = tril(dy·xᵀ), G = dM ⊙ M, u_j = Σ_p x_jp E_jp;
    dx = Mᵀ·dy + w ⊙ E; dCB = Σ_h dM ⊙ L ⊙ dt_j, dC = dCB·B,
    dB = dCBᵀ·C + Σ_h (x ⊙ w)·dst; ddt_j = Σ_i (dM ⊙ CB ⊙ L)_ij + u_j
    w_end_j; dcum_i = Σ_j G_ij − Σ_k G_ki − u_i w_i (G_ii cancels), and
    the last row also gains Σ_j u_j w_j (cum_end's share of w)."""
    q = x.shape[2]
    cb = C @ B.transpose(-1, -2)                          # (bs, nc, i, j)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (bs, nc, i, j, H)
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    tril = tril[:, :, None]
    L = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
    dM = torch.where(tril, torch.einsum("bnihp,bnjhp->bnijh", dy, x), 0.0)
    cbL = cb[..., None] * L
    M = cbL * dt[:, :, None, :, :]
    E = torch.einsum("bnjs,bnhps->bnjhp", B, dst)         # (bs, nc, j, H, P)
    w_end = torch.exp(cum[:, :, -1:, :] - cum)            # (bs, nc, j, H)
    w = w_end * dt
    dx = torch.einsum("bnijh,bnihp->bnjhp", M, dy) + w[..., None] * E
    u = (x * E).sum(-1)                                   # (bs, nc, j, H)
    dML = dM * L
    dCB = (dML * dt[:, :, None, :, :]).sum(-1)            # (bs, nc, i, j)
    dC = dCB @ B
    dB = (dCB.transpose(-1, -2) @ C
          + torch.einsum("bnjhp,bnhps->bnjs", x * w[..., None], dst))
    ddt = (dM * cbL).sum(2) + u * w_end
    # G's diagonal enters both sums and cancels: left out, so that no
    # large G_ii rounds away a small dcum
    below = torch.ones((q, q), dtype=torch.bool, device=x.device).tril(-1)
    G = torch.where(below[:, :, None], dM * M, 0.0)
    uw = u * w
    dcum = G.sum(3) - G.sum(2) - uw
    dcum[:, :, -1, :] += uw.sum(2)
    return dx, dB, dC, ddt, dcum
