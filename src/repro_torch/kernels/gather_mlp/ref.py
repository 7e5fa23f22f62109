"""Plain PyTorch version of the gather_mlp kernel."""
from __future__ import annotations

import torch

BIG = 3.4e38


def gather_mlp_ref(raw, centers, w1, b1, w2=None, b2=None, mask=None):
    """raw (…, S, K, D), centers (…, S, Dc) subtracted from the leading Dc
    lanes; relu(x·W1 + b1)·W2 + b2, or x·W1 + b1 where ``w2`` and ``b2``
    are None (one layer); max over K.  -> (…, S, F).  ``mask`` (…, S, K)
    marks live positions (None = all); a row with none live is zero."""
    dc = centers.shape[-1]
    x = torch.cat([raw[..., :dc] - centers[..., None, :], raw[..., dc:]],
                  dim=-1)
    y = x @ w1 + b1
    if w2 is not None:
        y = torch.relu(y) @ w2 + b2
    if mask is None:
        return y.amax(-2)
    live = mask != 0
    pooled = torch.where(live[..., None], y, -BIG).amax(-2)
    return torch.where(live.any(-1)[..., None], pooled, 0.0)
