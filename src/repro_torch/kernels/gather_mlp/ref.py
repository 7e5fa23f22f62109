"""Plain PyTorch versions of the gather_mlp kernels: the product and
pool, and the linear route's split of W into TF32 halves (the split
hub_reuse's one-layer resident route shares, ``kernels.tf32_split``)."""
from __future__ import annotations

import torch

from ..tf32_split import k_order as linear_k_order  # noqa: F401
from ..tf32_split import split_weights_ref as _split
from ..tf32_split import tf32  # noqa: F401
from ..tiling import linear_tiles

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


def split_weights_ref(w):
    """W (D, F) as the linear route's first kernel lays it out in scratch
    (``tf32_split.split_weights_ref``): (2, F_pad, D_pad), F_pad the F
    tiles times the columns a block (``tiling.linear_tiles``), D_pad D
    rounded up to 16."""
    nft, n = linear_tiles(w.shape[1])
    return _split(w, nft * n)
