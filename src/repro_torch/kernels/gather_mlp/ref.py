"""Plain PyTorch versions of the gather_mlp kernels: the product and
pool, and the linear route's split of W into TF32 halves."""
from __future__ import annotations

import torch

from ..tiling import LINEAR_DEPTH, linear_tiles, round_up

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


def tf32(x):
    """``tf32x3::to_tf32`` (``cvt.rna.tf32.f32`` for finite x): the low 13
    mantissa bits rounded off, ties away from zero, as fp32."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def linear_k_order(d_pad: int):
    """The logical k at each position of a row of W's halves: within each
    8-group, position j holds k 2 (j % 4) + j // 4 (k at position
    (k % 2)·4 + k // 2), so that wgmma's k slots t and t + 4 of a
    thread's A fragment are x's columns 2t and 2t + 1."""
    j = torch.arange(d_pad)
    return j // 8 * 8 + 2 * (j % 4) + j % 8 // 4


def split_weights_ref(w):
    """W (D, F) as the linear route's first kernel lays it out in scratch:
    (2, F_pad, D_pad), big = rna(W)ᵀ then small = rna(Wᵀ − big), K-major
    (row n holds column n of W), k permuted within each 8-group
    (:func:`linear_k_order`), zero past D and F; F_pad the F tiles times
    the columns a block (``tiling.linear_tiles``), D_pad D rounded up to
    16."""
    d, f = w.shape
    nft, n = linear_tiles(f)
    d_pad = round_up(d, LINEAR_DEPTH)
    wt = torch.zeros((nft * n, d_pad), dtype=torch.float32, device=w.device)
    wt[:f, :d] = w.t()
    wt = wt[:, linear_k_order(d_pad).to(w.device)]
    big = tf32(wt)
    return torch.stack([big, tf32(wt - big)])
