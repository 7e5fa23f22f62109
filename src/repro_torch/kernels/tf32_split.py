"""Plain PyTorch version of ``csrc/tf32_split.cuh``: W (D, F) split into
the TF32 halves that the one-layer products on ``wgmma`` take from
scratch (gather_mlp's linear route, hub_reuse's one-layer resident
route), bit for bit."""
from __future__ import annotations

import torch

DEPTH = 16                 # D_pad: D rounded up to it (tf32_split::kDepth)


def tf32(x):
    """``tf32x3::to_tf32`` (``cvt.rna.tf32.f32`` for finite x): the low 13
    mantissa bits rounded off, ties away from zero, as fp32."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def k_order(d_pad: int):
    """The logical k at each position of a row of W's halves: within each
    8-group, position j holds k 2 (j % 4) + j // 4 (k at position
    (k % 2)·4 + k // 2), so that wgmma's k slots t and t + 4 of a
    thread's A fragment are x's columns 2t and 2t + 1."""
    j = torch.arange(d_pad)
    return j // 8 * 8 + 2 * (j % 4) + j % 8 // 4


def split_weights_ref(w, f_pad: int):
    """W (D, F) as the split kernels lay it out in scratch: (2, f_pad,
    D_pad), big = rna(W)ᵀ then small = rna(Wᵀ − big), K-major (row n
    holds column n of W), k permuted within each 8-group
    (:func:`k_order`), zero past D and F; D_pad is D rounded up to
    :data:`DEPTH`, f_pad the caller's F tiles times its columns a block."""
    d, f = w.shape
    d_pad = -(-d // DEPTH) * DEPTH
    wt = torch.zeros((f_pad, d_pad), dtype=torch.float32, device=w.device)
    wt[:f, :d] = w.t()
    wt = wt[:, k_order(d_pad).to(w.device)]
    big = tf32(wt)
    return torch.stack([big, tf32(wt - big)])
