"""Plain PyTorch version of the flash_attention kernel."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, causal: bool = True):
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype.  Query head h reads kv head h // (Hq / Hkv); scores and softmax
    in float32; ``causal`` keeps key j for query i where i >= j (top-left,
    the kernel's mask)."""
    d, group = q.shape[-1], q.shape[1] // k.shape[1]
    kx = k.float().repeat_interleave(group, dim=1)
    vx = v.float().repeat_interleave(group, dim=1)
    s = (q.float() @ kx.transpose(-1, -2)) / d ** 0.5
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    return (torch.softmax(s, dim=-1) @ vx).to(q.dtype)
