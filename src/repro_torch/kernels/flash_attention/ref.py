"""Plain PyTorch version of the flash_attention kernel."""
from __future__ import annotations

import math

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


def attention_lse_ref(q, k, causal: bool = True):
    """What the forward kernel stores beside its output for the backward:
    q (B, Hq, Sq, D), k (B, Hkv, Skv, D) -> float32 (B, Hq, Sq), each
    row's log-sum-exp of q·kᵀ/sqrt(D) over its visible keys (``causal``:
    top-left, as :func:`attention_ref`), in base 2: log2(e) times the
    natural one."""
    d, group = q.shape[-1], q.shape[1] // k.shape[1]
    kx = k.float().repeat_interleave(group, dim=1)
    s = (q.float() @ kx.transpose(-1, -2)) / d ** 0.5
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.logsumexp(s, dim=-1) * math.log2(math.e)


def attention_bwd_ref(q, k, v, o, do, causal: bool = True):
    """The gradient of :func:`attention_ref`, written out: -> (dq, dk, dv)
    in the inputs' dtypes.  P is recomputed from q and k, D_i =
    rowsum(dO_i ∘ O_i) is taken from the forward's output ``o``, dS =
    P ∘ (dO·vᵀ − D), and each kv head sums dk and dv over its group of
    query heads; every product in float32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    qf, dof = q.float(), do.float()
    kx = k.float().repeat_interleave(group, dim=1)
    vx = v.float().repeat_interleave(group, dim=1)
    s = (qf @ kx.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones((sq, skv), dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1)
    dp = dof @ vx.transpose(-1, -2)
    dsum = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - dsum)
    dq = (ds @ kx) * scale
    dk = ((ds.transpose(-1, -2) @ qf) * scale).reshape(
        b, hkv, group, skv, d).sum(2)
    dv = (p.transpose(-1, -2) @ dof).reshape(b, hkv, group, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
