"""Mixture-of-Experts: top-k routing, capacity-bounded scatter dispatch
(the port of ``repro.nn.moe``).

Dispatch schemes:
  * ``scatter`` (default) — tokens are scatter-added into per-expert
    capacity buffers (E, C+1, D), the last row taking the tokens past an
    expert's capacity, and gathered back with gate weights.
  * ``dense`` — every expert computes every token, mask-combined.  The
    routing oracle.

Routing is the JAX package's to the index: top-k breaks ties toward the
lower expert (a stable descending sort, as ``jax.lax.top_k``), and a
token's slot in its expert's queue is its first-come rank over the
flattened (T·k) order.

Aux: load-balance loss (Switch-style: E · Σ_e f_e · p_e).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import gelu, lecun, mlp_apply, mlp_params, normal


def moe_params(gen, d: int, f: int, n_experts: int, act: str, dtype,
               device, shared: bool = False) -> dict:
    p = {
        "router": lecun(gen, (d, n_experts), dtype, device),
        "w_in": normal(gen, (n_experts, d, f), (1.0 / d) ** 0.5, dtype,
                       device),
        "w_out": normal(gen, (n_experts, f, d), (1.0 / f) ** 0.5, dtype,
                        device),
    }
    if act in ("swiglu", "geglu"):
        p["w_gate"] = normal(gen, (n_experts, d, f), (1.0 / d) ** 0.5,
                             dtype, device)
    if shared:
        p["shared"] = mlp_params(gen, d, f, act, dtype, device)
    return p


def _expert_ffn(p, x, act):
    """x (E, C, D) -> (E, C, D), per-expert gated FFN."""
    if "w_gate" in p:
        pre = torch.bmm(x, p["w_gate"])
        g = F.silu(pre) if act == "swiglu" else gelu(pre)
        h = g * torch.bmm(x, p["w_in"])
    else:
        h = gelu(torch.bmm(x, p["w_in"]))
    return torch.bmm(h, p["w_out"])


def _route(p, xt, n_experts, top_k):
    """xt (T, D) -> (gate_k (T, k) f32, idx_k (T, k) int64, aux)."""
    logits = (xt @ p["router"]).float()                    # (T, E)
    gates = torch.softmax(logits, dim=-1)
    gate_k, idx_k = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_k[:, :top_k], idx_k[:, :top_k]
    gate_k = gate_k / torch.clamp_min(gate_k.sum(-1, keepdim=True), 1e-9)
    # Switch aux loss: fraction routed vs. mean gate, per expert
    f_e = torch.mean(F.one_hot(idx_k[:, 0], n_experts).float(), dim=0)
    p_e = torch.mean(gates, dim=0)
    aux = n_experts * torch.sum(f_e * p_e)
    return gate_k, idx_k, aux


def capacity(n_tok: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    return max(int(n_tok * top_k / n_experts * capacity_factor), 4)


def _slots(idx_k, n_experts: int, cap: int):
    """(T, k) expert indices -> (T, k) slots: each (token, k) pair's
    first-come rank in its expert's queue over the flattened (T·k) order,
    ``cap`` (the drop row) where the rank reaches the capacity."""
    flat = idx_k.reshape(-1)
    onehot = F.one_hot(flat, n_experts)
    pos = torch.cumsum(onehot, dim=0) - 1                  # (T*k, E)
    pos = torch.gather(pos, 1, flat[:, None]).reshape(idx_k.shape)
    return torch.where(pos < cap, pos, cap)


def moe_apply(p, x, n_experts: int, top_k: int, act: str,
              capacity_factor: float = 1.25, scheme: str = "scatter"):
    """x (B, S, D) -> (y (B, S, D), aux loss scalar).  (The JAX package's
    ``shard`` argument places expert buffers on a mesh; one device has
    none.)"""
    if scheme == "dense":
        return _moe_dense(p, x, n_experts, top_k, act)
    b, s, d = x.shape
    n_tok = b * s
    xt = x.reshape(n_tok, d)
    gate_k, idx_k, aux = _route(p, xt, n_experts, top_k)
    cap = capacity(n_tok, top_k, n_experts, capacity_factor)
    slot = _slots(idx_k, n_experts, cap)

    # scatter-dispatch into (E, C+1, D); the +1 row absorbs drops
    buf = torch.zeros((n_experts, cap + 1, d), dtype=x.dtype,
                      device=x.device)
    tok_rep = xt[:, None, :].expand(n_tok, top_k, d)
    buf.index_put_((idx_k.reshape(-1), slot.reshape(-1)),
                   tok_rep.reshape(-1, d), accumulate=True)
    ye = _expert_ffn(p, buf[:, :cap], act)                 # (E, C, D)
    ye = F.pad(ye, (0, 0, 0, 1))                           # drop row = 0
    out = ye[idx_k, slot]                                  # (T, k, D)
    yt = torch.sum(out * gate_k[..., None].to(x.dtype), dim=1)
    y = yt.reshape(b, s, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, act)
    return y, aux


def _moe_dense(p, x, n_experts, top_k, act):
    """Oracle: every expert computes every token; combine with gates."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gate_k, idx_k, aux = _route(p, xt, n_experts, top_k)
    w = torch.zeros((xt.shape[0], n_experts), dtype=torch.float32,
                    device=x.device)
    w.scatter_(1, idx_k, gate_k)                           # (T, E)
    ye = _expert_ffn(p, xt.expand(n_experts, *xt.shape), act)
    yt = torch.einsum("te,etd->td", w.to(xt.dtype), ye)
    y = yt.reshape(b, s, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, act)
    return y, aux
