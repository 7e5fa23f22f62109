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

Under a mesh (DTensor activations) the routing and the dispatch run
whole on every rank, as one device runs them (the capacity counts every
token of the global batch); the expert buffer is laid out by ``shard``
(``"ep"``: experts over ``model``) and the expert FFN runs on the
DTensor weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import sharding as shd
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
              capacity_factor: float = 1.25, scheme: str = "scatter",
              shard: str = "ep"):
    """x (B, S, D) -> (y (B, S, D), aux loss scalar).  ``shard`` lays
    the expert buffer out under a mesh (``"ep"``: experts over the model
    axis; ``"tp"``: left to the expert weights' split)."""
    if shd.is_dtensor(x):
        return _moe_sharded(p, x, n_experts, top_k, act, capacity_factor,
                            scheme, shard)
    if scheme == "dense":
        return _moe_dense(p, x, n_experts, top_k, act)
    b, s, d = x.shape
    n_tok = b * s
    xt = x.reshape(n_tok, d)
    gate_k, idx_k, aux = _route(p, xt, n_experts, top_k)
    cap = capacity(n_tok, top_k, n_experts, capacity_factor)
    slot = _slots(idx_k, n_experts, cap)
    ye = _expert_ffn(p, _dispatch(xt, idx_k, slot, n_experts, cap), act)
    y = _combine(ye, idx_k, slot, gate_k).reshape(b, s, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, act)
    return y, aux


def _dispatch(xt, idx_k, slot, n_experts: int, cap: int):
    """Scatter tokens into (E, C+1, D), the +1 row absorbing drops; ->
    the (E, C, D) expert buffer."""
    n_tok, top_k = idx_k.shape
    d = xt.shape[-1]
    buf = torch.zeros((n_experts, cap + 1, d), dtype=xt.dtype,
                      device=xt.device)
    tok_rep = xt[:, None, :].expand(n_tok, top_k, d)
    buf.index_put_((idx_k.reshape(-1), slot.reshape(-1)),
                   tok_rep.reshape(-1, d), accumulate=True)
    return buf[:, :cap]


def _combine(ye, idx_k, slot, gate_k):
    """(E, C, D) expert outputs -> (T, D), gate-weighted over k."""
    ye = F.pad(ye, (0, 0, 0, 1))                           # drop row = 0
    out = ye[idx_k, slot]                                  # (T, k, D)
    return torch.sum(out * gate_k[..., None].to(ye.dtype), dim=1)


def _moe_sharded(p, x, n_experts, top_k, act, capacity_factor, scheme,
                 shard):
    """:func:`moe_apply` on a DTensor ``x``: routing, dispatch and combine
    on the whole batch on every rank (plain tensors, the same on each);
    the expert FFN on the DTensor weights, its buffer laid out by
    ``shard``."""
    b, s, d = x.shape
    xt = shd.whole(x).reshape(b * s, d)
    gate_k, idx_k, aux = _route({"router": shd.whole(p["router"])}, xt,
                                n_experts, top_k)
    if scheme == "dense":
        buf = xt.expand(n_experts, *xt.shape)
    else:
        cap = capacity(b * s, top_k, n_experts, capacity_factor)
        slot = _slots(idx_k, n_experts, cap)
        buf = _dispatch(xt, idx_k, slot, n_experts, cap)
    # EP: expert buffers live on their expert's shard
    buf = shd.constrain(shd.replicated_like(buf, x),
                        "tp" if shard == "ep" else None, None, None)
    ye = shd.whole(_expert_ffn(p, buf, act))
    yt = (_dense_combine(ye, idx_k, gate_k) if scheme == "dense"
          else _combine(ye, idx_k, slot, gate_k))
    # back in x's layout; a partial sum in x (decode's residual stream
    # after a row-parallel product) is whole in y, so replicated there
    from torch.distributed.tensor import Partial, Replicate
    y = shd.replicated_like(yt.reshape(b, s, d), x).redistribute(
        x.device_mesh, [Replicate() if isinstance(pl, Partial) else pl
                        for pl in x.placements])
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, act)
    return y, shd.replicated_like(aux, x)


def _moe_dense(p, x, n_experts, top_k, act):
    """Oracle: every expert computes every token; combine with gates."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gate_k, idx_k, aux = _route(p, xt, n_experts, top_k)
    ye = _expert_ffn(p, xt.expand(n_experts, *xt.shape), act)
    y = _dense_combine(ye, idx_k, gate_k).reshape(b, s, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, act)
    return y, aux


def _dense_combine(ye, idx_k, gate_k):
    """(E, T, D) outputs of every expert for every token -> (T, D), each
    token's top-k gate-weighted."""
    w = torch.zeros((ye.shape[1], ye.shape[0]), dtype=torch.float32,
                    device=ye.device)
    w.scatter_(1, idx_k, gate_k)                           # (T, E)
    return torch.einsum("te,etd->td", w.to(ye.dtype), ye)
