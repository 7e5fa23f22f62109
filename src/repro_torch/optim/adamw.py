"""AdamW with a configurable state dtype (the port of
``repro.optim.adamw``).

``state_dtype="bfloat16"`` halves the optimizer's memory; the update math
is always float32.  Params, m and v are updated in place under
``torch.no_grad()`` (the JAX package donates them to the jitted step).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import tree
from ..dist.sharding import is_dtensor, whole


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "bfloat16"    # m/v storage dtype


def init_state(cfg: AdamWConfig, params) -> dict:
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree.leaves(params)[0].device
    return {"m": tree.map(zeros, params), "v": tree.map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """-> (params, state), both updated in place: f32 math, m and v stored
    in their own dtype, params in theirs; decay only on leaves of ndim >=
    2; entries of ``state`` beside m, v and step (the compressor's
    ``"ef"``) are kept.  DTensor leaves update their local shards: a
    param, its grad, m and v share their placements (``lm.steps`` pins
    the grads), and the update is elementwise."""
    state["step"] += 1
    step = whole(state["step"]).float()
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, step)
    c2 = 1.0 - torch.pow(b2, step)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)
    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(state["m"]), tree.leaves(state["v"])):
        if is_dtensor(p):
            if not all(t.placements == p.placements for t in (g, m, v)):
                raise ValueError("adamw: a param, its grad, m and v must "
                                 "share their placements")
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        step_dir = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:   # no decay on norms/biases
            step_dir = step_dir + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step_dir)
        m.copy_(m32)
        v.copy_(v32)
    return params, state
