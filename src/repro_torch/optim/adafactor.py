"""Adafactor (factored second moment), the port of
``repro.optim.adafactor``: O(n + m) state per (n, m) matrix instead of
O(n·m).  Params and state update in place under ``torch.no_grad()``."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import tree


@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip: float = 1.0


def init_state(cfg: AdafactorConfig, params) -> dict:
    def st(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    device = tree.leaves(params)[0].device
    return {"f": tree.map(st, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def apply_updates(cfg: AdafactorConfig, params, grads, state,
                  lr_scale=1.0):
    """-> (params, state), both updated in place."""
    state["step"] += 1
    beta = 1.0 - (state["step"].float() + 1.0) ** (-cfg.decay)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)
    for p, g, s in zip(tree.leaves(params), tree.leaves(grads),
                       tree.flatten_up_to(params, state["f"])):
        g32 = g.float()
        g2 = g32 * g32 + cfg.eps
        if p.dim() >= 2:
            vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(vr.mean(-1, keepdim=True)[..., None],
                                       cfg.eps))
            u = g32 / torch.sqrt(denom + cfg.eps)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g32 / torch.sqrt(v + cfg.eps)
            s["v"].copy_(v)
        rms = torch.sqrt(torch.mean(u * u) + cfg.eps)
        u = u / torch.clamp_min(rms / cfg.clip, 1.0)
        p.copy_(p.float() - lr * u)
    return params, state
