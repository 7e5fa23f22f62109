"""Loss functions (the port of ``repro.lm.losses``)."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits (..., V) any float dtype, labels (...) int -> scalar mean
    NLL over unmasked positions.  Stable: f32 max-sub logsumexp."""
    lg = logits.float()
    m = torch.amax(lg, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(lg - m), dim=-1))
    picked = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
