"""Result Delta Compensation (paper §IV-B1, Eq. 1).

Cached MLP results are relative to the hub center; a subset with center
c_g reuses them after adding the compensation for Δ = c_hub − c_g:
``w·(P − c_g) = w·(P − c_hub) + w·Δ``.  ``linear`` composes the linear
parts (exact when the activation comes at block end); ``mlp`` feeds the
Δ-embedding through the whole MLP (MLP(Δ) − MLP(0)).
"""
from __future__ import annotations

import torch

from .mlp import MLP, apply_mlp


def comp_matrix(mlp: MLP, kind: str, d_center: int) -> torch.Tensor:
    """(d_center, F_out) — composed linear action of a center shift Δ."""
    w0 = mlp.layers[0].w
    if kind == "sa":
        m = w0[:d_center]
    elif kind == "edge":
        m = w0[:d_center] - w0[d_center:2 * d_center]
    else:
        raise ValueError(f"unknown block kind: {kind}")
    for layer in mlp.layers[1:]:
        m = m @ layer.w
    return m


def _delta_embedding(delta: torch.Tensor, kind: str, f_in: int):
    """Embed Δ into the MLP input space (rest zero)."""
    d = delta.shape[-1]
    if kind == "sa":
        parts = [delta]
    elif kind == "edge":
        parts = [delta, -delta]
    else:
        raise ValueError(kind)
    used = d * len(parts)
    parts.append(delta.new_zeros(delta.shape[:-1] + (f_in - used,)))
    return torch.cat(parts, dim=-1)


def compensation(mlp: MLP, delta: torch.Tensor, mode: str,
                 kind: str = "sa") -> torch.Tensor:
    """delta: (..., d_center) -> (..., F_out) additive adjustment."""
    if mode == "linear":
        return delta @ comp_matrix(mlp, kind, delta.shape[-1])
    if mode == "mlp":
        x = _delta_embedding(delta, kind, mlp.f_in)
        return apply_mlp(mlp, x) - apply_mlp(mlp, torch.zeros_like(x))
    raise ValueError(f"unknown compensation mode: {mode}")
