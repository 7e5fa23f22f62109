"""Shared point-MLP of the FC step (the paper's systolic-array workload).

Two activation placements (paper §VI-E):
  * ``per_layer`` — ReLU after every layer but the last (PointNet++
    default); delta compensation is approximate.
  * ``block_end`` — all layers linear, one activation applied *after*
    pooling (DGCNN(c) / PointVector-L style); compensation is exact.

Weights keep the ``(in, out)`` layout of the JAX package, so ``x @ w + b``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Dense:
    w: torch.Tensor            # (in, out)
    b: torch.Tensor            # (out,)


@dataclass
class MLP:
    layers: list               # [Dense]
    activation: str = "per_layer"   # per_layer | block_end

    @property
    def f_in(self) -> int:
        return self.layers[0].w.shape[0]

    @property
    def f_out(self) -> int:
        return self.layers[-1].w.shape[1]


def init_mlp(dims, activation: str = "per_layer", *,
             generator: torch.Generator, device=None,
             dtype=torch.float32) -> MLP:
    """He-normal weights, zero biases, drawn from ``generator``."""
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator, dtype=dtype) \
            * (2.0 / a) ** 0.5
        layers.append(Dense(w=w.to(device), b=torch.zeros(b, dtype=dtype,
                                                          device=device)))
    return MLP(layers=layers, activation=activation)


def apply_mlp(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """x: (..., f_in) -> (..., f_out)."""
    n = len(mlp.layers)
    for i, layer in enumerate(mlp.layers):
        x = x @ layer.w + layer.b
        if mlp.activation == "per_layer" and i < n - 1:
            x = torch.relu(x)
    return x


def post_pool_activation(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x) if mlp.activation == "block_end" else x
