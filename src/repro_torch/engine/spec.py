"""Model specifications — static, hashable descriptions of a PCN (the
port's copy of ``repro.engine.spec``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BlockSpec:
    """One building block (SA or EdgeConv) of a PCN."""
    n_centers: int
    k: int
    mlp_dims: tuple            # hidden+out dims, input inferred
    radius: float = 0.2
    kind: str = "sa"           # sa | edge
    sampler: str = "fps"
    neighbor: str = "pointacc"


@dataclass(frozen=True)
class PCNSpec:
    """A whole point-cloud network."""
    name: str
    blocks: tuple              # tuple[BlockSpec]
    head_dims: tuple           # classifier / per-point head
    n_classes: int
    in_feats: int = 3          # input feature dim (xyz counts as features)
    task: str = "cls"          # cls | seg
    global_mlp: tuple = ()     # final global SA mlp (cls only)
    activation: str = "per_layer"   # per_layer | block_end


def block_in_dim(kind: str, f_prev: int) -> int:
    return (3 + f_prev) if kind == "sa" else (2 * f_prev)


def arch_of(spec: PCNSpec) -> str:
    """Architecture family of a spec (the leading token of its name)."""
    return spec.name.split("_")[0]
