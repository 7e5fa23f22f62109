"""PointNeXt [40] — scalability-oriented PointNet++ variant (paper §VI-D).

PointNeXt-S: Stem MLP (per-point feature expansion — the paper's example of
an unoptimizable no-overlap layer, ~0.1% of FLOPs) followed by SA stages
with InvResMLP residual blocks.  Radii double per stage; every SA gather
routes through the Islandization Unit.
"""
from __future__ import annotations

from .common import BlockSpec, PCNSpec

POINTNEXT_S = PCNSpec(
    name="pointnext_s",
    blocks=(
        BlockSpec(2048, 32, (64,), radius=0.1),
        BlockSpec(512, 32, (128,), radius=0.2),
        BlockSpec(128, 32, (256,), radius=0.4),
        BlockSpec(32, 32, (512,), radius=0.8),
    ),
    head_dims=(256, 128),
    n_classes=13,
    in_feats=6,
    task="seg",
    global_mlp=(),
)

STEM_DIM = 32
