"""DGCNN [48] — EdgeConv benchmark, (c) classification / (s) segmentation.

EdgeConv: every point is a center (sampler="all"), k=20, MLP input
[f_j − f_i, f_i].  Accelerator-standard simplification (as in Mesorasi /
EdgePC): the neighbor graph is built in coordinate space for all layers
(the original paper rebuilds it in feature space; DS accelerators gather
spatially).  DGCNN(c) applies activation at block end, which makes L-PCN's
delta compensation exact (paper §VI-E).
"""
from __future__ import annotations

from .common import BlockSpec, PCNSpec

DGCNN_C = PCNSpec(
    name="dgcnn_c",
    blocks=(
        BlockSpec(1024, 20, (64,), kind="edge", sampler="all"),
        BlockSpec(1024, 20, (64,), kind="edge", sampler="all"),
        BlockSpec(1024, 20, (128,), kind="edge", sampler="all"),
        BlockSpec(1024, 20, (256,), kind="edge", sampler="all"),
    ),
    head_dims=(512, 256),
    n_classes=40,
    activation="block_end",   # -> exact delta compensation (paper §VI-E)
)

DGCNN_S = PCNSpec(
    name="dgcnn_s",
    blocks=(
        BlockSpec(8192, 20, (64,), kind="edge", sampler="all"),
        BlockSpec(8192, 20, (64,), kind="edge", sampler="all"),
        BlockSpec(8192, 20, (64,), kind="edge", sampler="all"),
    ),
    head_dims=(256, 128),
    n_classes=20,
    in_feats=6,
    task="seg",
    activation="block_end",
)


def with_points(spec: PCNSpec, n: int) -> PCNSpec:
    """Rescale an `all`-sampler spec to an n-point cloud."""
    from dataclasses import replace
    return replace(spec, blocks=tuple(
        BlockSpec(n, b.k, b.mlp_dims, b.radius, b.kind, b.sampler,
                  b.neighbor) for b in spec.blocks))
