"""PointNet++ [39] — the paper's primary benchmark (3 task variants).

(c)  classification, ModelNet40, 1024 pts:  SA(512,32) SA(128,64) + global
(ps) part segmentation, ShapeNet, 2048 pts: SA stack + FP decoder
(s)  semantic segmentation, S3DIS, 4096 pts
"""
from __future__ import annotations

from ..engine.spec import BlockSpec, PCNSpec

POINTNET2_C = PCNSpec(
    name="pointnet2_c",
    blocks=(
        BlockSpec(512, 32, (64, 64, 128), radius=0.2),
        BlockSpec(128, 64, (128, 128, 256), radius=0.4),
    ),
    global_mlp=(256, 512, 1024),
    head_dims=(512, 256),
    n_classes=40,
)

POINTNET2_PS = PCNSpec(
    name="pointnet2_ps",
    blocks=(
        BlockSpec(512, 32, (64, 64, 128), radius=0.2),
        BlockSpec(128, 64, (128, 128, 256), radius=0.4),
    ),
    head_dims=(256, 128),
    n_classes=50,
    task="seg",
)

POINTNET2_S = PCNSpec(
    name="pointnet2_s",
    blocks=(
        BlockSpec(1024, 32, (32, 32, 64), radius=0.1),
        BlockSpec(256, 32, (64, 64, 128), radius=0.2),
        BlockSpec(64, 32, (128, 128, 256), radius=0.4),
    ),
    head_dims=(256, 128),
    n_classes=13,
    in_feats=6,
    task="seg",
)
