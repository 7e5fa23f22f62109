"""PointVector [12] — vector-representation PointNet++ variant (§VI-D).

PointVector-L aggregates neighbor features through a *vector-attention*
style linear combination before pooling.  Crucially for L-PCN, the variant
evaluated in the paper applies its activation at the END of each building
block (paper §VI-E), so cached pre-activation results are compensated
exactly: CONV(A−B) = CONV(A) − CONV(B).
"""
from __future__ import annotations

from .common import BlockSpec, PCNSpec

POINTVECTOR_L = PCNSpec(
    name="pointvector_l",
    blocks=(
        BlockSpec(2048, 32, (96,), radius=0.1),
        BlockSpec(512, 32, (192,), radius=0.2),
        BlockSpec(128, 32, (384,), radius=0.4),
        BlockSpec(32, 32, (768,), radius=0.8),
    ),
    head_dims=(256, 128),
    n_classes=13,
    in_feats=6,
    task="seg",
    activation="block_end",   # -> exact delta compensation (paper §VI-E)
)
