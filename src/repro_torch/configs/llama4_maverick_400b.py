"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + shared
expert, MoE every 2nd layer (DESIGN.md §4 config-interpretation note:
all-MoE at d_ff=8192 would be ~774B; interleave-2 + shared matches the
released Maverick at ~398B total / ~17B active).
"""
from ..lm.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv=8, head_dim=128, d_ff=8192,
    vocab=202048, act="swiglu", norm="rms", rope_theta=500000.0,
    moe_experts=128, moe_top_k=1, moe_every=2, moe_shared=True,
    moe_d_ff=8192, moe_shard="ep")

REDUCED = ArchConfig(
    name="llama4-maverick-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv=2, head_dim=32, d_ff=256, vocab=512, act="swiglu",
    norm="rms", moe_experts=8, moe_top_k=1, moe_every=2, moe_shared=True,
    moe_d_ff=256, moe_scheme="scatter")
