"""grok-1-314b [moe] — 8 experts top-2, every layer [hf:xai-org/grok-1].

8 experts don't divide the 16-way model axis -> expert weights are
TP-sharded on d_ff over `model` (moe_shard="tp"), experts replicated on
that axis (DESIGN.md §5).
"""
from ..lm.config import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv=8, head_dim=128, d_ff=32768, vocab=131072,
    act="swiglu", norm="rms", moe_experts=8, moe_top_k=2, moe_every=1,
    moe_d_ff=32768, moe_shard="tp")

REDUCED = ArchConfig(
    name="grok-1-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv=2, head_dim=32, d_ff=256, vocab=512, act="swiglu",
    norm="rms", moe_experts=4, moe_top_k=2, moe_every=1, moe_d_ff=256,
    moe_shard="tp")
