"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838]."""
from ..lm.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv=16, d_ff=8192, vocab=50304,
    act="swiglu", norm="np_ln", rope_theta=10000.0, tie_embed=True)

REDUCED = ArchConfig(
    name="olmo-1b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv=4, d_ff=256, vocab=512, act="swiglu", norm="np_ln",
    tie_embed=True)
