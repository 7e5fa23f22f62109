"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295]."""
from ..lm.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense", n_layers=28, d_model=3072,
    n_heads=16, n_kv=16, head_dim=256, d_ff=24576, vocab=256000,
    act="geglu", norm="rms", rope_theta=10000.0, tie_embed=True,
    embed_scale=True)

REDUCED = ArchConfig(
    name="gemma-7b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv=4, head_dim=64, d_ff=384, vocab=512,
    act="geglu", norm="rms", tie_embed=True, embed_scale=True)
