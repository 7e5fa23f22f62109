"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from ..lm.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv=10, head_dim=128, d_ff=17920, vocab=100352,
    act="swiglu", norm="rms", rope_theta=10000.0)

REDUCED = ArchConfig(
    name="phi3-medium-14b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv=1, head_dim=32, d_ff=256, vocab=512,
    act="swiglu", norm="rms")
