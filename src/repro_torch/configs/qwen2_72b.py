"""qwen2-72b [dense] — GQA kv=8, QKV bias [arXiv:2407.10671]."""
from ..lm.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv=8, head_dim=128, d_ff=29568, vocab=152064,
    act="swiglu", norm="rms", qkv_bias=True, rope_theta=1e6)

REDUCED = ArchConfig(
    name="qwen2-72b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=8, n_kv=2, head_dim=16, d_ff=256, vocab=512,
    act="swiglu", norm="rms", qkv_bias=True)
