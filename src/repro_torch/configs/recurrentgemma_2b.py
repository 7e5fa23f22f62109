"""recurrentgemma-2b [hybrid] — RG-LRU + local attn 1:2 [arXiv:2402.19427]."""
from ..lm.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv=1, head_dim=256, d_ff=7680, vocab=256000,
    act="geglu", norm="rms", tie_embed=True, embed_scale=True,
    mixer_pattern=("rglru", "rglru", "local"), local_window=2048,
    d_rnn=2560)

REDUCED = ArchConfig(
    name="recurrentgemma-2b-smoke", family="hybrid", n_layers=3,
    d_model=128, n_heads=4, n_kv=1, head_dim=32, d_ff=256, vocab=512,
    act="geglu", norm="rms", tie_embed=True, embed_scale=True,
    mixer_pattern=("rglru", "rglru", "local"), local_window=32, d_rnn=128)
