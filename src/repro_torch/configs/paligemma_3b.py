"""paligemma-3b [vlm] — SigLIP (stub) + gemma-2b decoder [arXiv:2407.07726].

The SigLIP patch embedder is STUBBED per assignment: input_specs provides
(B, 256, D) precomputed patch embeddings as the bidirectional prefix.
"""
from ..lm.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
    n_heads=8, n_kv=1, head_dim=256, d_ff=16384, vocab=257216,
    act="geglu", norm="rms", tie_embed=True, embed_scale=True,
    prefix_tokens=256)

REDUCED = ArchConfig(
    name="paligemma-3b-smoke", family="vlm", n_layers=2, d_model=128,
    n_heads=4, n_kv=1, head_dim=32, d_ff=256, vocab=512,
    act="geglu", norm="rms", tie_embed=True, embed_scale=True,
    prefix_tokens=16)
