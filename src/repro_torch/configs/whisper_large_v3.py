"""whisper-large-v3 [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356].

32 encoder + 32 decoder layers (the spec's "32L" is per stack, matching
the released model).  input_specs provides (B, 1500, D) precomputed frame
embeddings (mel+conv frontend stubbed per assignment).
"""
from ..lm.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv=20, head_dim=64, d_ff=5120, vocab=51866,
    act="gelu", norm="ln", qkv_bias=True, tie_embed=True,
    enc_layers=32, enc_seq=1500)

REDUCED = ArchConfig(
    name="whisper-large-v3-smoke", family="audio", n_layers=2,
    d_model=128, n_heads=4, n_kv=4, head_dim=32, d_ff=256, vocab=512,
    act="gelu", norm="ln", qkv_bias=True, tie_embed=True,
    enc_layers=2, enc_seq=64)
