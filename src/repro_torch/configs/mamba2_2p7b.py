"""mamba2-2.7b [ssm] — SSD, attention-free [arXiv:2405.21060]."""
from ..lm.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=1, n_kv=1, d_ff=0, vocab=50280, norm="rms", tie_embed=True,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_headdim=64, ssd_chunk=64)

REDUCED = ArchConfig(
    name="mamba2-2.7b-smoke", family="ssm", n_layers=2, d_model=128,
    n_heads=1, n_kv=1, d_ff=0, vocab=512, norm="rms", tie_embed=True,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_headdim=32, ssd_chunk=32)
