"""Hand-written CUDA kernels, with their plain PyTorch versions.

The two FC dataflows of the PCN main path:

  gather_mlp       fused normalize → 2-layer MLP or one layer → max over K
                   (dense path)
  hub_reuse        pool MLP → compensated reuse gather → max over K (islands)

and three entry points of their own (no call site in the engine):

  knn              brute-force kNN, nearest first, ties to the lower index
  flash_attention  causal GQA attention forward, online softmax, and
                   its gradient (``flash_attention_bwd``)
  ssd_chunk        Mamba-2 SSD intra-chunk output and chunk states, and
                   its gradient (``ssd_chunk_bwd``)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built from ``csrc/`` with nvcc at first use) or
raises.  flash_attention and ssd_chunk have backward kernels: on the
card the others raise :class:`NoBackwardError` where autograd would need
their gradient.  :data:`LAUNCHES` counts the kernel launches per wrapper, and
also per route where a kernel has several (``flash_attention_wgmma``,
``flash_attention_mma``, ``flash_attention_split``, ``gather_mlp_wide``,
``hub_reuse_resident``, ``hub_reuse_layered``, ``ssd_chunk_whole``,
``ssd_chunk_tiled``, ``ssd_chunk_bwd_whole``, ``ssd_chunk_bwd_tiled``).
"""
from ._build import _LOCK, BUILD_LOG, LAUNCHES, NoBackwardError, build

NAMES = ("gather_mlp", "hub_reuse", "knn", "flash_attention",
         "flash_attention_bwd", "ssd_chunk", "ssd_chunk_bwd")


def launch_counts() -> dict:
    with _LOCK:
        return {name: LAUNCHES[name] for name in NAMES}


def reset_launch_counts() -> None:
    with _LOCK:
        LAUNCHES.clear()


def build_all() -> float:
    """Build every kernel source (one nvcc each, in parallel); seconds."""
    return build(NAMES)
