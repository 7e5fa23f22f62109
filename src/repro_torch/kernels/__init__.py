"""Hand-written CUDA kernels, with their plain PyTorch versions.

The two FC dataflows of the PCN main path:

  gather_mlp       fused normalize → 2-layer MLP → max over K (dense path)
  hub_reuse        pool MLP → compensated reuse gather → max over K (islands)

and three entry points of their own (no call site in the engine):

  knn              brute-force kNN, nearest first, ties to the lower index
  flash_attention  causal GQA attention forward, online softmax
  ssd_chunk        Mamba-2 SSD intra-chunk output and chunk states

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built from ``csrc/`` with nvcc at first use) or
raises.  :data:`LAUNCHES` counts the kernel launches per wrapper, and
flash_attention's also per route (``flash_attention_wgmma``,
``flash_attention_simt``).
"""
from ._build import _LOCK, BUILD_LOG, LAUNCHES, build

NAMES = ("gather_mlp", "hub_reuse", "knn", "flash_attention", "ssd_chunk")


def launch_counts() -> dict:
    with _LOCK:
        return {name: LAUNCHES[name] for name in NAMES}


def reset_launch_counts() -> None:
    with _LOCK:
        LAUNCHES.clear()


def build_all() -> float:
    """Build every kernel source (one nvcc each, in parallel); seconds."""
    return build(NAMES)
