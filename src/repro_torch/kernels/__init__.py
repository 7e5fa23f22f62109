"""Hand-written CUDA kernels of the two FC dataflows, with their plain
PyTorch versions.

  gather_mlp  fused normalize → 2-layer MLP → max over K (dense path)
  hub_reuse   pool MLP → compensated reuse gather → max over K (islands)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built from ``csrc/`` with nvcc at first use) or
raises.  :data:`LAUNCHES` counts the kernel launches per wrapper.
"""
from ._build import BUILD_LOG, LAUNCHES, build


def launch_counts() -> dict:
    return {name: LAUNCHES[name] for name in ("gather_mlp", "hub_reuse")}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def build_all() -> float:
    """Build every kernel source (one nvcc each, in parallel); seconds."""
    return build(["gather_mlp", "hub_reuse"])
