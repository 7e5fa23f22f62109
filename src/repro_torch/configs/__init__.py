"""Architecture registry + the assigned input-shape sets (the port's copy
of ``repro.configs``).

40 cells = 10 archs x 4 shapes.  ``long_500k`` needs sub-quadratic
attention: it runs for ssm/hybrid archs and is SKIPPED (with a note) for
pure full-attention archs (DESIGN.md §4).  Encoder-only archs would skip
decode shapes; none of the 10 is encoder-only.
"""
from __future__ import annotations

from dataclasses import dataclass
from importlib import import_module

_ARCH_MODULES = {
    "phi3-medium-14b": "phi3_medium_14b",
    "olmo-1b": "olmo_1b",
    "gemma-7b": "gemma_7b",
    "qwen2-72b": "qwen2_72b",
    "mamba2-2.7b": "mamba2_2p7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "paligemma-3b": "paligemma_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "grok-1-314b": "grok1_314b",
    "whisper-large-v3": "whisper_large_v3",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch: str, reduced: bool = False):
    mod = import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs with sub-quadratic sequence mixing (long_500k runs only for these)
SUBQUADRATIC = {"mamba2-2.7b", "recurrentgemma-2b"}


def cells():
    """All (arch, shape) cells with skip annotations."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES.values():
            skip = (s.name == "long_500k" and a not in SUBQUADRATIC)
            out.append((a, s.name,
                        "full-attention arch: 500k KV/scores infeasible, "
                        "sub-quadratic attention required (DESIGN.md 4)"
                        if skip else None))
    return out
