"""Batched, device-explicit PCN engine (the port of ``repro.engine``).

    from repro_torch import engine
    eng = engine.PCNEngine(spec, mode="lpcn", fc_backend="cuda")

FC backends: "reference" (plain PyTorch) and "cuda" (the hand-written
kernels; their plain versions on CPU tensors).  Extension points:
:func:`register_sampler`, :func:`register_neighbor`,
:func:`register_fc_backend`; :func:`apply_with_reports` adds the
paper's per-cloud workload counters to the logits.
"""
from ..core.registry import (FC_BACKENDS, NEIGHBORS, SAMPLERS, Registry,
                             register_fc_backend, register_neighbor,
                             register_sampler)
from .archs import ARCHS, Arch, EngineCtx, get_arch
from .engine import (PCNEngine, apply, apply_single, apply_with_reports,
                     init)
from .fc import two_layer_form
from .params import (Batch, PCNParams, as_batch, from_legacy,
                     params_from_numpy, structure_from_numpy, to_legacy,
                     validate_cloud)
from .spec import BlockSpec, PCNSpec, arch_of, block_in_dim

__all__ = [
    "PCNEngine", "init", "apply", "apply_single", "apply_with_reports",
    "Batch", "PCNParams", "as_batch", "from_legacy", "to_legacy",
    "params_from_numpy", "structure_from_numpy", "validate_cloud",
    "BlockSpec", "PCNSpec", "arch_of", "block_in_dim",
    "Registry", "SAMPLERS", "NEIGHBORS", "FC_BACKENDS", "ARCHS", "Arch",
    "EngineCtx", "register_sampler", "register_neighbor",
    "register_fc_backend", "get_arch", "two_layer_form",
]
