"""Batched, device-explicit PCN engine (the port of ``repro.engine``).

    from repro_torch import engine
    eng = engine.PCNEngine(spec, mode="lpcn", fc_backend="cuda")

FC backends: "reference" (plain PyTorch) and "cuda" (the hand-written
kernels; their plain versions on CPU tensors).
"""
from ..core.registry import FC_BACKENDS, NEIGHBORS, SAMPLERS, Registry
from .archs import ARCHS, Arch, EngineCtx, get_arch
from .engine import PCNEngine, apply, apply_single, init
from .fc import two_layer_form
from .params import (Batch, PCNParams, as_batch, params_from_numpy,
                     structure_from_numpy, validate_cloud)
from .spec import BlockSpec, PCNSpec, arch_of, block_in_dim

__all__ = [
    "PCNEngine", "init", "apply", "apply_single",
    "Batch", "PCNParams", "as_batch", "params_from_numpy",
    "structure_from_numpy", "validate_cloud",
    "BlockSpec", "PCNSpec", "arch_of", "block_in_dim",
    "Registry", "SAMPLERS", "NEIGHBORS", "FC_BACKENDS", "ARCHS", "Arch",
    "EngineCtx", "get_arch", "two_layer_form",
]
