"""Named-component registries — the engine's plug-in mechanism.

Interfaces (batched: every array has leading cloud axes):

  sampler(xyz, *, tree, n_centers, key, n_valid)  -> (..., n_centers) int64
  neighbor(xyz, centers, *, tree, k, radius,
           octree_level, n_valid)                 -> (..., S, K) int64
  fc backend: an :class:`~repro_torch.core.pipeline.FCBackend`, registered
  by ``core.pipeline`` ("reference") and ``repro_torch.engine.fc``
  ("cuda").

``n_valid`` (None or a (...,) count tensor) marks rows >= n_valid of
``xyz`` as padding: samplers never select them and neighbor methods never
return them (unfillable slots are ``-1``).
"""
from __future__ import annotations

import torch

from . import neighbor as nb
from . import sampling


class Registry:
    """A small name -> component table with clear failure modes."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict = {}

    def register(self, name: str, value=None):
        """Register ``value`` under ``name``; usable as a decorator."""
        def _add(v):
            if name in self._entries:
                raise ValueError(f"duplicate {self.kind} {name!r}")
            self._entries[name] = v
            return v
        return _add if value is None else _add(value)

    def get(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries)) or "<none>"
            raise KeyError(f"unknown {self.kind} {name!r}; registered "
                           f"{self.kind}s: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> tuple:
        return tuple(sorted(self._entries))


SAMPLERS = Registry("sampler")
NEIGHBORS = Registry("neighbor")
FC_BACKENDS = Registry("fc_backend")


@SAMPLERS.register("fps")
def _fps(xyz, *, tree, n_centers, key, n_valid=None):
    del tree, key
    valid = None
    if n_valid is not None:
        valid = (torch.arange(xyz.shape[-2], device=xyz.device)
                 < n_valid[..., None])
    return sampling.farthest_point_sampling(xyz, n_centers, valid=valid)


@SAMPLERS.register("all")
def _all(xyz, *, tree, n_centers, key, n_valid=None):
    """DGCNN: every point is a center.  Padding rows stay in the center
    list (static shape); the block masks them via ``center_valid``."""
    del tree, n_centers, key, n_valid
    idx = torch.arange(xyz.shape[-2], device=xyz.device)
    return idx.expand(xyz.shape[:-1]).contiguous()


@NEIGHBORS.register("pointacc")
def _pointacc(xyz, centers, *, tree, k, radius, octree_level, n_valid=None):
    del tree, radius, octree_level
    return nb.knn_bruteforce(xyz, centers, k, n_valid)


def get_fc_backend(name: str):
    """Resolve an FC backend, loading the kernel-backed ones on demand
    (``repro_torch.engine.fc`` registers "cuda" on import)."""
    if name not in FC_BACKENDS:
        from ..engine import fc  # noqa: F401  (registers backends)
    return FC_BACKENDS.get(name)
