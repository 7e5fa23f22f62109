"""Named-component registries — the engine's plug-in mechanism.

Every swappable stage of the building block (the sampler, the neighbor
search and the FC backend) is resolved by name, so the Islandization Unit
plugs into any of the paper's DS baselines.  Third-party code extends the
engine with

    from repro_torch.engine import register_sampler

    @register_sampler("my_sampler")
    def my_sampler(xyz, *, tree, n_centers, key, n_valid=None):
        ...

Interfaces (batched: every array has leading cloud axes):

  sampler(xyz, *, tree, n_centers, key, n_valid)  -> (..., n_centers) int64
  neighbor(xyz, centers, *, tree, k, radius,
           octree_level, n_valid)                 -> (..., S, K) int64
  fc backend: an :class:`~repro_torch.core.pipeline.FCBackend`, registered
  by ``core.pipeline`` ("reference") and ``repro_torch.engine.fc``
  ("cuda").

``n_valid`` (None or a (...,) count tensor) marks rows >= n_valid of
``xyz`` as padding: samplers never select them and neighbor methods never
return them (unfillable slots are ``-1``).  The batched engine always
passes it, so a component used through ``engine.apply`` must accept it;
the per-cloud entries without ``n_valid`` leave it out.
"""
from __future__ import annotations

import math

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
                raise ValueError(
                    f"duplicate {self.kind} {name!r}: already registered; "
                    f"pick a distinct name or remove the old entry first")
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


def register_sampler(name: str, fn=None):
    return SAMPLERS.register(name, fn)


def register_neighbor(name: str, fn=None):
    return NEIGHBORS.register(name, fn)


def register_fc_backend(name: str, backend=None):
    return FC_BACKENDS.register(name, backend)


# ---- samplers (paper Fig. 6) ------------------------------------------------

@SAMPLERS.register("fps")
def _fps(xyz, *, tree, n_centers, key, n_valid=None):
    del tree, key
    valid = None
    if n_valid is not None:
        valid = (torch.arange(xyz.shape[-2], device=xyz.device)
                 < n_valid[..., None])
    return sampling.farthest_point_sampling(xyz, n_centers, valid=valid)


@SAMPLERS.register("random")
def _random(xyz, *, tree, n_centers, key, n_valid=None):
    del tree
    return sampling.random_sampling(key, xyz.shape[-2], n_centers, n_valid)


@SAMPLERS.register("morton")
def _morton(xyz, *, tree, n_centers, key, n_valid=None):
    del key
    return sampling.morton_strided_sampling(tree.order, n_centers, n_valid)


@SAMPLERS.register("all")
def _all(xyz, *, tree, n_centers, key, n_valid=None):
    """DGCNN: every point is a center.  Padding rows stay in the center
    list (static shape); the block masks them via ``center_valid``."""
    del tree, n_centers, key, n_valid
    idx = torch.arange(xyz.shape[-2], device=xyz.device)
    return idx.expand(xyz.shape[:-1]).contiguous()


# ---- neighbor methods (the four DS baselines + ball query) ------------------

@NEIGHBORS.register("pointacc")
def _pointacc(xyz, centers, *, tree, k, radius, octree_level, n_valid=None):
    del tree, radius, octree_level
    return nb.knn_bruteforce(xyz, centers, k, n_valid)


@NEIGHBORS.register("hgpcn")
def _hgpcn(xyz, centers, *, tree, k, radius, octree_level, n_valid=None):
    """Density-adaptive narrowing level: about k points expected in the
    27-node neighbourhood.  The level comes from the padded N, as the JAX
    package's does under ``vmap``."""
    del radius
    lvl = max(1, min(octree_level,
                     int(math.log(max(xyz.shape[-2] / k, 2), 8))))
    return nb.knn_octree(tree, xyz, centers, k, level=lvl, n_valid=n_valid)


@NEIGHBORS.register("edgepc")
def _edgepc(xyz, centers, *, tree, k, radius, octree_level, n_valid=None):
    del radius, octree_level
    return nb.knn_morton_window(tree, xyz, centers, k, n_valid=n_valid)


@NEIGHBORS.register("crescent")
def _crescent(xyz, centers, *, tree, k, radius, octree_level, n_valid=None):
    del tree, radius, octree_level
    return nb.knn_kdtree_approx(xyz, centers, k, n_valid=n_valid)


@NEIGHBORS.register("ball")
def _ball(xyz, centers, *, tree, k, radius, octree_level, n_valid=None):
    del tree, octree_level
    return nb.ball_query(xyz, centers, radius, k, n_valid)


def get_fc_backend(name: str):
    """Resolve an FC backend, loading the kernel-backed ones on demand
    (``repro_torch.engine.fc`` registers "cuda" on import)."""
    if name not in FC_BACKENDS:
        from ..engine import fc  # noqa: F401  (registers backends)
    return FC_BACKENDS.get(name)
