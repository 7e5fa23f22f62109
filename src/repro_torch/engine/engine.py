"""The engine: from a padded cloud batch to logits, on one device.

    from repro_torch.engine import PCNEngine, Batch
    from repro_torch.models.pointnet2 import POINTNET2_C

    eng = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda")
    params = eng.init(seed=0)
    logits = eng.apply(params, Batch.from_clouds(clouds, n_pad=1024))

The forward runs in two stages: the geometric chain (DS → octree →
islandize → hub-schedule) for the whole batch with per-cloud keys, then
Feature Computation, where each block's dense and reuse dataflows are one
kernel launch each for the whole batch.  The device defaults to the GPU
and must be given as ``device="cpu"`` to run the plain PyTorch path.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fc  # noqa: F401  (registers the "cuda" backend)
from ..device import resolve_device
from .archs import EngineCtx, get_arch
from .params import Batch, PCNParams, as_batch, key_words
from .spec import PCNSpec


def init(spec: PCNSpec, seed: int = 0, device=None) -> PCNParams:
    """Random params for ``spec`` from a torch generator seeded with
    ``seed`` (not bit-equal to the JAX package's init; carry JAX weights
    across with :func:`~repro_torch.engine.params.params_from_numpy`)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return get_arch(spec).init(spec, gen, device)


def apply(params: PCNParams, batch, *, spec: PCNSpec, mode: str = "lpcn",
          fc_backend: str = "reference", isl_kw: dict | None = None,
          device=None):
    """Padded :class:`Batch` (or (B, N, 3) array) -> (B, n_classes) logits.

    Ragged contract: ``batch.n_valid`` masks padding end to end, so
    ``apply(batch)[i]`` equals :func:`apply_single` on cloud i's unpadded
    prefix with key ``batch.keys[i]``."""
    device = resolve_device(device)
    ctx = EngineCtx.make(mode=mode, fc_backend=fc_backend, isl_kw=isl_kw)
    b = as_batch(batch, device)
    with torch.no_grad():
        return get_arch(spec).forward(params, spec, b.xyz, b.feats, b.keys,
                                      ctx, b.n_valid)


def apply_single(params: PCNParams, xyz, feats=None, key=None, *,
                 spec: PCNSpec, mode: str = "lpcn",
                 fc_backend: str = "reference", isl_kw: dict | None = None,
                 n_valid=None, device=None):
    """One cloud (N, 3) / (N, F) with key (2,) -> (n_classes,) logits: the
    batched forward at B = 1.  ``n_valid`` (int or None) marks rows >=
    n_valid as padding."""
    device = resolve_device(device)
    ctx = EngineCtx.make(mode=mode, fc_backend=fc_backend, isl_kw=isl_kw)
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    feats = xyz if feats is None else torch.as_tensor(
        feats, dtype=torch.float32, device=device)
    key = key_words(key, device)
    nv = None if n_valid is None else torch.tensor([int(n_valid)],
                                                   device=device)
    with torch.no_grad():
        return get_arch(spec).forward(params, spec, xyz[None], feats[None],
                                      key[None], ctx, nv)[0]


class PCNEngine:
    """A spec bound to an execution configuration and a device — the
    serving handle: construct once, ``init`` (or carry over) params, then
    ``apply`` padded batches."""

    def __init__(self, spec: PCNSpec, *, mode: str = "lpcn",
                 fc_backend: str = "reference", isl_kw: dict | None = None,
                 device=None):
        self.spec = spec
        self.mode = mode
        self.fc_backend = fc_backend
        self.isl_kw = dict(isl_kw or {})
        self.device = resolve_device(device)
        self._warmed: set = set()     # (batch, n_points) bucket_callable
        # a bad mode, backend or family fails here, not at the first batch
        EngineCtx.make(mode=mode, fc_backend=fc_backend, isl_kw=self.isl_kw)
        get_arch(spec)

    def _kw(self):
        return dict(spec=self.spec, mode=self.mode,
                    fc_backend=self.fc_backend, isl_kw=self.isl_kw,
                    device=self.device)

    def init(self, seed: int = 0) -> PCNParams:
        return init(self.spec, seed, self.device)

    def apply(self, params: PCNParams, batch) -> torch.Tensor:
        """Padded batch (Batch or (B, N, 3) array) -> logits."""
        return apply(params, batch, **self._kw())

    def apply_single(self, params: PCNParams, xyz, feats=None, key=None, *,
                     n_valid=None) -> torch.Tensor:
        """One cloud -> (n_classes,) logits."""
        return apply_single(params, xyz, feats, key, n_valid=n_valid,
                            **self._kw())

    def bucket_callable(self, params: PCNParams, batch_size: int,
                        n_points: int):
        """Warm the (batch_size, n_points) bucket — the first run builds
        any kernel not built yet — and return ``batch -> logits`` bound to
        ``params``: the serving layer's per-bucket seam.  The bucket is
        recorded in :attr:`compile_count`."""
        rng = np.random.default_rng(0)
        xyz = rng.standard_normal((batch_size, n_points, 3)).astype(
            np.float32)
        f = self.spec.in_feats
        feats = None if f <= 3 else np.concatenate(
            [xyz, np.zeros((batch_size, n_points, f - 3), np.float32)], -1)
        self.apply(params, Batch.make(xyz, feats, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed.add((batch_size, n_points))
        return lambda batch: self.apply(params, batch)

    @property
    def compile_count(self) -> int:
        """Distinct (batch, n_points) buckets warmed by
        :meth:`bucket_callable` — the counterpart of the JAX engine's jit
        cache size, which the port does not have."""
        return len(self._warmed)

    def __repr__(self):
        return (f"PCNEngine({self.spec.name}, mode={self.mode!r}, "
                f"fc_backend={self.fc_backend!r}, device={self.device})")
