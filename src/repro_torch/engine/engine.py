"""The engine: from a padded cloud batch to logits, on one device or over
a data mesh.

    from repro_torch.engine import PCNEngine, Batch
    from repro_torch.models.pointnet2 import POINTNET2_C

    eng = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda")
    params = eng.init(seed=0)
    logits = eng.apply(params, Batch.from_clouds(clouds, n_pad=1024))

The forward runs in two stages: the geometric chain (DS → octree →
islandize → hub-schedule) for the whole batch with per-cloud keys, then
Feature Computation, where each block's dense and reuse dataflows are one
kernel launch each for the whole batch (``fc_backend="cuda_per_cloud"``:
one a cloud).  ``kernel_kw`` (``{"rows", "nsplit", "chunk"}``) forces the
FC kernels' launch knobs over the tile-plan store
(``repro_torch.kernels.plans``) and the heuristic.  The device defaults
to the GPU and must be given as ``device="cpu"`` to run the plain
PyTorch path.

``mesh`` (a ``repro_torch.launch.mesh.Mesh`` with a ``"data"`` axis, e.g.
``data_mesh(n)`` under ``torchrun --nproc-per-node n``) turns on the
sharded serving path (``engine/sharded.py``): each rank runs its block of
the batch's rows and every rank gets the whole logits.  ``mesh=None`` is
the single-device fast path, which never imports ``torch.distributed``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fc  # noqa: F401  (registers the "cuda" backend)
from ..device import resolve_device
from ..core.pipeline import _first
from .archs import EngineCtx, get_arch
from .params import Batch, PCNParams, as_batch, from_legacy, key_words
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
          kernel_kw: dict | None = None, device=None, mesh=None):
    """Padded :class:`Batch` (or (B, N, 3) array) -> logits, (B,
    n_classes) for cls specs and (B, N, n_classes) for seg specs.

    Ragged contract: ``batch.n_valid`` masks padding end to end, so
    ``apply(batch)[i]`` (cls) / ``apply(batch)[i, :n_valid[i]]`` (seg)
    equals :func:`apply_single` on cloud i's unpadded prefix with key
    ``batch.keys[i]``; seg rows >= n_valid[i] are zeros.  Legacy param
    dicts are accepted (:func:`~repro_torch.engine.params.from_legacy`).
    ``kernel_kw`` forces the FC kernels' launch knobs (``rows``,
    ``nsplit``, ``chunk``; see :class:`~repro_torch.engine.archs.EngineCtx`);
    unknown keys and the JAX package's TPU knobs raise.  ``mesh``: every
    rank of it calls ``apply`` (rank 0's batch is the one run), each runs
    B / n_data rows, and each returns the whole (B, …) logits."""
    if mesh is not None:
        from . import sharded
        ctx = EngineCtx.make(mode=mode, fc_backend=fc_backend,
                             isl_kw=isl_kw, kernel_kw=kernel_kw, mesh=mesh)
        with torch.no_grad():
            return sharded.forward(from_legacy(params),
                                   as_batch(batch, resolve_device(device)),
                                   spec, ctx, mesh)
    return _forward(params, batch, spec, mode, fc_backend, isl_kw,
                    kernel_kw, device, with_report=False)


def apply_with_reports(params: PCNParams, batch, *, spec: PCNSpec,
                       mode: str = "lpcn", fc_backend: str = "reference",
                       isl_kw: dict | None = None,
                       kernel_kw: dict | None = None, device=None):
    """Like :func:`apply`, and also the per-cloud
    :class:`~repro_torch.core.workload.WorkloadReport` ((B,) counters
    summed over the blocks), computed from the forward's own stage-1
    structures; None in traditional mode.  Padding contributes to no
    counter, so the counters are the same with and without padding.
    -> (logits, report)."""
    return _forward(params, batch, spec, mode, fc_backend, isl_kw,
                    kernel_kw, device, with_report=True)


def _forward(params, batch, spec, mode, fc_backend, isl_kw, kernel_kw,
             device, with_report):
    device = resolve_device(device)
    ctx = EngineCtx.make(mode=mode, fc_backend=fc_backend, isl_kw=isl_kw,
                         kernel_kw=kernel_kw)
    b = as_batch(batch, device)
    with torch.no_grad():
        return get_arch(spec).forward(from_legacy(params), spec, b.xyz,
                                      b.feats, b.keys, ctx, b.n_valid,
                                      with_report=with_report)


def apply_single(params: PCNParams, xyz, feats=None, key=None, *,
                 spec: PCNSpec, mode: str = "lpcn",
                 fc_backend: str = "reference", isl_kw: dict | None = None,
                 kernel_kw: dict | None = None, with_report: bool = False,
                 n_valid=None, device=None):
    """One cloud (N, 3) / (N, F) with key (2,) -> (n_classes,) logits, or
    (N, n_classes) for a seg spec: the batched forward at B = 1.
    ``n_valid`` (int or None) marks rows >= n_valid as padding.  With
    ``with_report`` -> (logits, WorkloadReport with 0-d counters, or None
    in traditional mode)."""
    device = resolve_device(device)
    ctx = EngineCtx.make(mode=mode, fc_backend=fc_backend, isl_kw=isl_kw,
                         kernel_kw=kernel_kw)
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    feats = xyz if feats is None else torch.as_tensor(
        feats, dtype=torch.float32, device=device)
    key = key_words(key, device)
    nv = None if n_valid is None else torch.tensor([int(n_valid)],
                                                   device=device)
    with torch.no_grad():
        out = get_arch(spec).forward(from_legacy(params), spec, xyz[None],
                                     feats[None], key[None], ctx, nv,
                                     with_report=with_report)
    if not with_report:
        return out[0]
    logits, report = out
    return logits[0], _first(report)


class PCNEngine:
    """A spec bound to an execution configuration and a device — the
    serving handle: construct once, ``init`` (or carry over) params, then
    ``apply`` padded batches.  ``kernel_kw`` forces the FC kernels' launch
    knobs on every call (:func:`apply`).  ``mesh`` makes it a sharded
    serving handle (:func:`apply`); a server that forms batches on rank 0
    alone has the other ranks :meth:`follow` it."""

    def __init__(self, spec: PCNSpec, *, mode: str = "lpcn",
                 fc_backend: str = "reference", isl_kw: dict | None = None,
                 kernel_kw: dict | None = None, device=None, mesh=None):
        self.spec = spec
        self.mode = mode
        self.fc_backend = fc_backend
        self.isl_kw = dict(isl_kw or {})
        self.kernel_kw = dict(kernel_kw or {})
        self.device = resolve_device(device)
        self.mesh = mesh
        self._warmed: set = set()     # (batch, n_points) bucket_callable
        # a bad mode, backend, knob, mesh or family fails here, not at the
        # first batch
        self.ctx = EngineCtx.make(mode=mode, fc_backend=fc_backend,
                                  isl_kw=self.isl_kw,
                                  kernel_kw=self.kernel_kw, mesh=mesh)
        get_arch(spec)

    def _kw(self):
        return dict(spec=self.spec, mode=self.mode,
                    fc_backend=self.fc_backend, isl_kw=self.isl_kw,
                    kernel_kw=self.kernel_kw, device=self.device)

    def twin(self, fc_backend: str) -> "PCNEngine":
        """This engine with another FC backend (the degraded path)."""
        return PCNEngine(self.spec, mode=self.mode, fc_backend=fc_backend,
                         isl_kw=self.isl_kw, kernel_kw=self.kernel_kw,
                         device=self.device, mesh=self.mesh)

    def follow(self, params: PCNParams) -> int:
        """On a mesh rank other than 0: run rank 0's forwards (of this
        engine or a :meth:`twin`) until it calls :meth:`release`.  -> the
        forwards run."""
        from . import sharded
        return sharded.follow(self, from_legacy(params))

    def release(self) -> None:
        """On rank 0: end the other ranks' :meth:`follow`."""
        from . import sharded
        sharded.release(self.device)

    def init(self, seed: int = 0) -> PCNParams:
        return init(self.spec, seed, self.device)

    def apply(self, params: PCNParams, batch) -> torch.Tensor:
        """Padded batch (Batch or (B, N, 3) array) -> logits."""
        return apply(params, batch, mesh=self.mesh, **self._kw())

    def apply_single(self, params: PCNParams, xyz, feats=None, key=None, *,
                     with_report: bool = False, n_valid=None):
        """One cloud -> (n_classes,) or, for seg, (N, n_classes) logits;
        with ``with_report``, (logits, report)."""
        return apply_single(params, xyz, feats, key, with_report=with_report,
                            n_valid=n_valid, **self._kw())

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
        kw = f", kernel_kw={self.kernel_kw}" if self.kernel_kw else ""
        m = "" if self.mesh is None else f", mesh={self.mesh.shape}"
        return (f"PCNEngine({self.spec.name}, mode={self.mode!r}, "
                f"fc_backend={self.fc_backend!r}{kw}, device={self.device}"
                f"{m})")
