"""The L-PCN Building Block: Data Structuring → Islandization → Feature
Computation (paper Fig. 2/5/13), batched over clouds.

Execution modes:

  * ``traditional`` — every subset fully fetched and computed;
  * ``lpcn`` — Octree-based Islandization + Hub-based Scheduling: the pool
    MLP runs once per island (hub-relative), cached positions are reused
    with delta compensation, and a compact overflow buffer computes the
    rest.

The block runs in two stages: :func:`structure_block` (geometry and RNG
only) and :func:`compute_block_features_batched` (Feature Computation).
Every array carries a leading cloud axis (B, …); the per-cloud API
(:func:`fc_traditional`, :func:`fc_lpcn`, :func:`compute_block_features`,
:func:`lpcn_block`) is the batched code at B = 1.  The two heavy dataflows
go through an :class:`FCBackend`: the "reference" backend here is plain
PyTorch, the "cuda" backend (``repro_torch.engine.fc``) runs the
hand-written kernels.  Overflow and merge bookkeeping is shared.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass
from typing import Callable

import torch

from .. import random
from . import octree as oct
from .delta_comp import compensation
from .hub_schedule import Schedule, build_schedule
from .islandize import Islands, _take, islandize
from .mlp import MLP, apply_mlp, post_pool_activation
from .registry import FC_BACKENDS, NEIGHBORS, SAMPLERS, get_fc_backend
from .workload import WorkloadReport, analyze

BIG = 3.4e38


def _lift(x):
    """One cloud's array, or a dataclass of them (Islands, Schedule,
    BlockStructure), with a leading cloud axis of 1; None stays None."""
    if x is None:
        return None
    if is_dataclass(x):
        return type(x)(**{f.name: _lift(getattr(x, f.name))
                          for f in fields(x)})
    return x[None]


def _first(x):
    """The inverse of :func:`_lift`: cloud 0 of a batched value."""
    if x is None:
        return None
    if is_dataclass(x):
        return type(x)(**{f.name: _first(getattr(x, f.name))
                          for f in fields(x)})
    return x[0] if isinstance(x, torch.Tensor) else x


@dataclass(frozen=True)
class LPCNConfig:
    """Hyper-parameters of one building block (paper defaults)."""
    n_centers: int = 512
    k: int = 32
    sampler: str = "fps"
    neighbor: str = "pointacc"
    radius: float = 0.2
    mode: str = "lpcn"                # traditional | lpcn
    block_kind: str = "sa"            # sa | edge
    island_size: int = 32             # subsets per island
    island_capacity: int = 64         # island-list rows
    cache_capacity_x: float = 2.0     # hub cache = x * k
    compensation: str = "linear"      # linear | mlp
    octree_level: int = 4
    hub_select: str = "random"
    overflow_frac: float = 0.5        # compact overflow buffer / (M*K)
    fc_backend: str = "reference"

    @property
    def cache_capacity(self) -> int:
        return int(self.cache_capacity_x * self.k)


@dataclass(frozen=True)
class FCBackend:
    """A Feature-Computation dataflow implementation (the paper's FCU),
    batched over clouds.

    dense(mlp, kind, xyz, feats, nbr_idx, centers_xyz, center_feats,
          nbr_valid) -> (B, S, F_out) pooled pre-activation features;
          masked slots are left out of the pool and an all-masked subset
          gives a zero row.
    reuse(mlp, pool_in, slot, comp, live) -> (B, H, M, F_out) pooled
          reuse partials, ``-BIG`` where a subset has no live cached
          position (``slot >= 0`` and ``live``).

    Where the engine is given ``kernel_kw`` (tuning knobs, validated by
    ``EngineCtx.make``), both also receive it as the keyword
    ``kernel_kw``; a backend that has no knobs ignores it.
    """
    name: str
    dense: Callable
    reuse: Callable


def _knobs(kernel_kw) -> dict:
    """The keyword a backend's dataflows get: ``kernel_kw`` where set."""
    return {"kernel_kw": kernel_kw} if kernel_kw else {}


def _center_vec(kind: str, centers_xyz, center_feats):
    return centers_xyz if kind == "sa" else center_feats


def _point_inputs(kind: str, xyz, feats, ids, center_vec):
    """MLP inputs of gathered point ids (B, …) against ``center_vec``
    (broadcastable to (B, …, Dc)).  sa: [xyz_j − c, f_j]; edge:
    [f_j − c, c]."""
    if kind == "sa":
        return torch.cat([_take(xyz, ids) - center_vec, _take(feats, ids)],
                         dim=-1)
    rel = _take(feats, ids) - center_vec
    return torch.cat([rel, center_vec.expand(rel.shape)], dim=-1)


def _subset_inputs(kind, xyz, feats, nbr_idx, centers_xyz, center_feats):
    """(B, S, K, f_in) MLP inputs of every subset (dense path)."""
    cv = _center_vec(kind, centers_xyz, center_feats)
    return _point_inputs(kind, xyz, feats, nbr_idx, cv[:, :, None, :])


def _dense_reference(mlp: MLP, kind, xyz, feats, nbr_idx, centers_xyz,
                     center_feats=None, nbr_valid=None, kernel_kw=None):
    """Plain dense dataflow: gather, MLP, max over K (no knobs)."""
    ids = nbr_idx if nbr_valid is None else torch.where(nbr_valid, nbr_idx,
                                                        0)
    y = apply_mlp(mlp, _subset_inputs(kind, xyz, feats, ids, centers_xyz,
                                      center_feats))       # (B, S, K, F)
    if nbr_valid is None:
        return y.amax(2)
    pooled = torch.where(nbr_valid[..., None], y, -BIG).amax(2)
    return torch.where(nbr_valid.any(2)[..., None], pooled, 0.0)


def _reuse_reference(mlp: MLP, pool_in, slot, comp, live=None,
                     kernel_kw=None):
    """Plain reuse dataflow: pool MLP, slot gather, + comp, masked max
    over K; ``-BIG`` for a subset with no live slot (no knobs)."""
    y = apply_mlp(mlp, pool_in)                           # (B, H, C, F)
    b, h, m, k = slot.shape
    safe = torch.clamp(slot, 0, pool_in.shape[2] - 1).long().reshape(
        b, h, m * k)
    g = torch.gather(y, 2, safe[..., None].expand(b, h, m * k, y.shape[-1]))
    g = g.reshape(b, h, m, k, -1) + comp[:, :, :, None, :]
    ok = slot >= 0 if live is None else (slot >= 0) & live
    return torch.where(ok[..., None], g, -BIG).amax(3)


FC_BACKENDS.register("reference", FCBackend(
    name="reference", dense=_dense_reference, reuse=_reuse_reference))


def fc_traditional_batched(mlp: MLP, xyz, feats, nbr_idx, centers_xyz,
                           center_feats=None, kind: str = "sa",
                           backend: FCBackend | None = None,
                           nbr_valid=None, kernel_kw=None):
    """Baseline FC: the MLP on all S·K gathered points, then max-pool."""
    backend = backend or FC_BACKENDS.get("reference")
    pooled = backend.dense(mlp, kind, xyz, feats, nbr_idx, centers_xyz,
                           center_feats, nbr_valid, **_knobs(kernel_kw))
    return post_pool_activation(mlp, pooled)


def fc_traditional(mlp: MLP, xyz, feats, nbr_idx, centers_xyz,
                   center_feats=None, kind: str = "sa",
                   backend: FCBackend | None = None, nbr_valid=None):
    """Baseline FC on ONE cloud: the MLP on all S·K gathered points, then
    max-pool.  ``nbr_valid`` (S, K) masks ragged -1 slots out of the pool
    (an empty subset gives a zero row).  -> (S, Fout)."""
    return fc_traditional_batched(
        mlp, xyz[None], feats[None], nbr_idx[None], centers_xyz[None],
        _lift(center_feats), kind, backend, _lift(nbr_valid))[0]


def _lpcn_reuse_inputs(mlp: MLP, xyz, feats, nbr_idx, centers_xyz,
                       islands: Islands, sched: Schedule, cfg: LPCNConfig,
                       center_feats=None):
    """Operands of ``backend.reuse``.  Returns (pool_in (B, H, C, fin),
    comp (B, H, M, Fout), slot_live (B, H, M, K), sub_vec (B, H, M, Dc))."""
    B, S, K = nbr_idx.shape
    H, M = islands.members.shape[1:]
    C = sched.pool_ids.shape[-1]
    kind = cfg.block_kind

    cvec = _center_vec(kind, centers_xyz, center_feats)   # (B, S, Dc)
    hub_vec = _take(cvec, islands.hub)                     # (B, H, Dc)
    pids = torch.clamp(sched.pool_ids, 0, xyz.shape[1] - 1)
    pool_in = _point_inputs(kind, xyz, feats, pids, hub_vec[:, :, None, :])
    pool_live = sched.pool_ids >= 0

    sub_vec = _take(cvec, torch.clamp(islands.members, 0, S - 1))
    delta = hub_vec[:, :, None, :] - sub_vec               # (B, H, M, Dc)
    comp = compensation(mlp, delta, cfg.compensation, kind)

    safe_slot = torch.clamp(sched.reuse_slot, 0, C - 1).long().reshape(
        B, H, M * K)
    slot_live = torch.gather(pool_live, 2, safe_slot).reshape(B, H, M, K)
    return pool_in, comp, slot_live, sub_vec


def _lpcn_merge(mlp: MLP, xyz, feats, nbr_idx, islands: Islands,
                sched: Schedule, cfg: LPCNConfig, sub_vec, slot_live,
                reuse_pooled):
    """Overflow compute + max-merge with the reuse partials + scatter to
    center order.  Returns (out (B, S, Fout) without the dense fallback,
    fb (B, S) bool fallback rows)."""
    B, S, K = nbr_idx.shape
    H, M = islands.members.shape[1:]
    MK = M * K
    F = mlp.f_out
    kind = cfg.block_kind
    dev = nbr_idx.device
    reuse_ok = (sched.reuse_slot >= 0) & slot_live

    # --- compact overflow compute (never-cached live positions) ----------
    budget = max(int(cfg.overflow_frac * M * K), K)
    need = ((~reuse_ok) & sched.pos_live).reshape(B, H, MK)
    prio = torch.where(need, torch.arange(MK, device=dev), MK)
    takepos = torch.sort(prio, dim=-1, stable=True).indices[..., :budget]
    taken = torch.gather(need, 2, takepos)
    mem = torch.clamp(islands.members, 0, S - 1)
    ids_hmk = torch.where(sched.pos_live, _take(nbr_idx, mem), 0)
    ids = torch.gather(ids_hmk.reshape(B, H, MK), 2, takepos)
    ids = torch.clamp(ids, 0, xyz.shape[1] - 1)
    row = torch.clamp(takepos // K, 0, M - 1)
    sv = torch.gather(sub_vec, 2, row[..., None].expand(
        row.shape + sub_vec.shape[-1:]))
    o_out = apply_mlp(mlp, _point_inputs(kind, xyz, feats, ids, sv))

    # overflow results on their own canvas (spare column MK takes the
    # untaken slots), pooled; max-pool commutes with the merge
    oidx = torch.where(taken, takepos, MK)
    over = torch.full((B, H, MK + 1, F), -BIG, dtype=o_out.dtype, device=dev)
    over.scatter_(2, oidx[..., None].expand(B, H, budget, F),
                  torch.where(taken[..., None], o_out, -BIG))
    over_pooled = over[:, :, :MK].reshape(B, H, M, K, F).amax(3)
    pooled = torch.maximum(reuse_pooled, over_pooled)
    # merge-boundary guard: a subset both of whose sides stayed at the
    # -BIG identity zero-fills; the sentinel never leaks past the merge
    pooled = torch.where(pooled > -BIG / 2, pooled, 0.0)

    # rows whose overflow exceeded the budget fall back to the dense path
    covered = torch.zeros((B, H, MK + 1), dtype=torch.bool, device=dev)
    covered.scatter_(2, oidx, taken)
    uncovered_row = (need & ~covered[:, :, :MK]).reshape(B, H, M, K).any(-1)

    # --- scatter per-subset results to center order (spare row S) --------
    tgt = torch.where(sched.subset_valid, islands.members, S).reshape(B, -1)
    out = torch.zeros((B, S + 1, F), dtype=pooled.dtype, device=dev)
    out.scatter_(1, tgt[..., None].expand(B, H * M, F),
                 pooled.reshape(B, H * M, F))
    fb = torch.zeros((B, S + 1), dtype=torch.bool, device=dev)
    fb.scatter_(1, tgt, uncovered_row.reshape(B, H * M))
    return out[:, :S], fb[:, :S] | islands.solo


def fc_lpcn_batched(mlp: MLP, xyz, feats, nbr_idx, centers_xyz,
                    islands: Islands, sched: Schedule, cfg: LPCNConfig,
                    center_feats=None, backend: FCBackend | None = None,
                    nbr_valid=None, kernel_kw=None):
    """Islandized FC: pool-MLP + compensated reuse + compact overflow,
    with the dense path for fallback rows.  -> (B, S, Fout)."""
    backend = backend or get_fc_backend(cfg.fc_backend)
    pool_in, comp, slot_live, sub_vec = _lpcn_reuse_inputs(
        mlp, xyz, feats, nbr_idx, centers_xyz, islands, sched, cfg,
        center_feats)
    reuse_pooled = backend.reuse(mlp, pool_in, sched.reuse_slot, comp,
                                 slot_live, **_knobs(kernel_kw))
    out, fb = _lpcn_merge(mlp, xyz, feats, nbr_idx, islands, sched, cfg,
                          sub_vec, slot_live, reuse_pooled)
    h_dense = backend.dense(mlp, cfg.block_kind, xyz, feats, nbr_idx,
                            centers_xyz, center_feats, nbr_valid,
                            **_knobs(kernel_kw))
    out = torch.where(fb[..., None], h_dense, out)
    return post_pool_activation(mlp, out)


def fc_lpcn(mlp: MLP, xyz, feats, nbr_idx, centers_xyz, islands: Islands,
            sched: Schedule, cfg: LPCNConfig, center_feats=None,
            backend: FCBackend | None = None, nbr_valid=None):
    """Islandized FC on ONE cloud (per-cloud ``islands`` and ``sched``):
    pool-MLP + compensated reuse + compact overflow.  -> (S, Fout), the
    contract of :func:`fc_traditional`."""
    return fc_lpcn_batched(
        mlp, xyz[None], feats[None], nbr_idx[None], centers_xyz[None],
        _lift(islands), _lift(sched), cfg, _lift(center_feats), backend,
        _lift(nbr_valid))[0]


@dataclass
class BlockOutput:
    """One building block on one cloud, as :func:`lpcn_block` returns it."""
    center_idx: torch.Tensor
    center_xyz: torch.Tensor
    features: torch.Tensor
    islands: Islands | None
    schedule: Schedule | None
    nbr_idx: torch.Tensor
    report: WorkloadReport | None = None
    center_valid: torch.Tensor | None = None   # (S,) bool; None = all valid


@dataclass
class BlockStructure:
    """Geometric stage of one building block, batched: everything the FC
    stage needs that depends only on coordinates and keys.  ``islands``
    and ``schedule`` are None in traditional mode; ``center_valid`` /
    ``nbr_valid`` are None when the clouds carry no padding count."""
    center_idx: torch.Tensor                  # (B, S)
    center_xyz: torch.Tensor                  # (B, S, 3)
    nbr: torch.Tensor                         # (B, S, K)
    islands: Islands | None
    schedule: Schedule | None
    center_valid: torch.Tensor | None         # (B, S) bool
    nbr_valid: torch.Tensor | None            # (B, S, K) bool


def _no_n_valid_hint(kind: str, name: str, err: TypeError, kw: dict):
    """A component that lacks ``n_valid``: name it and the fix."""
    if kw and "n_valid" in str(err):
        return TypeError(
            f"{kind} {name!r} does not accept n_valid, which the batched "
            f"engine always passes; add n_valid=None to its signature (see "
            f"core.registry docstring)")
    return None


def data_structuring(cfg: LPCNConfig, xyz, key, n_valid=None):
    """DS step: sample centers, gather neighbors (registry-resolved).
    -> (center_idx (B, S), nbr_idx (B, S, K)).

    ``n_valid`` is passed to the components only when set; a component
    that lacks it gets a TypeError naming it."""
    tree = oct.build(xyz, n_valid=n_valid)
    kw = {} if n_valid is None else {"n_valid": n_valid}
    try:
        cidx = SAMPLERS.get(cfg.sampler)(
            xyz, tree=tree, n_centers=cfg.n_centers, key=key, **kw)
    except TypeError as e:
        raise _no_n_valid_hint("sampler", cfg.sampler, e, kw) or e
    try:
        nbr = NEIGHBORS.get(cfg.neighbor)(
            xyz, _take(xyz, cidx), tree=tree, k=cfg.k, radius=cfg.radius,
            octree_level=cfg.octree_level, **kw)
    except TypeError as e:
        raise _no_n_valid_hint("neighbor", cfg.neighbor, e, kw) or e
    return cidx, nbr


def structure_block(cfg: LPCNConfig, xyz, key, n_valid=None
                    ) -> BlockStructure:
    """Stage 1 of a building block on clouds (B, N, 3) with keys (B, 2):
    DS → octree → islandize → hub-schedule."""
    keys = random.split(key)
    kds, kisl = keys[:, 0], keys[:, 1]
    cidx, nbr = data_structuring(cfg, xyz, kds, n_valid=n_valid)
    centers_xyz = _take(xyz, cidx)
    center_valid = None if n_valid is None else cidx < n_valid[:, None]
    nbr_valid = None if n_valid is None else nbr >= 0
    if cfg.mode == "traditional":
        return BlockStructure(cidx, centers_xyz, nbr, None, None,
                              center_valid, nbr_valid)
    n_hubs = max(cidx.shape[1] // cfg.island_size, 1)
    n_hubs_valid = None
    if center_valid is not None:
        n_hubs_valid = torch.clamp(center_valid.sum(-1) // cfg.island_size,
                                   min=1)
    isl = islandize(centers_xyz, n_hubs, level=cfg.octree_level,
                    capacity=cfg.island_capacity, hub_select=cfg.hub_select,
                    key=kisl, center_valid=center_valid,
                    n_hubs_valid=n_hubs_valid)
    sched = build_schedule(isl, nbr, cfg.cache_capacity)
    return BlockStructure(cidx, centers_xyz, nbr, isl, sched, center_valid,
                          nbr_valid)


def compute_block_features_batched(cfg: LPCNConfig, mlp: MLP, xyz, feats,
                                   st: BlockStructure,
                                   backend: FCBackend | None = None,
                                   kernel_kw=None):
    """Stage 2: Feature Computation over a stacked structure; the two
    dataflows go through the backend once each for the whole batch, with
    ``kernel_kw`` where given.  -> (B, S, Fout), padding centers
    zeroed."""
    backend = backend or get_fc_backend(cfg.fc_backend)
    center_feats = _take(feats, st.center_idx)
    if cfg.mode == "traditional":
        f = fc_traditional_batched(mlp, xyz, feats, st.nbr, st.center_xyz,
                                   center_feats, cfg.block_kind,
                                   backend=backend, nbr_valid=st.nbr_valid,
                                   kernel_kw=kernel_kw)
    else:
        f = fc_lpcn_batched(mlp, xyz, feats, st.nbr, st.center_xyz,
                            st.islands, st.schedule, cfg, center_feats,
                            backend=backend, nbr_valid=st.nbr_valid,
                            kernel_kw=kernel_kw)
    if st.center_valid is not None:
        f = torch.where(st.center_valid[..., None], f, 0.0)
    return f


def compute_block_features(cfg: LPCNConfig, mlp: MLP, xyz, feats,
                           st: BlockStructure,
                           backend: FCBackend | None = None):
    """Stage 2 on ONE cloud over its (unbatched) structure.  -> (S, Fout),
    padding centers zeroed."""
    return compute_block_features_batched(cfg, mlp, xyz[None], feats[None],
                                          _lift(st), backend)[0]


def lpcn_block(cfg: LPCNConfig, mlp: MLP, xyz, feats, key,
               with_report: bool = False, n_valid=None) -> BlockOutput:
    """One building block on ONE cloud (N, 3)/(N, F) with key (2,): the two
    stages at B = 1.  ``n_valid`` (int or None) marks rows >= n_valid as
    padding: the block then equals its run on the unpadded prefix, with
    padding centers' features zeroed (``center_valid`` marks them) and a
    report that counts only real work (0-d counters; None in traditional
    mode or without ``with_report``)."""
    nv = None if n_valid is None else torch.as_tensor(
        [int(n_valid)], device=xyz.device)
    st = structure_block(cfg, xyz[None], key[None], n_valid=nv)
    f = compute_block_features_batched(cfg, mlp, xyz[None], feats[None], st)
    report = None
    if with_report and st.islands is not None:
        report = _first(analyze(st.islands, st.schedule, cfg.k))
    st = _first(st)
    return BlockOutput(st.center_idx, st.center_xyz, f[0], st.islands,
                       st.schedule, st.nbr, report,
                       center_valid=st.center_valid)
