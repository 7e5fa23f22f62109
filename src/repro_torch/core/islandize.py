"""Octree-based Islandization (paper §IV-A), batched over clouds.

Partition each cloud's sampled centers into *Islands* of spatially
adjacent point subsets:

  Step 1  pick hub centers at random (shape-stable per-index scores,
          the paper's default) or by masked FPS (``hub_select="fps"``);
  Step 2  multi-source BFS over occupied voxels of the Sampled Octree at
          ``level`` (26-connectivity); a voxel reached in an earlier round
          is nearer, same-round ties go to the hub nearest the voxel
          center; voxels the BFS never reaches join the nearest hub;
  Step 3  every center joins its voxel's island;
  Step 4  Island Lists: hub first, then BFS-round order, then distance,
          padded to ``capacity``; centers past capacity become ``solo``.

Every step mirrors ``repro.core.islandize`` operation for operation, so the
integer outputs are equal.  JAX's ``.at[].set(mode="drop")`` scatters
become writes into a spare row that is sliced off; the hub seed scatter,
where two hubs may share a voxel, takes the larger hub id ("later hub
wins", deterministic on every device).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import morton
from .octree import adjacent_node_keys
from .sampling import farthest_point_sampling, index_uniform, sqdist

INT32_MAX = 2 ** 31 - 1


@dataclass
class Islands:
    """members:  (..., H, M) center indices per island, hub in slot 0, -1
                 padding; a center is in at most one island.
    hub:      (..., H) hub center index per island.
    solo:     (..., S) bool — centers past island capacity.
    round_of: (..., S) BFS round of each center's voxel."""
    members: torch.Tensor
    hub: torch.Tensor
    solo: torch.Tensor
    round_of: torch.Tensor


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather along axis 1: x (B, S, *rest), idx (B, *ix) ->
    (B, *ix, *rest)."""
    b = x.shape[0]
    rest = x.shape[2:]
    flat = idx.reshape(b, -1)
    out = torch.gather(x, 1, flat.reshape(flat.shape + (1,) * len(rest))
                       .expand(flat.shape + rest))
    return out.reshape(idx.shape + rest)


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort`` along the last axis (last key primary) as
    successive stable sorts."""
    perm = None
    for k in keys:
        kk = k if perm is None else torch.gather(k, -1, perm)
        p = torch.sort(kk, dim=-1, stable=True).indices
        perm = p if perm is None else torch.gather(perm, -1, p)
    return perm


def islandize(centers: torch.Tensor, n_hubs: int, *, level: int = 4,
              capacity: int = 64, hub_select: str = "random",
              max_rounds: int = 32, key: torch.Tensor,
              center_valid: torch.Tensor | None = None,
              n_hubs_valid: torch.Tensor | None = None) -> Islands:
    """Partition ``centers`` (B, S, 3) into ``n_hubs`` islands per cloud,
    with per-cloud keys (B, 2).  ``center_valid`` (B, S) marks padding
    centers (no voxel, no island, never solo); ``n_hubs_valid`` (B,) keeps
    hub slots past the valid budget inert.  ``hub_select`` is "random" or
    "fps"; any other name raises (the JAX package takes it as random)."""
    if hub_select not in ("random", "fps"):
        raise ValueError(f"unknown hub_select {hub_select!r}; expected "
                         f"'random' or 'fps'")
    B, S, _ = centers.shape
    dev = centers.device
    H = n_hubs
    ar_h = torch.arange(H, device=dev)
    hub_ok = None if n_hubs_valid is None else ar_h < n_hubs_valid[:, None]

    # ---- voxelization of the Sampled Octree at `level` -------------------
    clo, chi = morton.masked_bounds(centers, center_valid)
    codes = morton.morton_codes(centers, morton.MAX_DEPTH, lo=clo, hi=chi)
    ckeys = morton.node_key(codes, level, morton.MAX_DEPTH)       # (B, S)
    if center_valid is not None:
        ckeys = torch.where(center_valid, ckeys, morton.SENTINEL)
    sort_keys = torch.sort(ckeys, dim=-1).values
    is_new = torch.ones_like(sort_keys, dtype=torch.bool)
    is_new[:, 1:] = sort_keys[:, 1:] != sort_keys[:, :-1]
    ukeys = torch.sort(torch.where(is_new, sort_keys, morton.SENTINEL),
                       dim=-1).values
    vox_of_center = torch.searchsorted(ukeys, ckeys)              # (B, S)

    side = 1 << level
    vxyz = morton.decode(torch.where(ukeys == morton.SENTINEL, 0, ukeys)
                         ).to(torch.float32)
    extent = torch.clamp((chi - clo).amax(-1), min=1e-9)[:, None, None]
    vcenter = clo[:, None, :] + (vxyz + 0.5) / side * extent      # (B, S, 3)

    nkeys = adjacent_node_keys(ukeys, level, morton.MAX_DEPTH)    # (B, S, 27)
    npos = torch.searchsorted(ukeys, nkeys.reshape(B, -1)).reshape(B, S, 27)
    npos = torch.clamp(npos, 0, S - 1)
    nvalid = (_take(ukeys, npos) == nkeys) & (nkeys != morton.SENTINEL)
    nbr = torch.where(nvalid, npos, -1)
    nbr_safe = torch.clamp(nbr, 0, S - 1)

    # ---- Step 1: hub selection -------------------------------------------
    if hub_select == "fps":
        hub_idx = farthest_point_sampling(centers, H, valid=center_valid)
    else:
        scores = index_uniform(key, S)                            # (B, S)
        if center_valid is not None:
            scores = torch.where(center_valid, scores, float("inf"))
        hub_idx = torch.sort(scores, dim=-1, stable=True).indices[:, :H]
    hub_xyz = _take(centers, hub_idx)                             # (B, H, 3)
    hub_vox = torch.gather(vox_of_center, 1, hub_idx)
    hub_tgt = hub_vox if hub_ok is None else torch.where(hub_ok, hub_vox, S)

    # ---- Step 2: multi-source BFS over occupied voxels -------------------
    inf = torch.tensor(float("inf"), device=dev)
    assign = torch.full((B, S + 1), -1, dtype=torch.int64, device=dev)
    assign.scatter_reduce_(1, hub_tgt, ar_h.expand(B, H), reduce="amax")
    assign = assign[:, :S]
    rnd = torch.where(assign >= 0, 0, INT32_MAX)
    valid_vox = ukeys != morton.SENTINEL
    for r in range(1, max_rounds + 1):
        nass = torch.where(nbr >= 0, _take(assign, nbr_safe), -1)
        nrnd = torch.where(nbr >= 0, _take(rnd, nbr_safe), INT32_MAX)
        frontier = (nass >= 0) & (nrnd < r)                       # (B, S, 27)
        cand = _take(hub_xyz, torch.clamp(nass, 0, H - 1))        # (B,S,27,3)
        d = torch.where(frontier, sqdist(cand, vcenter[:, :, None, :]), inf)
        best = torch.argmin(d, dim=-1)
        dmin = d.amin(-1)
        best_hub = torch.gather(nass, -1, best[..., None])[..., 0]
        reach = (dmin < inf) & (assign < 0) & valid_vox
        assign = torch.where(reach, best_hub, assign)
        rnd = torch.where(reach, r, rnd)

    unassigned = (assign < 0) & valid_vox
    d_all = sqdist(vcenter[:, :, None, :], hub_xyz[:, None, :, :])  # (B,S,H)
    if hub_ok is not None:
        d_all = torch.where(hub_ok[:, None, :], d_all, inf)
    nearest = torch.argmin(d_all, dim=-1)
    assign = torch.where(unassigned, nearest, assign)
    rnd = torch.where(unassigned, max_rounds + 1, rnd)

    # ---- Step 3: per-center island id ------------------------------------
    island_of = torch.gather(assign, 1, vox_of_center)
    round_of = torch.gather(rnd, 1, vox_of_center)
    if center_valid is not None:
        island_of = torch.where(center_valid, island_of, H)

    # ---- Step 4: Island Lists (hub first, then round order) --------------
    d_to_hub = sqdist(centers, _take(hub_xyz, torch.clamp(island_of, 0,
                                                          H - 1)))
    hub_idx_tgt = hub_idx if hub_ok is None else torch.where(hub_ok,
                                                             hub_idx, S)
    is_hub = torch.zeros((B, S + 1), dtype=torch.bool, device=dev)
    is_hub.scatter_(1, hub_idx_tgt, True)
    is_hub = is_hub[:, :S]
    ordr = _lexsort((d_to_hub, round_of.to(torch.float32),
                     (~is_hub).to(torch.int64), island_of))
    sorted_isl = torch.gather(island_of, 1, ordr)
    pos_in_isl = (torch.arange(S, device=dev)
                  - torch.searchsorted(sorted_isl, sorted_isl))
    M = capacity
    fits = pos_in_isl < M
    row = torch.where(fits, sorted_isl, H)
    flat = row * M + torch.clamp(pos_in_isl, 0, M - 1)
    members = torch.full((B, (H + 1) * M), -1, dtype=torch.int64, device=dev)
    members.scatter_(1, flat, ordr)
    members = members[:, :H * M].reshape(B, H, M)
    solo = torch.zeros((B, S), dtype=torch.bool, device=dev)
    solo.scatter_(1, ordr, ~fits)
    if center_valid is not None:
        solo &= center_valid
    return Islands(members=members, hub=hub_idx, solo=solo,
                   round_of=round_of)
