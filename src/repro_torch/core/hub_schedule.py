"""Hub-based Scheduling (paper §IV-B) — overlap detection + Hub Cache.

Computes the final cache contents and hit pattern of every island in
closed form: over the island's flattened point sequence (subsets in
island-list order, hub first) mark first occurrences, give cache slots to
the first ``cache_capacity`` distinct points in order, and derive the slot
serving every (subset, k) position.  Point identity is the index into the
input cloud.  Batched over (clouds, islands) where the JAX package vmaps.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .islandize import Islands, _take


@dataclass
class Schedule:
    """pool_ids:     (..., H, C) point ids resident in the Hub Cache (-1 =
                  empty slot); slots 0..K-1 hold the hub subset.
    reuse_slot:   (..., H, M, K) int32 cache slot serving the position, or
                  -1; int32 is what the hub_reuse kernel reads.
    is_first:     (..., H, M, K) bool — first occurrence of its point.
    subset_valid: (..., H, M) bool — island-list row is a real subset.
    pos_live:     (..., H, M, K) bool — real subset row and a valid
                  gathered point."""
    pool_ids: torch.Tensor
    reuse_slot: torch.Tensor
    is_first: torch.Tensor
    subset_valid: torch.Tensor
    pos_live: torch.Tensor


def build_schedule(islands: Islands, nbr_idx: torch.Tensor,
                   cache_capacity: int) -> Schedule:
    """Hub-Cache schedule of every island.  ``islands`` are batched
    (B, H, M); ``nbr_idx`` (B, S, K) are the gathered point ids."""
    B, H, M = islands.members.shape
    K = nbr_idx.shape[-1]
    C = cache_capacity
    n = M * K
    dev = nbr_idx.device

    members = islands.members
    valid_row = members >= 0
    ids = _take(nbr_idx, torch.clamp(members, 0, nbr_idx.shape[1] - 1))
    ids = torch.where(valid_row[..., None], ids, -1)             # (B,H,M,K)

    flat = ids.reshape(B, H, n)
    seq = torch.arange(n, device=dev).expand(B, H, n)
    # group occurrences of a point together, in sequence order
    sflat, order = torch.sort(flat, dim=-1, stable=True)
    first_in_group = torch.ones_like(sflat, dtype=torch.bool)
    first_in_group[..., 1:] = sflat[..., 1:] != sflat[..., :-1]
    # group start, propagated along the group by a running max
    group_start = torch.cummax(torch.where(first_in_group, seq, 0),
                               dim=-1).values
    leader_seq = torch.gather(order, -1, group_start)
    is_first = torch.zeros_like(first_in_group).scatter_(
        -1, order, first_in_group)
    leader_of = torch.zeros_like(order).scatter_(-1, order, leader_seq)
    live = flat >= 0
    is_first = is_first & live
    slot_of_pos = torch.where(is_first, torch.cumsum(is_first, -1) - 1, -1)
    cached_leader = is_first & (slot_of_pos < C)
    leader_slot = torch.gather(slot_of_pos, -1, leader_of)
    leader_cached = torch.gather(cached_leader, -1, leader_of)
    reuse = torch.where(live & leader_cached, leader_slot, -1)
    pool = torch.full((B, H, C + 1), -1, dtype=torch.int64, device=dev)
    pool.scatter_(-1, torch.where(cached_leader, slot_of_pos, C),
                  torch.where(cached_leader, flat, -1))
    return Schedule(pool_ids=pool[..., :C],
                    reuse_slot=reuse.reshape(B, H, M, K).to(torch.int32),
                    is_first=is_first.reshape(B, H, M, K),
                    subset_valid=valid_row, pos_live=ids >= 0)
