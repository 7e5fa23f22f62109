"""Linear octree over Morton-sorted points (the paper's octree-search
engine as array primitives): a node is a contiguous range of the sorted
codes, and adjacency is decode, ±1 per axis, re-encode."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import morton


@dataclass
class LinearOctree:
    """codes: (..., N) sorted Morton codes; order: (..., N) permutation
    with codes[i] belonging to points[order[i]]; depth: code depth."""
    codes: torch.Tensor
    order: torch.Tensor
    depth: int


def build(points: torch.Tensor, depth: int = morton.MAX_DEPTH, lo=None,
          hi=None, n_valid=None) -> LinearOctree:
    """Linear octree of clouds (..., N, 3).  ``n_valid`` (...) marks rows
    >= n_valid as padding: their codes become the sentinel, so the order
    is valid-first, and the box comes from valid rows only."""
    valid = None
    if n_valid is not None:
        valid = (torch.arange(points.shape[-2], device=points.device)
                 < torch.as_tensor(n_valid, device=points.device)[..., None])
        if lo is None and hi is None:
            lo, hi = morton.masked_bounds(points, valid)
    codes = morton.morton_codes(points, depth, lo, hi)
    if valid is not None:
        codes = torch.where(valid, codes, morton.SENTINEL)
    codes, order = torch.sort(codes, dim=-1, stable=True)
    return LinearOctree(codes=codes, order=order, depth=depth)


def adjacent_node_keys(keys: torch.Tensor, level: int,
                       depth: int = morton.MAX_DEPTH) -> torch.Tensor:
    """26-neighbourhood (+ self) keys of octree nodes at ``level``:
    (...) -> (..., 27).  Out-of-bounds neighbours repeat the node's key."""
    del depth
    side = 1 << level
    xyz = morton.decode(keys)                                  # (..., 3)
    r = torch.arange(-1, 2, device=keys.device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(27, 3)
    nxyz = xyz[..., None, :] + offs                            # (..., 27, 3)
    valid = ((nxyz >= 0) & (nxyz < side)).all(-1)
    nkeys = morton.encode(torch.clamp(nxyz, 0, side - 1))
    return torch.where(valid, nkeys, keys[..., None])
