"""Linear octree over Morton-sorted points (the paper's octree-search
engine as array primitives): a node is a contiguous range of the sorted
codes found by ``searchsorted``, membership is ``searchsorted`` plus an
equality test, and adjacency is decode, ±1 per axis, re-encode.  Every
query runs over the tree's leading cloud axes."""
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

    def node_keys(self, level: int) -> torch.Tensor:
        """Per sorted point: its octree-node key at ``level``."""
        return morton.node_key(self.codes, level, self.depth)

    def node_range(self, key: torch.Tensor, level: int):
        """[start, end) of node ``key`` at ``level`` in the sorted codes;
        ``key`` is (..., *Q) over the tree's leading axes.  The bounds
        wrap at 32 bits as the JAX package's uint32 ones do."""
        shift = 3 * (self.depth - level)
        lo = (key << shift) & morton.SENTINEL
        hi = (((key + 1) & morton.SENTINEL) << shift) & morton.SENTINEL
        return (searchsorted(self.codes, lo), searchsorted(self.codes, hi))

    def contains(self, query_codes: torch.Tensor):
        """Exact membership of full-depth codes (..., *Q) (the Overlap
        Detection hit test) -> (hit mask, sorted index of the hit or
        -1)."""
        pos = searchsorted(self.codes, query_codes)
        pos = torch.clamp(pos, 0, self.codes.shape[-1] - 1)
        hit = _take_last(self.codes, pos) == query_codes
        return hit, torch.where(hit, pos, -1)


def _take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N) at idx (..., *Q) whose leading axes are x's."""
    lead = x.shape[:-1]
    return torch.gather(x, -1, idx.reshape(lead + (-1,))).reshape(idx.shape)


def searchsorted(sorted_seq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Left ``searchsorted`` of q (..., *Q) into each sorted row of
    ``sorted_seq`` (..., N) with the same leading axes."""
    lead = sorted_seq.shape[:-1]
    return torch.searchsorted(sorted_seq, q.reshape(lead + (-1,)).contiguous()
                              ).reshape(q.shape)


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


def prune(tree: LinearOctree, keep_sorted_idx: torch.Tensor) -> LinearOctree:
    """The paper's Pruning Module: the Sampled Octree is the Input Octree
    restricted to the sampled points; ``keep_sorted_idx`` (..., K) indexes
    the sorted arrays."""
    return LinearOctree(codes=torch.gather(tree.codes, -1, keep_sorted_idx),
                        order=torch.gather(tree.order, -1, keep_sorted_idx),
                        depth=tree.depth)


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
