"""Neighbor Search Module — accurate and approximate neighbor gathering.

The four baseline accelerators differ only in this step (paper §VI-A):

  * accurate: PointACC (brute-force rank), HgPCN (octree-narrowed rank);
  * approximate: EdgePC (Morton window), Crescent (tree buckets);

plus PointNet++'s own ball query.  Every function takes clouds with
leading batch axes and returns int64 indices into ``points``.

Ragged contract: with ``n_valid`` a padding row is never returned; the
accurate methods mark slots they cannot fill with a valid point ``-1``,
the window/bucket approximations repeat valid candidates instead.  Each
ranking is a stable ascending sort of the distances, so ties go to the
lower candidate position, as ``lax.top_k`` breaks them.
"""
from __future__ import annotations

import torch

from . import morton
from .octree import LinearOctree, adjacent_node_keys, searchsorted
from .sampling import sqdist


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., S, 3), (..., N, 3) -> (..., S, N) squared distances."""
    return sqdist(a[..., :, None, :], b[..., None, :, :])


def _count(points: torch.Tensor, n_valid) -> torch.Tensor:
    """The valid count of each cloud, (...) int64 (N without padding)."""
    if n_valid is None:
        return torch.full(points.shape[:-2], points.shape[-2],
                          dtype=torch.int64, device=points.device)
    return torch.as_tensor(n_valid, device=points.device)


def _valid_cols(points: torch.Tensor, n_valid) -> torch.Tensor:
    """(..., 1, N) bool: row j of each cloud is below its valid count."""
    ar = torch.arange(points.shape[-2], device=points.device)
    return (ar < _count(points, n_valid)[..., None])[..., None, :]


def masked_sqdist(centers: torch.Tensor, points: torch.Tensor,
                  n_valid=None) -> torch.Tensor:
    """(..., S, N) squared distances, padding columns pinned to +inf."""
    d = pairwise_sqdist(centers, points)
    if n_valid is None:
        return d
    return torch.where(_valid_cols(points, n_valid), d, float("inf"))


def masked_bounds(points: torch.Tensor, n_valid=None):
    """Bounding box of each cloud's valid prefix: padding cannot shift
    the Morton quantization."""
    if n_valid is None:
        return morton.masked_bounds(points)
    valid = _valid_cols(points, n_valid)[..., 0, :]
    return morton.masked_bounds(points, valid)


def _smallest(d: torch.Tensor, k: int):
    """The k smallest of the last axis, ascending, ties to the lower
    index: (values, indices)."""
    dk, idx = torch.sort(d, dim=-1, stable=True)
    return dk[..., :k], idx[..., :k]


def _window(order: torch.Tensor, start: torch.Tensor, width: int,
            count: torch.Tensor) -> torch.Tensor:
    """``order`` (..., N) at sorted positions start + [0, width), start
    (..., S), clipped to each cloud's valid prefix -> (..., S, width).  An
    empty cloud clips to -1, which indexes the last row, as a negative
    index does in JAX."""
    n = order.shape[-1]
    pos = start[..., None] + torch.arange(width, device=order.device)
    pos = torch.minimum(torch.clamp(pos, min=0), (count - 1)[..., None, None])
    pos = torch.where(pos < 0, pos + n, pos)
    return torch.take_along_dim(order[..., None, :], pos, dim=-1)


def _rank_candidates(points, centers, cand, k):
    """The k nearest of each center's candidate ids (..., S, W)."""
    cpts = torch.take_along_dim(points[..., None, :, :], cand[..., None],
                                dim=-2)                       # (..., S, W, 3)
    _, j = _smallest(sqdist(cpts, centers[..., :, None, :]), k)
    return torch.take_along_dim(cand, j, dim=-1)


def knn_bruteforce(points: torch.Tensor, centers: torch.Tensor, k: int,
                   n_valid=None) -> torch.Tensor:
    """Accurate kNN (PointACC's ranking): (..., S, k) nearest first;
    ``-1`` beyond the valid count."""
    dk, idx = _smallest(masked_sqdist(centers, points, n_valid), k)
    if n_valid is not None:
        idx = torch.where(torch.isfinite(dk), idx, -1)
    return idx


def ball_query(points: torch.Tensor, centers: torch.Tensor, radius: float,
               k: int, n_valid=None) -> torch.Tensor:
    """PointNet++ ball query: the first k points (by index) within
    ``radius``; slots past the in-radius count repeat the first in-radius
    point.  Unmasked, an empty radius falls back to point 0; with
    ``n_valid`` padding is never in radius and an empty radius gives an
    all ``-1`` row.  ``radius`` is squared in float32, as JAX squares a
    traced float."""
    d = pairwise_sqdist(centers, points)
    r = torch.tensor(radius, dtype=torch.float32, device=points.device)
    inb = d <= r * r
    if n_valid is not None:
        inb &= _valid_cols(points, n_valid)
    n = points.shape[-2]
    ranked = torch.where(inb, torch.arange(n, device=points.device), n)
    vals, idx = _smallest(ranked, k)
    got = vals < n
    first = idx[..., :1]
    if n_valid is not None:
        first = torch.where(got[..., :1], first, -1)
    return torch.where(got, idx, first)


def knn_morton_window(tree: LinearOctree, points: torch.Tensor,
                      centers: torch.Tensor, k: int, window: int = 128,
                      n_valid=None) -> torch.Tensor:
    """EdgePC-style approximate kNN: the candidates are ``window`` points
    around the center's position in Morton order, ranked exactly.  With
    ``n_valid`` the window slides over the valid prefix of a valid-first
    tree, so a short prefix repeats candidates and never gives padding."""
    lo, hi = masked_bounds(points, n_valid)
    pos = searchsorted(tree.codes, morton.morton_codes(centers, tree.depth,
                                                       lo=lo, hi=hi))
    count = _count(points, n_valid)
    start = torch.minimum(torch.clamp(pos - window // 2, min=0),
                          torch.clamp(count - window, min=0)[..., None])
    return _rank_candidates(points, centers,
                            _window(tree.order, start, window, count), k)


def knn_octree(tree: LinearOctree, points: torch.Tensor,
               centers: torch.Tensor, k: int, level: int = 6,
               n_valid=None) -> torch.Tensor:
    """HgPCN-style accurate kNN narrowed by the octree: the candidates are
    the points of the center's node at ``level`` and its 26 neighbours,
    ranked exactly; a center with fewer than k valid candidates ranks
    every valid point instead.  Distances live in sorted-position space
    and map back through ``tree.order``; unfillable slots are ``-1``.

    Membership ORs 27 (..., S, N) comparisons one neighbour key at a time,
    so no (S, N, 27) mask is held."""
    lo, hi = masked_bounds(points, n_valid)
    ccodes = morton.morton_codes(centers, tree.depth, lo=lo, hi=hi)
    nkeys = adjacent_node_keys(morton.node_key(ccodes, level, tree.depth),
                               level, tree.depth)            # (..., S, 27)
    pkeys = tree.node_keys(level)[..., None, :]               # (..., 1, N)
    member = pkeys == nkeys[..., 0:1]
    for t in range(1, nkeys.shape[-1]):
        member |= pkeys == nkeys[..., t:t + 1]
    spts = torch.take_along_dim(points, tree.order[..., None], dim=-2)
    d_true = pairwise_sqdist(centers, spts)
    if n_valid is not None:
        sorted_ok = _valid_cols(points, n_valid)
        member &= sorted_ok
        d_true = torch.where(sorted_ok, d_true, float("inf"))
    d = torch.where(member, d_true, float("inf"))
    enough = member.sum(-1, keepdim=True) >= k
    dk, j = _smallest(torch.where(enough, d, d_true), k)
    out = torch.take_along_dim(tree.order[..., None, :], j, dim=-1)
    if n_valid is not None:
        out = torch.where(torch.isfinite(dk), out, -1)
    return out


def knn_kdtree_approx(points: torch.Tensor, centers: torch.Tensor, k: int,
                      leaf: int = 64, n_valid=None) -> torch.Tensor:
    """Crescent-style approximate kNN: Morton-ordered buckets of ``leaf``
    points stand in for the KD tree's; the candidates are the center's
    bucket and the adjacent half buckets (2·leaf points), ranked exactly.
    Padding sorts to the back with sentinel codes and the buckets cover
    only the valid prefix."""
    lo, hi = masked_bounds(points, n_valid)
    codes = morton.morton_codes(points, lo=lo, hi=hi)
    if n_valid is not None:
        codes = torch.where(_valid_cols(points, n_valid)[..., 0, :], codes,
                            morton.SENTINEL)
    scodes, order = torch.sort(codes, dim=-1, stable=True)
    pos = searchsorted(scodes, morton.morton_codes(centers, lo=lo, hi=hi))
    count = _count(points, n_valid)[..., None]
    bucket = torch.minimum(pos // leaf, torch.clamp(count // leaf - 1, min=0))
    start = torch.minimum(torch.clamp(bucket * leaf - leaf // 2, min=0),
                          torch.clamp(count - 2 * leaf, min=0))
    return _rank_candidates(points, centers,
                            _window(order, start, 2 * leaf, count[..., 0]),
                            k)


METHODS = {
    "pointacc": "knn_bruteforce",     # accurate, brute-force rank
    "hgpcn": "knn_octree",            # accurate, octree-narrowed
    "edgepc": "knn_morton_window",    # approximate, Morton window
    "crescent": "knn_kdtree_approx",  # approximate, tree buckets
}
