"""Morton (Z-order) codes — the octree linearization used throughout L-PCN.

Codes are 30-bit (10 bits per axis) and held in int64 tensors, with
``SENTINEL = 0xFFFFFFFF`` above every real code, so they equal the JAX
package's uint32 codes value for value.  ``quantize`` evaluates
``(p − lo) / extent · n`` in that exact float32 operation order, so the
codes match bit for bit.  ``np_morton_codes`` is the numpy twin (float64
quantization, uint32 codes) for analytics and dataset tooling.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_DEPTH = 10
SENTINEL = 0xFFFFFFFF


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` two zero bits apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_part1by2`."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def masked_bounds(points: torch.Tensor, valid: torch.Tensor | None = None):
    """(lo, hi) box over the rows of ``points`` (..., N, 3) where ``valid``
    (..., N) is True (None = all rows): padding cannot shift it."""
    if valid is None:
        return points.amin(-2), points.amax(-2)
    ok = valid[..., None]
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    return (torch.where(ok, points, inf).amin(-2),
            torch.where(ok, points, -inf).amax(-2))


def quantize(points: torch.Tensor, depth: int = MAX_DEPTH, lo=None,
             hi=None) -> torch.Tensor:
    """(..., N, 3) float -> (..., N, 3) int64 voxel coords in
    [0, 2**depth); ``lo``/``hi`` (..., 3) default to the cloud's box."""
    if lo is None:
        lo = points.amin(-2)
    if hi is None:
        hi = points.amax(-2)
    extent = torch.clamp((hi - lo).amax(-1), min=1e-9)[..., None, None]
    n = (1 << depth) - 1
    scaled = (points - lo[..., None, :]) / extent * n
    return torch.clamp(scaled, 0, n).to(torch.int64)


def encode(ivox: torch.Tensor) -> torch.Tensor:
    """Interleave integer voxel coords (..., 3) -> Morton codes (...)."""
    return (_part1by2(ivox[..., 0]) | (_part1by2(ivox[..., 1]) << 1)
            | (_part1by2(ivox[..., 2]) << 2))


def decode(codes: torch.Tensor) -> torch.Tensor:
    """Morton codes (...) -> (..., 3) int64 voxel coordinates."""
    return torch.stack([_compact1by2(codes), _compact1by2(codes >> 1),
                        _compact1by2(codes >> 2)], dim=-1)


def morton_codes(points: torch.Tensor, depth: int = MAX_DEPTH, lo=None,
                 hi=None) -> torch.Tensor:
    """points (..., N, 3) -> Morton codes (..., N) at ``depth``."""
    return encode(quantize(points, depth, lo, hi))


def node_key(codes: torch.Tensor, depth: int,
             full_depth: int = MAX_DEPTH) -> torch.Tensor:
    """Octree-node key at ``depth`` of a code made at ``full_depth``."""
    return codes >> (3 * (full_depth - depth))


# ---- numpy twins (analytics / dataset tooling) -----------------------------

def _np_part1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(0x3FF)
    x = (x | (x << np.uint32(16))) & np.uint32(0x030000FF)
    x = (x | (x << np.uint32(8))) & np.uint32(0x0300F00F)
    x = (x | (x << np.uint32(4))) & np.uint32(0x030C30C3)
    x = (x | (x << np.uint32(2))) & np.uint32(0x09249249)
    return x


def np_morton_codes(points: np.ndarray, depth: int = MAX_DEPTH,
                    lo=None, hi=None) -> np.ndarray:
    """points (..., 3) -> uint32 Morton codes, quantized in float64 over
    the box of all points (``lo``/``hi`` override it)."""
    pts = np.asarray(points, dtype=np.float64)
    if lo is None:
        lo = pts.reshape(-1, 3).min(axis=0)
    if hi is None:
        hi = pts.reshape(-1, 3).max(axis=0)
    extent = max(float(np.max(np.asarray(hi) - np.asarray(lo))), 1e-9)
    n = (1 << depth) - 1
    iv = np.clip((pts - lo) / extent * n, 0, n).astype(np.uint32)
    return (_np_part1by2(iv[..., 0])
            | (_np_part1by2(iv[..., 1]) << np.uint32(1))
            | (_np_part1by2(iv[..., 2]) << np.uint32(2)))
