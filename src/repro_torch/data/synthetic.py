"""Synthetic point clouds (the port's copy of ``repro.data.synthetic``'s
cloud generator).

The public datasets (ModelNet40 and the rest) are not available offline,
so clouds are surface-sampled from composited geometric primitives
(spheres, boxes, cylinders, planes).  Surface sampling gives the
anisotropic, locally dense structure that drives L-PCN's overlap
statistics (uniform-volume noise would understate overlap).  numpy only:
the same generator state gives the same cloud as the JAX package's.
"""
from __future__ import annotations

import numpy as np


def _sphere(rng, n, c, r):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    return c + r * v


def _box(rng, n, c, s):
    face = rng.integers(0, 6, n)
    u = rng.uniform(-0.5, 0.5, (n, 3))
    axis, side = face % 3, (face // 3) * 1.0 - 0.5
    u[np.arange(n), axis] = side
    return c + u * s


def _cylinder(rng, n, c, r, h):
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-h / 2, h / 2, n)
    return c + np.stack([r * np.cos(th), r * np.sin(th), z], -1)


def _plane(rng, n, c, s):
    u = rng.uniform(-0.5, 0.5, (n, 2)) * s
    return c + np.stack([u[:, 0], u[:, 1], 0.02 * rng.normal(size=n)], -1)


def make_cloud(rng: np.random.Generator, n_points: int,
               scene_like: bool = False) -> np.ndarray:
    """One synthetic cloud (n_points, 3), normalized to the unit ball /
    room extent.  Object clouds: 3-6 primitives (CAD-surface-like);
    scenes: dominated by large planar surfaces (walls/floor) plus
    furniture-scale boxes — matching the surface concentration that
    drives the published overlap statistics on S3DIS/ScanNet."""
    prims = []
    n_parts = rng.integers(3, 7) if not scene_like else rng.integers(5, 9)
    share = rng.dirichlet(np.ones(n_parts) * 2.0) * n_points
    share = np.maximum(share.astype(int), 8)
    for pi, ns in enumerate(share):
        c = rng.uniform(-0.6, 0.6, 3)
        if scene_like:
            # 60% planes (room surfaces), 40% furniture boxes/cylinders
            kind = 3 if rng.random() < 0.6 else rng.integers(0, 3)
        else:
            kind = rng.integers(0, 3)
        if kind == 0:
            prims.append(_sphere(rng, ns, c, rng.uniform(0.1, 0.4)))
        elif kind == 1:
            prims.append(_box(rng, ns, c, rng.uniform(0.1, 0.5, 3)))
        elif kind == 2:
            prims.append(_cylinder(rng, ns, c, rng.uniform(0.05, 0.3),
                                   rng.uniform(0.2, 0.8)))
        else:
            prims.append(_plane(rng, ns, c, rng.uniform(0.8, 1.8, 2)))
    pts = np.concatenate(prims)[:n_points]
    if pts.shape[0] < n_points:  # pad by resampling
        extra = pts[rng.integers(0, pts.shape[0], n_points - pts.shape[0])]
        pts = np.concatenate([pts, extra])
    pts += 0.005 * rng.normal(size=pts.shape)  # sensor noise
    pts -= pts.mean(0)
    pts /= np.abs(pts).max() + 1e-9
    return pts.astype(np.float32)
