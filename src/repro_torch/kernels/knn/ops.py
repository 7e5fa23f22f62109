"""Wrapper of the knn CUDA kernel (``csrc/knn.cu``).

A CPU tensor takes the plain PyTorch version (:func:`knn_ref`); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import knn_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_K = 64           # the kernel keeps k entries in 2 registers per lane


def _lib():
    lib = _build.load("knn")
    lib.knn_forward.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    lib.knn_forward.restype = _I
    return lib


def knn(centers, points, k: int):
    """Brute-force k nearest neighbours.

    centers (S, 3), points (N, 3) float32; 0 <= k <= N.  -> ((S, k) float32
    squared distances ``(|c|² + |p|²) − 2·c·p``, (S, k) int32 indices into
    ``points``), nearest first, ties to the lower index."""
    n = points.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"knn: need 0 <= k <= N, got k={k}, N={n}")
    if centers.device.type == "cpu":
        return knn_ref(centers, points, k)
    if centers.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {centers.device}")
    if k > MAX_K:
        raise ValueError(f"knn: the kernel takes k <= {MAX_K}, got {k}")
    for arg, t in (("centers", centers), ("points", points)):
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"knn: {arg} has shape {tuple(t.shape)}, "
                             f"expected (*, 3)")
    _build.check_operands("knn", {"centers": centers, "points": points},
                          centers.device)
    s = centers.shape[0]
    dists = torch.empty((s, k), dtype=torch.float32, device=centers.device)
    idx = torch.empty((s, k), dtype=torch.int32, device=centers.device)
    if s * k:
        lib = _lib()
        code = lib.knn_forward(
            centers.data_ptr(), points.data_ptr(), dists.data_ptr(),
            idx.data_ptr(), s, n, k,
            torch.cuda.current_stream(centers.device).cuda_stream)
        _build.check_launch(lib, "knn", code)
        _build.LAUNCHES["knn"] += 1
    return dists, idx
