"""Wrapper of the knn CUDA kernel (``csrc/knn.cu``).

A CPU tensor takes the plain PyTorch version (:func:`knn_ref`); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, plans
from .ref import knn_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the kernel keeps lists of up to this many entries in shared memory
# (csrc/knn.cu kSmemLists); a longer k asks for device scratch
SMEM_K = 1024


def _declare(lib):
    lib.knn_forward.argtypes = [_P] * 4 + [_I] * 3 + [_P, _L, _P]
    lib.knn_forward.restype = _I
    lib.knn_scratch_bytes.argtypes = [_I] * 3
    lib.knn_scratch_bytes.restype = _L
    lib.knn_plan.argtypes = [_I] * 3 + [_P]
    lib.knn_plan.restype = None
    lib.knn_smem_bytes.argtypes = [_I] * 3
    lib.knn_smem_bytes.restype = _L


def _lib():
    return _build.load("knn", _declare)


def plan(s: int, n: int, k: int) -> dict:
    """How the kernel splits a call: warps a center (``w``), list
    registers a lane (``r``; 0: lists in memory), lists in device memory
    (``scratch``), blocks (``grid``)."""
    out = (ctypes.c_int * 4)()
    _lib().knn_plan(s, n, k, out)
    return dict(w=out[0], r=out[1], scratch=bool(out[2]), grid=out[3])


def library_smem(s: int, n: int, k: int) -> int:
    """A block's shared memory in the call's launch, as the built kernel
    counts it (0 for widths it does not take)."""
    return _lib().knn_smem_bytes(s, n, k)


def knn(centers, points, k: int):
    """Brute-force k nearest neighbours.

    centers (S, 3), points (N, 3) float32; 0 <= k <= N.  -> ((S, k) float32
    squared distances ``(|c|² + |p|²) − 2·c·p``, (S, k) int32 indices into
    ``points``), nearest first, ties to the lower index."""
    _build.refuse_dtensor("knn", (centers, points))
    n = points.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"knn: need 0 <= k <= N, got k={k}, N={n}")
    dev = centers.device
    if plans.capturing():
        # the launch the call makes (the library's plan where it runs)
        pl = {"route": None}
        if dev.type == "cuda" and centers.shape[0] * k:
            pl.update(plan(centers.shape[0], n, k))
        plans.note_plan("knn", dict(s=centers.shape[0], n=n, k=k), pl)
    if dev.type == "cpu":
        return knn_ref(centers, points, k)
    if dev.type != "cuda":
        raise ValueError(f"knn: unsupported device {dev}")
    _build.refuse_grad("knn", (centers, points),
                       "PCN training takes its neighbors from the plain "
                       "core.neighbor.knn_bruteforce, as the JAX package "
                       "does")
    for arg, t in (("centers", centers), ("points", points)):
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"knn: {arg} has shape {tuple(t.shape)}, "
                             f"expected (*, 3)")
    _build.check_operands("knn", {"centers": centers, "points": points},
                          dev)
    s = centers.shape[0]
    # one allocation: distances in the first half, indices in the second
    out = torch.empty((2, s, k), dtype=torch.int32, device=dev)
    dists, idx = out[0].view(torch.float32), out[1]
    if s * k:
        lib = _lib()
        scratch, nbytes = None, 0
        if k > SMEM_K:
            nbytes = lib.knn_scratch_bytes(s, n, k)
            if nbytes:
                scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        code = lib.knn_forward(
            centers.data_ptr(), points.data_ptr(), dists.data_ptr(),
            idx.data_ptr(), s, n, k,
            None if scratch is None else scratch.data_ptr(), nbytes,
            torch._C._cuda_getCurrentRawStream(dev.index))
        _build.check_launch(lib, "knn", code)
        _build.count_launch("knn")
    return dists, idx
