"""Wrapper of the gather_mlp CUDA kernel (``csrc/gather_mlp.cu``, 3xTF32
on the tensor cores).

A CPU tensor takes the plain PyTorch version (:func:`gather_mlp_ref`); a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import gather_mlp_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("gather_mlp")
    lib.gather_mlp_forward.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.gather_mlp_forward.restype = _I
    lib.gather_mlp_row_tile.argtypes = [_I] * 3
    lib.gather_mlp_row_tile.restype = _I
    return lib


def row_tile(b: int, s: int, k: int) -> int:
    """Rows per tile (64 or 128) the kernel takes for b·s subsets of k
    points on the current CUDA device."""
    return _lib().gather_mlp_row_tile(b, s, k)


def gather_mlp(raw, centers, w1, b1, w2, b2, mask=None):
    """Fused normalize → 2-layer MLP → max over K.

    raw (B, S, K, D) or (S, K, D); centers (…, S, Dc) subtracted from the
    leading Dc lanes of raw; w1 (D, H), b1 (H,), w2 (H, F), b2 (F,);
    mask (…, S, K) bool marks live positions (None = all), and a subset
    with none live gives a zero row.  -> (…, S, F) float32."""
    if raw.device.type == "cpu":
        return gather_mlp_ref(raw, centers, w1, b1, w2, b2, mask)
    if raw.device.type != "cuda":
        raise ValueError(f"gather_mlp: unsupported device {raw.device}")
    single = raw.dim() == 3
    if single:
        raw, centers = raw[None], centers[None]
        mask = None if mask is None else mask[None]
    if mask is not None and mask.dtype != torch.bool:
        mask = mask != 0
    b, s, k, d = raw.shape
    dc, hdim, fout = centers.shape[-1], w1.shape[1], w2.shape[1]
    expect = {"centers": (b, s, dc), "w1": (d, hdim), "b1": (hdim,),
              "w2": (hdim, fout), "b2": (fout,), "mask": (b, s, k)}
    ops = {"raw": raw, "centers": centers, "w1": w1, "b1": b1, "w2": w2,
           "b2": b2, "mask": mask}
    for arg, shape in expect.items():
        if ops[arg] is not None and tuple(ops[arg].shape) != shape:
            raise ValueError(f"gather_mlp: {arg} has shape "
                             f"{tuple(ops[arg].shape)}, expected {shape}")
    if not 0 < dc <= d:
        raise ValueError(f"gather_mlp: need 0 < Dc={dc} <= D={d}")
    _build.check_operands("gather_mlp", ops, raw.device,
                          {"mask": torch.bool})
    out = torch.empty((b, s, fout), dtype=torch.float32, device=raw.device)
    if b * s:
        lib = _lib()
        code = lib.gather_mlp_forward(
            raw.data_ptr(), centers.data_ptr(),
            None if mask is None else mask.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), b, s, k, d, dc, hdim, fout,
            torch.cuda.current_stream(raw.device).cuda_stream)
        _build.check_launch(lib, "gather_mlp", code)
        _build.count_launch("gather_mlp")
    return out[0] if single else out
