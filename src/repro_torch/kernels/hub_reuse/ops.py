"""Wrapper of the hub_reuse CUDA kernel (``csrc/hub_reuse.cu``).

A CPU tensor takes the plain PyTorch version (:func:`hub_reuse_ref`); a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import hub_reuse_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("hub_reuse")
    lib.hub_reuse_forward.argtypes = [_P] * 9 + [_I] * 8 + [_P]
    lib.hub_reuse_forward.restype = _I
    return lib


def hub_reuse(pool_in, slot, comp, w1, b1, w2, b2, live=None):
    """Pool MLP + compensated reuse gather + masked max over K.

    pool_in (B, H, C, D) or (H, C, D) hub-relative cache inputs; slot
    (…, H, M, K) int32 cache slot per position (-1 = not cached); comp
    (…, H, M, F) per-subset compensation; live (…, H, M, K) bool (None =
    all resident).  -> (…, H, M, F) float32: max over the live slots of
    y[slot] + comp, ``-BIG`` where a subset has none."""
    if pool_in.device.type == "cpu":
        return hub_reuse_ref(pool_in, slot, comp, w1, b1, w2, b2, live)
    if pool_in.device.type != "cuda":
        raise ValueError(f"hub_reuse: unsupported device {pool_in.device}")
    single = pool_in.dim() == 3
    if single:
        pool_in, slot, comp = pool_in[None], slot[None], comp[None]
        live = None if live is None else live[None]
    if live is not None and live.dtype != torch.bool:
        live = live != 0
    b, hn, c, d = pool_in.shape
    m, k = slot.shape[-2:]
    hdim, fout = w1.shape[1], w2.shape[1]
    expect = {"slot": (b, hn, m, k), "comp": (b, hn, m, fout),
              "w1": (d, hdim), "b1": (hdim,), "w2": (hdim, fout),
              "b2": (fout,), "live": (b, hn, m, k)}
    ops = {"pool_in": pool_in, "slot": slot, "comp": comp, "w1": w1,
           "b1": b1, "w2": w2, "b2": b2, "live": live}
    for arg, shape in expect.items():
        if ops[arg] is not None and tuple(ops[arg].shape) != shape:
            raise ValueError(f"hub_reuse: {arg} has shape "
                             f"{tuple(ops[arg].shape)}, expected {shape}")
    _build.check_operands("hub_reuse", ops, pool_in.device,
                          {"slot": torch.int32, "live": torch.bool})
    out = torch.empty((b, hn, m, fout), dtype=torch.float32,
                      device=pool_in.device)
    if b * hn * m:
        lib = _lib()
        code = lib.hub_reuse_forward(
            pool_in.data_ptr(), slot.data_ptr(), comp.data_ptr(),
            None if live is None else live.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), b, hn, c, m, k, d, hdim, fout,
            torch.cuda.current_stream(pool_in.device).cuda_stream)
        _build.check_launch(lib, "hub_reuse", code)
        _build.count_launch("hub_reuse")
    return out[0] if single else out
