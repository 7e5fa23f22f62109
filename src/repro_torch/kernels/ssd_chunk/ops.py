"""Wrapper of the ssd_chunk CUDA kernel (``csrc/ssd_chunk.cu``).

A CPU tensor takes the plain PyTorch version (:func:`ssd_chunk_ref`); a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_chunk_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
# the kernel's register tiles: chunk length, head dim, state dim
MAX_Q, MAX_P, MAX_S = 64, 64, 128


def _lib():
    lib = _build.load("ssd_chunk")
    lib.ssd_chunk_forward.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    lib.ssd_chunk_forward.restype = _I
    return lib


def ssd_chunk(x, B, C, dt, cum):
    """Mamba-2 SSD intra-chunk output and chunk states.

    x (bs, nc, q, H, P); B, C (bs, nc, q, S); dt, cum (bs, nc, q, H), all
    float32.  -> (y_in (bs, nc, q, H, P), states (bs, nc, H, P, S)):
    y_in[i] = Σ_{j<=i} (C_i·B_j) exp(cum_i − cum_j) dt_j x_j per head, and
    states = Σ_j x_j exp(cum_end − cum_j) dt_j B_jᵀ."""
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, B, C, dt, cum)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: unsupported device {x.device}")
    if x.dim() != 5:
        raise ValueError(f"ssd_chunk: x has shape {tuple(x.shape)}, "
                         f"expected (bs, nc, q, H, P)")
    bs, nc, q, h, p = x.shape
    s = B.shape[-1]
    expect = {"B": (bs, nc, q, s), "C": (bs, nc, q, s),
              "dt": (bs, nc, q, h), "cum": (bs, nc, q, h)}
    ops = {"x": x, "B": B, "C": C, "dt": dt, "cum": cum}
    for arg, shape in expect.items():
        if tuple(ops[arg].shape) != shape:
            raise ValueError(f"ssd_chunk: {arg} has shape "
                             f"{tuple(ops[arg].shape)}, expected {shape}")
    if not (0 < q <= MAX_Q and 0 < p <= MAX_P and 0 < s <= MAX_S):
        raise ValueError(f"ssd_chunk: the kernel takes 0 < q <= {MAX_Q}, "
                         f"0 < P <= {MAX_P}, 0 < S <= {MAX_S}; got q={q}, "
                         f"P={p}, S={s}")
    _build.check_operands("ssd_chunk", ops, x.device)
    y = torch.empty_like(x)
    states = torch.empty((bs, nc, h, p, s), dtype=torch.float32,
                         device=x.device)
    if bs * nc * h:
        lib = _lib()
        code = lib.ssd_chunk_forward(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
            cum.data_ptr(), y.data_ptr(), states.data_ptr(), bs * nc, h, q,
            p, s, torch.cuda.current_stream(x.device).cuda_stream)
        _build.check_launch(lib, "ssd_chunk", code)
        _build.count_launch("ssd_chunk")
    return y, states
