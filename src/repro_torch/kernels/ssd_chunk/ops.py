"""Wrappers of the ssd_chunk CUDA kernels: the forward
(``csrc/ssd_chunk.cu``) and its gradient (``csrc/ssd_chunk_bwd.cu``),
joined by :class:`SsdChunkFn`.

A CPU tensor takes the plain PyTorch versions (:func:`ssd_chunk_ref`,
:func:`ssd_chunk_bwd_ref`); a CUDA tensor launches the kernel or raises.
Both kernels take any chunk length q, in two routes (:func:`route`):
``"whole"`` for q <= :data:`MAX_Q`, which keeps the chunk's C·Bᵀ in
shared memory, and ``"tiled"`` above it, which splits the chunk's rows
(forward) or columns (backward) across blocks, each forming its share of
C·Bᵀ once a head group (Mamba-2's published chunk is 256).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, plans
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
# the longest chunk of the "whole" route (csrc/ssd_chunk.cu kQMax: C·Bᵀ
# and two x tiles of q rows in shared memory); longer chunks take the
# "tiled" route; P and S are tiled, any size
MAX_Q = 128
# the backward's kernels, each launched once a call, in this order: per
# (chunk, head group) dx, ddt, dcum and the group's partial sums; per
# chunk the partial sums added in a fixed order, then dB and dC
SSD_BWD_PASSES = ("heads", "chunk")
# ssd_chunk_backward_plan's fields, in order (the heads pass's launch,
# its grid's y and the scratch the call takes, in floats)
BWD_PLAN = ("heads_a_group", "groups", "warps", "blocks_an_sm",
            "smem_bytes", "b_resident", "state_term_on_chip", "tiled",
            "grid_y", "scratch")


# what ssd_chunk_plan reports: the forward's launch
PLAN = ("qp", "hg", "grid_x", "grid_y", "smem", "tiled")


def route(q: int) -> str:
    """The route both kernels take for chunks of q rows."""
    return "whole" if q <= MAX_Q else "tiled"


def _declare(lib):
    lib.ssd_chunk_forward.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    lib.ssd_chunk_forward.restype = _I
    lib.ssd_chunk_plan.argtypes = [_I] * 5 + [_P]
    lib.ssd_chunk_plan.restype = _I


def _lib():
    return _build.load("ssd_chunk", _declare)


def library_plan(bn: int, h: int, q: int, p: int, s: int) -> dict:
    """The forward's launch at these widths, as the library plans it on
    the current device (``PLAN``: q padded (to 16, or to the tiled
    route's 64-row tiles), heads a block, the grid, a block's shared
    memory and whether the route is the tiled one).  Loads the library,
    so a card is needed: the plan follows its SM count."""
    lib = _lib()
    out = (ctypes.c_longlong * len(PLAN))()
    code = lib.ssd_chunk_plan(bn, h, q, p, s, out)
    _build.check_launch(lib, "ssd_chunk", code)
    return dict(zip(PLAN, out))


def _declare_bwd(lib):
    lib.ssd_chunk_backward.argtypes = [_P] * 13 + [_I] * 5 + [_P]
    lib.ssd_chunk_backward.restype = _I
    lib.ssd_chunk_backward_scratch.argtypes = [_I] * 5
    lib.ssd_chunk_backward_scratch.restype = ctypes.c_longlong
    lib.ssd_chunk_backward_plan.argtypes = [_I] * 5 + [_P]
    lib.ssd_chunk_backward_plan.restype = _I


def _lib_bwd():
    return _build.load("ssd_chunk_bwd", _declare_bwd)


def backward_plan(bs, nc, q, h, p, s) -> dict:
    """The heads pass's launch at these widths, as the library plans it
    (``BWD_PLAN``: heads a group, its warps and shared memory, whether B
    and the state term of dB stay on chip, whether the route is the tiled
    one, the grid's y and the scratch in floats).  Loads the library, so a
    card is needed: the plan follows its SM count."""
    lib = _lib_bwd()
    out = (ctypes.c_longlong * len(BWD_PLAN))()
    code = lib.ssd_chunk_backward_plan(bs * nc, h, q, p, s, out)
    _build.check_launch(lib, "ssd_chunk_bwd", code)
    return dict(zip(BWD_PLAN, out))


def ssd_chunk(x, B, C, dt, cum):
    """Mamba-2 SSD intra-chunk output and chunk states, differentiable
    through :class:`SsdChunkFn` (its backward is
    :func:`ssd_chunk_backward`).

    x (bs, nc, q, H, P); B, C (bs, nc, q, S); dt, cum (bs, nc, q, H), all
    float32.  -> (y_in (bs, nc, q, H, P), states (bs, nc, H, P, S)):
    y_in[i] = Σ_{j<=i} (C_i·B_j) exp(cum_i − cum_j) dt_j x_j per head, and
    states = Σ_j x_j exp(cum_end − cum_j) dt_j B_jᵀ."""
    _build.refuse_dtensor("ssd_chunk", (x, B, C, dt, cum))
    return SsdChunkFn.apply(x, B, C, dt, cum)


class SsdChunkFn(torch.autograd.Function):
    """ssd_chunk with its gradient: the forward kernel, and the backward
    kernel on the five saved inputs (the plain versions on CPU
    tensors)."""

    @staticmethod
    def forward(ctx, x, B, C, dt, cum):
        ctx.save_for_backward(x, B, C, dt, cum)
        return _forward(x, B, C, dt, cum)

    @staticmethod
    def backward(ctx, dy, dst):
        # an output that does not reach the loss comes as zeros
        return ssd_chunk_backward(*ctx.saved_tensors, dy.contiguous(),
                                  dst.contiguous())


def _check_shapes(name, x, B, ops):
    if x.dim() != 5:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, expected "
                         f"(bs, nc, q, H, P)")
    bs, nc, q, h, p = x.shape
    s = B.shape[-1]
    expect = {"B": (bs, nc, q, s), "C": (bs, nc, q, s),
              "dt": (bs, nc, q, h), "cum": (bs, nc, q, h),
              "dy": (bs, nc, q, h, p), "dst": (bs, nc, h, p, s)}
    for arg, t in ops.items():
        if arg in expect and tuple(t.shape) != expect[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {expect[arg]}")
    if not (q > 0 and p > 0 and s > 0):
        raise ValueError(f"{name}: the kernel takes chunks of q > 0 rows "
                         f"and P, S > 0; got q={q}, P={p}, S={s}")
    return bs, nc, q, h, p, s


def _forward(x, B, C, dt, cum):
    """The forward of :func:`ssd_chunk`, without autograd's wiring."""
    if plans.capturing() and x.dim() == 5:
        bs, nc, q, h, p = x.shape
        plans.note_plan("ssd_chunk", dict(bn=bs * nc, h=h, q=q, p=p,
                                          s=B.shape[-1]), {"route": route(q)})
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, B, C, dt, cum)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: unsupported device {x.device}")
    ops = {"x": x, "B": B, "C": C, "dt": dt, "cum": cum}
    bs, nc, q, h, p, s = _check_shapes("ssd_chunk", x, B, ops)
    _build.check_operands("ssd_chunk", ops, x.device)
    # one allocation: y_in first, the states after it
    n_y = x.numel()
    out = torch.empty(n_y + bs * nc * h * p * s, dtype=torch.float32,
                      device=x.device)
    y, states = out[:n_y].view(x.shape), out[n_y:].view(bs, nc, h, p, s)
    if bs * nc * h:
        lib = _lib()
        code = lib.ssd_chunk_forward(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
            cum.data_ptr(), y.data_ptr(), states.data_ptr(), bs * nc, h, q,
            p, s, torch._C._cuda_getCurrentRawStream(x.device.index))
        _build.check_launch(lib, "ssd_chunk", code)
        _build.count_launch("ssd_chunk", f"ssd_chunk_{route(q)}")
    return y, states


def ssd_chunk_backward(x, B, C, dt, cum, dy, dst):
    """The gradient of :func:`ssd_chunk`: its five inputs and the
    outputs' gradients dy (bs, nc, q, H, P) and dst (bs, nc, H, P, S),
    all float32.  -> (dx, dB, dC, ddt, dcum) in the inputs' shapes (see
    :func:`ssd_chunk_bwd_ref` for the closed form).  On a CUDA device
    every operand contiguous, any q (the route of :func:`route`);
    ``len(SSD_BWD_PASSES)`` launches, no atomics (the same inputs give the
    same bits)."""
    _build.refuse_dtensor("ssd_chunk_backward", (x, B, C, dt, cum, dy, dst))
    if x.device.type == "cpu":
        return ssd_chunk_bwd_ref(x, B, C, dt, cum, dy, dst)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_backward: unsupported device "
                         f"{x.device}")
    ops = {"x": x, "B": B, "C": C, "dt": dt, "cum": cum, "dy": dy,
           "dst": dst}
    bs, nc, q, h, p, s = _check_shapes("ssd_chunk_backward", x, B, ops)
    _build.check_operands("ssd_chunk_backward", ops, x.device)
    dx, dB, dC = (torch.empty_like(t) for t in (x, B, C))
    ddt, dcum = torch.empty_like(dt), torch.empty_like(cum)
    if bs * nc * h == 0:
        return dx, dB.zero_(), dC.zero_(), ddt, dcum
    lib = _lib_bwd()
    # each head group's partial dCB and state term of dB, from the first
    # pass to the second
    scratch = torch.empty(lib.ssd_chunk_backward_scratch(bs * nc, h, q, p,
                                                         s),
                          dtype=torch.float32, device=x.device)
    code = lib.ssd_chunk_backward(
        x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
        cum.data_ptr(), dy.data_ptr(), dst.data_ptr(), dx.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(), dcum.data_ptr(),
        scratch.data_ptr(), bs * nc, h, q, p, s,
        torch._C._cuda_getCurrentRawStream(x.device.index))
    _build.check_launch(lib, "ssd_chunk_bwd", code)
    for _ in SSD_BWD_PASSES:
        _build.count_launch("ssd_chunk_bwd", f"ssd_chunk_bwd_{route(q)}")
    return dx, dB, dC, ddt, dcum
