"""Wrapper of the gather_mlp CUDA kernel (``csrc/gather_mlp.cu``, 3xTF32
on the tensor cores).

A CPU tensor takes the plain PyTorch version (:func:`gather_mlp_ref`); a
CUDA tensor launches the kernel or raises.  The kernel has two routes
(:func:`route`): ``"narrow"`` keeps a row tile's h whole in shared memory,
``"wide"`` holds it in 64-column chunks where whole h does not fit.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import gather_mlp_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_SMEM = 232448          # a block's shared memory on Hopper, bytes
ROUTES = ("narrow", "wide")


def _lib():
    lib = _build.load("gather_mlp")
    lib.gather_mlp_forward.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.gather_mlp_forward.restype = _I
    lib.gather_mlp_row_tile.argtypes = [_I] * 3
    lib.gather_mlp_row_tile.restype = _I
    lib.gather_mlp_route.argtypes = [_I] * 5
    lib.gather_mlp_route.restype = _I
    return lib


def _up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _stride(x: int) -> int:
    """x rounded up to ≡ 8 mod 32 floats (the kernel's row strides)."""
    return x + (8 - x) % 32


def route(k: int, d: int, dc: int, h: int, f: int) -> str:
    """The route the kernel takes for subsets of k points of width d,
    centers of width dc, hidden width h and output width f, from the
    kernel's own shared-memory formulas (``csrc/gather_mlp.cu``:
    ``smem_bytes`` and ``wide::smem_bytes``): ``"narrow"`` where a 64-row
    tile's x and whole h fit, else ``"wide"``.  Raises where even the wide
    route's x does not fit."""
    kp = _up(k, 16) if k > 0 else 16
    dp, hp = _up(d, 8), _up(h, 8)
    spt = 64 // kp if kp <= 64 else 1
    narrow = (4 * (64 * _stride(max(dp, hp)) * (1 if h <= 128 else 2)
                   + 2 * 32 * 132 + 4 * 128 + spt * (f + dc))
              + 4 * (64 + spt))
    if narrow <= MAX_SMEM:
        return "narrow"
    wide = (4 * (64 * _stride(dp) + 64 * 72 + 3 * 64 * 68 + 4 * 64
                 + spt * (64 + dc)) + 4 * (64 + spt))
    if wide <= MAX_SMEM:
        return "wide"
    raise ValueError(f"gather_mlp: no route takes K={k} D={d} Dc={dc}: a "
                     f"64-row tile of x needs {wide} bytes of shared memory "
                     f"with the wide route, over {MAX_SMEM}")


def library_route(k: int, d: int, dc: int, h: int, f: int) -> str:
    """The route the built kernel reports for the shape (the card's
    answer to :func:`route`)."""
    r = _lib().gather_mlp_route(k, d, dc, h, f)
    return ROUTES[r] if r >= 0 else "none"


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
    way = route(k, d, dc, hdim, fout)
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
        _build.count_launch("gather_mlp", f"gather_mlp_{way}")
    return out[0] if single else out
