"""Wrapper of the gather_mlp CUDA kernel (``csrc/gather_mlp.cu``, 3xTF32
on the tensor cores).

A CPU tensor takes the plain PyTorch version (:func:`gather_mlp_ref`); a
CUDA tensor launches the kernel or raises.  The kernel has two routes
(:func:`route`): ``"narrow"`` keeps a row tile's h whole in shared memory,
``"wide"`` keeps y in registers and h in 32-column chunks where whole h
does not fit (:func:`wide_plan`: how it tiles a call).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import gather_mlp_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
MAX_SMEM = 232448          # a block's shared memory on Hopper, bytes
SMEM_SM = 233472           # an SM's shared memory, bytes
WIDE_BLOCKS_PER_SM = 2     # what the wide route's plan aims at (kBlocks)
ROUTES = ("narrow", "wide")
# the wide route's plan fields, in gather_mlp_wide_plan's order
PLAN = ("resident", "ft", "nft", "nsplit", "cps", "spt", "groups", "smem")


def _declare(lib):
    lib.gather_mlp_forward.argtypes = [_P] * 9 + [_I] * 7 + [_P]
    lib.gather_mlp_forward.restype = _I
    lib.gather_mlp_row_tile.argtypes = [_I] * 3
    lib.gather_mlp_row_tile.restype = _I
    lib.gather_mlp_route.argtypes = [_I] * 5
    lib.gather_mlp_route.restype = _I
    lib.gather_mlp_scratch_bytes.argtypes = [_I] * 7
    lib.gather_mlp_scratch_bytes.restype = _L
    lib.gather_mlp_wide_plan.argtypes = [_I] * 7 + [_P]
    lib.gather_mlp_wide_plan.restype = None


def _lib():
    return _build.load("gather_mlp", _declare)


def _up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _stride(x: int) -> int:
    """x rounded up to ≡ 8 mod 32 floats (the kernel's row strides)."""
    return x + (8 - x) % 32


def route(k: int, d: int, dc: int, h: int, f: int) -> str:
    """The route the kernel takes for subsets of k points of width d,
    centers of width dc, hidden width h and output width f, from the
    kernel's shared-memory formula (``csrc/gather_mlp.cu``:
    ``smem_bytes``): ``"narrow"`` where a 64-row tile's x and whole h fit,
    else ``"wide"``, which takes any shape."""
    kp = _up(k, 16) if k > 0 else 16
    dp, hp = _up(d, 8), _up(h, 8)
    spt = 64 // kp if kp <= 64 else 1
    narrow = (4 * (64 * _stride(max(dp, hp)) * (1 if h <= 128 else 2)
                   + 2 * 32 * 132 + 4 * 128 + spt * (f + dc))
              + 4 * (64 + spt))
    return "narrow" if narrow <= MAX_SMEM else "wide"


def wide_plan(b: int, s: int, k: int, d: int, dc: int, h: int, f: int,
              sms: int) -> dict:
    """How the wide route tiles a call on a card of ``sms`` SMs, from the
    kernel's own formulas (``csrc/gather_mlp.cu``: ``wide::make_plan``):
    whole subsets packed k rows apart into 64-row tiles (``spt`` a tile,
    ``groups`` of them), ``nft`` F tiles of ``ft`` columns (layer 1 runs
    once per F tile), H's 32-column chunks split ``nsplit`` ways (``cps``
    chunks a split) where the blocks would leave SMs idle, and x
    ``resident`` in shared memory where it fits in a block's share of an
    SM (two blocks an SM), else streamed in slices; ``smem`` bytes a
    block."""
    kp = max(k, 1)
    spt, multi = (64 // kp, False) if kp <= 64 else (1, True)
    dp, nchunk = _up(d, 8), -(-h // 32)
    nft = -(-f // 256)
    ft = _up(-(-f // nft), 64)
    groups = -(-(b * s) // spt)
    blocks = groups * nft
    nsplit = 1
    if blocks < sms:
        nsplit = min(max(nchunk // 2, 1), -(-sms // blocks))
    cps = -(-nchunk // nsplit)
    nsplit = -(-nchunk // cps)
    w2 = min(4352 // (ft + 4) // 8 * 8, 32) * (ft + 4)

    def smem(xd, dc, resident):
        stage = max(dc * 36 + (0 if resident else 64 * 72), w2)
        main = max(64 * (xd + 40) + 2 * stage, 64 * (ft + 8))
        return 4 * (3 * 64 + 4 + main + (ft if multi else 0))

    size = smem(_stride(dp), 128, True)
    resident = size <= SMEM_SM // WIDE_BLOCKS_PER_SM - 1024
    if not resident:
        size = smem(0, 64, False)
    return dict(resident=int(resident), ft=ft, nft=nft, nsplit=nsplit,
                cps=cps, spt=spt, groups=groups, smem=size)


def library_route(k: int, d: int, dc: int, h: int, f: int) -> str:
    """The route the built kernel reports for the shape (the card's
    answer to :func:`route`)."""
    return ROUTES[_lib().gather_mlp_route(k, d, dc, h, f)]


def library_plan(b: int, s: int, k: int, d: int, dc: int, h: int,
                 f: int) -> dict | None:
    """The wide route's plan the built kernel reports for the call on the
    current CUDA device (the card's answer to :func:`wide_plan`); None
    where the call takes the narrow route."""
    out = (ctypes.c_longlong * len(PLAN))()
    _lib().gather_mlp_wide_plan(b, s, k, d, dc, h, f, out)
    return None if out[0] < 0 else dict(zip(PLAN, out))


def row_tile(b: int, s: int, k: int) -> int:
    """Rows per tile (64 or 128) the narrow route takes for b·s subsets
    of k points on the current CUDA device."""
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
        scratch = None
        if way == "wide":
            nbytes = lib.gather_mlp_scratch_bytes(b, s, k, d, dc, hdim, fout)
            if nbytes:
                scratch = torch.empty(nbytes, dtype=torch.uint8,
                                      device=raw.device)
        code = lib.gather_mlp_forward(
            raw.data_ptr(), centers.data_ptr(),
            None if mask is None else mask.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, s, k, d, dc, hdim, fout,
            torch._C._cuda_getCurrentRawStream(raw.device.index))
        _build.check_launch(lib, "gather_mlp", code)
        _build.count_launch("gather_mlp", f"gather_mlp_{way}")
    return out[0] if single else out
