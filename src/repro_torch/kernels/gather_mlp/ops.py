"""Wrapper of the gather_mlp CUDA kernel (``csrc/gather_mlp.cu``, 3xTF32
on the tensor cores).

A CPU tensor takes the plain PyTorch version (:func:`gather_mlp_ref`); a
CUDA tensor launches the kernel or raises.  The kernel has three routes
(:func:`route`): for two layers, ``"narrow"`` keeps a row tile's h whole
in shared memory, ``"wide"`` keeps y in registers and h in 32-column
chunks where whole h does not fit (:func:`wide_plan`: how it tiles a
call); a one-layer call (``w2`` None: y = x·W + b, which the plans key as
h = 0) takes ``"linear"``, two kernels: W split into TF32 halves in
scratch (:func:`split_weights`), then one product on wgmma streamed over
D (:func:`linear_plan`).

Each call resolves its plan (:func:`plan`) before the CPU/CUDA split, so
a CPU forward records the same cells: an explicit knob (``rows`` on the
narrow and linear routes, ``nsplit`` on the wide one, ``variant``) over a
hit in the tile-plan store (``repro_torch.kernels.plans``) over the
heuristic.  A ``"per_cloud"`` plan launches the kernel once per cloud, at
B = 1.
"""
from __future__ import annotations

import ctypes
import warnings

import torch

from .. import _build, plans, tiling
from ..tiling import (MAX_SMEM, ROUTES, SMEM_SM,  # noqa: F401
                      WIDE_BLOCKS_PER_SM, linear_plan, route,
                      wide_plan)
from .ref import gather_mlp_ref, split_weights_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the wide route's plan fields, in gather_mlp_wide_plan's order
PLAN = ("resident", "ft", "nft", "nsplit", "cps", "spt", "groups", "smem")
# the linear route's plan fields, in gather_mlp_linear_plan's order
LINEAR_PLAN = ("rows", "spt", "n_tiles", "groups", "nft", "n", "stages",
               "x_tma", "smem", "scratch")
VARIANTS = ("batched", "per_cloud")


def _declare(lib):
    lib.gather_mlp_forward.argtypes = [_P] * 9 + [_I] * 9 + [_P]
    lib.gather_mlp_forward.restype = _I
    lib.gather_mlp_row_tile.argtypes = [_I] * 3
    lib.gather_mlp_row_tile.restype = _I
    lib.gather_mlp_route.argtypes = [_I] * 5
    lib.gather_mlp_route.restype = _I
    lib.gather_mlp_rows.argtypes = [_I] * 8
    lib.gather_mlp_rows.restype = _I
    lib.gather_mlp_smem_bytes.argtypes = [_I] * 9
    lib.gather_mlp_smem_bytes.restype = _L
    lib.gather_mlp_scratch_bytes.argtypes = [_I] * 8
    lib.gather_mlp_scratch_bytes.restype = _L
    lib.gather_mlp_wide_plan.argtypes = [_I] * 8 + [_P]
    lib.gather_mlp_wide_plan.restype = None
    lib.gather_mlp_linear_plan.argtypes = [_I] * 7 + [_P]
    lib.gather_mlp_linear_plan.restype = None
    lib.gather_mlp_split_weights.argtypes = [_P, _P, _I, _I, _P]
    lib.gather_mlp_split_weights.restype = _I


def _lib():
    return _build.load("gather_mlp", _declare)


def library_route(k: int, d: int, dc: int, h: int, f: int) -> str:
    """The route the built kernel reports for the shape (the card's
    answer to :func:`route`)."""
    return ROUTES[_lib().gather_mlp_route(k, d, dc, h, f)]


def library_plan(b: int, s: int, k: int, d: int, dc: int, h: int,
                 f: int, nsplit: int = 0) -> dict | None:
    """The wide route's plan the built kernel reports for the call on the
    current CUDA device under the knob ``nsplit`` (0 = its own), the
    card's answer to :func:`wide_plan`; None where the call takes
    another route."""
    out = (ctypes.c_longlong * len(PLAN))()
    _lib().gather_mlp_wide_plan(b, s, k, d, dc, h, f, nsplit, out)
    return None if out[0] < 0 else dict(zip(PLAN, out))


def library_linear_plan(b: int, s: int, k: int, d: int, dc: int, f: int,
                        rows: int = 0) -> dict | None:
    """The linear route's plan the built kernel reports for the one-layer
    call on the current CUDA device under the knob ``rows`` (0 = its
    own): :func:`linear_plan`'s fields, ``x_tma`` and ``scratch`` bytes;
    None where the call takes another route."""
    out = (ctypes.c_longlong * len(LINEAR_PLAN))()
    _lib().gather_mlp_linear_plan(b, s, k, d, dc, f, rows, out)
    return None if out[0] < 0 else dict(zip(LINEAR_PLAN, out))


def library_scratch(b: int, s: int, k: int, d: int, dc: int, h: int,
                    f: int, nsplit: int = 0) -> int:
    """Bytes of device scratch the built kernel asks of the call (the
    wide route's partial y where it splits H, the linear route's split
    W; 0 on the narrow route)."""
    return _lib().gather_mlp_scratch_bytes(b, s, k, d, dc, h, f, nsplit)


def split_weights(w):
    """The linear route's first kernel alone: W (D, F) split into its
    TF32 halves, (2, F_pad, D_pad) float32, as :func:`split_weights_ref`
    lays them out.  A CPU tensor takes that plain version; a CUDA one
    launches the kernel (counted as ``gather_mlp_split_weights``)."""
    if w.device.type == "cpu":
        return split_weights_ref(w)
    _build.check_operands("split_weights", {"w": w}, w.device)
    d, f = w.shape
    nft, n = tiling.linear_tiles(f)
    out = torch.empty((2, nft * n, tiling.round_up(d, tiling.LINEAR_DEPTH)),
                      dtype=torch.float32, device=w.device)
    lib = _lib()
    code = lib.gather_mlp_split_weights(
        w.data_ptr(), out.data_ptr(), d, f,
        torch._C._cuda_getCurrentRawStream(w.device.index))
    _build.check_launch(lib, "gather_mlp", code)
    _build.count_launch("gather_mlp_split_weights")
    return out


def library_smem(b: int, s: int, k: int, d: int, dc: int, h: int, f: int,
                 rows: int = 0, nsplit: int = 0) -> int:
    """Shared memory of a block of the call under the knobs, as the built
    kernel counts it (the card's answer to
    :func:`~repro_torch.kernels.tiling.gather_mlp_smem`); -1 for a knob
    out of range."""
    return _lib().gather_mlp_smem_bytes(b, s, k, d, dc, h, f, rows, nsplit)


def row_tile(b: int, s: int, k: int) -> int:
    """Rows per tile (64 or 128) the narrow route's heuristic picks for
    b·s subsets of k points on the current CUDA device."""
    return _lib().gather_mlp_row_tile(b, s, k)


# ---- plan resolution -------------------------------------------------------

_MEMO: dict = {}
plans.register_cache_clearer(_MEMO.clear)


def plan(b: int, s: int, k: int, d: int, dc: int, h: int, f: int, device,
         rows: int | None = None, nsplit: int | None = None,
         variant: str | None = None) -> dict:
    """The plan a call of b clouds of s subsets of k points (widths d, dc,
    h, f; h = 0 for one layer) on ``device`` launches: ``route``,
    ``variant`` ("batched" or "per_cloud"), ``provenance`` ("override"
    where a knob or ``variant`` is given, "autotuned" for a store hit,
    else "heuristic"), and the route's knob: ``rows`` (narrow, linear) or
    ``nsplit`` (wide), the library's own where the heuristic sets it on a
    card, None where it does on the CPU.  A given knob that does not fit raises ``ValueError``; a store
    entry that does not fit warns and the heuristic plans the call.
    Memoised per call shape until the store changes."""
    return _resolved((b, s, k, d, dc, h, f, torch.device(device), rows,
                      nsplit, variant))[0]


def _resolved(key: tuple) -> tuple:
    """(plan, rows knob, nsplit knob, scratch bytes) of the call ``key``
    (:func:`plan`'s arguments), memoised."""
    hit = _MEMO.get(key)
    if hit is None:
        hit = _MEMO[key] = _resolve(*key)
    return hit


def _resolve(b, s, k, d, dc, h, f, device, rows, nsplit, variant):
    dims = dict(b=b, s=s, k=k, d=d, dc=dc, h=h, f=f)
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"gather_mlp: variant {variant!r} is not one of "
                         f"{VARIANTS}")
    knobs = {n: v for n, v in (("rows", rows), ("nsplit", nsplit))
             if v is not None}
    if knobs or variant is not None:
        err = tiling.infeasible("gather_mlp", dims, knobs)
        if err:
            raise ValueError(f"gather_mlp: {plans.plan_key('gather_mlp', dims)}"
                             f": {err}")
        prov, variant = "override", variant or "batched"
    else:
        prov, variant = "heuristic", "batched"
        entry = plans.lookup("gather_mlp", device=device, **dims)
        if entry is not None:
            err = (plans.entry_error("gather_mlp", entry)
                   or tiling.infeasible("gather_mlp", dims,
                                        plans.knobs("gather_mlp", entry)))
            if err:
                warnings.warn(
                    f"tile plan for {plans.plan_key('gather_mlp', dims)} no "
                    f"longer fits ({err}); the heuristic plans it (re-run "
                    f"python -m repro_torch.launch.autotune)",
                    RuntimeWarning, stacklevel=4)
            else:
                knobs = plans.knobs("gather_mlp", entry)
                prov = "autotuned"
                variant = entry.get("variant") or "batched"
    way = route(k, d, dc, h, f)
    r_arg, n_arg = knobs.get("rows", 0), knobs.get("nsplit", 0)
    out = dict(route=way, variant=variant, provenance=prov,
               rows=knobs.get("rows"), nsplit=knobs.get("nsplit"))
    scratch = 0
    if device.type == "cuda":
        lib = _lib()
        bb = 1 if variant == "per_cloud" else b
        if way != "wide":
            out["rows"] = lib.gather_mlp_rows(bb, s, k, d, dc, h, f, r_arg)
        else:
            out["nsplit"] = library_plan(bb, s, k, d, dc, h, f,
                                         n_arg)["nsplit"]
        scratch = lib.gather_mlp_scratch_bytes(bb, s, k, d, dc, h, f, n_arg)
    return out, r_arg, n_arg, scratch


def gather_mlp(raw, centers, w1, b1, w2=None, b2=None, mask=None, *,
               rows=None, nsplit=None, variant=None):
    """Fused normalize → 2-layer MLP (or one layer) → max over K.

    raw (B, S, K, D) or (S, K, D); centers (…, S, Dc) subtracted from the
    leading Dc lanes of raw; w1 (D, H), b1 (H,), w2 (H, F), b2 (F,), or
    with ``w2`` and ``b2`` None one layer: w1 (D, F), b1 (F,), y = x·w1 +
    b1 (the linear route); mask (…, S, K) bool marks live positions (None
    = all), and a subset with none live gives a zero row.  ``rows`` (64
    or 128, narrow and linear routes), ``nsplit`` (wide route) and
    ``variant`` ("batched", "per_cloud") force the plan (:func:`plan`).
    -> (…, S, F) float32."""
    _build.refuse_dtensor("gather_mlp", (raw, centers, w1, b1, w2, b2, mask))
    if raw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_mlp: unsupported device {raw.device}")
    if (w2 is None) != (b2 is None):
        raise ValueError("gather_mlp: w2 and b2 are given together (two "
                         "layers) or both None (one layer)")
    single = raw.dim() == 3
    s, k, d = raw.shape[-3:]
    b = 1 if single else raw.shape[0]
    dc = centers.shape[-1]
    hdim, fout = (0, w1.shape[1]) if w2 is None else (w1.shape[1],
                                                      w2.shape[1])
    pl, r_arg, n_arg, nbytes = _resolved((b, s, k, d, dc, hdim, fout,
                                          raw.device, rows, nsplit, variant))
    if plans.capturing():
        plans.note_plan("gather_mlp", dict(b=b, s=s, k=k, d=d, dc=dc,
                                           h=hdim, f=fout), pl)
    if raw.device.type == "cpu":
        return gather_mlp_ref(raw, centers, w1, b1, w2, b2, mask)
    _build.refuse_grad("gather_mlp", (raw, centers, w1, b1, w2, b2),
                       _build.FC_TRAINING)
    if single:
        raw, centers = raw[None], centers[None]
        mask = None if mask is None else mask[None]
    if mask is not None and mask.dtype != torch.bool:
        mask = mask != 0
    expect = {"centers": (b, s, dc), "w1": (d, hdim or fout),
              "b1": (hdim or fout,), "w2": (hdim, fout), "b2": (fout,),
              "mask": (b, s, k)}
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
        scratch = None
        if nbytes:
            scratch = torch.empty(nbytes, dtype=torch.uint8,
                                  device=raw.device)
        stream = torch._C._cuda_getCurrentRawStream(raw.device.index)
        weights = (w1.data_ptr(), b1.data_ptr(),
                   None if w2 is None else w2.data_ptr(),
                   None if b2 is None else b2.data_ptr())
        scratch_ptr = None if scratch is None else scratch.data_ptr()
        # one launch for the batch, or one a cloud at the clouds' offsets
        # (every operand is contiguous, the batch its leading axis)
        n, bb = (b, 1) if pl["variant"] == "per_cloud" else (1, b)
        for i in range(n):
            code = lib.gather_mlp_forward(
                raw.data_ptr() + i * 4 * s * k * d,
                centers.data_ptr() + i * 4 * s * dc,
                None if mask is None else mask.data_ptr() + i * s * k,
                *weights, out.data_ptr() + i * 4 * s * fout, scratch_ptr,
                bb, s, k, d, dc, hdim, fout, r_arg, n_arg, stream)
            _build.check_launch(lib, "gather_mlp", code)
            _build.count_launch("gather_mlp", f"gather_mlp_{pl['route']}")
            if pl["route"] == "linear":     # W's split, then the product
                _build.count_launch("gather_mlp_split_weights")
    return out[0] if single else out
