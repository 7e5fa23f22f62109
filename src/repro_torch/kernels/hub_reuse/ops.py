"""Wrapper of the hub_reuse CUDA kernel (``csrc/hub_reuse.cu``).

A CPU tensor takes the plain PyTorch version (:func:`hub_reuse_ref`); a
CUDA tensor launches the kernel or raises.  The kernel has two forms: two
layers, relu(x·W1 + b1)·W2 + b2, and one, x·W1 + b1 (``w2`` and ``b2``
None, which the plans key as h = 0: the engine's lowering of every
one-layer point-MLP).  It has two routes, which the call's widths, form
and the card's SM count fix
(:func:`~repro_torch.kernels.tiling.hub_reuse_route`): ``resident``, for
the calls one launch of an island's cache rows in a block covers (C <=
128 rows that fit) and, in 128-row chunks, for C past 128 where its grid
fills most of the card; and ``layered`` for every other call (the layers
once for all cache rows, in device scratch, then the gather; three
kernels a call in two layers, two in one, counted as one launch).  On
``resident`` a launch takes a chunk of at most ``chunk`` cache rows (64
or 128); a C past the chunk takes one launch a chunk, each merged into
the output by an elementwise max.  A one-layer resident call whose
products reach 2^28 multiply-adds (``tiling.reuse_linear_wgmma``) takes
a kernel on ``wgmma`` with the gather in its epilogue
(:func:`linear_plan`), after W's split into TF32 halves in scratch, once
a call.  Every shape has a plan.  Launches are counted as ``hub_reuse``,
by route (``hub_reuse_resident``, ``hub_reuse_layered``, both forms)
and, for the one-layer form, by route and form
(``hub_reuse_resident_linear``, ``hub_reuse_layered_linear``); the wgmma
kernel's also as ``hub_reuse_linear_wgmma``, and its call's W split as
``hub_reuse_split_weights``.

Each call resolves its plan (:func:`plan`) before the CPU/CUDA split, as
``gather_mlp``'s does: an explicit ``chunk`` or ``variant`` over a hit in
the tile-plan store (``repro_torch.kernels.plans``) over the heuristic
(``chunk`` = 128 on the resident route, none on the layered one,
:func:`~repro_torch.kernels.tiling.hub_reuse_chunk`); the SM count is the
card's (an H100's, 132, for a CPU call).  A ``"per_cloud"``
plan launches once per cloud (and chunk), at B = 1.
"""
from __future__ import annotations

import ctypes
import warnings

import torch

from .. import _build, plans, tiling
from ..tf32_split import split_weights_ref
from .ref import hub_reuse_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
CHUNK = 128                # the most cache rows a launch takes (csrc kMaxC)
VARIANTS = ("batched", "per_cloud")
#: what hub_reuse_plan reports: the route (0 resident, 1 layered), the
#: splits of y's GEMM (over H, or over D in one layer), scratch floats
#: (the layered route's h and partials of y, the wgmma kernel's W halves)
#: and a block's shared memory
PLAN = ("route", "nsplit", "scratch", "smem")
#: the wgmma kernel's plan fields, in hub_reuse_linear_plan's order
#: (``tiling.reuse_linear_plan``'s)
LINEAR_PLAN = ("rows", "ipt", "groups", "nft", "n", "items", "stages",
               "x_tma", "smem", "scratch")


def _declare(lib):
    lib.hub_reuse_forward.argtypes = [_P] * 10 + [_I] * 11 + [_P]
    lib.hub_reuse_forward.restype = _I
    lib.hub_reuse_layered.argtypes = [_P] * 10 + [_I] * 8 + [_P]
    lib.hub_reuse_layered.restype = _I
    lib.hub_reuse_smem_bytes.argtypes = [_I] * 10
    lib.hub_reuse_smem_bytes.restype = _L
    lib.hub_reuse_plan.argtypes = [_I] * 8 + [_P]
    lib.hub_reuse_plan.restype = _I
    lib.hub_reuse_linear_plan.argtypes = [_I] * 8 + [_P]
    lib.hub_reuse_linear_plan.restype = None
    lib.hub_reuse_split_weights.argtypes = [_P, _P, _I, _I, _P]
    lib.hub_reuse_split_weights.restype = _I


def _lib():
    return _build.load("hub_reuse", _declare)


_LIB_PLANS: dict = {}


def library_plan(b: int, hn: int, c: int, m: int, k: int, d: int, h: int,
                 f: int) -> dict:
    """What the built kernel launches for the call on this card (h = 0:
    one layer; :data:`PLAN`; the route by name): the card's answer to
    :func:`~repro_torch.kernels.tiling.hub_reuse_route`, ``nsplit`` and
    ``scratch`` of
    :func:`~repro_torch.kernels.tiling.hub_reuse_layered_plan` (0 on the
    resident route) and :func:`~repro_torch.kernels.tiling.hub_reuse_smem`
    at chunk 128."""
    lib = _lib()
    key = (id(lib), torch.cuda.current_device(), b, hn, c, m, k, d, h, f)
    got = _LIB_PLANS.get(key)     # memoised: a layered call asks each time
    if got is None:
        out = (ctypes.c_longlong * len(PLAN))()
        if lib.hub_reuse_plan(b, hn, c, m, k, d, h, f, out) != 0:
            raise ValueError(f"hub_reuse: no plan for C={c}, D={d}, H={h}")
        got = dict(zip(PLAN, out))
        got["route"] = ("resident", "layered")[got["route"]]
        _LIB_PLANS[key] = got
    return dict(got)


def library_smem(b: int, hn: int, c: int, m: int, k: int, d: int, h: int,
                 f: int, live: bool = True, chunk: int = CHUNK) -> int:
    """Shared memory of a resident block of the call's largest launch at
    ``chunk`` in the form ``h`` names (0: one layer; the wgmma kernel's
    block follows b, hn, f and the card), as the built kernel counts it
    (the card's answer to
    :func:`~repro_torch.kernels.tiling.hub_reuse_smem`); -1 for a chunk
    out of range."""
    return _lib().hub_reuse_smem_bytes(b, hn, c, m, k, d, h, f, int(live),
                                       chunk)


def library_linear_plan(b: int, hn: int, c: int, m: int, k: int, d: int,
                        f: int, chunk: int = CHUNK) -> dict | None:
    """The wgmma kernel's plan the built library reports for the call's
    first launch at ``chunk`` on the current CUDA device
    (:data:`LINEAR_PLAN`: the card's answer to
    :func:`~repro_torch.kernels.tiling.reuse_linear_plan`, ``x_tma`` for
    a 16-byte aligned pool); None where the call does not take that
    kernel (the layered route, or
    :func:`~repro_torch.kernels.tiling.reuse_linear_wgmma` fails)."""
    out = (ctypes.c_longlong * len(LINEAR_PLAN))()
    _lib().hub_reuse_linear_plan(b, hn, c, m, k, d, f, chunk, out)
    return None if out[0] < 0 else dict(zip(LINEAR_PLAN, out))


def split_weights(w):
    """The wgmma kernel's W (D, F) split into its TF32 halves, once a
    call: (2, F_pad, D_pad) float32, F_pad = F rounded up to 128, as
    :func:`~repro_torch.kernels.tf32_split.split_weights_ref` lays them
    out.  A CPU tensor takes that plain version; a CUDA one launches the
    kernel (counted as ``hub_reuse_split_weights``)."""
    d, f = w.shape
    f_pad = tiling.round_up(f, tiling.REUSE_LINEAR_MAX_COLS)
    if w.device.type == "cpu":
        return split_weights_ref(w, f_pad)
    _build.check_operands("split_weights", {"w": w}, w.device)
    out = torch.empty((2, f_pad, tiling.round_up(d, tiling.LINEAR_DEPTH)),
                      dtype=torch.float32, device=w.device)
    lib = _lib()
    code = lib.hub_reuse_split_weights(
        w.data_ptr(), out.data_ptr(), d, f,
        torch._C._cuda_getCurrentRawStream(w.device.index))
    _build.check_launch(lib, "hub_reuse", code)
    _build.count_launch("hub_reuse_split_weights")
    return out


def linear_plan(b: int, hn: int, c: int, d: int, f: int, device,
                chunk: int = CHUNK) -> dict:
    """How the wgmma kernel tiles a one-layer call's first launch on
    ``device`` (an H100's SM count for a CPU call):
    :func:`~repro_torch.kernels.tiling.reuse_linear_plan`."""
    return tiling.reuse_linear_plan(b, hn, c, d, f, card_sms(device),
                                    chunk)


def card_sms(device) -> int:
    """The SM count a call's route is planned for: the card's, or an
    H100's (``tiling.H100_SMS``) for a CPU call."""
    device = torch.device(device)
    if device.type != "cuda":
        return tiling.H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---- plan resolution -------------------------------------------------------

_MEMO: dict = {}
plans.register_cache_clearer(_MEMO.clear)


def plan(b: int, hn: int, c: int, m: int, k: int, d: int, h: int, f: int,
         device, chunk: int | None = None,
         variant: str | None = None) -> dict:
    """The plan a call of b clouds of hn islands (C cache rows, M subsets
    of K points, widths d, h, f; h = 0 for one layer) on ``device``
    launches: ``route``
    ("resident" or "layered", fixed by the widths), ``variant``
    ("batched" or "per_cloud"), ``provenance`` ("override", "autotuned" or
    "heuristic", as ``gather_mlp``'s) and ``chunk`` (None on the layered
    route).  A given chunk that does not fit, or on the layered route,
    raises ``ValueError``; a store entry that does not fit warns and the
    heuristic plans the call.  Memoised per call shape until the store
    changes."""
    return _resolved((b, hn, c, m, k, d, h, f, torch.device(device), chunk,
                      variant))


def _resolved(key: tuple) -> dict:
    hit = _MEMO.get(key)
    if hit is None:
        hit = _MEMO[key] = _resolve(*key)
    return hit


def _resolve(b, hn, c, m, k, d, h, f, device, chunk, variant):
    dims = dict(b=b, hn=hn, c=c, m=m, k=k, d=d, h=h, f=f)
    sms = card_sms(device)
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"hub_reuse: variant {variant!r} is not one of "
                         f"{VARIANTS}")
    knobs = {} if chunk is None else {"chunk": chunk}
    if knobs or variant is not None:
        err = tiling.infeasible("hub_reuse", dims, knobs, sms)
        if err:
            raise ValueError(f"hub_reuse: {plans.plan_key('hub_reuse', dims)}"
                             f": {err}")
        prov, variant = "override", variant or "batched"
    else:
        prov, variant = "heuristic", "batched"
        entry = plans.lookup("hub_reuse", device=device, **dims)
        if entry is not None:
            err = (plans.entry_error("hub_reuse", entry)
                   or tiling.infeasible("hub_reuse", dims,
                                        plans.knobs("hub_reuse", entry),
                                        sms))
            if err:
                warnings.warn(
                    f"tile plan for {plans.plan_key('hub_reuse', dims)} no "
                    f"longer fits ({err}); the heuristic plans it (re-run "
                    f"python -m repro_torch.launch.autotune)",
                    RuntimeWarning, stacklevel=4)
            else:
                knobs = plans.knobs("hub_reuse", entry)
                prov = "autotuned"
                variant = entry.get("variant") or "batched"
    # a per_cloud plan's launches each take one cloud
    rb = 1 if variant == "per_cloud" else b
    route = tiling.hub_reuse_route(rb, hn, c, m, k, d, f, sms, h=h)
    return dict(route=route, variant=variant, provenance=prov,
                chunk=(knobs.get("chunk", tiling.hub_reuse_chunk(c, m, k, d,
                                                                 h=h))
                       if route == "resident" else None))


def hub_reuse(pool_in, slot, comp, w1, b1, w2=None, b2=None, live=None, *,
              chunk=None, variant=None):
    """Pool MLP + compensated reuse gather + masked max over K.

    pool_in (B, H, C, D) or (H, C, D) hub-relative cache inputs; slot
    (…, H, M, K) int32 cache slot per position (-1 = not cached); comp
    (…, H, M, F) per-subset compensation; w1 (D, H), b1 (H,), w2 (H, F),
    b2 (F,): y = relu(pool_in·w1 + b1)·w2 + b2, or with ``w2`` and ``b2``
    None one layer: w1 (D, F), b1 (F,), y = pool_in·w1 + b1; live (…, H,
    M, K) bool (None = all resident).  -> (…, H, M, F) float32: max over
    the live slots of y[slot] + comp, ``-BIG`` where a subset has none.
    ``chunk`` (64 or 128 cache rows a launch) and ``variant`` ("batched",
    "per_cloud") force the plan (:func:`plan`)."""
    _build.refuse_dtensor("hub_reuse", (pool_in, slot, comp, w1, b1, w2, b2,
                                        live))
    if pool_in.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hub_reuse: unsupported device {pool_in.device}")
    if (w2 is None) != (b2 is None):
        raise ValueError("hub_reuse: w2 and b2 are given together (two "
                         "layers) or both None (one layer)")
    single = pool_in.dim() == 3
    hn, c, d = pool_in.shape[-3:]
    b = 1 if single else pool_in.shape[0]
    m, k = slot.shape[-2:]
    hdim, fout = (0, w1.shape[1]) if w2 is None else (w1.shape[1],
                                                      w2.shape[1])
    pl = _resolved((b, hn, c, m, k, d, hdim, fout, pool_in.device, chunk,
                    variant))
    if plans.capturing():
        plans.note_plan("hub_reuse", dict(b=b, hn=hn, c=c, m=m, k=k, d=d,
                                          h=hdim, f=fout), pl)
    if pool_in.device.type == "cpu":
        return hub_reuse_ref(pool_in, slot, comp, w1, b1, w2, b2, live)
    _build.refuse_grad("hub_reuse", (pool_in, comp, w1, b1, w2, b2),
                       _build.FC_TRAINING)
    if single:
        pool_in, slot, comp = pool_in[None], slot[None], comp[None]
        live = None if live is None else live[None]
    if live is not None and live.dtype != torch.bool:
        live = live != 0
    expect = {"slot": (b, hn, m, k), "comp": (b, hn, m, fout),
              "w1": (d, hdim or fout), "b1": (hdim or fout,),
              "w2": (hdim, fout), "b2": (fout,), "live": (b, hn, m, k)}
    ops = {"pool_in": pool_in, "slot": slot, "comp": comp, "w1": w1,
           "b1": b1, "w2": w2, "b2": b2, "live": live}
    for arg, shape in expect.items():
        if ops[arg] is not None and tuple(ops[arg].shape) != shape:
            raise ValueError(f"hub_reuse: {arg} has shape "
                             f"{tuple(ops[arg].shape)}, expected {shape}")
    _build.check_operands("hub_reuse", ops, pool_in.device,
                          {"slot": torch.int32, "live": torch.bool})
    if c < 1:
        raise ValueError("hub_reuse: needs C >= 1 cache rows")
    out = torch.empty((b, hn, m, fout), dtype=torch.float32,
                      device=pool_in.device)
    if b * hn * m:
        lib = _lib()
        stream = torch._C._cuda_getCurrentRawStream(pool_in.device.index)
        weights = (w1.data_ptr(), b1.data_ptr(),
                   None if w2 is None else w2.data_ptr(),
                   None if b2 is None else b2.data_ptr())
        # the counts a launch adds: the kernel's, its route's, and in one
        # layer its route's and form's
        way = f"hub_reuse_{pl['route']}"
        counts = ("hub_reuse", way) + ((way + "_linear",) if hdim == 0
                                       else ())
        # the batch at once, or each cloud at the clouds' offsets (every
        # operand is contiguous, the batch leading)
        n, bb = (b, 1) if pl["variant"] == "per_cloud" else (1, b)
        layered = pl["route"] == "layered"
        # scratch: the layered route's h and y's partials, or the wgmma
        # kernel's W halves, split once for every launch of the call
        scratch = None
        if layered:
            scratch = torch.empty(
                library_plan(bb, hn, c, m, k, d, hdim, fout)["scratch"],
                dtype=torch.float32, device=pool_in.device)
        elif hdim == 0 and tiling.reuse_linear_wgmma(bb, hn, c, d, fout):
            counts += ("hub_reuse_linear_wgmma",)
            scratch = split_weights(w1)
        for i in range(n):
            mk = i * hn * m * k
            ptrs = (pool_in.data_ptr() + i * 4 * hn * c * d,
                    slot.data_ptr() + 4 * mk,
                    comp.data_ptr() + i * 4 * hn * m * fout,
                    None if live is None else live.data_ptr() + mk,
                    *weights, out.data_ptr() + i * 4 * hn * m * fout)
            if layered:
                code = lib.hub_reuse_layered(
                    *ptrs, scratch.data_ptr(), bb, hn, c, m, k, d, hdim,
                    fout, stream)
                _build.check_launch(lib, "hub_reuse", code)
                _build.count_launch(*counts)
                continue
            # one launch a chunk, each merged into the last by a max
            for c0 in range(0, c, pl["chunk"]):
                code = lib.hub_reuse_forward(
                    *ptrs, None if scratch is None else scratch.data_ptr(),
                    bb, hn, c, m, k, d, hdim, fout, c0, int(c0 > 0),
                    pl["chunk"], stream)
                _build.check_launch(lib, "hub_reuse", code)
                _build.count_launch(*counts)
    return out[0] if single else out
