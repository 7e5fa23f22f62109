"""Wrappers of the flash_attention CUDA kernels: the forward
(``csrc/flash_attention.cu``) and its gradient
(``csrc/flash_attention_bwd.cu``), joined by :class:`FlashAttentionFn`.

A CPU tensor takes the plain PyTorch versions (:func:`attention_ref`,
:func:`attention_lse_ref`, :func:`attention_bwd_ref`); a CUDA tensor
launches the kernel of the route that :func:`_variant` names or raises.
Every head width D >= 1 has a route: ``wgmma`` and ``mma`` up to
:data:`MAX_D`, ``split`` (D over a thread-block cluster, in sweeps where
a block's slice is wider than its pass holds) above it.

The log-sum-exp that the forward hands the backward is float32 (B, Hq,
Sq) in the kernels' log2 domain: row i's log2(sum_j exp2(q_i·k_j ·
log2(e) / sqrt(D))) over its visible keys, i.e. log2(e) times the
natural log-sum-exp of the scaled scores (:func:`attention_lse_ref`).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, plans
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_D = 256                # the widest head of the mma and wgmma routes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"mma": 0, "wgmma": 1, "split": 2}
# the backward's kernels, each launched once a call, in this order
BWD_PASSES = ("dq", "dkdv")


# what flash_attention_layout reports for a route: the forward's query
# rows a block, keys a kv tile, D padded (a block's slice of it on the
# split route, a piece of that where the slice streams), shared memory,
# threads, blocks a cluster and columns of D a block; then the backward's
# dQ and dK/dV passes' blocks a cluster, slice and shared memory (the split
# route; 0 on the others); then the sweeps of the forward and of each
# backward pass (1 but on the split route, whose widest slices take more)
LAYOUT = ("bq", "bk", "dp", "smem", "threads", "cluster", "slice",
          "dq_cluster", "dq_slice", "dq_smem", "dkv_cluster", "dkv_slice",
          "dkv_smem", "sweeps", "dq_sweeps", "dkv_sweeps")


def _declare(lib):
    lib.flash_attention_forward.argtypes = [_P] * 5 + [_I] * 9 + [_P]
    lib.flash_attention_forward.restype = _I
    lib.flash_attention_layout.argtypes = [_I] * 3 + [_P]
    lib.flash_attention_layout.restype = _I


def _lib():
    return _build.load("flash_attention", _declare)


def library_layout(route: str, dtype, d: int) -> dict:
    """The tiles the built forward launches on ``route`` (``"mma"``,
    ``"wgmma"`` or ``"split"``) for ``dtype`` (a torch
    dtype or its name) and D (``LAYOUT``; on the split routes the
    backward's passes too).  Loads the library, so a card is needed.
    Raises for a route the call cannot take."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    lib = _lib()
    out = (ctypes.c_int * len(LAYOUT))()
    code = lib.flash_attention_layout(_VARIANTS[route], _DTYPES[dtype], d,
                                      out)
    _build.check_launch(lib, "flash_attention", code)
    return dict(zip(LAYOUT, out))


def _declare_bwd(lib):
    lib.flash_attention_backward.argtypes = [_P] * 10 + [_I] * 9 + [_P]
    lib.flash_attention_backward.restype = _I


def _lib_bwd():
    return _build.load("flash_attention_bwd", _declare_bwd)


def _variant(dtype, d: int, ptrs=()) -> str:
    """The route a CUDA call takes, forward and backward alike:
    ``"split"`` (D in slices over the blocks of a thread-block cluster,
    mma.sync) for every D > MAX_D; ``"wgmma"``
    (bf16 products on ``wgmma``, fed by TMA, whose base addresses and rows
    must be multiples of 16 bytes) for bfloat16 with D % 8 == 0, D <= 128
    and every address in ``ptrs`` 16-byte aligned; else ``"mma"``
    (``mma.sync``: f32 in 3xTF32, bf16 with fp32 accumulation).  Raises
    for D < 1."""
    if d < 1:
        raise ValueError(f"flash_attention: the kernels take D >= 1, got "
                         f"D={d}")
    if d > MAX_D:
        return "split"
    aligned = all(p % 16 == 0 for p in ptrs)
    return ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and d <= 128
            and aligned else "mma")


def flash_attention(q, k, v, causal: bool = True):
    """Attention forward, GQA-aware, differentiable through
    :class:`FlashAttentionFn` (its backward is
    :func:`flash_attention_backward`).

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with Hq % Hkv == 0; float32 or
    bfloat16, all of one dtype.  -> (B, Hq, Sq, D) in q's dtype (see
    :func:`_forward`).  Only a call that records a graph has the forward
    keep its log-sum-exp for the backward."""
    _build.refuse_dtensor("flash_attention", (q, k, v))
    graph = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return FlashAttentionFn.apply(q, k, v, causal, graph)


class FlashAttentionFn(torch.autograd.Function):
    """flash_attention with its gradient: the forward kernel, which also
    stores the log-sum-exp when ``keep_lse``, and the backward kernel on
    the saved q, k, v, output and log-sum-exp (the plain versions on CPU
    tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, keep_lse=True):
        out, lse = (_forward(q, k, v, causal, lse=True) if keep_lse
                    else (_forward(q, k, v, causal), None))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, do.contiguous(),
                                              ctx.causal, lse=lse)
        return dq, dk, dv, None, None


def _check_heads(name, q, k):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    hq, hkv = q.shape[1], k.shape[1]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{name}: Hq={hq} is not a multiple of Hkv={hkv}")


def flash_attention_backward(q, k, v, o, do, causal: bool = True,
                             lse=None):
    """The gradient of :func:`flash_attention`: q (B, Hq, Sq, D), k, v
    (B, Hkv, Skv, D), its output ``o`` and the output's gradient ``do``
    (B, Hq, Sq, D), all float32 or all bfloat16, and ``lse`` the
    forward's log-sum-exp (float32 (B, Hq, Sq), the module's log2 domain;
    ``_forward(..., lse=True)`` returns it).  -> (dq, dk, dv) in their
    inputs' dtype: P recomputed from q, k and the log-sum-exp in float32,
    dS = P ∘ (dO·vᵀ − rowsum(dO ∘ O)), dq = dS·k/sqrt(D), dk and dv
    summed over each kv head's query heads.  On a CUDA device every
    operand contiguous, any D >= 1; two launches on the route of
    :func:`_variant` (counted per pass and route,
    ``flash_attention_bwd_<pass>_<route>``), no atomics (the same inputs
    give the same bits).  With ``lse=None`` on the card the forward kernel
    runs once more to obtain it (one ``flash_attention`` launch).  On the
    CPU ``lse`` is not read: :func:`attention_bwd_ref` recomputes the
    softmax."""
    _check_heads("flash_attention_backward", q, k)
    _build.refuse_dtensor("flash_attention_backward", (q, k, v, o, do, lse))
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: unsupported device "
                         f"{q.device}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    want = {"k": (b, hkv, skv, d), "v": (b, hkv, skv, d),
            "o": (b, hq, sq, d), "do": (b, hq, sq, d)}
    ops = {"q": q, "k": k, "v": v, "o": o, "do": do}
    for arg, shape in want.items():
        if tuple(ops[arg].shape) != shape:
            raise ValueError(f"flash_attention_backward: {arg} has shape "
                             f"{tuple(ops[arg].shape)}, expected {shape}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_backward: dtype {q.dtype}, "
                         f"expected float32 or bfloat16")
    if d < 1 or skv < 1:
        raise ValueError(f"flash_attention_backward: the kernel takes "
                         f"D >= 1 and Skv >= 1, got D={d}, Skv={skv}")
    dtypes = dict.fromkeys(ops, q.dtype)
    if lse is None:
        lse = _forward(q, k, v, causal, lse=True)[1]
    ops["lse"], dtypes["lse"] = lse, torch.float32
    if tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"flash_attention_backward: lse has shape "
                         f"{tuple(lse.shape)}, expected {(b, hq, sq)}")
    _build.check_operands("flash_attention_backward", ops, q.device, dtypes)
    dq = torch.empty_like(q)
    if b * hq * sq == 0:
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    route = _variant(q.dtype, d,
                     [t.data_ptr() for t in (q, k, v, o, do)])
    # rowsum(dO ∘ O) per query row, from the dQ pass to the dK/dV pass
    dsum = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib = _lib_bwd()
    code = lib.flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dsum.data_ptr(), b, hq, hkv, sq, skv, d, int(causal),
        _DTYPES[q.dtype], _VARIANTS[route],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(lib, "flash_attention_bwd", code)
    for kernel in BWD_PASSES:
        _build.count_launch("flash_attention_bwd",
                            f"flash_attention_bwd_{kernel}_{route}")
    return dq, dk, dv


def _note(q, k, v, causal, lse):
    """Record the call's launch for ``plans.capture()``: its dims, dtype,
    whether q, k and v are 16-byte aligned, and the route
    :func:`_variant` names (None for a D no kernel takes: D < 1)."""
    b, hq, sq, d = q.shape
    ptrs = [t.data_ptr() for t in (q, k, v)]
    plans.note_plan("flash_attention", dict(
        b=b, hq=hq, hkv=k.shape[1], sq=sq, skv=k.shape[2], d=d), dict(
        route=_variant(q.dtype, d, ptrs) if d > 0 else None,
        dtype=str(q.dtype).removeprefix("torch."),
        aligned=all(p % 16 == 0 for p in ptrs), causal=bool(causal),
        lse=bool(lse)))


def _forward(q, k, v, causal: bool = True, lse: bool = False):
    """Attention forward, GQA-aware.

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with Hq % Hkv == 0; float32 or
    bfloat16, all of one dtype.  -> (B, Hq, Sq, D) in q's dtype: softmax of
    q·kᵀ/sqrt(D) over the keys, with ``causal`` those j <= i (top-left),
    times v; scores and softmax in float32 (bf16 rounds the
    probabilities to bf16 before the product with v; f32 runs its
    products in 3xTF32).  With ``lse`` -> (out, the rows' log-sum-exp,
    float32 (B, Hq, Sq) in the module's log2 domain), which the kernel
    stores beside the output.  On a CUDA device any D >= 1 (the route of
    :func:`_variant`)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if plans.capturing():
        _note(q, k, v, causal, lse)
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, causal)
        return (out, attention_lse_ref(q, k, causal)) if lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for arg, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, hkv, skv, d):
            raise ValueError(f"flash_attention: {arg} has shape "
                             f"{tuple(t.shape)}, expected {(b, hkv, skv, d)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype}, expected "
                         f"float32 or bfloat16")
    if skv < 1:
        raise ValueError(f"flash_attention: the kernels take Skv >= 1, got "
                         f"Skv={skv}")
    _build.check_operands("flash_attention", {"q": q, "k": k, "v": v},
                          q.device, dict.fromkeys("qkv", q.dtype))
    variant = _variant(q.dtype, d, [t.data_ptr() for t in (q, k, v)])
    out = torch.empty_like(q)
    rows = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
            if lse else None)
    if b * hq * sq:
        lib = _lib()
        code = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            rows.data_ptr() if lse else None, b, hq, hkv, sq, skv, d,
            int(causal), _DTYPES[q.dtype], _VARIANTS[variant],
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check_launch(lib, "flash_attention", code)
        _build.count_launch("flash_attention", f"flash_attention_{variant}")
    return (out, rows) if lse else out
