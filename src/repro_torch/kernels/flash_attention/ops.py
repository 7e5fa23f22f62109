"""Wrapper of the flash_attention CUDA kernels (``csrc/flash_attention.cu``).

A CPU tensor takes the plain PyTorch version (:func:`attention_ref`); a
CUDA tensor launches the kernel that :func:`_variant` names or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "wgmma": 1}


def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_forward.argtypes = [_P] * 4 + [_I] * 9 + [_P]
    lib.flash_attention_forward.restype = _I
    return lib


def _variant(dtype, d: int, ptrs=()) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` (bf16 products on the
    tensor cores, fed by TMA, whose base addresses and rows must be
    multiples of 16 bytes) for bfloat16 with D % 8 == 0 and every address
    in ``ptrs`` 16-byte aligned, else ``"simt"`` (fp32 products on the
    CUDA cores)."""
    aligned = all(p % 16 == 0 for p in ptrs)
    return ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and aligned
            else "simt")


def flash_attention(q, k, v, causal: bool = True):
    """Attention forward, GQA-aware.

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with Hq % Hkv == 0; float32 or
    bfloat16, all of one dtype.  -> (B, Hq, Sq, D) in q's dtype: softmax of
    q·kᵀ/sqrt(D) over the keys, with ``causal`` those j <= i (top-left),
    times v; scores and softmax in float32 (the bf16 tensor-core route
    rounds the probabilities to bf16 before the product with v; a bf16
    operand that is not 16-byte aligned takes the CUDA-core kernel)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for arg, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, hkv, skv, d):
            raise ValueError(f"flash_attention: {arg} has shape "
                             f"{tuple(t.shape)}, expected {(b, hkv, skv, d)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype}, expected "
                         f"float32 or bfloat16")
    if not 0 < d <= MAX_D or skv < 1:
        raise ValueError(f"flash_attention: the kernel takes 0 < D <= "
                         f"{MAX_D} and Skv >= 1, got D={d}, Skv={skv}")
    _build.check_operands("flash_attention", {"q": q, "k": k, "v": v},
                          q.device, dict.fromkeys("qkv", q.dtype))
    out = torch.empty_like(q)
    if b * hq * sq:
        variant = _variant(q.dtype, d, [t.data_ptr() for t in (q, k, v)])
        lib = _lib()
        code = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, skv, d, int(causal), _DTYPES[q.dtype],
            _VARIANTS[variant],
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check_launch(lib, "flash_attention", code)
        _build.count_launch("flash_attention", f"flash_attention_{variant}")
    return out
