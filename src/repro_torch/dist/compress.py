"""Gradient compression codecs with error feedback (the port of
``repro.dist.compress``).

Each step quantizes ``g + ef`` and carries the quantization residual into
the next step, so residuals never accumulate (``sum(compressed) = sum(g)
+ ef_0 - ef_T``).

    ef = init_error_feedback(grads)
    dg, ef = compress_grads(grads, ef)          # int8 by default

``make_compressor`` adapts a codec to the ``compressor`` hook of
``lm.steps.make_train_step`` (error feedback rides in
``opt_state["ef"]``; seed it with :func:`init_error_feedback` before the
first step, as ``launch/train.py --compress`` does).
"""
from __future__ import annotations

import torch

from .. import tree


def init_error_feedback(grads):
    """Zero residual tree (f32, the codec's accumulation dtype)."""
    return tree.map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _quant_int8(v):
    """Symmetric per-tensor int8 quantization (the wire carries the int8
    payload and one f32 scale; here it is round-tripped)."""
    s = torch.clamp_min(v.abs().max(), 1e-30) / 127.0
    return torch.round(v / s) * s


def _topk(frac: float):
    def q(v):
        flat = v.reshape(-1)
        k = max(int(flat.shape[0] * frac), 1)
        thresh = torch.topk(flat.abs(), k).values[-1]
        return torch.where(v.abs() >= thresh, v, 0.0)
    return q


_CODECS = {"int8": _quant_int8}


def compress_grads(grads, ef, codec: str = "int8", topk_frac: float = 0.1):
    """-> (compressed grads, new error feedback).  ``codec``: ``"int8"``
    (symmetric 8-bit quantization) or ``"topk"`` (magnitude
    sparsification keeping ``topk_frac`` of entries)."""
    q = _topk(topk_frac) if codec == "topk" else _CODECS[codec]
    acc = tree.map(lambda g, e: g.float() + e, grads, ef)
    dg = tree.map(q, acc)
    new_ef = tree.map(lambda a, d: a - d, acc, dg)
    dg = tree.map(lambda d, g: d.to(g.dtype), dg, grads)
    return dg, new_ef


def make_compressor(codec: str = "int8", topk_frac: float = 0.1):
    """Adapt a codec to ``make_train_step(compressor=...)``:
    compressor(grads, opt_state) -> (grads, opt_state), with the error
    feedback carried in ``opt_state["ef"]`` (seeded with
    :func:`init_error_feedback` before the first step)."""
    def compressor(grads, opt_state):
        if "ef" not in opt_state:
            raise ValueError(
                "opt_state has no 'ef' entry; seed it with "
                "dist.compress.init_error_feedback(params) before the "
                "first step (launch/train.py --compress does this)")
        dg, ef = compress_grads(grads, opt_state["ef"], codec=codec,
                                topk_frac=topk_frac)
        return dg, {**opt_state, "ef": ef}
    return compressor
