"""Host-side hazards of eager PyTorch: the port's reading of the JAX
package's recompile-hazard lint (``repro.analysis.retrace``).

The port has no jit cache to defeat, but the same operand forms cost it
on every call:

* **R001** — a ``numpy.ndarray`` (or a tensor on another device than the
  entry point's) in an operand tree: the entry point copies it to the
  device on every call, silently (``engine.params.as_batch``).
* **R002** — a bare python scalar in an operand tree (warning): its dtype
  is fixed only where it meets a tensor, so bf16 and float32 paths round
  it differently (``nn/attention.py::_scaled`` keeps its scale a
  float32 tensor for that reason).
* **R003** — an unhashable value where the wrappers memoise a call's plan
  (``gather_mlp/ops.py::_resolved``, ``hub_reuse/ops.py::_resolved``
  key on the call's dims and knobs): the call cannot resolve.
* **R004** — growth of the wrappers' plan memos, of the kernel libraries
  loaded (``kernels/_build.py``) or of tile-plan store lookups across
  same-shape input mixes (the JAX package's four: a raw tensor, a
  ``Batch``, a ``Batch`` with ``n_valid``, keys of numpy origin): after
  the first call every other form must reuse what it resolved.

:func:`cache_size` is the probe R004 reads.
"""
from __future__ import annotations

import numpy as np
import torch

from .findings import Finding


def _leaf_paths(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaf_paths(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{path}[{i}]")
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            yield from _leaf_paths(getattr(tree, k), f"{path}.{k}")
    else:
        yield path, tree


def leaf_findings(tree, where: str = "operands", device=None) -> list:
    """R001/R002 over every leaf of an operand tree (dicts, lists, tuples
    and dataclasses such as ``Batch`` and ``PCNParams``) bound for an
    entry point on ``device`` (None: any device)."""
    dev = None if device is None else torch.device(device)
    out: list[Finding] = []
    for path, leaf in _leaf_paths(tree):
        loc = f"{where}{path}"
        if isinstance(leaf, torch.Tensor):
            if dev is not None and leaf.device.type != dev.type:
                out.append(Finding(
                    "R001",
                    f"tensor on {leaf.device} (shape {tuple(leaf.shape)}) "
                    f"bound for {dev}: copied on every call; move it once",
                    where=loc))
            continue
        if isinstance(leaf, np.ndarray):
            out.append(Finding(
                "R001",
                f"numpy.ndarray leaf (shape {leaf.shape}) — the entry "
                f"point copies it to the device on every call; make it a "
                f"tensor on the device once",
                where=loc))
        elif isinstance(leaf, (bool, int, float, complex)) and not \
                isinstance(leaf, np.generic):
            out.append(Finding(
                "R002",
                f"python {type(leaf).__name__} leaf {leaf!r} — its dtype "
                f"is fixed only where it meets a tensor; make it a tensor "
                f"of an explicit dtype",
                where=loc))
    return out


def static_findings(statics: dict, where: str = "statics") -> list:
    """R003 over values that end up in a memoised plan key (the spec, the
    mode, the backend, the kernel knobs)."""
    out: list[Finding] = []
    for name, value in statics.items():
        try:
            hash(value)
        except TypeError:
            out.append(Finding(
                "R003",
                f"{name!r} = {type(value).__name__} is unhashable — the "
                f"wrappers memoise each call's plan on it (freeze it: int, "
                f"tuple, frozen dataclass)",
                where=f"{where}.{name}"))
    return out


def cache_size() -> dict:
    """What a call may add the first time and never again: the wrappers'
    plan memos, the kernel libraries loaded and the store lookups."""
    from ..kernels import _build, plans
    from ..kernels.gather_mlp import ops as g_ops
    from ..kernels.hub_reuse import ops as h_ops
    return {"gather_mlp_plans": len(g_ops._MEMO),
            "hub_reuse_plans": len(h_ops._MEMO),
            "libraries": len(_build._LIBS),
            "store_lookups": plans.lookup_count()}


def cache_growth_findings(fn, arg_sets, *, where: str = "cache") -> list:
    """R004: call ``fn`` once per argument tuple in ``arg_sets`` (all of
    one shape class) and flag any count of :func:`cache_size` that grew
    after the first call.  This executes ``fn`` — keep the inputs
    small."""
    fn(*arg_sets[0])
    first = cache_size()
    for args in arg_sets[1:]:
        fn(*args)
    last = cache_size()
    grew = {k: (first[k], last[k]) for k in last if last[k] > first[k]}
    if grew:
        return [Finding(
            "R004",
            f"grew across {len(arg_sets)} same-shape input mixes after the "
            f"first: {grew} — some input form resolves its plans anew",
            where=where)]
    return []
