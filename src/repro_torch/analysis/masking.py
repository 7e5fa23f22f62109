"""Ragged-masking lint: reductions over point axes must be guarded.

The port's counterpart of ``repro.analysis.masking``, over a ``torch.fx``
graph of ATen ops (``make_fx`` of a target's eager FC stage and tail, its
stage-1 structures fixed first so their data-dependent control flow stays
outside the graph).  A padded batch carries dead rows, and an ``amax`` or
``sum`` over the point axis silently folds them in (the ragged-batch bug
the JAX package's lint was written for); every such reduction must be
*guarded*: its operand passes through an ``n_valid``-style ``where`` /
``masked_fill`` or a ±BIG / ±inf sentinel fill upstream.

* a value becomes **guarded** when a ``where`` or ``masked_fill`` makes
  it, or when it is a sentinel constant (|value| ≥ 1e30 or infinite: a
  ``full`` / ``scalar_tensor`` / constant tensor of −BIG);
* guardedness flows through elementwise and structural ops (any guarded
  operand guards the output);
* ``mm`` / ``bmm`` / ``matmul`` / ``addmm`` / ``linear`` / convolutions
  and the reductions themselves **consume** the guard (a product mixes
  rows, so the mask must be applied again before the next pool);
* **M001** fires on a floating reduction (``amax``, ``amin``, ``sum``,
  ``mean``, ``max.dim``, ``min.dim``, ``argmax``, ``argmin``) over a dim
  whose size is in the target's point sizes, with an unguarded operand.

On the CPU the kernel wrappers run their plain versions, so the graph
holds the kernels' own masked pools (``gather_mlp_ref``,
``hub_reuse_ref``).  Nothing is launched on a card.
"""
from __future__ import annotations

import torch

from .findings import Finding

SENTINEL_ABS = 1e30

#: checked reductions (by the ATen overload packet's name)
CHECKED = ("amax", "amin", "sum", "mean", "max", "min", "argmax", "argmin")
#: ops that consume guardedness
KILL = ("mm", "bmm", "matmul", "addmm", "baddbmm", "linear", "convolution",
        "einsum") + CHECKED
#: ops whose output is a guard
GUARDS = ("where", "masked_fill")
#: ops that make a constant from their arguments
CONSTANTS = ("full", "scalar_tensor", "full_like", "fill", "new_full")


def _name(node) -> str:
    """The ATen op's name without namespace and overload (``amax``)."""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__.rstrip("_")
    return getattr(target, "__name__", str(target))


def _is_sentinel(v) -> bool:
    if isinstance(v, bool):
        return False
    if isinstance(v, (int, float)):
        return abs(v) >= SENTINEL_ABS or v != v
    if isinstance(v, torch.Tensor) and v.is_floating_point() and v.numel():
        a = v.detach().abs()
        return bool(torch.isinf(a).any() or a.max() >= SENTINEL_ABS)
    return False


def _dims(node, ndim):
    """The reduced dims of a reduction node (all dims where none)."""
    name = _name(node)
    args = list(node.args[1:]) + [node.kwargs.get("dim")]
    dim = next((a for a in args if isinstance(a, (int, list, tuple))
                and not isinstance(a, bool)), None)
    if name in ("max", "min") and dim is None:
        return list(range(ndim))          # max(x) over everything
    if dim is None or dim == []:
        return list(range(ndim))
    dims = [dim] if isinstance(dim, int) else list(dim)
    return [d % ndim for d in dims] if ndim else []


def masked_reduction_findings(gm, *, point_sizes, where: str = "graph"):
    """Run the M001 dataflow over ``gm`` (a ``torch.fx.GraphModule`` whose
    nodes carry ``meta["val"]``, as ``make_fx`` leaves them).

    ``point_sizes``: dim lengths that hold potentially padded point rows
    (cloud length N, neighbor counts K, all-sampler center counts)."""
    sizes = frozenset(int(p) for p in point_sizes)
    guard: dict = {}
    found: dict = {}
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            guard[node] = _is_sentinel(getattr(gm, node.target, None))
            continue
        if node.op != "call_function":
            guard[node] = False
            continue
        name = _name(node)
        any_in = any(guard.get(a, False) for a in node.all_input_nodes)
        if name in CHECKED:
            src = node.args[0]
            val = getattr(src, "meta", {}).get("val")
            if (isinstance(val, torch.Tensor) and val.is_floating_point()
                    and not guard.get(src, False)):
                shape = tuple(val.shape)
                dims = _dims(node, len(shape))
                hits = [d for d in dims if shape[d] in sizes]
                if hits:
                    shape_s = "x".join(map(str, shape))
                    dims_s = ",".join(map(str, dims))
                    key = (name, shape, tuple(dims))
                    found.setdefault(key, Finding(
                        "M001",
                        f"{name} over point dim(s) {hits} (size "
                        f"{[shape[d] for d in hits]}) of f"
                        f"{val.element_size() * 8}({shape_s}) with no "
                        f"n_valid mask / sentinel fill on the operand",
                        where=f"{where}/{name}({shape_s})@dims({dims_s})"))
            guard[node] = False
        elif name in GUARDS:
            guard[node] = True
        elif name in KILL:
            guard[node] = False
        elif name in CONSTANTS:
            guard[node] = any(_is_sentinel(a) for a in node.args)
        else:
            scalars = [a for a in node.args if not hasattr(a, "op")]
            guard[node] = any_in or any(_is_sentinel(a) for a in scalars)
    return list(found.values())


def trace_graph(fn, *args):
    """``make_fx`` of ``fn(*args)`` in real mode (the ops run on the given
    tensors, so data-dependent indexing traces as it ran)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    with torch.no_grad():
        return make_fx(fn, tracing_mode="real")(*args)
