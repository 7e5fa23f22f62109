"""Sharding rules (the port of ``repro.dist.sharding``): logical axes,
constraint helpers, sharding trees, over ``torch.distributed.tensor``.

Model code never names mesh axes: it constrains activations along
*logical* axes, which this module maps onto the active mesh:

  ``dp``    data parallel (batch rows)   -> every data-like mesh axis
                                            (``pod`` and ``data``)
  ``fsdp``  parameter sharding           -> ``data``
  ``tp``    tensor parallel              -> ``model``
  ``sp``    sequence parallel (between   -> ``model`` (Megatron-SP),
            blocks)                         off when ``use_mesh(sp=False)``

The rules (:func:`param_spec`, :func:`fit_spec`, :func:`_physical`, the
specs of :func:`batch_shardings` / :func:`cache_shardings`) are the JAX
package's, entry for entry: a spec is a tuple with one entry a tensor
dim, a mesh axis name, a tuple of them, or None.  A :class:`Sharding`
turns a spec into DTensor placements: ``Shard(dim)`` on each mesh
dimension an entry names (of more than one rank), ``Replicate()`` on the
others.  Meshes are read
through ``dict(mesh.shape)`` and ``mesh.axis_names`` only, so the rules
take ``repro_torch.launch.mesh.Mesh`` and the JAX package's meshes alike.

Outside a :func:`use_mesh` context every ``constrain`` is a no-op, and a
plain tensor passes through one unchanged: the single-device path runs as
it did.
"""
from __future__ import annotations

import sys
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass

import torch

from .. import tree as _tree

# (mesh, {logical name -> physical axis or tuple or None}) of the
# innermost use_mesh context; None when no mesh is active
_ACTIVE: ContextVar[tuple | None] = ContextVar(
    "repro_torch_dist_active_mesh", default=None)

_DATA_AXES = ("pod", "data")


def _mesh_sizes(mesh) -> dict:
    return dict(mesh.shape)


def _dp_axes(mesh):
    """All data-like axes present on ``mesh`` (batch rows shard over the
    product of pod x data)."""
    names = set(mesh.axis_names)
    axes = tuple(a for a in _DATA_AXES if a in names)
    return axes if len(axes) != 1 else axes[0]


def _physical(mesh, sp: bool = True, profile: str = "tp") -> dict:
    names = set(mesh.axis_names)
    model = "model" if "model" in names and profile != "flat_dp" else None
    return {
        "dp": _dp_axes(mesh) or None,
        "fsdp": "data" if "data" in names else None,
        "tp": model,
        "sp": model if sp else None,
    }


@contextmanager
def use_mesh(mesh, sp: bool = True, profile: str = "tp"):
    """Activate ``mesh`` for :func:`constrain` / :func:`constrain_heads`.
    ``sp`` gates sequence sharding between blocks
    (``ArchConfig.seq_shard_blocks``); ``profile`` selects the logical
    mapping (``ArchConfig.shard_profile``).  Nests and restores."""
    token = _ACTIVE.set((mesh, _physical(mesh, sp=sp, profile=profile)))
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The mesh of the innermost :func:`use_mesh` context (or None)."""
    active = _ACTIVE.get()
    return active[0] if active is not None else None


def fit_spec(spec, shape, mesh) -> tuple:
    """Drop spec entries whose mesh-axis product does not divide the
    dimension (replicate them).  ``spec`` may be shorter than ``shape``;
    missing trailing dims are replicated.  Entries read as a JAX
    ``PartitionSpec`` reads them: ``()`` is None, ``("a",)`` is "a"."""
    sizes = _mesh_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if isinstance(entry, tuple) and len(entry) < 2:
            entry = entry[0] if entry else None
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(entry if n and dim % n == 0 else None)
    return tuple(out)


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh; ``placements`` are its DTensor placements, one a
    mesh dimension: ``Shard(dim)`` where the spec splits ``dim`` over it,
    ``Replicate()`` elsewhere and on a mesh dimension of size 1 (the same
    layout, and one DTensor propagates through every op)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        sizes = _mesh_sizes(self.mesh)
        out = [Replicate()] * len(self.mesh.axis_names)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if sizes[a] > 1:
                    out[self.mesh.axis_names.index(a)] = Shard(dim)
        return tuple(out)

    def distribute(self, t):
        """The full tensor ``t`` (the same on every rank) as a DTensor of
        these placements, each rank keeping its own shard; a DTensor
        redistributed to them."""
        from torch.distributed.tensor import distribute_tensor
        if is_dtensor(t):
            return t.redistribute(self.mesh.device_mesh, self.placements)
        return distribute_tensor(t.detach(), self.mesh.device_mesh,
                                 self.placements, src_data_rank=None)


def _sharding(mesh, spec, shape) -> Sharding:
    return Sharding(mesh, fit_spec(spec, shape, mesh))


def _logical_spec(phys, logical) -> tuple:
    return tuple(phys.get(name) if name else None for name in logical)


def _redistribute(x, spec, mesh):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = _sharding(mesh, spec, x.shape).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh.device_mesh, placements)


def constrain(x, *logical):
    """Lay ``x`` out along logical axes (one name or None a dim): a
    DTensor is redistributed to the placements :func:`fit_spec` gives, a
    plain tensor passes through.  No-op outside :func:`use_mesh`."""
    active = _ACTIVE.get()
    if active is None:
        return x
    mesh, phys = active
    return _redistribute(x, _logical_spec(phys, logical), mesh)


def gather_seq(x):
    """A (B, S, D) activation with its sequence whole on every model rank
    (batch over the data axes), as Megatron's sequence parallelism
    gathers it before a block's products: DTensor (torch 2.11) cannot
    fold a sequence split over the model axis into the rows of a product.
    No-op outside :func:`use_mesh`; a plain tensor passes through."""
    return constrain(x, "dp", None, None)


def lookup(table, ids):
    """``table[ids]``: an embedding lookup.  Under a mesh the ids are
    replicated first, so that its gradient (an accumulating
    ``index_put``) meets no split index, for which DTensor (torch 2.11)
    has no working rule; the rows come out whole on every rank and are
    laid out by the caller's next ``constrain``.  The table's gradient
    comes back in its own layout (:func:`pin_grad`)."""
    if is_dtensor(ids):
        from torch.distributed.tensor import Replicate
        ids = ids.redistribute(ids.device_mesh,
                               [Replicate()] * ids.device_mesh.ndim)
    return pin_grad(table)[ids]


def pin_grad(t):
    """``t`` itself, whose gradient comes back laid out as ``t`` is (a
    partial sum reduced into its shards).  For a parameter read twice (a
    tied embedding: the lookup and the head), autograd then adds two
    gradients of one layout: DTensor (torch 2.11) cannot turn a shard into
    the partial sum that the other read's gradient is.  A plain tensor
    passes through."""
    if not is_dtensor(t):
        return t
    return _PinGrad.apply(t)


class _PinGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.layout = (t.device_mesh, tuple(t.placements))
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        mesh, placements = ctx.layout
        if tuple(grad.placements) == placements:
            return grad
        return grad.redistribute(mesh, placements)


def heads_spec(phys, sizes, n_heads: int) -> tuple:
    """(B, S, H, Dh): batch over ``dp``, heads over ``tp`` only where the
    head count divides the model axis (few KV heads stay replicated)."""
    tp = phys.get("tp")
    heads = tp if tp is not None and n_heads % sizes[tp] == 0 else None
    return (phys.get("dp"), None, heads, None)


def constrain_heads(x, n_heads: int):
    """Constrain a (B, S, H, Dh) tensor by :func:`heads_spec`.  No-op
    outside :func:`use_mesh`; a plain tensor passes through."""
    active = _ACTIVE.get()
    if active is None:
        return x
    mesh, phys = active
    return _redistribute(x, heads_spec(phys, _mesh_sizes(mesh), n_heads),
                         mesh)


def constrain_heads_flat(x, n_heads: int):
    """Constrain a (B, S, H·Dh) tensor as :func:`constrain_heads` lays
    out its (B, S, H, Dh) view: the last dim over ``tp`` only where the
    head count divides the model axis, so that the split into heads is a
    local view on every rank.  No-op outside :func:`use_mesh`; a plain
    tensor passes through."""
    active = _ACTIVE.get()
    if active is None:
        return x
    mesh, phys = active
    dp, _, heads, _ = heads_spec(phys, _mesh_sizes(mesh), n_heads)
    return _redistribute(x, (dp, None, heads), mesh)


# ---------------------------------------------------------------------------
# DTensors at the model's seams
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing
    ``torch.distributed`` when nothing has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def replicated_like(t, x):
    """``t`` (a plain tensor the same on every rank: a table, a mask, a
    zero state) as a replicated DTensor on ``x``'s mesh where ``x`` is a
    DTensor; else ``t`` itself."""
    if not is_dtensor(x) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def like(x, ref):
    """``x`` laid out as the DTensor ``ref`` is (a decode step's new
    recurrent state handed back in its cache's layout, as the JAX
    package's ``out_shardings`` do); ``x`` itself where either is a plain
    tensor."""
    if not (is_dtensor(x) and is_dtensor(ref)):
        return x
    if tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def write_slot(cache, at: int, new) -> None:
    """``cache[:, at] = new[:, 0]`` in place.  On a DTensor cache (laid
    out by :func:`cache_shardings`: batch over the data axes, heads over
    ``model`` where the count divides it, else replicated) each rank
    writes its own shard: ``new`` is laid out as the cache is, and its
    local rows go into the cache's local shard."""
    if not is_dtensor(cache):
        cache[:, at] = new[:, 0]
        return
    new = new.redistribute(cache.device_mesh, cache.placements)
    cache.to_local()[:, at] = new.to_local()[:, 0]


def whole(x):
    """A DTensor's whole value as a plain tensor on every rank (which then
    computes the same thing from it on each); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def carry(fn):
    """``fn`` to be run later under the mesh context active now: autograd
    recomputes a checkpointed layer on its own thread (one a device on
    the GPU), where this module's context variable is not set."""
    active = _ACTIVE.get()
    if active is None:
        return fn

    def run(*args, **kwargs):
        token = _ACTIVE.set(active)
        try:
            return fn(*args, **kwargs)
        finally:
            _ACTIVE.reset(token)
    return run


def _active():
    active = _ACTIVE.get()
    if active is None:
        raise RuntimeError("a DTensor reached a sharded seam outside "
                           "dist.sharding.use_mesh")
    return active


def local_call(fn, args, in_specs, out_specs, out_shapes):
    """``fn`` on each rank's shards of the DTensors ``args``, laid out by
    ``in_specs`` (mesh-axis specs, already fitted), its outputs wrapped
    as DTensors of ``out_specs`` and global ``out_shapes``.  This is how
    a kernel wrapper, which takes plain tensors only, runs under a mesh.
    An input replicated over a mesh axis that an output is sharded over
    gets its gradient back as a partial sum over that axis."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, _ = _active()
    outs_sh = [Sharding(mesh, s).placements for s in out_specs]
    split = {d for pl in outs_sh for d, p in enumerate(pl)
             if not isinstance(p, Replicate)}
    local = []
    for x, spec in zip(args, in_specs):
        pl = Sharding(mesh, spec).placements
        grad_pl = tuple(Partial() if d in split and isinstance(p, Replicate)
                        else p for d, p in enumerate(pl))
        local.append(x.redistribute(mesh.device_mesh, pl).to_local(
            grad_placements=grad_pl).contiguous())
    res = fn(*local)
    single = not isinstance(res, (tuple, list))
    res = (res,) if single else res
    out = tuple(
        DTensor.from_local(r.contiguous(), mesh.device_mesh, pl,
                           run_check=False,
                           shape=torch.Size(shape),
                           stride=_contiguous_stride(shape))
        for r, pl, shape in zip(res, outs_sh, out_shapes))
    return out[0] if single else out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def coordinate(axis) -> int:
    """This rank's coordinate along ``axis`` (a mesh axis or a tuple of
    them, major first) of the active mesh."""
    mesh, _ = _active()
    axes = axis if isinstance(axis, tuple) else (axis,)
    c = 0
    for a in axes:
        c = c * mesh.shape[a] + mesh.device_mesh.get_local_rank(a)
    return c


def axis_size(axis) -> int:
    mesh, _ = _active()
    n = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        n *= mesh.shape[a]
    return n


def physical():
    """The active context's logical->physical mapping and mesh sizes."""
    mesh, phys = _active()
    return phys, _mesh_sizes(mesh)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

# column-parallel 2-D matrices (d_in, d_out): shard d_in over fsdp,
# d_out over tp (inputs replicated within a TP group, outputs split)
_COL = {"wq", "wk", "wv", "w_in", "w_gate", "w_x", "w_r", "w_i",
        "in_proj", "router", "lm_head"}
# row-parallel 2-D matrices (d_in, d_out): the contracted dim is the
# TP-split one (wo consumes TP-split head outputs)
_ROW = {"wo", "w_out", "out_proj"}


def param_spec(path: str, leaf, moe_shard: str = "ep") -> tuple:
    """Logical partition of one parameter leaf.

    ``path`` is the ``/``-joined tree path (e.g. ``layers/0/mixer/wq``);
    ``leaf`` only needs ``.ndim``.  3-D leaves are stacked per-expert
    weights: ``moe_shard="ep"`` puts experts on the model axis (expert
    parallelism), ``"tp"`` shards inside each expert instead.
    """
    ndim = leaf.ndim
    if ndim == 0:
        return ()
    if ndim == 1:
        return (None,)
    name = path.rsplit("/", 1)[-1]
    if ndim == 3:  # (E, d_in, d_out) stacked expert weights
        if name in _ROW:
            return ("tp", None, "fsdp") if moe_shard == "ep" \
                else (None, "tp", "fsdp")
        return ("tp", "fsdp", None) if moe_shard == "ep" \
            else (None, "fsdp", "tp")
    if ndim == 2:
        if name == "embed":
            return ("tp", "fsdp")        # (V, D): vocab over model
        if name == "conv_w":
            return (None, "tp")          # depthwise conv: channels split
        if name in _ROW:
            return ("tp", "fsdp")
        if name in _COL:
            return ("fsdp", "tp")
        return ("fsdp", None)
    return (None,) * ndim


def _resolve(mesh):
    """The logical->physical mapping: the active context's if this mesh
    is the active one, else the default profile for ``mesh``."""
    active = _ACTIVE.get()
    if active is not None and active[0] is mesh:
        return active[1]
    return _physical(mesh)


def param_shardings(params, mesh, moe_shard: str = "ep"):
    """A tree of :class:`Sharding` for a parameter / optimizer-state tree
    (leaves need ``.ndim`` and ``.shape``)."""
    phys = _resolve(mesh)
    return _tree.unflatten(params, [
        _sharding(mesh, _logical_spec(phys, param_spec(path, leaf,
                                                       moe_shard)),
                  leaf.shape)
        for path, leaf in zip(_tree.paths(params), _tree.leaves(params))])


def batch_shardings(batch, mesh):
    """A tree of :class:`Sharding` for step inputs: the leading (batch)
    dim over the data axes, everything else replicated.  Shared by the LM
    steps and the PCN engine."""
    dp = _dp_axes(mesh) or None
    return _tree.map(
        lambda leaf: _sharding(mesh, (dp,) if leaf.ndim else (),
                               leaf.shape), batch)


def cache_shardings(cache, mesh):
    """A tree of :class:`Sharding` for decode caches: batch over ``dp``,
    the head/channel dim over ``tp`` where it divides (KV heads, SSD
    heads, conv/recurrent channels)."""
    phys = _resolve(mesh)
    dp, tp = phys.get("dp"), phys.get("tp")
    out = []
    for path, leaf in zip(_tree.paths(cache), _tree.leaves(cache)):
        name = path.rsplit("/", 1)[-1]
        nd = leaf.ndim
        if nd >= 4 and name in ("k", "v", "xk", "xv"):
            spec = (dp, None, tp, None)        # (B, T, Hkv, Dh)
        elif nd == 3 and name in ("ks", "vs", "conv"):
            spec = (dp, None, tp)              # (B, T, Hkv) / (B, W, C)
        elif name == "state":
            spec = (dp, tp)                    # (B, H, ...) / (B, D)
        elif nd >= 1:
            spec = (dp,)
        else:
            spec = ()
        out.append(_sharding(mesh, spec, leaf.shape))
    return _tree.unflatten(cache, out)


def distribute(tree, shardings):
    """Each leaf of ``tree`` (full, or a DTensor) as the DTensor its
    :class:`Sharding` in ``shardings`` (a matching tree) gives."""
    return _tree.map(lambda t, sh: sh.distribute(t), tree, shardings)

