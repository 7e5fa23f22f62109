"""The engine's data-parallel forward under a mesh (``PCNEngine(mesh=)``,
``engine.apply(..., mesh=)``): imported only when a mesh is given, so the
single-device path never imports ``torch.distributed``.

Every rank of the mesh takes part in each forward.  Rank 0 leads: it
broadcasts a header (the batch's shape and FC backend) and the batch to
all ranks, so the others either call the same forward with the same batch
(a loop run on every rank) or :func:`follow` the leader (a server that
forms batches on rank 0 alone).  Each rank runs its contiguous block of
B / n_data rows, as ``P("data")`` lays them out, each cloud with its own
key, params whole on every rank; the (B, …) logits come back on every
rank through an ``all_gather`` along ``data``.  Ranks along ``model``
compute the same rows.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.registry import FC_BACKENDS
from .archs import get_arch
from .params import Batch

_RUN, _STOP = 1, 0


def _backends() -> tuple:
    from . import fc  # noqa: F401  (registers the kernel backends)
    return tuple(sorted(FC_BACKENDS.names()))


def _header(b: Batch | None, fc_backend: str, device) -> torch.Tensor:
    """[op, B, N, F, backend index] from rank 0 to every rank."""
    h = torch.zeros(5, dtype=torch.int64, device=device)
    if b is not None:
        h[0] = _RUN
        h[1:4] = torch.tensor((*b.xyz.shape[:2], b.feats.shape[-1]))
        h[4] = _backends().index(fc_backend)
    dist.broadcast(h, src=0)
    return h


def _share(b: Batch) -> Batch:
    """Rank 0's batch on every rank (copies: the caller's is kept)."""
    b = Batch(*(t.clone() for t in (b.xyz, b.feats, b.keys, b.n_valid)))
    for t in (b.xyz, b.feats, b.keys, b.n_valid):
        dist.broadcast(t, src=0)
    return b


def forward(params, b: Batch, spec, ctx, mesh, announced: bool = False):
    """One sharded forward of ``b`` (see the module docstring); every rank
    calls it.  ``announced``: the header was already exchanged
    (:func:`follow`).  -> (B, …) logits."""
    if not announced:
        h = _header(b, ctx.fc_backend, b.xyz.device)
        mine = torch.tensor((*b.xyz.shape[:2], b.feats.shape[-1]))
        if not torch.equal(h[1:4].cpu(), mine):
            raise RuntimeError(f"sharded forward: rank 0 runs a batch of "
                               f"shape {tuple(h[1:4].tolist())}, this rank "
                               f"{tuple(mine.tolist())}")
    b = _share(b)
    n = mesh.shape["data"]
    bsz = b.xyz.shape[0]
    if bsz % n:
        raise ValueError(f"a batch of {bsz} clouds does not divide over "
                         f"the {n}-way data mesh")
    r = mesh.coordinate("data")
    rows = slice(r * bsz // n, (r + 1) * bsz // n)
    local = get_arch(spec).forward(params, spec, b.xyz[rows],
                                   b.feats[rows], b.keys[rows], ctx,
                                   b.n_valid[rows]).contiguous()
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=mesh.get_group("data"))
    return torch.cat(parts, dim=0)


def follow(engine, params) -> int:
    """Serve rank 0's forwards on a rank that is not rank 0 until rank 0
    calls :func:`release`; ``engine`` is this rank's twin of rank 0's (the
    FC backend of each forward comes with its header).  -> the forwards
    run."""
    twins = {}
    count = 0
    while True:
        h = _header(None, "", engine.device)
        if int(h[0]) == _STOP:
            return count
        bsz, n_pts, f = (int(v) for v in h[1:4])
        backend = _backends()[int(h[4])]
        eng = twins.get(backend)
        if eng is None:
            eng = twins[backend] = (engine if backend == engine.fc_backend
                                    else engine.twin(backend))
        dev = engine.device
        b = Batch(torch.empty((bsz, n_pts, 3), device=dev),
                  torch.empty((bsz, n_pts, f), device=dev),
                  torch.empty((bsz, 2), dtype=torch.int64, device=dev),
                  torch.empty((bsz,), dtype=torch.int64, device=dev))
        with torch.no_grad():
            forward(params, b, eng.spec, eng.ctx, eng.mesh, announced=True)
        count += 1


def release(device) -> None:
    """On rank 0: end the other ranks' :func:`follow` loops."""
    _header(None, "", device)
