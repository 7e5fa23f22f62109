"""Mesh constructors (the port of ``repro.launch.mesh``) over
``torch.distributed``'s device meshes.

A :class:`Mesh` is one process's view of a ``DeviceMesh``: one rank a
device, as ``torchrun --nproc-per-node N`` launches them.  It reads as the
JAX package's meshes do (``dict(mesh.shape)``, ``mesh.axis_names``), so
``repro_torch.dist.sharding`` reads both kinds alike.

Functions, not module constants: importing this module starts no process
group.  When none exists and the mesh needs one device, a world of one is
made in-process (:func:`release_world` ends it); a mesh of more devices
needs the ranks launched beforehand, or a fake world (:func:`fake_world`:
this process alone plays rank 0 of N, meshes on the ``meta`` device, the
dry run's world).
"""
from __future__ import annotations

import os

import torch

from ..device import resolve_device

# the world this module started, if any (released by release_world), and
# whether it is fake
_OWN_WORLD = {"on": False, "fake": False}


class Mesh:
    """A ``DeviceMesh`` with the JAX package's reading: ``shape`` maps
    axis names to sizes, ``axis_names`` is their tuple in mesh order."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.device_type = device_mesh.device_type

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def coordinate(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def get_group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def _world(n: int, device_type: str) -> None:
    """Make sure a process group of ``n`` ranks exists: one from
    torchrun's environment, or an in-process world of one for a mesh of
    one device.  Raises if the launched world is not ``n``."""
    import torch.distributed as dist
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend)
        elif n == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
            _OWN_WORLD["on"] = True
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise RuntimeError(
            f"this mesh needs {n} ranks, one a device, but the world "
            f"launched has {have}; launch it with torchrun "
            f"--nproc-per-node {n} (or as many nodes x ranks as make {n})")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))


def fake_world(n: int) -> None:
    """Make this process rank 0 of a FAKE world of ``n`` ranks: torch's
    fake process group (``torch.testing._internal.distributed.fake_pg``),
    whose collectives return without moving a byte, so no other rank is
    launched.  Meshes of that world are made with ``device="meta"`` and
    hold shapes only (the dry run's world, ``launch/dryrun.py``);
    :func:`release_world` ends it.  Raises if a process group exists
    already, or if this torch has no fake backend."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group exists already")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"fake_world: this torch ({torch.__version__}) has no fake "
            f"process group: {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    _OWN_WORLD.update(on=True, fake=True)


def release_world() -> None:
    """End the world of one that a mesh of one device started, or the
    fake world (no-op if the process group came from elsewhere)."""
    if _OWN_WORLD["on"]:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        _OWN_WORLD.update(on=False, fake=False)


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on the GPU (or ``device="cpu"``):
    one rank a device."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    n = 1
    for s in shape:
        n *= s
    if _OWN_WORLD["fake"]:
        return _fake_mesh(shape, axes, n, device)
    device_type = resolve_device(device).type
    _world(n, device_type)
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=axes))


def _fake_mesh(shape, axes, n: int, device) -> Mesh:
    """A mesh of the fake world, whose tensors are ``meta`` ones
    (``device="meta"``).  It is a CUDA device mesh where a card is
    present, so that DTensor plans the collectives NCCL would run; on a
    host without one a CPU mesh, on which DTensor plans an all-to-all as
    an all-gather (gloo has none) and shape propagation needs no CUDA."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device is None or torch.device(device).type != "meta":
        raise RuntimeError(
            f"the world is fake (launch.mesh.fake_world): its collectives "
            f"move nothing, so its meshes take device='meta' (shapes "
            f"only), not {device!r}")
    if dist.get_world_size() != n:
        raise RuntimeError(f"this mesh needs {n} ranks; the fake world "
                           f"has {dist.get_world_size()}")
    return Mesh(init_device_mesh(
        "cuda" if torch.cuda.is_available() else "cpu", shape,
        mesh_dim_names=axes))


def world_size() -> int:
    """Ranks launched (1 when no process group exists and none was asked
    for through torchrun's environment)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 single pod (256 devices) or 2x16x16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def local_mesh(device=None) -> Mesh:
    """(1, world) over ("data", "model"): every rank launched.

    The PCN engine does not need this on one device: ``mesh=None`` (the
    default) is its fast path, with the same numerics and no
    ``torch.distributed``."""
    return make_mesh((1, world_size()), ("data", "model"), device)


def data_mesh(n_data: int | None = None, device=None) -> Mesh:
    """(n, 1) over ("data", "model"), the PCN engine's sharded serving
    mesh.  Raises an actionable error when more shards are asked for than
    ranks were launched."""
    have = world_size()
    n = have if n_data is None else n_data
    if n < 1:
        raise ValueError(f"n_data must be >= 1, got {n}")
    if n > have:
        raise ValueError(
            f"requested a {n}-way data mesh but only {have} rank(s) were "
            f"launched; launch one a device with torchrun "
            f"--nproc-per-node {n} (on the CPU add --device cpu) or lower "
            f"the request (e.g. serve --mesh-data {have})")
    return make_mesh((n, 1), ("data", "model"), device)
