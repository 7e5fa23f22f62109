"""Analysis targets: what ``python -m repro_torch.analysis`` runs and
checks.

A :class:`Target` is one (entry point, input shape class) pair: a
closure that runs it once (its kernel calls are captured as sites, on
the target's device), a closure that traces its FC stage and tail to an
ATen graph on the CPU for the masking lint (None where it has none), the
operand tree a caller passes (for the R001/R002 leaf scan), the values
that reach the wrappers' memoised plan keys (for R003), and the *point
sizes*: the dim lengths that carry potentially padded point rows.

The default matrix is the JAX package's: all four model families × both
modes × the eager ``reference`` and the kernels' ``cuda`` FC backends
at reduced N = 96 shapes and a ragged (96, 70, 57) batch, plus the
serving dispatcher's partial batch (numpy clouds and numpy keys through
``Batch.from_clouds``) and the sharded engine under a one-rank mesh.  The
three entry kernels, which no PCN forward launches, get one target each
at the LM configs' reduced widths (``entry:*``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device

MODELS = ("pointnet2", "dgcnn", "pointnext", "pointvector")
MODES = ("traditional", "lpcn")
BACKENDS = ("reference", "cuda")
ENTRIES = ("knn", "flash_attention", "ssd_chunk", "hub_reuse")

_N = 96
_SIZES = (96, 70, 57)


@dataclass
class Target:
    name: str
    run: Callable[[], Any]               # the forward, once
    trace: Callable[[], Any] | None = None   # -> torch.fx.GraphModule
    operands: Any = None                 # for the R001/R002 leaf scan
    statics: dict = field(default_factory=dict)   # for the R003 check
    point_sizes: frozenset = frozenset()
    family: str | None = None
    device: torch.device = torch.device("cpu")


def reduced_specs() -> dict:
    """The 4 reduced model specs the analyzer runs at (the JAX package's):
    N = 96, two small blocks per family."""
    from ..models import MODEL_ZOO, dgcnn, pointnet2
    from ..models.common import BlockSpec
    return {
        "pointnet2": replace(pointnet2.POINTNET2_C, blocks=(
            BlockSpec(48, 8, (16, 32)), BlockSpec(16, 8, (32, 48)))),
        "dgcnn": replace(dgcnn.with_points(dgcnn.DGCNN_C, _N), blocks=(
            BlockSpec(_N, 8, (24,), kind="edge", sampler="all"),
            BlockSpec(_N, 8, (32,), kind="edge", sampler="all"))),
        "pointnext": replace(MODEL_ZOO["pointnext_s"][1], blocks=(
            BlockSpec(48, 8, (24,)), BlockSpec(16, 8, (32,)))),
        "pointvector": replace(MODEL_ZOO["pointvector_l"][1], blocks=(
            BlockSpec(48, 8, (24,)), BlockSpec(16, 8, (48,)))),
    }


def spec_point_sizes(spec, n: int) -> frozenset:
    """Dim lengths where padded point rows can appear for ``spec`` at
    padded cloud length ``n``: the cloud axis, every neighbor axis, and
    center axes of blocks that keep all rows (``sampler="all"``).
    Downsampled center axes are fully valid by construction and are
    excluded."""
    sizes = {n}
    for b in spec.blocks:
        sizes.add(b.k)
        if b.sampler == "all":
            sizes.add(min(b.n_centers, n))
    return frozenset(sizes)


def _clouds(spec, sizes=_SIZES, seed=0):
    from ..data.synthetic import make_cloud
    rng = np.random.default_rng(seed)
    b = len(sizes)
    xyz = np.stack([make_cloud(rng, _N) for _ in range(b)]).astype(
        np.float32)
    feats = None
    if spec.in_feats > 3:
        feats = np.concatenate([xyz, rng.uniform(
            0, 1, (b, _N, spec.in_feats - 3)).astype(np.float32)], -1)
    return xyz, feats


def make_batch(spec, device, sizes=_SIZES, seed=0):
    """The matrix's ragged batch: (3, 96) clouds, n_valid (96, 70, 57)."""
    from .. import random
    from ..engine.params import Batch
    xyz, feats = _clouds(spec, sizes, seed)
    return Batch.make(xyz, feats, key=random.PRNGKey(7), n_valid=list(sizes),
                      device=device)


def fc_graph(spec, mode: str, backend: str, params, batch):
    """The FC stage and tail of one forward as an ATen graph (CPU): stage 1
    runs first, eagerly, and its structures are constants of the
    graph."""
    from ..engine.archs import EngineCtx, get_arch
    from .masking import trace_graph
    arch = get_arch(spec)
    ctx = EngineCtx.make(mode=mode, fc_backend=backend)
    with torch.no_grad():
        structs, nv_levels = arch.structure(spec, ctx, batch.xyz, batch.keys,
                                            batch.n_valid)

    def fn(xyz, feats):
        state = arch.features(params, spec, ctx, xyz, feats, structs)
        return arch.tail(params, spec, state, nv_levels, batch.n_valid)
    return trace_graph(fn, batch.xyz, batch.feats)


def _engine_target(model, mode, backend, spec, device, mesh=None,
                   tag="engine", batch=None, operands=None) -> Target:
    from .. import engine
    params = engine.init(spec, 0, device)
    batch = make_batch(spec, device) if batch is None else batch

    def run():
        return engine.apply(params, batch, spec=spec, mode=mode,
                            fc_backend=backend, device=device, mesh=mesh)

    def trace():
        cpu = torch.device("cpu")
        p = params if device.type == "cpu" else engine.init(spec, 0, cpu)
        return fc_graph(spec, mode, backend, p, batch.to(cpu))

    return Target(
        name=f"{tag}:{model}/{mode}/{backend}", run=run, trace=trace,
        operands=operands or {"params": params, "batch": batch},
        statics={"spec": spec, "mode": mode, "fc_backend": backend},
        point_sizes=spec_point_sizes(spec, _N), family=model, device=device)


def _serve_target(spec, device) -> Target:
    """The dispatcher's partial-batch path: numpy clouds, one of them an
    empty fill row, and a stacked numpy key array through
    ``Batch.from_clouds`` into the bucket's forward."""
    from .. import random
    from ..engine.params import Batch
    rng = np.random.default_rng(0)
    clouds = [rng.standard_normal((sz, 3)).astype(np.float32)
              for sz in (96, 70)] + [np.zeros((0, 3), np.float32)]
    keys = np.stack([random.PRNGKey(i + 1).numpy() for i in range(2)]
                    + [random.PRNGKey(0).numpy()]).astype(np.uint32)
    batch = Batch.from_clouds(clouds, key=keys, n_pad=_N, device=device)
    t = _engine_target("pointnet2", "lpcn", "cuda", spec, device,
                       tag="serve", batch=batch)
    t.name = "serve:pointnet2/lpcn/cuda"
    return t


def _dist_target(spec, device) -> Target:
    """The sharded entry point (``engine/sharded.py``) under a one-rank
    data mesh: a world of one in this process, ended after the run."""
    from ..launch import mesh as lmesh
    t = _engine_target("pointnet2", "lpcn", "cuda", spec, device,
                       tag="dist")

    def sharded():
        from .. import engine
        m = lmesh.data_mesh(1, device)
        try:
            return engine.apply(t.operands["params"], t.operands["batch"],
                                spec=spec, mode="lpcn", fc_backend="cuda",
                                device=device, mesh=m)
        finally:
            lmesh.release_world()
    t.run = sharded
    return t


def _entry_targets(device, names=ENTRIES) -> list:
    """One target per entry kernel, at the widths of its model's reduced
    config: knn over a 96-point cloud (k = 8) and over 1024 points
    (k = 300, lists past the registers), flash_attention at olmo-1b's
    reduced heads in float32 and bfloat16 and at a head of 320 (the split
    route), ssd_chunk at mamba2-2.7b's reduced widths and at a chunk of
    160 (the tiled route); and one for the FC kernel's routes that no
    reduced spec reaches: hub_reuse at C = 128 and D = 387 and 700 (the
    layered route)."""
    from ..configs import get_config
    gen = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(device=device,
                                                    dtype=dtype)
    out = []
    if "knn" in names:
        from ..kernels.knn import knn
        calls = [(r(48, 3), r(96, 3), 8), (r(64, 3), r(1024, 3), 300)]
        out.append(Target("entry:knn",
                          lambda calls=calls: [knn(*c) for c in calls],
                          operands={"calls": [c[:2] for c in calls]},
                          statics={"k": tuple(c[2] for c in calls)},
                          device=device))
    if "flash_attention" in names:
        from ..kernels.flash_attention import flash_attention
        cfg = get_config("olmo-1b", reduced=True)
        hq, hkv, d = cfg.n_heads, cfg.n_kv, cfg.hd
        calls = [tuple(r(2, h, 64, d, dtype=dt) for h in (hq, hkv, hkv))
                 for dt in (torch.float32, torch.bfloat16)]
        calls.append(tuple(r(1, h, 64, 320, dtype=torch.bfloat16)
                           for h in (hq, hkv, hkv)))
        out.append(Target(
            "entry:flash_attention",
            lambda calls=calls: [flash_attention(*c, causal=True)
                                 for c in calls],
            operands={"calls": calls}, device=device))
    if "ssd_chunk" in names:
        from ..kernels.ssd_chunk import ssd_chunk
        cfg = get_config("mamba2-2.7b", reduced=True)
        h = cfg.ssm_heads
        p, s, q = cfg.ssm_headdim, cfg.ssm_state, cfg.ssd_chunk
        dt = torch.rand((2, 2, q, h), generator=gen).to(device) * 0.1
        args = (r(2, 2, q, h, p), r(2, 2, q, s), r(2, 2, q, s), dt,
                torch.cumsum(-dt, 2))
        dt2 = torch.rand((1, 1, 160, h), generator=gen).to(device) * 0.1
        long = (r(1, 1, 160, h, p), r(1, 1, 160, s), r(1, 1, 160, s), dt2,
                torch.cumsum(-dt2, 2))
        out.append(Target("entry:ssd_chunk",
                          lambda: [ssd_chunk(*args), ssd_chunk(*long)],
                          operands={"args": args, "long": long},
                          device=device))
    if "hub_reuse" in names:
        from ..kernels.hub_reuse import hub_reuse
        calls = []
        for d in (387, 700):
            slot = torch.randint(-1, 128, (1, 1, 8, 8), generator=gen,
                                 dtype=torch.int32).to(device)
            calls.append((r(1, 1, 128, d), slot, r(1, 1, 8, 16), r(d, 16),
                          r(16), r(16, 16), r(16)))
        out.append(Target(
            "entry:hub_reuse",
            lambda calls=calls: [hub_reuse(*c) for c in calls],
            operands={"calls": calls}, device=device))
    return out


# The level-2 SA pools reduce over neighbors gathered from FPS-downsampled
# centers, which are fully valid by construction (the engine's nv_levels
# goes None below the first downsampling block: core/pipeline.py), so they
# run the unmasked pool.  M001 cannot see that from the graph (K = 8
# collides with the masked level-1 pools), so the level-2 pool shapes of
# the reduced matrix are suppressed here, next to the matrix, as the JAX
# package suppresses them.  dgcnn (sampler="all") keeps masks live at
# every level and is checked unsuppressed.
# analysis: allow M001 */amax(3x16x8x48)@dims(2) -- level-2 SA pool over fully-valid FPS centers (pointnet2, pointvector)
# analysis: allow M001 */amax(3x16x8x32)@dims(2) -- level-2 SA pool over fully-valid FPS centers (pointnext)
def default_targets(models=MODELS, modes=MODES, backends=BACKENDS,
                    include_serve: bool = True, include_dist: bool = True,
                    include_entries: bool = True,
                    device=None) -> list[Target]:
    """The matrix on ``device`` (the card by default, as every entry
    point of the port; ``"cpu"`` for the kernels' plain versions)."""
    device = resolve_device(device)
    specs = reduced_specs()
    out = []
    for model in models:
        for mode in modes:
            for backend in backends:
                out.append(_engine_target(model, mode, backend, specs[model],
                                          device))
    if include_serve:
        out.append(_serve_target(specs["pointnet2"], device))
    if include_dist:
        out.append(_dist_target(specs["pointnet2"], device))
    if include_entries:
        out.extend(_entry_targets(device))
    return out
