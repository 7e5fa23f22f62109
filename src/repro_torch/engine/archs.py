"""Architecture families: init + batched two-stage forward.

Every family of the JAX package is here, registered under the leading
token of ``spec.name`` ("pointnet2", "dgcnn", "pointnext",
"pointvector"); names of no known family take the generic SA stack.  A
forward runs in three parts, each a field of :class:`Arch`:

  * ``structure`` — stage 1 for the whole batch: every block's DS →
    octree → islandize → hub-schedule (coordinates and keys only);
  * ``features`` — stage 2: the FC dataflows block by block through the
    backend, one launch per dataflow per block (plus the stem and the
    per-stage residuals of PointNeXt / PointVector, plain matmuls);
  * ``tail`` — the global pool and the head (cls) or the FP decoder and
    the masked per-point head (seg).

The key-split sequences mirror the JAX package, so the same per-cloud keys
give the same hubs.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import random
from ..core.mlp import apply_mlp, init_mlp
from ..core.pipeline import (BIG, LPCNConfig, compute_block_features_batched,
                             structure_block)
from ..core.registry import Registry, get_fc_backend
from ..core.sampling import sqdist
from ..core.workload import WorkloadReport, analyze
from ..kernels.tiling import CHUNKS, ROWS
from .params import PCNParams
from .spec import BlockSpec, PCNSpec, arch_of, block_in_dim

ARCHS = Registry("arch")


@dataclass(frozen=True)
class Arch:
    """One family.  init(spec, generator, device) -> PCNParams;
    structure(spec, ctx, xyz, keys, n_valid) -> (structs, nv_levels);
    features(params, spec, ctx, xyz, feats, structs) -> state;
    tail(params, spec, state, nv_levels, n_valid) -> logits, (B, n_classes)
    for cls and (B, N, n_classes) for seg with padding rows zero."""
    name: str
    init: callable
    structure: callable
    features: callable
    tail: callable

    def forward(self, params, spec, xyz, feats, keys, ctx, n_valid=None,
                with_report=False):
        """-> logits, or (logits, :func:`structure_report`) with
        ``with_report``."""
        structs, nv_levels = self.structure(spec, ctx, xyz, keys, n_valid)
        state = self.features(params, spec, ctx, xyz, feats, structs)
        logits = self.tail(params, spec, state, nv_levels, n_valid)
        if not with_report:
            return logits
        return logits, structure_report(spec, structs)


def structure_report(spec: PCNSpec, structs) -> WorkloadReport | None:
    """The forward's workload report from its stage-1 structures: every
    block's (B,) counters summed, the first block's k kept; None in
    traditional mode (no islands)."""
    reports = [analyze(st.islands, st.schedule, b.k)
               for b, st in zip(spec.blocks, structs)
               if st.islands is not None]
    return WorkloadReport.sum_counters(reports) if reports else None


@dataclass(frozen=True)
class EngineCtx:
    """Per-call execution context.  ``kernel_kw`` holds the FC kernels'
    launch knobs (``rows``: gather_mlp's narrow or linear row tile, 64 or
    128;
    ``nsplit``: its wide route's H split; ``chunk``: hub_reuse's cache
    rows a resident launch, 64 or 128; each acts only on the calls of its
    route), over the tile-plan store and the
    heuristic (``repro_torch.kernels.plans``).  ``mesh``: the data mesh
    of the sharded forward (None: one device)."""
    mode: str = "lpcn"
    fc_backend: str = "reference"
    isl_kw: tuple = ()            # sorted (key, value) pairs of LPCNConfig
    kernel_kw: tuple = ()         # sorted (key, value) pairs
    mesh: object = None           # launch.mesh.Mesh | None

    KERNEL_KW_KEYS = frozenset({"rows", "nsplit", "chunk"})
    # the JAX package's TPU knobs, which mean nothing to these kernels
    TPU_KW_KEYS = frozenset({"ts", "th", "lanes", "vmem_budget_mb",
                             "dimension_semantics"})

    @staticmethod
    def make(mode="lpcn", fc_backend="reference", isl_kw=None,
             kernel_kw=None, mesh=None):
        if mode not in ("lpcn", "traditional"):
            raise ValueError(f"unknown mode {mode!r}")
        get_fc_backend(fc_backend)          # unknown names raise here
        kernel_kw = dict(kernel_kw or {})
        tpu = sorted(set(kernel_kw) & EngineCtx.TPU_KW_KEYS)
        if tpu:
            raise ValueError(
                f"kernel_kw {tpu}: TPU tile knobs of the JAX package; the "
                f"CUDA kernels take {sorted(EngineCtx.KERNEL_KW_KEYS)} "
                f"(rows: gather_mlp's narrow or linear row tile, nsplit: "
                f"its wide "
                f"route's H split, chunk: hub_reuse's cache rows a "
                f"resident launch)")
        unknown = sorted(set(kernel_kw) - EngineCtx.KERNEL_KW_KEYS)
        if unknown:
            raise ValueError(
                f"unknown kernel_kw key(s) {unknown}; valid knobs: "
                f"{sorted(EngineCtx.KERNEL_KW_KEYS)} (a typo here would "
                f"silently leave the plan to the store or the heuristic)")
        for name, v in kernel_kw.items():
            allowed = {"rows": ROWS, "chunk": CHUNKS}.get(name)
            ok = isinstance(v, int) and not isinstance(v, bool) and (
                v >= 1 if allowed is None else v in allowed)
            if not ok:
                raise ValueError(
                    f"kernel_kw {name!r} must be "
                    f"{'a positive int' if allowed is None else allowed}, "
                    f"got {v!r}")
        if mesh is not None and "data" not in mesh.axis_names:
            raise ValueError(
                f"engine meshes shard the batch along a 'data' axis; got "
                f"axes {tuple(mesh.axis_names)} (build one with "
                f"repro_torch.launch.mesh.data_mesh / make_mesh)")
        return EngineCtx(mode=mode, fc_backend=fc_backend,
                         isl_kw=tuple(sorted((isl_kw or {}).items())),
                         kernel_kw=tuple(sorted(kernel_kw.items())),
                         mesh=mesh)


def get_arch(spec: PCNSpec) -> Arch:
    """The spec's family; names of no known family take the generic SA
    stack ("pointnet2"), as in the JAX package."""
    name = arch_of(spec)
    return ARCHS.get(name if name in ARCHS else "pointnet2")


def block_cfg(b: BlockSpec, ctx: EngineCtx) -> LPCNConfig:
    return LPCNConfig(n_centers=b.n_centers, k=b.k, sampler=b.sampler,
                      neighbor=b.neighbor, radius=b.radius, mode=ctx.mode,
                      block_kind=b.kind, fc_backend=ctx.fc_backend,
                      **dict(ctx.isl_kw))


def _mask_rows_b(x, n_valid, fill=0.0):
    """Set rows >= n_valid[i] of x (B, N, F) to ``fill``."""
    if n_valid is None:
        return x
    ok = torch.arange(x.shape[1], device=x.device) < n_valid[:, None]
    return torch.where(ok[..., None], x, fill)


def feature_propagation(xyz_dst, xyz_src, f_src, k: int = 3,
                        src_n_valid=None):
    """PointNet++ FP layer, batched: inverse-distance k-NN interpolation of
    source features (B, Ns, F) at (B, Ns, 3) onto destinations (B, Nd, 3).
    ``src_n_valid`` (B,) masks padding sources out (distance +inf, weight
    exactly 0).

    As the JAX package: distances are the direct difference summed x, y, z
    (a destination that is also a source is exactly 0 away, weight 1e8),
    and the k nearest are taken ties to the lower index (a stable sort, as
    ``lax.top_k``)."""
    d = sqdist(xyz_dst[:, :, None, :], xyz_src[:, None, :, :])  # (B, Nd, Ns)
    if src_n_valid is not None:
        ok = (torch.arange(xyz_src.shape[1], device=d.device)
              < src_n_valid[:, None])
        d = torch.where(ok[:, None, :], d, float("inf"))
    dk, idx = torch.sort(d, dim=-1, stable=True)
    dk, idx = dk[..., :k], idx[..., :k]
    w = 1.0 / torch.clamp(dk, min=1e-8)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    b, nd = idx.shape[:2]
    g = torch.gather(f_src, 1, idx.reshape(b, nd * k, 1).expand(
        b, nd * k, f_src.shape[-1])).reshape(b, nd, k, -1)
    return (g * w[..., None]).sum(2)


def _structure_stack_b(spec: PCNSpec, ctx: EngineCtx, xyz, keys, n_valid):
    """Stage 1 of an SA stack: one stacked structure per block and the
    n_valid chain (downsampling samplers give fully valid centers, so
    None below them; "all" keeps the count)."""
    structs, nv_levels = [], [n_valid]
    cur_xyz, cur_nv = xyz, n_valid
    for b in spec.blocks:
        ks = random.split(keys)
        keys, sub = ks[:, 0], ks[:, 1]
        st = structure_block(block_cfg(b, ctx), cur_xyz, sub, n_valid=cur_nv)
        structs.append(st)
        cur_xyz = st.center_xyz
        cur_nv = cur_nv if b.sampler == "all" else None
        nv_levels.append(cur_nv)
    return structs, nv_levels


def _compute_stack_b(params: PCNParams, spec: PCNSpec, ctx: EngineCtx, xyz,
                     feats, structs, combine=None):
    """Stage 2 of an SA stack: features through the backend block by
    block, each block's output through ``combine(extra, h)`` where the
    family has one.  -> (xyz per level, final features)."""
    backend = get_fc_backend(ctx.fc_backend)
    extras = params.extras or (None,) * len(spec.blocks)
    cur_xyz, cur_f = xyz, feats
    xyz_levels = [xyz]
    for b, mlp, extra, st in zip(spec.blocks, params.blocks, extras,
                                 structs):
        cur_f = compute_block_features_batched(
            block_cfg(b, ctx), mlp, cur_xyz, cur_f, st, backend=backend,
            kernel_kw=dict(ctx.kernel_kw))
        if combine is not None:
            cur_f = combine(extra, cur_f)
        cur_xyz = st.center_xyz
        xyz_levels.append(cur_xyz)
    return xyz_levels, cur_f


def _global_pool_b(params: PCNParams, center_xyz, center_f, n_valid=None):
    """Final global SA: one subset holding every remaining center (the
    paper's no-overlap layer, processed traditionally)."""
    if params.global_mlp is None:
        return _mask_rows_b(center_f, n_valid, fill=-BIG).amax(1)
    if n_valid is None:
        centroid = center_xyz.mean(1)
    else:
        ok = (torch.arange(center_xyz.shape[1], device=center_xyz.device)
              < n_valid[:, None])[..., None]
        centroid = torch.where(ok, center_xyz, 0.0).sum(1) \
            / torch.clamp(n_valid, min=1)[:, None]
    x = torch.cat([center_xyz - centroid[:, None, :], center_f], dim=-1)
    return _mask_rows_b(apply_mlp(params.global_mlp, x), n_valid,
                        fill=-BIG).amax(1)


def _tail_seg(params: PCNParams, spec: PCNSpec, state, nv_levels, n_valid):
    """Segmentation tail: the FP decoder back up the pyramid, then the
    per-point head with padding rows zeroed."""
    xyz_levels, f = state
    for lvl in range(len(xyz_levels) - 2, -1, -1):
        f = feature_propagation(xyz_levels[lvl], xyz_levels[lvl + 1], f,
                                src_n_valid=nv_levels[lvl + 1])
    return _mask_rows_b(apply_mlp(params.head, f), n_valid)


# ---- generic SA stack (PointNet++ and ad-hoc specs) -------------------------

def _init_pointnet2(spec: PCNSpec, generator: torch.Generator,
                    device) -> PCNParams:
    blocks = []
    f = spec.in_feats
    for b in spec.blocks:
        dims = [block_in_dim(b.kind, f), *b.mlp_dims]
        blocks.append(init_mlp(dims, spec.activation, generator=generator,
                               device=device))
        f = b.mlp_dims[-1]
    global_mlp = None
    if spec.task == "cls" and spec.global_mlp:
        global_mlp = init_mlp([3 + f, *spec.global_mlp], spec.activation,
                              generator=generator, device=device)
        f = spec.global_mlp[-1]
    head = init_mlp([f, *spec.head_dims, spec.n_classes], "per_layer",
                    generator=generator, device=device)
    return PCNParams(blocks=tuple(blocks), head=head, global_mlp=global_mlp)


def _tail_pointnet2(params, spec, state, nv_levels, n_valid):
    if spec.task != "cls":
        return _tail_seg(params, spec, state, nv_levels, n_valid)
    xyz_levels, f = state
    return apply_mlp(params.head, _global_pool_b(
        params, xyz_levels[-1], f, n_valid=nv_levels[-1]))


ARCHS.register("pointnet2", Arch("pointnet2", _init_pointnet2,
                                 _structure_stack_b, _compute_stack_b,
                                 _tail_pointnet2))


# ---- DGCNN (EdgeConv; every point a center) ---------------------------------

def _init_dgcnn(spec: PCNSpec, generator: torch.Generator,
                device) -> PCNParams:
    """The SA-stack init, with the head rebuilt for the concat of every
    EdgeConv output (cls) or that plus the broadcast global vector
    (seg)."""
    p = _init_pointnet2(spec, generator, device)
    cat_dim = sum(b.mlp_dims[-1] for b in spec.blocks)
    head_in = cat_dim if spec.task == "cls" else 2 * cat_dim
    head = init_mlp([head_in, *spec.head_dims, spec.n_classes], "per_layer",
                    generator=generator, device=device)
    return PCNParams(blocks=p.blocks, head=head, global_mlp=None)


def _structure_dgcnn(spec: PCNSpec, ctx: EngineCtx, xyz, keys, n_valid):
    """Stage 1 of the EdgeConv stack: every block structures the SAME
    cloud (no downsampling), padding rows kept and masked."""
    structs = []
    for b in spec.blocks:
        ks = random.split(keys)
        keys, sub = ks[:, 0], ks[:, 1]
        structs.append(structure_block(block_cfg(b, ctx), xyz, sub,
                                       n_valid=n_valid))
    return structs, [n_valid] * (len(spec.blocks) + 1)


def _features_dgcnn(params, spec, ctx, xyz, feats, structs):
    """Every EdgeConv output, concatenated: (B, N, sum of widths)."""
    backend = get_fc_backend(ctx.fc_backend)
    f, per_layer = feats, []
    for b, mlp, st in zip(spec.blocks, params.blocks, structs):
        f = compute_block_features_batched(block_cfg(b, ctx), mlp, xyz, f,
                                           st, backend=backend,
                                           kernel_kw=dict(ctx.kernel_kw))
        per_layer.append(f)
    return torch.cat(per_layer, dim=-1)


def _tail_dgcnn(params, spec, cat, nv_levels, n_valid):
    gmax = _mask_rows_b(cat, n_valid, fill=-BIG).amax(1)
    if spec.task == "cls":
        return apply_mlp(params.head, gmax)
    per_point = torch.cat([cat, gmax[:, None].expand(cat.shape)], dim=-1)
    return _mask_rows_b(apply_mlp(params.head, per_point), n_valid)


ARCHS.register("dgcnn", Arch("dgcnn", _init_dgcnn, _structure_dgcnn,
                             _features_dgcnn, _tail_dgcnn))


# ---- PointNeXt and PointVector (stem + SA stages + FP decoder) --------------

def _init_stem_stack(spec: PCNSpec, generator, device, stem_dim: int,
                     extra_dims) -> PCNParams:
    """Stem, SA blocks, one extra MLP per stage (``extra_dims(f)``), and
    the per-point head."""
    stem = init_mlp([spec.in_feats, stem_dim], "per_layer",
                    generator=generator, device=device)
    blocks, extras = [], []
    f = stem_dim
    for b in spec.blocks:
        blocks.append(init_mlp([3 + f, *b.mlp_dims], spec.activation,
                               generator=generator, device=device))
        f = b.mlp_dims[-1]
        extras.append(init_mlp(extra_dims(f), "per_layer",
                               generator=generator, device=device))
    head = init_mlp([f, *spec.head_dims, spec.n_classes], "per_layer",
                    generator=generator, device=device)
    return PCNParams(blocks=tuple(blocks), head=head, stem=stem,
                     extras=tuple(extras))


def _init_pointnext(spec, generator, device, stem_dim: int = 32):
    # InvResMLP: pointwise expansion x4 + projection, residual
    return _init_stem_stack(spec, generator, device, stem_dim,
                            lambda f: [f, 4 * f, f])


def _init_pointvector(spec, generator, device, stem_dim: int = 64):
    # vector branch: per-center linear recombination after pooling
    return _init_stem_stack(spec, generator, device, stem_dim,
                            lambda f: [f, f])


def _stem_features(combine):
    """Stage 2 of a stem stack: the stem (a plain matmul), then each SA
    block and its ``combine(extra, h)`` residual."""
    def features(params, spec, ctx, xyz, feats, structs):
        return _compute_stack_b(params, spec, ctx, xyz,
                                apply_mlp(params.stem, feats), structs,
                                combine)
    return features


ARCHS.register("pointnext", Arch(
    "pointnext", _init_pointnext, _structure_stack_b,
    _stem_features(lambda inv, h: h + apply_mlp(inv, h)), _tail_seg))
ARCHS.register("pointvector", Arch(
    "pointvector", _init_pointvector, _structure_stack_b,
    _stem_features(lambda vec, h: torch.relu(apply_mlp(vec, h))),
    _tail_seg))
