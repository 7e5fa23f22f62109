"""Architecture families: init + batched two-stage forward.

The ``pointnet2`` family (generic SA stacks, classification) is ported:
stage 1 builds every block's structure for the whole batch (DS → octree →
islandize → hub-schedule, coordinates and keys only), stage 2 runs the FC
dataflows block by block through the backend, one launch per dataflow
per block, then the global SA pool and the head.  The key-split sequence
mirrors the JAX package, so the same per-cloud keys give the same hubs.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import random
from ..core.mlp import apply_mlp, init_mlp
from ..core.pipeline import (BIG, LPCNConfig, compute_block_features_batched,
                             structure_block)
from ..core.registry import Registry, get_fc_backend
from .params import PCNParams
from .spec import BlockSpec, PCNSpec, arch_of, block_in_dim

ARCHS = Registry("arch")


@dataclass(frozen=True)
class Arch:
    """init(spec, generator, device) -> PCNParams; forward(params, spec,
    xyz, feats, keys, ctx, n_valid) -> (B, n_classes) logits."""
    name: str
    init: callable
    forward: callable


@dataclass(frozen=True)
class EngineCtx:
    """Per-call execution context."""
    mode: str = "lpcn"
    fc_backend: str = "reference"
    isl_kw: tuple = ()            # sorted (key, value) pairs of LPCNConfig

    @staticmethod
    def make(mode="lpcn", fc_backend="reference", isl_kw=None):
        if mode not in ("lpcn", "traditional"):
            raise ValueError(f"unknown mode {mode!r}")
        get_fc_backend(fc_backend)          # unknown names raise here
        return EngineCtx(mode=mode, fc_backend=fc_backend,
                         isl_kw=tuple(sorted((isl_kw or {}).items())))


# families of the JAX package that this package does not carry yet
NOT_PORTED = ("dgcnn", "pointnext", "pointvector")


def get_arch(spec: PCNSpec) -> Arch:
    """The spec's family; names of no known family take the generic SA
    stack ("pointnet2"), as in the JAX package."""
    name = arch_of(spec)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"architecture family {name!r} is not ported yet; ported: "
            f"{', '.join(ARCHS.names())}")
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


def _structure_stack_b(spec: PCNSpec, ctx: EngineCtx, xyz, keys, n_valid):
    """Stage 1 for the whole batch: one stacked structure per block and
    the n_valid chain (downsampling samplers give fully valid centers, so
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
                     feats, structs):
    """Stage 2: features through the backend block by block."""
    backend = get_fc_backend(ctx.fc_backend)
    cur_xyz, cur_f = xyz, feats
    for b, mlp, st in zip(spec.blocks, params.blocks, structs):
        cur_f = compute_block_features_batched(block_cfg(b, ctx), mlp,
                                               cur_xyz, cur_f, st,
                                               backend=backend)
        cur_xyz = st.center_xyz
    return cur_xyz, cur_f


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


def _fwd_pointnet2(params: PCNParams, spec: PCNSpec, xyz, feats, keys,
                   ctx: EngineCtx, n_valid=None):
    if spec.task != "cls":
        raise NotImplementedError(
            "segmentation (the FP decoder) is not ported yet")
    structs, nv_levels = _structure_stack_b(spec, ctx, xyz, keys, n_valid)
    cx, cf = _compute_stack_b(params, spec, ctx, xyz, feats, structs)
    g = _global_pool_b(params, cx, cf, n_valid=nv_levels[-1])
    return apply_mlp(params.head, g)


ARCHS.register("pointnet2", Arch("pointnet2", _init_pointnet2,
                                 _fwd_pointnet2))
