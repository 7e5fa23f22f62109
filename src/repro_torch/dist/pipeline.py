"""Pipeline parallelism (the port of ``repro.dist.pipeline``): a GPipe
microbatch schedule over one mesh axis, with point-to-point sends.

Each rank along the pipeline axis holds ONE stage's parameters; the
``n_micro`` microbatches stream through the stages, one hop a step, for
``n_micro + n_stage - 1`` steps (the fill/drain bubble).  The result
equals applying the stages in order to every microbatch.
"""
from __future__ import annotations

import torch

from .. import tree


def pipeline_apply(mesh, axis: str, n_micro: int, fn, stage_params, x):
    """Run ``x`` through a pipeline of stages laid out along ``axis`` of
    ``mesh`` (a ``repro_torch.launch.mesh.Mesh``); every rank calls it.

    fn(params, microbatch) -> microbatch   one stage's computation
    stage_params                            tree, leaves (n_stage, ...)
    x                                       (n_micro, mb, ...) inputs

    Returns (n_micro, mb, ...) outputs on every rank: stage s runs
    microbatch t - s at step t (no step computes a bubble), sends its
    result to stage s + 1, and the last stage's outputs reach every rank
    of the axis by an all-reduce (the others add zeros), as the JAX
    package's ``psum`` does."""
    import torch.distributed as dist
    n_stage = mesh.shape[axis]
    leading = {leaf.shape[0] for leaf in tree.leaves(stage_params)}
    if leading != {n_stage}:
        raise ValueError(
            f"stage_params leading dims {sorted(leading)} != mesh axis "
            f"{axis!r} size {n_stage}")
    if x.shape[0] != n_micro:
        raise ValueError(f"x has {x.shape[0]} microbatches, expected "
                         f"{n_micro}")
    group = mesh.get_group(axis)
    s = mesh.coordinate(axis)
    peer = lambda i: dist.get_global_rank(group, i)        # noqa: E731
    params = tree.map(lambda a: a[s], stage_params)
    outs = torch.zeros_like(x)
    recv = torch.empty_like(x[0])
    for t in range(n_micro + n_stage - 1):
        m = t - s                       # this stage's microbatch this step
        if not 0 <= m < n_micro:
            continue
        if s > 0:
            dist.recv(recv, src=peer(s - 1), group=group)
        y = fn(params, x[m] if s == 0 else recv).contiguous()
        if s < n_stage - 1:
            dist.send(y, dst=peer(s + 1), group=group)
        else:
            outs[m] = y
    dist.all_reduce(outs, group=group)
    return outs
