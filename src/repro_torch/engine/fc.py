"""The "cuda" FC backend: the building block's two dataflows routed through
the hand-written kernels (on CPU tensors, through their plain versions).

  dense  -> kernels/gather_mlp   fused normalize → MLP → max over K
  reuse  -> kernels/hub_reuse    pool MLP → reuse gather → Δ-comp → max

Both dataflows hand their kernel one linear map or two layers
(:func:`dense_form`):

  * ``block_end`` (all layers linear): every layer composed into ONE
    linear map (W, b), which gather_mlp's ``linear`` route and
    hub_reuse's one-layer form compute in one product; ``per_layer``
    with 1 layer likewise.
  * ``per_layer`` with 2 layers: the kernels' two-layer (W1, relu, W2)
    form, directly.
  * ``per_layer`` with more than 2 layers: the leading layers run as a
    plain PyTorch prologue (the cheap narrow layers, left to
    ``torch.matmul`` as the JAX package leaves them to XLA); the last two
    run fused in the kernel.

The JAX package's kernels take only the two-layer form, and it lowers
the one linear map as relu(x·[W,−W]+[b,−b])·[I;−I] (:func:`two_layer_form`,
exact, because relu(a) − relu(−a) = a); the port's kernels take the
map itself, one product, where that form does 2 + 2F/D times its flops
(hub_reuse's resident route, which forms the first layer in each of its
64-feature tiles, 2F·(D + 64)/(64·D) times).

Each dataflow is ONE kernel launch for the whole batch of clouds (one a
cloud under ``"cuda_per_cloud"``, the A/B counterpart of the JAX
package's ``"pallas_vmap"``).  ``kernel_kw`` (the engine's ``{"rows",
"nsplit", "chunk"}``) reaches each launch whose route its knob acts on:
``rows`` gather_mlp's narrow and linear routes, ``nsplit`` its wide one,
``chunk`` hub_reuse.  A knob is left out of the launches of the other
routes, and raises where its value does not fit the launch.
"""
from __future__ import annotations

import torch

from ..core.mlp import MLP
from ..core.islandize import _take
from ..core.pipeline import FCBackend, _subset_inputs
from ..core.registry import FC_BACKENDS
from ..kernels import tiling
from ..kernels.gather_mlp import gather_mlp
from ..kernels.hub_reuse import hub_reuse


def _split_sign(w, b):
    """Embed x·w+b as a relu pair: relu(x·[w,−w]+[b,−b])·[I;−I]."""
    eye = torch.eye(w.shape[1], dtype=w.dtype, device=w.device)
    return (torch.cat([w, -w], dim=1), torch.cat([b, -b]),
            torch.cat([eye, -eye], dim=0), torch.zeros_like(b))


def _one_map(mlp: MLP):
    """(w, b) of ``mlp`` where it is one linear map (``block_end``: every
    layer composed; ``per_layer`` with one layer), else None."""
    layers = mlp.layers
    if mlp.activation != "block_end" and len(layers) != 1:
        return None
    w, b = layers[0].w, layers[0].b
    for layer in layers[1:]:
        b = b @ layer.w + layer.b
        w = w @ layer.w
    return w, b


def two_layer_form(mlp: MLP):
    """(prologue | None, (w1, b1, w2, b2)): ``mlp`` in the kernels' fixed
    relu-sandwich form; the prologue (if any) runs before the kernel."""
    layers = mlp.layers
    one = _one_map(mlp)
    if one is not None:
        return None, _split_sign(*one)
    if len(layers) == 2:
        return None, (layers[0].w, layers[0].b, layers[1].w, layers[1].b)

    def prologue(x):
        for layer in layers[:-2]:
            x = torch.relu(x @ layer.w + layer.b)
        return x

    return prologue, (layers[-2].w, layers[-2].b, layers[-1].w,
                      layers[-1].b)


def dense_form(mlp: MLP):
    """(prologue | None, weights): ``mlp`` as both dataflows' kernels take
    it, the weights (w, b) of their one-layer form (gather_mlp's
    ``linear`` route, hub_reuse with ``w2`` None) where ``mlp`` is one
    linear map, else :func:`two_layer_form`'s (w1, b1, w2, b2)."""
    one = _one_map(mlp)
    return (None, one) if one is not None else two_layer_form(mlp)


def _dense_weights(mlp: MLP):
    """The gather_mlp weights; on the prologue path W1 gains a zero row for
    the zero center lane :func:`_dense_raw_ctr` prepends (the kernel
    subtracts at least one center lane)."""
    prologue, (w1, *rest) = dense_form(mlp)
    if prologue is not None:
        w1 = torch.cat([w1.new_zeros((1, w1.shape[1])), w1], dim=0)
    return prologue, (w1, *rest)


def _widths(weights) -> tuple:
    """(H, F) of the kernels' weights: H = 0 for one layer (w, b)."""
    if len(weights) == 2:
        return 0, weights[0].shape[1]
    return weights[0].shape[1], weights[2].shape[1]


def dense_shape(kind: str, k: int, mlp: MLP) -> tuple:
    """(K, D, Dc, H, F) of the gather_mlp launch that the dense dataflow
    of a block of ``kind`` with k neighbors and point-MLP ``mlp`` makes
    (:func:`_dense_raw_ctr` gives raw (…, K, D) and centers (…, Dc)); H is
    0 where the launch takes one layer (the linear route)."""
    prologue, weights = _dense_weights(mlp)
    d = weights[0].shape[0]
    dc = 1 if prologue is not None else 3 if kind == "sa" else d
    return (k, d, dc, *_widths(weights))


def _dense_raw_ctr(prologue, kind, xyz, feats, nbr_idx, centers_xyz,
                   center_feats, nbr_valid):
    """gather_mlp data operands (raw (B, S, K, D), ctr (B, S, Dc))."""
    ids = nbr_idx if nbr_valid is None else torch.where(nbr_valid, nbr_idx,
                                                        0)
    if prologue is None:
        if kind == "sa":
            # the kernel subtracts the center from the leading 3 lanes
            return (torch.cat([_take(xyz, ids), _take(feats, ids)], dim=-1),
                    centers_xyz.contiguous())
        # edge input [f_j − c, c] is a subtract of [c, −c] from [f_j, 0]
        fj = _take(feats, ids)
        return (torch.cat([fj, torch.zeros_like(fj)], dim=-1),
                torch.cat([center_feats, -center_feats], dim=-1))
    x = prologue(_subset_inputs(kind, xyz, feats, ids, centers_xyz,
                                center_feats))
    raw = torch.cat([x.new_zeros(x.shape[:-1] + (1,)), x], dim=-1)
    return raw, raw.new_zeros(raw.shape[:2] + (1,))


def _route_knobs(kernel_kw, names) -> dict:
    """The knobs of ``kernel_kw`` among ``names`` (the call's route's)."""
    return {k: v for k, v in (kernel_kw or {}).items() if k in names}


def _dense_cuda(mlp: MLP, kind, xyz, feats, nbr_idx, centers_xyz,
                center_feats=None, nbr_valid=None, kernel_kw=None,
                variant=None):
    """Dense FC through ONE gather_mlp launch.  -> (B, S, Fout)."""
    prologue, weights = _dense_weights(mlp)
    raw, ctr = _dense_raw_ctr(prologue, kind, xyz, feats, nbr_idx,
                              centers_xyz, center_feats, nbr_valid)
    kw = {}
    if kernel_kw:
        way = tiling.route(raw.shape[-2], raw.shape[-1], ctr.shape[-1],
                           *_widths(weights))
        kw = _route_knobs(kernel_kw, ("nsplit",) if way == "wide"
                          else ("rows",))
    return gather_mlp(raw, ctr, *weights, mask=nbr_valid, variant=variant,
                      **kw)


def _reuse_cuda(mlp: MLP, pool_in, slot, comp, live=None, kernel_kw=None,
                variant=None):
    """Reuse dataflow through ONE hub_reuse call, one layer where ``mlp``
    is one linear map (:func:`dense_form`).  -> (B, H, M, Fout)."""
    prologue, weights = dense_form(mlp)
    x = pool_in if prologue is None else prologue(pool_in)
    kw = {}
    if kernel_kw:
        from ..kernels.hub_reuse.ops import card_sms
        hn, c, d = x.shape[-3:]
        h, f = _widths(weights)
        dims = dict(b=1 if x.dim() == 3 else x.shape[0], hn=hn, c=c,
                    m=slot.shape[-2], k=slot.shape[-1], d=d, h=h, f=f)
        kw = _route_knobs(kernel_kw, tiling.knobs_of("hub_reuse", dims,
                                                     card_sms(x.device)))
    return hub_reuse(x, slot, comp, *weights, live=live, variant=variant,
                     **kw)


def _dense_per_cloud(*args, **kw):
    """:func:`_dense_cuda` with one gather_mlp launch per cloud."""
    return _dense_cuda(*args, **kw, variant="per_cloud")


def _reuse_per_cloud(*args, **kw):
    """:func:`_reuse_cuda` with one hub_reuse launch per cloud."""
    return _reuse_cuda(*args, **kw, variant="per_cloud")


FC_BACKENDS.register("cuda", FCBackend(name="cuda", dense=_dense_cuda,
                                       reuse=_reuse_cuda))
# the same kernels, one launch per cloud per dataflow: the A/B of the
# batched launch (the JAX package's "pallas_vmap"), and the dispatch a
# "per_cloud" plan-store entry selects for one cell
FC_BACKENDS.register("cuda_per_cloud", FCBackend(
    name="cuda_per_cloud", dense=_dense_per_cloud, reuse=_reuse_per_cloud))
