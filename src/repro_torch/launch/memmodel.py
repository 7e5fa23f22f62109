"""Analytic per-device memory of the LM cells on H100s (the port of
``repro.launch.memmodel``): does a step fit one card's HBM?

The arithmetic is the JAX package's, term for term, so its byte fields
equal JAX's on the same mesh; only the fit test reads the card
(``repro_torch.HW["hbm_bytes"]``, 80 GB, in place of a TPU's 16 GiB):

  state  = params (bf16) + grads (accum dtype) + AdamW m / v (state
           dtype), each sharded as ``dist.sharding`` shards it
  live activations (train, a microbatch, remat a layer):
           the residuals saved at layer boundaries + one layer's working
           set + the logits
  caches (decode): KV / state caches, sharded as ``cache_shardings``

A mesh is read through ``dict(mesh.shape)`` and ``mesh.axis_names``
only: a ``launch.mesh`` mesh of a fake world (``fake_world``) gives the
production meshes' numbers without launching a rank.
"""
from __future__ import annotations

from .. import HW
from .. import tree
from ..configs import SHAPES
from ..dist import sharding as shd
from ..lm import model_zoo as zoo
from ..lm.config import ArchConfig
from ..nn.attention import CHUNK_Q_ABOVE, N_Q_CHUNKS


def _tree_device_bytes(shapes_tree, shardings_tree, mesh) -> int:
    """Sum of per-device bytes over a tree of tensors (their shapes and
    dtypes) and the matching tree of ``dist.sharding.Sharding``: each
    split dim ceil-divided by its mesh axes, as GSPMD pads."""
    sizes = dict(mesh.shape)
    total = 0
    for t, sh in zip(tree.leaves(shapes_tree), tree.leaves(shardings_tree)):
        spec = tuple(sh.spec) + (None,) * (t.ndim - len(sh.spec))
        n = 1
        for dim, entry in zip(t.shape, spec):
            div = 1
            for a in (() if entry is None else entry
                      if isinstance(entry, tuple) else (entry,)):
                div *= sizes[a]
            n *= -(-dim // div)
        total += n * t.element_size()
    return total


def _shape(shape):
    """A ``configs.SHAPES`` name or a ``ShapeSpec`` of one's own."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def _params(cfg: ArchConfig, mesh) -> int:
    params = zoo.init(None, cfg, "meta")
    return _tree_device_bytes(
        params, shd.param_shardings(params, mesh, cfg.moe_shard), mesh)


def fits(total_bytes: int) -> bool:
    """Whether ``total_bytes`` fit one card's HBM."""
    return total_bytes < HW["hbm_bytes"]


def train_footprint(cfg: ArchConfig, shape, mesh, microbatches: int,
                    accum_bytes: int = 4, opt_state_bytes: int = 2) -> dict:
    """Per-device bytes for one training step (production schedule) of
    ``shape`` (a ``SHAPES`` name or a ``ShapeSpec``)."""
    sp = _shape(shape)
    param_b = _params(cfg, mesh)
    n_params_dev = param_b // 2       # bf16 params
    grads_b = n_params_dev * accum_bytes
    opt_b = 2 * n_params_dev * opt_state_bytes   # m and v

    sizes = dict(mesh.shape)
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    tp = sizes.get("model", 1)

    rows_per_dev = max(sp.global_batch // (dp * microbatches), 1)
    seq = sp.seq_len
    d = cfg.d_model
    # residual stream saved at every layer boundary (remat), the sequence
    # sharded over model between blocks (SP)
    resid = (cfg.n_layers + cfg.enc_layers) * rows_per_dev \
        * (-(-seq // tp)) * d * 2
    # one layer's working set: attention scores chunk (f32) + mlp hidden
    if cfg.family == "ssm":
        q = min(cfg.ssd_chunk, seq)
        nc = max(seq // q, 1)
        work = rows_per_dev * nc * q * q * (-(-cfg.ssm_heads // tp)) * 4 \
            + rows_per_dev * nc * (-(-cfg.ssm_heads // tp)) \
            * cfg.ssm_headdim * cfg.ssm_state * 4
    else:
        qc = seq if seq <= CHUNK_Q_ABOVE else seq // N_Q_CHUNKS
        heads_dev = -(-cfg.n_heads // tp)
        work = rows_per_dev * heads_dev * qc * seq * 4
        ff = cfg.moe_d_ff or cfg.d_ff
        work += rows_per_dev * seq * max(-(-ff // tp), d) * 2
    # logits for one microbatch (vocab sharded over model)
    logits = rows_per_dev * seq * (-(-cfg.vocab // tp)) * 4

    total = param_b + grads_b + opt_b + resid + work + logits
    return {
        "params_bytes": param_b, "grads_bytes": grads_b,
        "opt_bytes": opt_b, "residuals_bytes": resid,
        "working_set_bytes": work, "logits_bytes": logits,
        "total_bytes": total, "fits_hbm": fits(total),
    }


def decode_footprint(cfg: ArchConfig, shape, mesh) -> dict:
    """Per-device bytes for one decode step (params + caches + a small
    working set)."""
    sp = _shape(shape)
    param_b = _params(cfg, mesh)
    cache = zoo.cache_specs(cfg, sp.global_batch, sp.seq_len)
    cache_b = _tree_device_bytes(cache, shd.cache_shardings(cache, mesh),
                                 mesh)
    work = sp.global_batch * cfg.d_model * 4 * 8
    total = param_b + cache_b + work
    return {"params_bytes": param_b, "cache_bytes": cache_b,
            "working_set_bytes": work, "total_bytes": total,
            "fits_hbm": fits(total)}
