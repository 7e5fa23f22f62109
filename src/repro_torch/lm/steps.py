"""Step builders (the port of ``repro.lm.steps``): the train step with
gradient accumulation, the LR schedule, optional gradient compression and
AdamW, and the serving steps, each under ``torch.no_grad()``."""
from __future__ import annotations

import torch

from .. import tree
from ..dist import sharding as shd
from ..optim import adamw
from ..optim.schedules import warmup_cosine
from . import model_zoo as zoo
from .config import ArchConfig


def loss_and_grads(cfg: ArchConfig, params, batch):
    """-> (loss, aux, grads) of ``model_zoo.loss_fn`` at ``params``: grads
    a list in ``tree.leaves`` order, each in its leaf's dtype (zeros for a
    leaf the loss does not reach).  The params' own tensors are not
    marked as requiring grad."""
    flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with torch.enable_grad():
        loss, aux = zoo.loss_fn(cfg, tree.unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return _value(loss), _value(aux), [
        torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]


def _value(t):
    """A metric as a plain tensor (a DTensor's whole value)."""
    return shd.whole(t.detach())


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1, accum_dtype=torch.float32,
                    compressor=None, param_shardings=None):
    """-> train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics), params and optimizer state updated in place.

    Grads by :func:`loss_and_grads`; over
    ``microbatches`` slices of the leading batch dim (one microbatch's
    activations live at a time) they are summed in ``accum_dtype`` and
    divided by the count, as the loss and aux are; with one microbatch
    they stay in the params' dtype.  ``compressor``: an optional
    ``dist.compress`` hook applied to the grads (its error feedback in
    ``opt_state["ef"]``).  Then ``warmup_cosine(step)`` and AdamW.
    Metrics: ``loss``, ``aux``, ``grad_norm``, ``lr_scale`` (0-d
    tensors).

    ``param_shardings`` (a tree of ``dist.sharding.Sharding``, the mesh
    given by ``dist.sharding.param_shardings``): params and optimizer
    state are DTensors of those placements, and ``batch`` holds the
    global batch, the same on every rank.  Each microbatch is laid out
    over the data axes (``batch_shardings``), each grad is pinned to its
    param's placements (a partial sum is reduced there) before the
    accumulation, the compressor and AdamW, and the grad norm is the
    global tensors'.  The caller runs the step under
    ``dist.sharding.use_mesh``."""
    def laid_out(mb):
        if param_shardings is None:
            return mb
        mesh = tree.leaves(param_shardings)[0].mesh
        return shd.distribute(mb, shd.batch_shardings(mb, mesh))

    def pinned(flat):
        if param_shardings is None:
            return flat
        return [g.redistribute(sh.mesh.device_mesh, sh.placements)
                for g, sh in zip(flat, tree.leaves(param_shardings))]

    def train_step(params, opt_state, batch, step):
        if microbatches == 1:
            loss, aux, flat = loss_and_grads(cfg, params, laid_out(batch))
            flat = pinned(flat)
        else:
            def slice_mb(i):
                return {k: x.reshape((microbatches, x.shape[0] // microbatches)
                                     + x.shape[1:])[i]
                        for k, x in batch.items()}
            flat = [torch.zeros_like(p, dtype=accum_dtype)
                    for p in tree.leaves(params)]
            loss = aux = 0.0
            for i in range(microbatches):
                l, a, g = loss_and_grads(cfg, params, laid_out(slice_mb(i)))
                for acc, gg in zip(flat, pinned(g)):
                    acc += gg.to(accum_dtype)
                del g
                loss, aux = loss + l, aux + a
            flat = [g / microbatches for g in flat]
            loss, aux = loss / microbatches, aux / microbatches
        grads = tree.unflatten(params, flat)
        del flat

        if compressor is not None:
            grads, opt_state = compressor(grads, opt_state)

        lr_scale = warmup_cosine(step)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state, lr_scale)
        gnorm = torch.sqrt(sum(shd.whole(torch.sum(torch.square(g.float())))
                               for g in tree.leaves(grads)))
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm,
                   "lr_scale": lr_scale}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """-> prefill_step(params, batch) -> last-token logits (B, V)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return zoo.prefill_fn(cfg, params, batch)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """-> decode_step(params, token, cache, pos) -> (next_token, logits,
    cache).  Greedy sampling (argmax, the first of equal maxima); under a
    mesh over the whole vocab on every model rank (the logits' vocab dim
    gathered first)."""
    @torch.no_grad()
    def decode_step(params, token, cache, pos: int):
        logits, cache = zoo.decode_fn(cfg, params, token, cache, pos)
        logits = shd.constrain(logits, "dp", None)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, cache
    return decode_step
