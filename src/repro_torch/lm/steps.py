"""Step builders (the port of ``repro.lm.steps``): the train step with
gradient accumulation, the LR schedule, optional gradient compression and
AdamW, and the serving steps, each under ``torch.no_grad()``."""
from __future__ import annotations

import torch

from .. import tree
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
    return loss.detach(), aux.detach(), [
        torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1, accum_dtype=torch.float32,
                    compressor=None):
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
    tensors).  The JAX package's ``param_shardings`` has no counterpart:
    there is no mesh."""
    def train_step(params, opt_state, batch, step):
        if microbatches == 1:
            loss, aux, flat = loss_and_grads(cfg, params, batch)
        else:
            def slice_mb(i):
                return {k: x.reshape((microbatches, x.shape[0] // microbatches)
                                     + x.shape[1:])[i]
                        for k, x in batch.items()}
            flat = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                    for p in tree.leaves(params)]
            loss = aux = 0.0
            for i in range(microbatches):
                l, a, g = loss_and_grads(cfg, params, slice_mb(i))
                for acc, gg in zip(flat, g):
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
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
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
    cache).  Greedy sampling (argmax, the first of equal maxima)."""
    @torch.no_grad()
    def decode_step(params, token, cache, pos: int):
        logits, cache = zoo.decode_fn(cfg, params, token, cache, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, cache
    return decode_step
