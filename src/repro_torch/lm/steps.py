"""Step builders for serving (the port of ``repro.lm.steps``'s
``make_prefill_step`` and ``make_decode_step``), each step under
``torch.no_grad()``.  The train step comes with the trainer."""
from __future__ import annotations

import torch

from . import model_zoo as zoo
from .config import ArchConfig


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
