"""Unified entry points across the LM families (the port of
``repro.lm.model_zoo``), on the GPU unless given ``device="cpu"``:

    init(gen, cfg, device)                  -> params
    loss_fn(cfg, params, batch)             -> (loss, aux)
    prefill_fn(cfg, params, batch)          -> last-position logits
    decode_fn(cfg, params, tok, cache, pos) -> (logits, cache)
    make_cache(cfg, params, batch, len)     -> cache
    input_specs(cfg, seq_len, batch, kind)  -> batch on ``meta``
    cache_specs(cfg, batch, cache_len)      -> cache on ``meta``

Batches are dicts of tensors:  dense/moe/ssm/hybrid: {tokens (B,S+1)};
vlm: {patches (B,P,D), tokens (B,S+1)};  audio: {frames (B,T,D),
tokens (B,S+1)}.  Labels are tokens shifted by one.  The dry run's
stand-ins are tensors on the ``meta`` device (shapes and dtypes, no
storage), as ``init(None, cfg, "meta")`` gives the params'.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import BWD_PASSES
from ..kernels.ssd_chunk.ops import SSD_BWD_PASSES
from ..dist.sharding import constrain
from ..nn.attention import attention_route
from . import transformer as tfm
from . import whisper as whi
from .config import ArchConfig
from .losses import cross_entropy

AUX_WEIGHT = 0.01


def init(gen: torch.Generator, cfg: ArchConfig, device=None):
    """Random params drawn from ``gen``, on ``device`` (default: the
    GPU).  On ``"meta"`` nothing is drawn (``gen`` may be None): the
    params' shapes and dtypes only."""
    if cfg.family == "audio":
        return whi.init_params(gen, cfg, device)
    return tfm.init_params(gen, cfg, device)


def _whole_vocab(logits):
    """Under a mesh, the logits' vocab dim gathered onto every model rank
    (rows stay over the data axes) before the loss picks labels."""
    return constrain(logits, "dp", None, None)


def loss_fn(cfg: ArchConfig, params, batch):
    toks = batch["tokens"]
    inp, lab = toks[:, :-1], toks[:, 1:]
    if cfg.family == "audio":
        logits, aux = whi.forward(cfg, params, batch["frames"], inp)
        return cross_entropy(_whole_vocab(logits), lab), aux
    if cfg.family == "vlm":
        logits, aux = tfm.forward(cfg, params, tokens=inp,
                                  prefix_embeds=batch["patches"])
        txt_logits = _whole_vocab(logits)[:, cfg.prefix_tokens:]
        return cross_entropy(txt_logits, lab) + AUX_WEIGHT * aux, aux
    logits, aux = tfm.forward(cfg, params, tokens=inp)
    return cross_entropy(_whole_vocab(logits), lab) + AUX_WEIGHT * aux, aux


def prefill_fn(cfg: ArchConfig, params, batch):
    """Forward pass only (inference prefill): returns last-position
    logits.  The head projects ONLY the last position — a (B, S, V)
    logits tensor is never materialized."""
    if cfg.family == "audio":
        logits, _ = whi.forward(cfg, params, batch["frames"],
                                batch["tokens"][:, :-1],
                                head_last_only=True)
    elif cfg.family == "vlm":
        logits, _ = tfm.forward(cfg, params, tokens=batch["tokens"][:, :-1],
                                prefix_embeds=batch["patches"],
                                head_last_only=True)
    else:
        logits, _ = tfm.forward(cfg, params, tokens=batch["tokens"][:, :-1],
                                head_last_only=True)
    return logits[:, -1, :]


def make_cache(cfg: ArchConfig, params, batch_sz: int, cache_len: int,
               frames=None, device=None):
    """Decode caches; audio runs the encoder over ``frames`` (its caches
    follow the frames' device), the rest allocate on ``device`` (default:
    the GPU)."""
    if cfg.family == "audio":
        return whi.init_cache(cfg, params, frames, cache_len)
    return tfm.init_cache(cfg, batch_sz, cache_len, device)


def prefill_launches(cfg: ArchConfig) -> dict:
    """The kernel launches of one :func:`prefill_fn` call on the card, as
    the routes name them (a decode step launches none; an audio
    :func:`make_cache` runs the encoder's)."""
    if cfg.family == "audio":
        flash = (cfg.enc_layers * (attention_route("bidir", cfg.hd) == "flash")
                 + cfg.n_layers * (attention_route("causal", cfg.hd)
                                   == "flash"))
        return {"flash_attention": flash, "ssd_chunk": 0}
    prefix = cfg.prefix_tokens if cfg.family == "vlm" else 0
    mixers = [cfg.mixer_of(i) for i in range(cfg.n_layers)]
    flash = attention_route("causal", cfg.hd, prefix,
                            cfg.logits_softcap) == "flash"
    return {"flash_attention": mixers.count("attn") * flash,
            "ssd_chunk": mixers.count("ssd")}


def train_launches(cfg: ArchConfig, microbatches: int = 1) -> dict:
    """The kernel launches of one ``steps.make_train_step`` step on the
    card: each microbatch runs the prefill's forward launches (the head
    aside, which launches nothing) and, under ``cfg.remat``, runs them
    again in the backward; for each ``flash_attention`` forward it
    differentiates one ``flash_attention_backward`` call, which launches
    ``len(BWD_PASSES)`` kernels (the dQ pass, then the dK/dV pass), and
    for each ``ssd_chunk`` forward one ``ssd_chunk_backward`` call, which
    launches ``len(SSD_BWD_PASSES)`` (the heads pass, then the chunk
    pass)."""
    fwd = prefill_launches(cfg)
    runs = microbatches * (2 if cfg.remat else 1)
    return {"flash_attention": runs * fwd["flash_attention"],
            "flash_attention_bwd": (len(BWD_PASSES) * microbatches
                                    * fwd["flash_attention"]),
            "ssd_chunk": runs * fwd["ssd_chunk"],
            "ssd_chunk_bwd": (len(SSD_BWD_PASSES) * microbatches
                              * fwd["ssd_chunk"])}


def decode_fn(cfg: ArchConfig, params, token, cache, pos: int):
    if cfg.family == "audio":
        return whi.decode_step(cfg, params, token, cache, pos)
    return tfm.decode_step(cfg, params, token, cache, pos)


# ---------------------------------------------------------------------------
# meta-device stand-ins for the dry run (no storage)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, seq_len: int, batch: int,
                kind: str = "train") -> dict:
    """The batch of one step of ``kind`` on the ``meta`` device."""
    meta = dict(dtype=tfm.dtype_of(cfg), device="meta")
    if kind in ("train", "prefill"):
        b = {"tokens": torch.empty((batch, seq_len + 1), dtype=torch.int32,
                                   device="meta")}
        if cfg.family == "vlm":
            b["patches"] = torch.empty(
                (batch, cfg.prefix_tokens, cfg.d_model), **meta)
        if cfg.family == "audio":
            b["frames"] = torch.empty((batch, cfg.enc_seq, cfg.d_model),
                                      **meta)
        return b
    # decode: one new token against a cache of seq_len
    return {"token": torch.empty((batch,), dtype=torch.int32,
                                 device="meta")}


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int):
    """The decode cache of :func:`make_cache` on the ``meta`` device (the
    audio arch's cross K/V at the encoder's length, as its encoder would
    give them)."""
    if cfg.family != "audio":
        return tfm.init_cache(cfg, batch, cache_len, "meta")
    meta = dict(dtype=tfm.dtype_of(cfg), device="meta")
    self_kv = (batch, cache_len, cfg.n_kv, cfg.hd)
    cross_kv = (batch, cfg.enc_seq, cfg.n_kv, cfg.hd)
    return [{"k": torch.empty(self_kv, **meta),
             "v": torch.empty(self_kv, **meta),
             "xk": torch.empty(cross_kv, **meta),
             "xv": torch.empty(cross_kv, **meta)}
            for _ in range(cfg.n_layers)]
