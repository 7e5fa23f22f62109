"""Generic decoder-only LM covering 9 of the 10 assigned architectures
(dense / MoE / SSM / hybrid / VLM-prefix), the port of
``repro.lm.transformer``; whisper.py adds the enc-dec audio arch on the
same primitives.

Params are a dict:
  embed (V, D), final_norm {...}, lm_head (D, V) (absent if tied),
  layers: list of per-layer dicts {"norm1", "mixer", "norm2"?, "ffn"?}.

Execution is eager over the layer list.  With ``cfg.remat`` and grad
enabled, each layer runs under ``torch.utils.checkpoint`` (the
counterpart of ``jax.checkpoint``): its activations are recomputed in the
backward, so the layer's kernels run twice a training step.  Prefill and
decode run without grad and are unchanged.  Between blocks the
activations are constrained (``dist.sharding.constrain``: batch over
``dp``, the sequence over ``sp`` where ``cfg.seq_shard_blocks``), and a
block's normed input is gathered whole along the sequence before its
products (``gather_seq``), which lays DTensors out under a mesh and
leaves plain tensors as they are.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..dist.sharding import (carry, constrain, gather_seq, like, lookup,
                             pin_grad)
from ..nn import attention as attn
from ..nn import layers as nnl
from ..nn import moe as nnmoe
from ..nn import rglru as nnr
from ..nn import ssm as nnssm
from .config import ArchConfig


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ArchConfig, i: int,
               device) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    mixer_kind = cfg.mixer_of(i)
    p = {"norm1": nnl.norm_params(cfg.norm, d, dt, device)}
    if mixer_kind in ("attn", "local"):
        p["mixer"] = attn.attn_params(gen, d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                      cfg.qkv_bias, dt, device)
    elif mixer_kind == "ssd":
        p["mixer"] = nnssm.ssd_params(gen, d, cfg.ssm_state, cfg.ssm_conv,
                                      cfg.ssm_expand, cfg.ssm_headdim, dt,
                                      device)
    elif mixer_kind == "rglru":
        p["mixer"] = nnr.rglru_params(gen, d, cfg.d_rnn or d, cfg.ssm_conv,
                                      dt, device)
    else:
        raise ValueError(mixer_kind)
    ffn_kind = cfg.ffn_of(i)
    if ffn_kind != "none":
        p["norm2"] = nnl.norm_params(cfg.norm, d, dt, device)
        if ffn_kind == "mlp":
            p["ffn"] = nnl.mlp_params(gen, d, cfg.d_ff, cfg.act, dt, device)
        else:
            p["ffn"] = nnmoe.moe_params(gen, d, cfg.moe_d_ff or cfg.d_ff,
                                        cfg.moe_experts, cfg.act, dt, device,
                                        shared=cfg.moe_shared)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """Random params drawn from ``gen`` (on the generator's device), placed
    on ``device`` (default: the GPU)."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    params = {
        "embed": nnl.embed_init(gen, (cfg.vocab, cfg.d_model), dt, device),
        "final_norm": nnl.norm_params(cfg.norm, cfg.d_model, dt, device),
        "layers": [init_layer(gen, cfg, i, device)
                   for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embed:
        params["lm_head"] = nnl.lecun(gen, (cfg.d_model, cfg.vocab), dt,
                                      device)
    return params


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def apply_layer(cfg: ArchConfig, i: int, p: dict, x, positions,
                prefix_len: int = 0):
    """Full-sequence (train/prefill) layer.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mixer_kind = cfg.mixer_of(i)
    h = gather_seq(nnl.apply_norm(cfg.norm, x, p["norm1"]))
    if mixer_kind == "attn":
        m = attn.causal_attention(p["mixer"], h, cfg.n_heads, cfg.n_kv,
                                  cfg.hd, positions, cfg.rope_theta,
                                  cfg.logits_softcap, prefix_len)
    elif mixer_kind == "local":
        m = attn.local_attention(p["mixer"], h, cfg.n_heads, cfg.n_kv,
                                 cfg.hd, positions, cfg.rope_theta,
                                 cfg.local_window)
    elif mixer_kind == "ssd":
        m = nnssm.ssd_apply(p["mixer"], h, cfg.ssm_state, cfg.ssm_expand,
                            cfg.ssm_headdim, cfg.ssd_chunk)
    elif mixer_kind == "rglru":
        m = nnr.rglru_apply(p["mixer"], h)
    else:
        raise ValueError(mixer_kind)
    x = x + _residual(cfg, m)
    if "ffn" in p:
        h = gather_seq(nnl.apply_norm(cfg.norm, x, p["norm2"]))
        if cfg.ffn_of(i) == "moe":
            y, aux = nnmoe.moe_apply(p["ffn"], h, cfg.moe_experts,
                                     cfg.moe_top_k, cfg.act,
                                     cfg.capacity_factor, cfg.moe_scheme,
                                     cfg.moe_shard)
        else:
            y = nnl.mlp_apply(p["ffn"], h, cfg.act)
        x = x + _residual(cfg, y)
    return x, aux


def _residual(cfg: ArchConfig, x):
    """``x`` in the residual stream's layout between blocks: batch over
    ``dp``, the sequence over ``sp`` where ``cfg.seq_shard_blocks`` (a
    block's output reduce-scattered along the sequence, as Megatron's
    sequence parallelism does; its gradient comes back in the layout the
    block's products made)."""
    return constrain(x, "dp", "sp" if cfg.seq_shard_blocks else None, None)


def remat(cfg: ArchConfig, fn, *args):
    """fn(*args), under ``torch.utils.checkpoint`` where ``cfg.remat`` is
    set and grad is enabled (its activations recomputed in the
    backward)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(carry(fn), *args, use_reentrant=False)
    return fn(*args)


def _scale(cfg: ArchConfig, x):
    """Gemma's sqrt(d) input scale, rounded to the model dtype first."""
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(params: dict, x):
    head = params.get("lm_head")
    return x @ (pin_grad(params["embed"]).T if head is None else head)


def forward(cfg: ArchConfig, params: dict, tokens=None, embeds=None,
            prefix_embeds=None, head_last_only: bool = False):
    """Full-sequence forward.  tokens (B, S) int and/or prefix_embeds
    (B, P, D) prepended (VLM).  Returns (logits (B, T, V), aux).
    ``head_last_only``: inference prefill — project only the final
    position (avoids materializing (B, S, V) logits)."""
    assert tokens is not None or embeds is not None
    x = _scale(cfg, lookup(params["embed"], tokens.long()) if embeds is None
               else embeds)
    prefix_len = 0
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        prefix_len = prefix_embeds.shape[1]
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    x = _residual(cfg, x)
    for i, lp in enumerate(params["layers"]):
        x, aux = remat(cfg, apply_layer, cfg, i, lp, x, positions,
                       prefix_len)
        x = _residual(cfg, x)
        aux_total = aux_total + aux
    x = gather_seq(nnl.apply_norm(cfg.norm, x, params["final_norm"]))
    if head_last_only:
        x = x[:, -1:, :]
    return _head(params, x), aux_total


# ---------------------------------------------------------------------------
# decode (one token against caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               device=None) -> list:
    """Per-layer decode caches (dtype = model dtype, f32 recurrent
    states), on ``device`` (default: the GPU)."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    caches = []
    for i in range(cfg.n_layers):
        kind = cfg.mixer_of(i)
        if kind in ("attn", "local"):
            w = min(cfg.local_window, cache_len) if kind == "local" \
                else cache_len
            shape = (batch, w, cfg.n_kv, cfg.hd)
            if cfg.kv_quant:
                caches.append({
                    "k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "ks": torch.zeros(shape[:3], **f32),
                    "vs": torch.zeros(shape[:3], **f32)})
            else:
                caches.append({
                    "k": torch.zeros(shape, dtype=dt, device=device),
                    "v": torch.zeros(shape, dtype=dt, device=device)})
        elif kind == "ssd":
            caches.append({
                "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                                      cfg.ssm_state), **f32),
                "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                     cfg.d_inner + 2 * cfg.ssm_state),
                                    dtype=dt, device=device)})
        elif kind == "rglru":
            dr = cfg.d_rnn or cfg.d_model
            caches.append({
                "state": torch.zeros((batch, dr), **f32),
                "conv": torch.zeros((batch, cfg.ssm_conv - 1, dr), dtype=dt,
                                    device=device)})
    return caches


def decode_step(cfg: ArchConfig, params: dict, token, caches: list,
                pos: int):
    """token (B,) int; pos the current position (an int).  Returns
    (logits (B, V), new caches); attention caches are updated in place
    (``nn.attention.decode_attention``).  Under a mesh (DTensor params,
    token and caches laid out by ``dist.sharding.cache_shardings``) the
    new recurrent states come back in their caches' layout."""
    pos = int(pos)
    x = _scale(cfg, lookup(params["embed"], token.long())[:, None, :])
    new_caches = []
    for i, (lp, c) in enumerate(zip(params["layers"], caches)):
        kind = cfg.mixer_of(i)
        h = nnl.apply_norm(cfg.norm, x, lp["norm1"])
        if kind in ("attn", "local"):
            window = cfg.local_window if kind == "local" else 0
            if cfg.kv_quant:
                m, nk, nv, nks, nvs = attn.decode_attention(
                    lp["mixer"], h, c["k"], c["v"], pos, cfg.n_heads,
                    cfg.n_kv, cfg.hd, cfg.rope_theta, window=window,
                    softcap=cfg.logits_softcap, k_scale=c["ks"],
                    v_scale=c["vs"])
                new_caches.append({"k": nk, "v": nv, "ks": nks,
                                   "vs": nvs})
            else:
                m, nk, nv = attn.decode_attention(
                    lp["mixer"], h, c["k"], c["v"], pos, cfg.n_heads,
                    cfg.n_kv, cfg.hd, cfg.rope_theta, window=window,
                    softcap=cfg.logits_softcap)
                new_caches.append({"k": nk, "v": nv})
        else:
            if kind == "ssd":
                m, st, cv = nnssm.ssd_decode(lp["mixer"], h, c["state"],
                                             c["conv"], cfg.ssm_state,
                                             cfg.ssm_expand, cfg.ssm_headdim)
            else:  # rglru
                m, st, cv = nnr.rglru_decode(lp["mixer"], h, c["state"],
                                             c["conv"])
            new_caches.append({"state": like(st, c["state"]),
                               "conv": like(cv, c["conv"])})
        x = x + m
        if "ffn" in lp:
            h = nnl.apply_norm(cfg.norm, x, lp["norm2"])
            if cfg.ffn_of(i) == "moe":
                y, _ = nnmoe.moe_apply(lp["ffn"], h, cfg.moe_experts,
                                       cfg.moe_top_k, cfg.act,
                                       cfg.capacity_factor, cfg.moe_scheme,
                                       cfg.moe_shard)
            else:
                y = nnl.mlp_apply(lp["ffn"], h, cfg.act)
            x = x + y
    x = nnl.apply_norm(cfg.norm, x, params["final_norm"])
    return _head(params, x)[:, 0, :], new_caches
