"""Whisper-large-v3 (enc-dec audio arch) on the shared primitives, the port
of ``repro.lm.whisper``.

The mel/conv frontend is stubbed: callers supply precomputed frame
embeddings (B, enc_seq, D).  Encoder: bidirectional attention (the
``flash_attention`` kernel, ``causal=False``) + GELU MLP, LayerNorm,
sinusoidal positions.  Decoder: causal self-attn + cross-attn per layer,
sinusoidal positions, full softmax vocab 51866.  With ``cfg.remat`` and
grad enabled each encoder and decoder layer runs under
``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps them in the JAX
package.  Under a mesh each layer's input is laid out batch over the data
axes, whole along the sequence (``dist.sharding.gather_seq``).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..dist import sharding as shd
from ..nn import attention as attn
from ..nn import layers as nnl
from .config import ArchConfig
from .transformer import dtype_of, remat

DECODE_POSITIONS = 8192   # decode positions wrap modulo this table size


def sinusoid(s: int, d: int, dtype, device, start: int = 0) -> torch.Tensor:
    """Rows [start, start + s) of the (positions, d) sinusoid table."""
    pos = torch.arange(start, start + s, dtype=torch.float32,
                       device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _positions(x, s: int, d: int, start: int = 0):
    """The (1, s, d) sinusoid rows [start, start + s) in ``x``'s dtype,
    replicated on ``x``'s mesh where ``x`` is a DTensor."""
    return shd.replicated_like(
        sinusoid(s, d, x.dtype, x.device, start=start)[None], x)


def init_params(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    device = resolve_device(device)
    dt = dtype_of(cfg)
    d = cfg.d_model

    def ln():
        return nnl.norm_params("ln", d, dt, device)

    def attention():
        return attn.attn_params(gen, d, cfg.n_heads, cfg.n_kv, cfg.hd, True,
                                dt, device)

    def ffn():
        return nnl.mlp_params(gen, d, cfg.d_ff, "gelu", dt, device)

    return {
        "embed": nnl.embed_init(gen, (cfg.vocab, d), dt, device),
        "enc_layers": [{"norm1": ln(), "mixer": attention(), "norm2": ln(),
                        "ffn": ffn()} for _ in range(cfg.enc_layers)],
        "enc_norm": ln(),
        "dec_layers": [{"norm1": ln(), "self": attention(), "norm_x": ln(),
                        "cross": attention(), "norm2": ln(), "ffn": ffn()}
                       for _ in range(cfg.n_layers)],
        "dec_norm": ln(),
    }  # lm head tied to embed (whisper ties)


def encode(cfg: ArchConfig, params, frames):
    """frames (B, T, D) stubbed conv-frontend output -> encoder states."""
    x = frames + _positions(frames, frames.shape[1], cfg.d_model)
    for lp in params["enc_layers"]:
        x = remat(cfg, _enc_layer, cfg, lp, shd.gather_seq(x))
    return shd.gather_seq(nnl.apply_norm("ln", x, params["enc_norm"]))


def _enc_layer(cfg: ArchConfig, lp, x):
    h = nnl.apply_norm("ln", x, lp["norm1"])
    x = x + attn.bidir_attention(lp["mixer"], h, cfg.n_heads, cfg.n_kv,
                                 cfg.hd)
    h = nnl.apply_norm("ln", x, lp["norm2"])
    return x + nnl.mlp_apply(lp["ffn"], h, "gelu")


def _dec_layer(cfg: ArchConfig, lp, x, enc, positions):
    h = nnl.apply_norm("ln", x, lp["norm1"])
    x = x + attn.causal_attention(lp["self"], h, cfg.n_heads, cfg.n_kv,
                                  cfg.hd, positions, cfg.rope_theta,
                                  use_rope=False)
    h = nnl.apply_norm("ln", x, lp["norm_x"])
    x = x + attn.cross_attention(lp["cross"], h, enc, cfg.n_heads, cfg.n_kv,
                                 cfg.hd)
    h = nnl.apply_norm("ln", x, lp["norm2"])
    return x + nnl.mlp_apply(lp["ffn"], h, "gelu")


def forward(cfg: ArchConfig, params, frames, tokens,
            head_last_only: bool = False):
    """-> (logits (B, S, V), aux=0)."""
    enc = encode(cfg, params, frames)
    x = shd.lookup(params["embed"], tokens.long())
    b, s, _ = x.shape
    x = x + _positions(x, s, cfg.d_model)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for lp in params["dec_layers"]:
        x = remat(cfg, _dec_layer, cfg, lp, shd.gather_seq(x), enc,
                  positions)
    x = shd.gather_seq(nnl.apply_norm("ln", x, params["dec_norm"]))
    if head_last_only:
        x = x[:, -1:, :]
    return (x @ shd.pin_grad(params["embed"]).T,
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---- decode ---------------------------------------------------------------

def init_cache(cfg: ArchConfig, params, frames, cache_len: int):
    """Prefill: run the encoder once, precompute per-layer cross K/V,
    allocate decoder self-attn caches (on the frames' device)."""
    enc = encode(cfg, params, frames)
    b = frames.shape[0]
    kv = dict(dtype=dtype_of(cfg), device=frames.device)
    caches = []
    for lp in params["dec_layers"]:
        ck, cv = attn.cross_kv(lp["cross"], enc, cfg.n_kv, cfg.hd)
        caches.append({
            "k": torch.zeros((b, cache_len, cfg.n_kv, cfg.hd), **kv),
            "v": torch.zeros((b, cache_len, cfg.n_kv, cfg.hd), **kv),
            "xk": ck, "xv": cv,
        })
    return caches


def decode_step(cfg: ArchConfig, params, token, caches, pos: int):
    """token (B,) int; pos an int.  -> (logits (B, V), caches), the
    self-attention caches updated in place."""
    pos = int(pos)
    x = shd.lookup(params["embed"], token.long())[:, None, :]
    x = x + _positions(x, 1, cfg.d_model, pos % DECODE_POSITIONS)
    new_caches = []
    for lp, c in zip(params["dec_layers"], caches):
        h = nnl.apply_norm("ln", x, lp["norm1"])
        m, nk, nv = attn.decode_attention(
            lp["self"], h, c["k"], c["v"], pos, cfg.n_heads, cfg.n_kv,
            cfg.hd, cfg.rope_theta, use_rope=False)
        x = x + m
        h = nnl.apply_norm("ln", x, lp["norm_x"])
        x = x + attn.decode_cross_attention(lp["cross"], h, c["xk"], c["xv"],
                                            cfg.n_heads, cfg.n_kv, cfg.hd)
        h = nnl.apply_norm("ln", x, lp["norm2"])
        x = x + nnl.mlp_apply(lp["ffn"], h, "gelu")
        new_caches.append({"k": nk, "v": nv, "xk": c["xk"], "xv": c["xv"]})
    x = nnl.apply_norm("ln", x, params["dec_norm"])
    return (x @ params["embed"].T)[:, 0, :], new_caches
