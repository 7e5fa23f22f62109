"""NN primitives on plain tensors (the port of ``repro.nn.layers``): norms,
RoPE, gated MLPs, embedding init.

Params are nested dicts of tensors with the JAX package's keys and
layouts (weights ``(in, out)``, so ``x @ w``).  Init draws come from a
``torch.Generator`` on its own device and land on ``device`` in the
requested dtype; they are not the JAX package's numbers (carry JAX
weights across with :func:`repro_torch.lm.params.from_numpy`).
Casts follow the JAX package: norms and RoPE compute in float32 and
return the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import sharding as shd


def normal(gen: torch.Generator, shape, std: float, dtype, device):
    """float32 N(0, std²) draws from ``gen``, cast to ``dtype`` on
    ``device``.  On the ``meta`` device (shapes only: the dry run's
    stand-ins) nothing is drawn and ``gen`` may be None."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(std).to(device=device, dtype=dtype)


def he(gen, shape, dtype, device, fan_in=None):
    fan_in = fan_in or shape[0]
    return normal(gen, shape, (2.0 / fan_in) ** 0.5, dtype, device)


def lecun(gen, shape, dtype, device, fan_in=None):
    fan_in = fan_in or shape[0]
    return normal(gen, shape, (1.0 / fan_in) ** 0.5, dtype, device)


def embed_init(gen, shape, dtype, device):
    """std = 1/sqrt(d): keeps tied-head logits O(1); embed_scale archs
    (gemma family) multiply inputs back up by sqrt(d)."""
    return normal(gen, shape, shape[-1] ** -0.5, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(x.dtype)


def np_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric LayerNorm (OLMo): no learned scale/bias."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(kind: str, x, p):
    if kind == "rms":
        return rmsnorm(x, p["scale"])
    if kind == "np_ln":
        return np_layernorm(x)
    if kind == "ln":
        return layernorm(x, p["scale"], p["bias"])
    raise ValueError(kind)


def norm_params(kind: str, d: int, dtype, device) -> dict:
    if kind == "rms":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "np_ln":
        return {}
    if kind == "ln":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, Dh), positions (..., S) -> rotated x."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq              # (..., S, half)
    cos = shd.replicated_like(torch.cos(ang)[..., None, :], x)  # (.,S,1,h/2)
    sin = shd.replicated_like(torch.sin(ang)[..., None, :], x)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# depthwise causal conv (the SSD and RG-LRU blocks)
# ---------------------------------------------------------------------------

def causal_conv(x, w):
    """x (B, S, D), w (W, D) depthwise causal conv (no activation), its
    taps summed in order as the JAX package sums them."""
    wlen = w.shape[0]
    if shd.is_dtensor(x):
        # the left padding as a concatenation: DTensor's pad rule drops a
        # mesh dimension from its result in some torch releases (2.11)
        b, _, d = x.shape
        zeros = torch.zeros((b, wlen - 1, d), dtype=x.dtype, device=x.device)
        xp = torch.cat([shd.replicated_like(zeros, x), x], dim=1)
    else:
        xp = F.pad(x, (0, 0, wlen - 1, 0))
    out = xp[:, 0:x.shape[1], :] * w[0][None, None, :]
    for i in range(1, wlen):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu(x, approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mlp_params(gen, d: int, f: int, act: str, dtype, device) -> dict:
    p = {"w_out": lecun(gen, (f, d), dtype, device)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = lecun(gen, (d, f), dtype, device)
    p["w_in"] = lecun(gen, (d, f), dtype, device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        g = F.silu(x @ p["w_gate"])
        return (g * (x @ p["w_in"])) @ p["w_out"]
    if act == "geglu":
        g = gelu(x @ p["w_gate"])
        return (g * (x @ p["w_in"])) @ p["w_out"]
    if act == "gelu":
        return gelu(x @ p["w_in"]) @ p["w_out"]
    raise ValueError(act)


def mlp_flops(d: int, f: int, act: str) -> int:
    n_mat = 3 if act in ("swiglu", "geglu") else 2
    return 2 * n_mat * d * f
