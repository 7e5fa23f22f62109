"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), the
port of ``repro.nn.rglru``.

Recurrence (diagonal, gated):
    r_t = sigmoid(W_r x_t)            (recurrence gate)
    i_t = sigmoid(W_i x_t)            (input gate)
    a_t = exp(-c · softplus(Λ) · r_t) (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The sequence form is an inclusive log-step scan (Hillis–Steele: ⌈log2 S⌉
steps over the whole sequence) with the JAX package's ``combine``; decode
is the O(1) step.  The full Griffin recurrent block is: linear x/gate
branches, causal conv(4) on the x branch, RG-LRU, gated merge, output
projection.
"""
from __future__ import annotations

import math

import torch

from .layers import causal_conv, gelu, lecun, normal, softplus

C_FACTOR = 8.0


def rglru_params(gen, d_model: int, d_rnn: int, d_conv: int, dtype,
                 device) -> dict:
    grid = torch.linspace(0.9, 0.999, d_rnn, dtype=torch.float32,
                          device=device)
    return {
        "w_x": lecun(gen, (d_model, d_rnn), dtype, device),
        "w_gate": lecun(gen, (d_model, d_rnn), dtype, device),
        "conv_w": normal(gen, (d_conv, d_rnn), 0.1, dtype, device),
        "w_r": lecun(gen, (d_rnn, d_rnn), dtype, device),
        "w_i": lecun(gen, (d_rnn, d_rnn), dtype, device),
        # Λ init so that a ∈ (0.9, 0.999) at r=1 (Griffin appendix)
        "lam": torch.log(torch.expm1(-torch.log(grid) / C_FACTOR)),
        "w_out": lecun(gen, (d_rnn, d_model), dtype, device),
    }


def _gates(p, x):
    r = torch.sigmoid((x @ p["w_r"]).float())
    i = torch.sigmoid((x @ p["w_i"]).float())
    log_a = -C_FACTOR * softplus(p["lam"]) * r               # (..., D)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    return a, beta * i


def combine(c1, c2):
    """The scan's associative operator: (a1, b1) then (a2, b2)."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def linear_scan(a, b):
    """Inclusive scan of :func:`combine` over axis 1 of (B, S, D) a, b:
    h_t = a_t · h_{t-1} + b_t from h_{-1} = 0.  -> (prod of a, h)."""
    s = a.shape[1]
    for k in range(math.ceil(math.log2(s)) if s > 1 else 0):
        d = 1 << k
        a_new, b_new = combine((a[:, :-d], b[:, :-d]), (a[:, d:], b[:, d:]))
        a = torch.cat([a[:, :d], a_new], dim=1)
        b = torch.cat([b[:, :d], b_new], dim=1)
    return a, b


def rglru_apply(p, u):
    """u (B, S, D) -> (B, S, D).  Griffin recurrent block, log-step
    scan."""
    gate = gelu(u @ p["w_gate"])
    x = causal_conv(u @ p["w_x"], p["conv_w"])
    a, bx = _gates(p, x)
    bx = bx * x.float()
    _, h = linear_scan(a, bx)
    return (h.to(u.dtype) * gate) @ p["w_out"]


def rglru_decode(p, u, state, conv_state):
    """u (B, 1, D); state (B, D_rnn) f32; conv_state (B, W-1, D_rnn)."""
    gate = gelu(u[:, 0] @ p["w_gate"])
    xt = u[:, 0] @ p["w_x"]
    hist = torch.cat([conv_state, xt[:, None, :]], dim=1)
    x = torch.sum(hist * p["conv_w"][None], dim=1)
    new_conv_state = hist[:, 1:]
    a, bi = _gates(p, x)
    state = a * state + bi * x.float()
    y = (state.to(u.dtype) * gate) @ p["w_out"]
    return y[:, None, :], state, new_conv_state
