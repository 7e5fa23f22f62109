"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] (the port of
``repro.nn.ssm``).

Chunked SSD: within a chunk the recurrence is a masked attention-like
quadratic form; across chunks a short loop carries the (n_heads, headdim,
d_state) states.  The intra-chunk output and the chunk states come from
the hand-written ``ssd_chunk`` kernel (float32, chunks of any length:
its tiled route takes those over 128 rows, Mamba-2's published 256), and
under autograd their gradient from its backward kernel (``SsdChunkFn``;
on a CPU tensor the wrappers run ``ssd_chunk_ref`` and the closed form
``ssd_chunk_bwd_ref``); the inter-chunk scan and the rest are plain
torch.  Single-token decode is the O(1) recurrence.
n_groups = 1 (B/C shared across heads, the released-model default).

Layer structure (released mamba2): in_proj -> [z | x | B | C | dt],
causal depthwise conv on (x,B,C), SSD, gated RMSNorm(z), out_proj.

Under a mesh (DTensor activations) x and dt are head-parallel over
``model`` where the head count divides it, batch over the data axes, and
the scan (the kernel, the inter-chunk carry, the skip term) runs on each
rank's local shard (``dist.sharding.local_call``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import sharding as shd
from ..kernels.ssd_chunk import ssd_chunk
from .layers import causal_conv, lecun, normal, rmsnorm, softplus


def ssd_params(gen, d_model: int, d_state: int, d_conv: int,
               expand: int, headdim: int, dtype, device) -> dict:
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    d_proj = 2 * d_inner + 2 * d_state + n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": lecun(gen, (d_model, d_proj), dtype, device),
        "conv_w": normal(gen, (d_conv, d_inner + 2 * d_state), 0.1, dtype,
                         device),
        "A_log": torch.zeros((n_heads,), **f32),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "norm_scale": torch.zeros((d_inner,), dtype=dtype, device=device),
        "out_proj": lecun(gen, (d_inner, d_model), dtype, device),
    }


def _split_proj(proj, d_inner, d_state):
    z = proj[..., :d_inner]
    x = proj[..., d_inner:2 * d_inner]
    B = proj[..., 2 * d_inner:2 * d_inner + d_state]
    C = proj[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    return z, x, B, C, dt


def ssd_apply(p, u, d_state: int, expand: int, headdim: int,
              chunk: int = 128):
    """u (B, S, D) -> (B, S, D).  Chunked SSD scan."""
    bsz, s, d_model = u.shape
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    proj = u @ p["in_proj"]
    z, x, B, C, dt = _split_proj(proj, d_inner, d_state)
    xBC = F.silu(causal_conv(torch.cat([x, B, C], -1), p["conv_w"]))
    x = xBC[..., :d_inner]
    B = xBC[..., d_inner:d_inner + d_state]
    C = xBC[..., d_inner + d_state:]
    dt = softplus(dt.float() + p["dt_bias"])                  # (B,S,H)

    h = n_heads
    xh = x.reshape(bsz, s, h, headdim).float()
    assert s % chunk == 0 or s < chunk, "seq must divide chunk"
    q = min(chunk, s)
    nc = s // q
    # head-parallel over the model axis: the chunk states shard H-fold
    xc = shd.constrain(xh.reshape(bsz, nc, q, h, headdim),
                       "dp", None, None, "tp", None).contiguous()
    Bc = B.reshape(bsz, nc, q, d_state).float().contiguous()
    Cc = C.reshape(bsz, nc, q, d_state).float().contiguous()
    dtc = shd.constrain(dt.reshape(bsz, nc, q, h), "dp", None, None, "tp")
    args = (xc, Bc, Cc, dtc, p["A_log"], p["D"])
    y = _scan_sharded(*args) if shd.is_dtensor(xc) else _scan(*args)
    y = y.reshape(bsz, s, d_inner).to(u.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_scale"])               # gated norm
    return y @ p["out_proj"]


def _scan(xc, Bc, Cc, dt, A_log, D):
    """The SSD of one chunked layer: xc (B, nc, q, H, P), Bc / Cc (B, nc,
    q, S), dt (B, nc, q, H) float32; -> y (B, nc·q, H, P) float32."""
    bsz, nc, q, h, p = xc.shape
    A = -torch.exp(A_log)                                     # (H,)
    cum = torch.cumsum(dt * A, dim=2)                         # in-chunk

    # intra-chunk output and chunk states: the kernel
    y_in, states = ssd_chunk(xc, Bc, Cc, dt, cum)

    # inter-chunk scan: the state carried into each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)
    st = torch.zeros((bsz, h, p, Bc.shape[-1]), dtype=torch.float32,
                     device=xc.device)
    st_before = []
    for n in range(nc):
        st_before.append(st)
        st = states[:, n] + chunk_decay[:, n, :, None, None] * st
    st_before = torch.stack(st_before, dim=1)                 # (B,nc,H,P,S)

    # contribution of carried-in state to each position
    y_out = (torch.einsum("bnis,bnhps->bnihp", Cc, st_before)
             * torch.exp(cum)[..., None])
    y = (y_in + y_out).reshape(bsz, nc * q, h, p)
    return y + D[None, None, :, None] * xc.reshape(bsz, nc * q, h, p)


def _scan_sharded(xc, Bc, Cc, dt, A_log, D):
    """:func:`_scan` on each rank's shard of DTensor operands: batch over
    the data axes, heads over ``model`` where the head count divides it
    (A_log and D split with them), B and C (shared by the heads) whole on
    every model rank."""
    phys, sizes = shd.physical()
    bsz, nc, q, h, p = xc.shape
    dp = shd.fit_spec((phys.get("dp"),), (bsz,), shd.active_mesh())[0]
    tp = phys.get("tp")
    heads = tp if tp is not None and h % sizes[tp] == 0 else None
    b_spec = (dp, None, None, None)
    return shd.local_call(
        _scan, (xc, Bc, Cc, dt, A_log, D),
        ((dp, None, None, heads, None), b_spec, b_spec,
         (dp, None, None, heads), (heads,), (heads,)),
        ((dp, None, heads, None),), ((bsz, nc * q, h, p),))


def ssd_decode(p, u, state, conv_state, d_state: int, expand: int,
               headdim: int):
    """Single-token decode.  u (B, 1, D); state (B, H, P, S);
    conv_state (B, W-1, d_inner + 2*d_state).  O(1) per token; returns
    (y (B, 1, D), new state, new conv_state)."""
    bsz, _, d_model = u.shape
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    proj = u @ p["in_proj"]
    z, x, B, C, dt = _split_proj(proj[:, 0], d_inner, d_state)
    xBC = torch.cat([x, B, C], -1)                            # (B, D')
    hist = torch.cat([conv_state, xBC[:, None, :]], dim=1)
    conv_out = F.silu(torch.sum(hist * p["conv_w"][None], dim=1))
    new_conv_state = hist[:, 1:]
    x = conv_out[..., :d_inner]
    B = conv_out[..., d_inner:d_inner + d_state].float()
    C = conv_out[..., d_inner + d_state:].float()
    dt = softplus(dt.float() + p["dt_bias"])                  # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])                           # (B,H)
    xh = x.reshape(bsz, n_heads, headdim).float()
    dBx = torch.einsum("bh,bs,bhp->bhps", dt, B, xh)
    state = state * dA[..., None, None] + dBx
    y = torch.einsum("bs,bhps->bhp", C, state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(bsz, d_inner).to(u.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_scale"])
    return (y @ p["out_proj"])[:, None, :], state, new_conv_state
