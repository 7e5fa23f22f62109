"""Attention: GQA/MQA, full-causal, block-local, cross; prefill + decode
(the port of ``repro.nn.attention``).

Shapes: hidden (B, S, D); per-head (B, S, H, Dh).  GQA is computed grouped
(no K/V expansion).  :func:`attention_route` names, from a call's static
arguments alone, where its softmax(QKᵀ)V core runs:

  * ``"flash"`` — the hand-written ``flash_attention`` kernel on
    (B, H, S, D) tensors: :func:`causal_attention` without a
    bidirectional prefix and without a softcap, and
    :func:`bidir_attention` (``causal=False``), at any head_dim (the
    kernel's ``split`` routes take those past ``MAX_D`` = 256).  These
    calls have Sq == Skv, where the kernel's top-left causal mask is the
    JAX package's ``rows >= cols``, and one call computes what the JAX
    package's query chunking above ``CHUNK_Q_ABOVE`` computes.
  * ``"plain"`` — torch einsums mirroring the JAX package: PaliGemma's
    bidirectional prefix, a softcap, :func:`local_attention`, cross
    attention and decode.

The route never falls back: on a CUDA tensor the kernel launches or
raises; on a CPU tensor its wrapper runs ``attention_ref``.

Under a mesh (``dist.sharding.use_mesh``, DTensor activations) q, k and v
are laid out by ``constrain_heads`` (batch over the data axes, heads over
``model`` where the count divides it), and every core, the kernel and
the plain route alike, runs on each rank's local shard (:func:`_attend`,
``dist.sharding.local_call``).  Decode's in-place cache writes go to each
rank's shard of the DTensor caches (``dist.sharding.write_slot``).
"""
from __future__ import annotations

import torch

from ..dist import sharding as shd
from ..kernels.flash_attention import flash_attention
from .layers import lecun, rope

NEG = -2.0e38
CHUNK_Q_ABOVE = 8192   # the plain route chunks the query axis above this
N_Q_CHUNKS = 8


def attention_route(kind: str, head_dim: int, prefix_len: int = 0,
                    softcap: float = 0.0) -> str:
    """``"flash"`` or ``"plain"`` for an attention call of ``kind``
    (``causal``, ``bidir``, ``local``, ``cross``, ``decode``)."""
    if (kind in ("causal", "bidir") and prefix_len == 0 and softcap == 0
            and head_dim > 0):
        return "flash"
    return "plain"


def attn_params(gen, d: int, n_heads: int, n_kv: int, head_dim: int,
                qkv_bias: bool, dtype, device) -> dict:
    p = {
        "wq": lecun(gen, (d, n_heads * head_dim), dtype, device),
        "wk": lecun(gen, (d, n_kv * head_dim), dtype, device),
        "wv": lecun(gen, (d, n_kv * head_dim), dtype, device),
        "wo": lecun(gen, (n_heads * head_dim, d), dtype, device,
                    fan_in=n_heads * head_dim),
    }
    if qkv_bias:
        for name, n in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((n * head_dim,), dtype=dtype,
                                  device=device)
    return p


def _heads(t, n: int, head_dim: int):
    """(B, S, n·Dh) -> (B, S, n, Dh); under a mesh laid out by
    ``constrain_heads`` (a head count the model axis does not divide is
    gathered whole before the split)."""
    t = shd.constrain_heads_flat(t, n)
    return shd.constrain_heads(t.reshape(*t.shape[:2], n, head_dim), n)


def _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta,
                 use_rope=True):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (_heads(q, n_heads, head_dim), _heads(k, n_kv, head_dim),
               _heads(v, n_kv, head_dim))
    if use_rope:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v


def _scaled(q, scale: float):
    """q times ``scale`` rounded to q's dtype first, as JAX multiplies by
    a weakly typed Python float."""
    return q * torch.tensor(scale, dtype=q.dtype)


def _gqa_scores(q, k, scale):
    """q (B,S,H,Dh), k (B,T,Hkv,Dh) -> float32 scores (B,Hkv,G,S,T),
    grouped; q is scaled in its own dtype, the products are float32."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    qg = _scaled(q, scale).reshape(b, s, hkv, h // hkv, dh)
    return torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())


def _gqa_out(probs, v):
    """probs (B,Hkv,G,S,T), v (B,T,Hkv,Dh) -> (B,S,H,Dh)."""
    b, hkv, g, s, _ = probs.shape
    o = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return o.reshape(b, s, hkv * g, v.shape[-1])


def _softmax(scores, dtype):
    return torch.softmax(scores, dim=-1).to(dtype)


def _attend(core, q, k, v):
    """``core(q, k, v)`` -> (B, S, H, Dh) on plain tensors q (B, S, H, Dh)
    and k, v (B, T, Hkv, Dh); -> (B, S, H·Dh).

    On DTensors (laid out by ``constrain_heads``) the core runs on each
    rank's shards (``dist.sharding.local_call``): batch over the data
    axes, heads over ``model`` where the count divides it.  Where the
    query heads split and too few KV heads to split are replicated, each
    rank keeps the KV heads its query heads read (their grads come back
    as partial sums).  So neither a kernel nor a GQA grouping nor the
    merge of the heads ever sees a DTensor, whose view rules cannot merge
    two split dims (torch 2.11) nor split an unevenly split one."""
    b, s, h, dh = q.shape
    if not shd.is_dtensor(q):
        return core(q, k, v).reshape(b, s, h * dh)
    phys, sizes = shd.physical()
    mesh = shd.active_mesh()
    hkv = k.shape[2]
    qs = shd.fit_spec(shd.heads_spec(phys, sizes, h), q.shape, mesh)
    ks = shd.fit_spec(shd.heads_spec(phys, sizes, hkv), k.shape, mesh)
    kv = slice(None)
    if qs[2] is not None and ks[2] is None:
        hl, g = h // shd.axis_size(qs[2]), h // hkv
        if hl % g and g % hl:
            raise ValueError(f"attention under a mesh: {hl} query heads a "
                             f"rank do not tile groups of {g}")
        first = shd.coordinate(qs[2]) * hl
        kv = slice(first // g, (first + hl - 1) // g + 1)

    def run(ql, kl, vl):
        o = core(ql, kl[:, :, kv], vl[:, :, kv])
        return o.reshape(*o.shape[:2], o.shape[2] * dh)
    # the heads merged on each rank: the output's last dim split where
    # the heads are, its gradient handed back in that layout
    return shd.local_call(run, (q, k, v), (qs, ks, ks),
                          ((qs[0], None, qs[2]),), ((b, s, h * dh),))


def _flash_local(q, k, v, causal: bool):
    """(B,S,H,Dh) plain tensors -> the kernel's output (B,S,H,Dh), through
    its (B, H, S, D) layout."""
    o = flash_attention(*(t.transpose(1, 2).contiguous() for t in (q, k, v)),
                        causal=causal)
    return o.transpose(1, 2)


def _flash(q, k, v, causal: bool):
    """q (B,S,H,Dh), k/v (B,S,Hkv,Dh) -> (B,S,H*Dh) through the kernel."""
    return _attend(lambda ql, kl, vl: _flash_local(ql, kl, vl, causal),
                   q, k, v)


def _plain(q, k, v, dtype, mask=None, softcap: float = 0.0):
    """The plain softmax(q·kᵀ)·v core: q (B,S,H,Dh), k, v (B,T,Hkv,Dh) ->
    (B,S,H,Dh); ``mask(scores)`` -> where scores stay (else NEG)."""
    scores = _gqa_scores(q, k, q.shape[-1] ** -0.5)     # (B,Hkv,G,S,T)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = torch.where(mask(scores), scores, NEG)
    return _gqa_out(_softmax(scores, dtype), v)


def _chunked(block, s: int):
    """``block(q0, q1)`` over the query axis: whole up to CHUNK_Q_ABOVE,
    else in N_Q_CHUNKS chunks concatenated."""
    if s <= CHUNK_Q_ABOVE:
        return block(0, s)
    assert s % N_Q_CHUNKS == 0
    qlen = s // N_Q_CHUNKS
    return torch.cat([block(i * qlen, (i + 1) * qlen)
                      for i in range(N_Q_CHUNKS)], dim=1)


def causal_attention(p, x, n_heads, n_kv, head_dim, positions, theta,
                     softcap: float = 0.0, prefix_len: int = 0,
                     use_rope: bool = True):
    """Full causal self-attention (optionally with a bidirectional prefix —
    PaliGemma's image tokens attend fully within the prefix).  The plain
    route processes the query axis in N_Q_CHUNKS chunks for S >
    CHUNK_Q_ABOVE, each against the keys up to its end."""
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta,
                           use_rope)
    if attention_route("causal", head_dim, prefix_len, softcap) == "flash":
        return _flash(q, k, v, causal=True) @ p["wo"]

    def core(q, k, v):
        def block(q0, q1):
            """queries [q0, q1) vs. keys [0, q1)."""
            rows = torch.arange(q0, q1, device=q.device)[:, None]
            cols = torch.arange(q1, device=q.device)[None, :]
            mask = rows >= cols
            if prefix_len > 0:
                mask = mask | ((rows < prefix_len) & (cols < prefix_len))
            return _plain(q[:, q0:q1], k[:, :q1], v[:, :q1], x.dtype,
                          lambda _: mask, softcap)
        return _chunked(block, q.shape[1])
    return _attend(core, q, k, v) @ p["wo"]


def local_attention(p, x, n_heads, n_kv, head_dim, positions, theta,
                    window: int):
    """Block-local causal attention, exact for lookback ``window``.

    Sequence is tiled into blocks of `window`; each block attends to itself
    and the previous block with a per-position causal+window mask.  Memory
    is O(S·2w) instead of O(S²)."""
    b, s, d = x.shape
    w = min(window, s)
    assert s % w == 0, "local attention needs seq divisible by window"
    nb = s // w
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta)

    def core(q, k, v):
        b, _, h, dh = q.shape
        hkv = k.shape[2]
        qb = _scaled(q, dh ** -0.5).reshape(b, nb, w, hkv, h // hkv, dh)
        kb = k.reshape(b, nb, w, hkv, dh)
        vb = v.reshape(b, nb, w, hkv, dh)
        # keys for block i: [block i-1 ++ block i] (block 0 pads with 0)
        kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
        vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
        k2 = torch.cat([kprev, kb], dim=2)              # (B,nb,2w,Hkv,Dh)
        v2 = torch.cat([vprev, vb], dim=2)
        scores = torch.einsum("bnshgd,bnthd->bnhgst", qb.float(),
                              k2.float())
        dev = q.device
        rows = torch.arange(w, device=dev)[:, None]         # in-block q pos
        cols = torch.arange(2 * w, device=dev)[None, :] - w  # key offset
        mask = (cols <= rows) & (cols > rows - w)           # causal, window
        first = torch.arange(nb, device=dev)[:, None, None] == 0
        mask_b = mask[None, :, :] & (~first | (cols[None] >= 0))
        scores = torch.where(mask_b[None, :, None, None, :, :], scores, NEG)
        o = torch.einsum("bnhgst,bnthd->bnshgd", _softmax(scores, x.dtype),
                         v2)
        return o.reshape(b, s, h, dh)
    return _attend(core, q, k, v) @ p["wo"]


def cross_attention(p, x, kv_feats, n_heads, n_kv, head_dim):
    """Whisper decoder cross-attention (no RoPE, no mask); q-chunked for
    long decoder sequences like causal_attention."""
    q = _heads(x @ p["wq"], n_heads, head_dim)
    k, v = cross_kv(p, kv_feats, n_kv, head_dim)

    def core(q, k, v):
        return _chunked(lambda q0, q1: _plain(q[:, q0:q1], k, v, x.dtype),
                        q.shape[1])
    return _attend(core, q, k, v) @ p["wo"]


def decode_cross_attention(p, x, cross_k, cross_v, n_heads, n_kv,
                           head_dim):
    """Decoder cross-attention against precomputed encoder K/V
    (cross_k/v (B, T, Hkv, Dh), computed once per request at prefill)."""
    q = _heads(x @ p["wq"], n_heads, head_dim)
    o = _attend(lambda q, k, v: _plain(q, k, v, x.dtype), q, cross_k,
                cross_v)
    return o @ p["wo"]


def cross_kv(p, kv_feats, n_kv, head_dim):
    """Precompute encoder K/V for decode."""
    k = _heads(kv_feats @ p["wk"], n_kv, head_dim)
    v = _heads(kv_feats @ p["wv"], n_kv, head_dim)
    return k, v


def bidir_attention(p, x, n_heads, n_kv, head_dim):
    """Encoder self-attention (Whisper encoder): full bidirectional."""
    q = _heads(x @ p["wq"], n_heads, head_dim)
    k = _heads(x @ p["wk"], n_kv, head_dim)
    v = _heads(x @ p["wv"], n_kv, head_dim)
    if attention_route("bidir", head_dim) == "flash":
        return _flash(q, k, v, causal=False) @ p["wo"]
    o = _attend(lambda q, k, v: _plain(q, k, v, x.dtype), q, k, v)
    return o @ p["wo"]


# ---------------------------------------------------------------------------
# decode (single new token against a cache)
# ---------------------------------------------------------------------------

def _quantize_kv(kv):
    """kv (B, 1, H, Dh) -> (int8 codes, (B, 1, H) f32 scale)."""
    kv32 = kv.float()
    scale = torch.clamp_min(kv32.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(kv32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def decode_attention(p, x, cache_k, cache_v, pos: int, n_heads, n_kv,
                     head_dim, theta, window: int = 0, use_rope: bool = True,
                     softcap: float = 0.0, k_scale=None, v_scale=None):
    """x (B, 1, D); cache_k/v (B, T, Hkv, Dh) with valid [0, pos);
    returns (out (B,1,D), cache_k, cache_v[, k_scale, v_scale]).

    The new token's K/V are written into the caches in place (the JAX
    package returns updated copies); the returned caches are the
    arguments.  ``window`` > 0 -> ring-buffer cache of size T=window
    (local attention).  ``k_scale``/``v_scale`` (B, T, Hkv) -> the cache
    is int8-quantized per (token, head), dequantized in the model dtype
    before the scores.  A slot past the cache's end writes its last row,
    as ``dynamic_update_slice`` clamps its start.  Under a mesh the
    caches are DTensors laid out by ``dist.sharding.cache_shardings`` and
    each rank writes its own shard (``dist.sharding.write_slot``).
    """
    b = x.shape[0]
    t = cache_k.shape[1]
    quant = k_scale is not None
    q = _heads(x @ p["wq"], n_heads, head_dim)
    k = _heads(x @ p["wk"], n_kv, head_dim)
    v = _heads(x @ p["wv"], n_kv, head_dim)
    if "bq" in p:
        q = q + _heads(p["bq"].reshape(1, 1, -1), n_heads, head_dim)
        k = k + _heads(p["bk"].reshape(1, 1, -1), n_kv, head_dim)
        v = v + _heads(p["bv"].reshape(1, 1, -1), n_kv, head_dim)
    if use_rope:
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q, posv, theta)
        k = rope(k, posv, theta)
    slot = pos % t if window else pos
    at = min(slot, t - 1)
    if quant:
        k8, ks = _quantize_kv(k)
        v8, vs = _quantize_kv(v)
        for cache, new in ((cache_k, k8), (cache_v, v8), (k_scale, ks),
                           (v_scale, vs)):
            shd.write_slot(cache, at, new)
        kf = cache_k.to(x.dtype) * k_scale[..., None].to(x.dtype)
        vf = cache_v.to(x.dtype) * v_scale[..., None].to(x.dtype)
    else:
        shd.write_slot(cache_k, at, k)
        shd.write_slot(cache_v, at, v)
        kf, vf = cache_k, cache_v
    mask = None
    if not (window and pos >= t):
        def mask(scores):
            return torch.arange(t, device=scores.device) <= slot
    o = _attend(lambda q, k, v: _plain(q, k, v, x.dtype, mask, softcap),
                q, kf, vf)
    if quant:
        return o @ p["wo"], cache_k, cache_v, k_scale, v_scale
    return o @ p["wo"], cache_k, cache_v
