"""The port's entry-point kernels against the JAX package: ``knn``,
``flash_attention`` and ``ssd_chunk`` on CPU tensors (their plain versions)
against the Pallas kernels in interpret mode and the JAX oracles, the edge
cases where the port departs from the Pallas kernels, and, on a CUDA host,
each kernel against its plain version.

The JAX package is imported inside the tests that compare with it, so
the card tests (``pytest -m cuda tests/test_torch_kernels.py``) also run
on a host without JAX."""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    attention_lse_ref, attention_ref, flash_attention)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import _variant
from repro_torch.kernels.gather_mlp import ops as gather_ops
from repro_torch.kernels.hub_reuse import ops as reuse_ops
from repro_torch.kernels.knn import knn, knn_ref
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref
from repro_torch.kernels.ssd_chunk import ops as ssd_ops

torch.set_num_threads(1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _knn_index_agreement(got, want, d):
    """Share of indices that agree where the distance is unique in its row
    (tests/test_kernels.py's rule: near-ties may reorder)."""
    unique = np.abs(d[:, 1:] - d[:, :-1]) > 1e-9
    return (got == want)[:, 1:][unique].mean()


def _knn_decided(d, d_next, tol):
    """Where the order is decided: the sorted distance differs from both
    neighbours in its row (the (k+1)-th, ``d_next``, +inf at k = N, beside
    the last) by more than ``tol``."""
    ext = np.concatenate([d, d_next], 1)
    gap = np.abs(ext[:, 1:] - ext[:, :-1]) > tol
    return np.concatenate([np.ones_like(gap[:, :1]), gap[:, :-1]], 1) & gap


# ---- knn ---------------------------------------------------------------------


@pytest.mark.parametrize("s,n,k,tc,tp", [
    (64, 256, 8, 64, 128),
    (130, 1000, 32, 128, 256),   # ragged tiles both axes
    (32, 512, 16, 32, 512),
    (16, 100, 4, 16, 64),
])
def test_knn_matches_jax(s, n, k, tc, tp):
    import jax.numpy as jnp
    from repro.kernels.knn.knn import knn_pallas
    from repro.kernels.knn.ref import knn_ref as jknn_ref
    rng = np.random.default_rng(s + n)
    c = rng.normal(size=(s, 3)).astype(np.float32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    d, i = knn(torch.from_numpy(c), torch.from_numpy(p), k)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert tuple(d.shape) == tuple(i.shape) == (s, k)
    d, i = d.numpy(), i.numpy()
    dk, ik = (np.asarray(a) for a in knn_pallas(
        jnp.asarray(c), jnp.asarray(p), k, tc=tc, tp=tp, interpret=True))
    d0, i0 = (np.asarray(a) for a in jknn_ref(jnp.asarray(c),
                                             jnp.asarray(p), k))
    for dw, iw in ((dk, ik), (d0, i0)):
        np.testing.assert_allclose(d, dw, rtol=1e-5, atol=1e-5)
        assert _knn_index_agreement(i, iw, dw) > 0.99
    # nearest first, and the lexicographic (distance, index) order
    assert (np.diff(d, axis=1) >= 0).all()
    tie = np.diff(d, axis=1) == 0
    assert (np.diff(i, axis=1)[tie] > 0).all()


@pytest.mark.parametrize("s,n,k,pallas", [
    (48, 400, 96, True),      # past the parent kernel's 64 entries
    (40, 700, 300, False),    # past 256: the lists in shared memory
    (24, 150, 150, True),     # k = N: every point, in order
])
def test_knn_wide_k_matches_jax(s, n, k, pallas):
    """The kernel's new domain, any 1 <= k <= N, on the plain version
    against JAX ``knn_ref`` (and the Pallas kernel in interpret mode where
    it is small): distances within 1e-5, indices exact wherever the
    distance order is decided."""
    import jax.numpy as jnp
    from repro.kernels.knn.knn import knn_pallas
    from repro.kernels.knn.ref import knn_ref as jknn_ref
    rng = np.random.default_rng(s + n + k)
    c = rng.normal(size=(s, 3)).astype(np.float32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    d, i = (t.numpy() for t in knn(torch.from_numpy(c),
                                    torch.from_numpy(p), k))
    assert d.shape == i.shape == (s, k)
    jc, jp = jnp.asarray(c), jnp.asarray(p)
    wants = [jknn_ref(jc, jp, min(k + 1, n))]
    if pallas:
        wants.append(knn_pallas(jc, jp, k, tc=16, tp=128, interpret=True))
    for dw, iw in wants:
        dw, iw = np.asarray(dw), np.asarray(iw)
        d_next = (dw[:, k:k + 1] if dw.shape[1] > k
                  else np.full((s, 1), np.inf, np.float32))
        dw, iw = dw[:, :k], iw[:, :k]
        np.testing.assert_allclose(d, dw, rtol=1e-5, atol=1e-5)
        decided = _knn_decided(dw, d_next, 1e-5)
        assert decided.mean() > 0.9
        np.testing.assert_array_equal(i[decided], iw[decided])
    if k == n:
        assert (np.sort(i, axis=1) == np.arange(n)).all()


def test_knn_ties_go_to_the_lower_index_across_tiles():
    """A point duplicated on both sides of a Pallas point-tile boundary
    (tp=4): the port keeps JAX ``knn_ref``'s lower-index order, which the
    Pallas kernel's [tile ++ best] merge does not."""
    import jax.numpy as jnp
    from repro.kernels.knn.knn import knn_pallas
    from repro.kernels.knn.ref import knn_ref as jknn_ref
    p = np.array([[3, 0, 0], [0, 2, 0], [5, 5, 5], [4, 4, 4],
                  [0, 0, 3], [0, 2, 0], [2, 2, 2], [1, 0, 0]], np.float32)
    c = np.zeros((2, 3), np.float32)
    c[1] = [0, 0, 0.5]
    d, i = knn(torch.from_numpy(c), torch.from_numpy(p), 3)
    d0, i0 = (np.asarray(a) for a in jknn_ref(jnp.asarray(c),
                                             jnp.asarray(p), 3))
    np.testing.assert_array_equal(i.numpy(), i0)
    np.testing.assert_array_equal(i.numpy()[0], [7, 1, 5])
    np.testing.assert_allclose(d.numpy(), d0, rtol=1e-6, atol=1e-6)
    dk, _ = knn_pallas(jnp.asarray(c), jnp.asarray(p), 3, tc=2, tp=4,
                       interpret=True)
    np.testing.assert_allclose(d.numpy(), np.asarray(dk), rtol=1e-6,
                               atol=1e-6)


def test_knn_refuses_k_above_n():
    """The Pallas kernel fills slots past N with index 0; the port
    raises."""
    c, p = torch.zeros((3, 3)), torch.ones((4, 3))
    with pytest.raises(ValueError, match="k <= N"):
        knn(c, p, 6)
    d, i = knn(c, p, 4)
    assert sorted(i[0].tolist()) == [0, 1, 2, 3]


# ---- flash_attention ---------------------------------------------------------


def _qkv(rng, b, hq, hkv, sq, skv, d):
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", [
    (1, 2, 1, 128, 32, True),
    (2, 4, 2, 256, 64, True),
    (1, 4, 4, 64, 32, False),
    (1, 8, 2, 192, 16, True),     # ragged q tiles
    (1, 2, 1, 128, 256, True),    # head_dim 256 (gemma_7b, paligemma_3b)
])
def test_flash_attention_matches_jax(b, hq, hkv, s, d, causal):
    import jax.numpy as jnp
    from repro.kernels.flash_attention.flash_attention import (
        flash_attention_pallas)
    from repro.kernels.flash_attention.ref import (
        attention_ref as jattention_ref)
    rng = np.random.default_rng(hq * s + d)
    qkv = _qkv(rng, b, hq, hkv, s, s, d)
    got = flash_attention(*_torch(qkv), causal=causal).numpy()
    jq = [jnp.asarray(a) for a in qkv]
    for want in (flash_attention_pallas(*jq, causal=causal, tq=64, tk=64,
                                        interpret=True),
                 jattention_ref(*jq, causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3,
                                   atol=2e-3)


def test_flash_attention_bf16_matches_jax():
    import jax.numpy as jnp
    from repro.kernels.flash_attention.flash_attention import (
        flash_attention_pallas)
    from repro.kernels.flash_attention.ref import (
        attention_ref as jattention_ref)
    rng = np.random.default_rng(7)
    qkv = _qkv(rng, 1, 2, 1, 128, 128, 32)
    got = flash_attention(*_torch(qkv, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jq = [jnp.asarray(a, jnp.bfloat16) for a in qkv]
    for want in (flash_attention_pallas(*jq, tq=64, tk=64, interpret=True),
                 jattention_ref(*jq)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=3e-2, atol=3e-2)


def test_flash_attention_causal_mask_is_top_left():
    """Sq=64 < Skv=128, causal: query i sees keys j <= i, as the Pallas
    kernel masks (JAX ``attention_ref`` masks bottom-right instead)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.flash_attention import (
        flash_attention_pallas)
    rng = np.random.default_rng(3)
    qkv = _qkv(rng, 1, 4, 2, 64, 128, 32)
    got = flash_attention(*_torch(qkv), causal=True).numpy()
    want = flash_attention_pallas(*[jnp.asarray(a) for a in qkv],
                                  causal=True, tq=64, tk=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)
    # row 0 attends to key 0 alone: its output is v[kv head][0]
    np.testing.assert_allclose(got[0, 0, 0], qkv[2][0, 0, 0], rtol=1e-6,
                               atol=1e-6)


def test_flash_attention_ragged_kv_is_finite_and_right():
    """Skv=96, non-causal: keys past Skv are masked, so the output is
    finite and equals JAX ``attention_ref`` (the Pallas kernel with tk=64
    reads its padding and returns NaN)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import (
        attention_ref as jattention_ref)
    rng = np.random.default_rng(5)
    qkv = _qkv(rng, 1, 4, 2, 64, 96, 32)
    got = flash_attention(*_torch(qkv), causal=False).numpy()
    assert np.isfinite(got).all()
    want = jattention_ref(*[jnp.asarray(a) for a in qkv], causal=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype,d,offset,want", [
    (torch.bfloat16, 16, 0, "wgmma"), (torch.bfloat16, 32, 0, "wgmma"),
    (torch.bfloat16, 64, 0, "wgmma"), (torch.bfloat16, 80, 0, "wgmma"),
    (torch.bfloat16, 128, 0, "wgmma"), (torch.bfloat16, 65, 0, "mma"),
    (torch.bfloat16, 128, 8, "wgmma"), (torch.bfloat16, 128, 1, "mma"),
    (torch.bfloat16, 64, 4, "mma"),
    (torch.float32, 16, 0, "mma"), (torch.float32, 65, 0, "mma"),
    (torch.float32, 128, 0, "mma"),
    (torch.bfloat16, 256, 0, "mma"), (torch.float32, 256, 0, "mma"),
    (torch.bfloat16, 257, 0, "split"), (torch.float32, 257, 0, "split"),
    (torch.bfloat16, 1024, 1, "split"), (torch.float32, 1025, 0, "split"),
    (torch.bfloat16, 2048, 0, "split"),
])
def test_flash_attention_variant(dtype, d, offset, want):
    """bf16 rows of a multiple of 16 bytes, D <= 128, at 16-byte aligned
    addresses take ``wgmma``; f32, other bf16 widths (D = 256 too) and a
    bf16 view at an offset of ``offset`` elements into a flat buffer
    (aligned when the offset is 16 bytes) the ``mma.sync`` kernel; every
    D > 256 the ``split`` kernels (a thread-block cluster), aligned or
    not; D < 1 raises."""
    flat = torch.zeros(offset + 4 * d, dtype=dtype)
    view = flat[offset:].view(4, d)
    assert flat.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="D >= 1"):
        _variant(dtype, 0, [flat.data_ptr()])
    assert _variant(dtype, d) == _variant(dtype, d, [flat.data_ptr()])
    assert _variant(dtype, d, [flat.data_ptr(), view.data_ptr()]) == want


def test_flash_attention_cpu_takes_the_plain_version():
    """A CPU call is ``attention_ref`` itself and counts no launch."""
    rng = np.random.default_rng(2)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = _torch(_qkv(rng, 1, 4, 2, 40, 72, 64), dtype)
        before = dict(_build.LAUNCHES)
        got = flash_attention(*qkv, causal=True)
        assert torch.equal(got, attention_ref(*qkv, causal=True))
        assert dict(_build.LAUNCHES) == before


def test_flash_attention_refuses_uneven_groups():
    q, k = torch.zeros((1, 6, 8, 16)), torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, k)


# ---- ssd_chunk ---------------------------------------------------------------


def _ssd_inputs(rng, bs, nc, q, h, p, s):
    """Drawn as tests/test_kernels.py draws them: cum non-increasing
    within a chunk (dA < 0)."""
    return (rng.normal(size=(bs, nc, q, h, p)).astype(np.float32),
            rng.normal(size=(bs, nc, q, s)).astype(np.float32),
            rng.normal(size=(bs, nc, q, s)).astype(np.float32),
            rng.uniform(0.1, 1.0, (bs, nc, q, h)).astype(np.float32),
            -np.cumsum(rng.uniform(0.01, 0.2, (bs, nc, q, h)),
                       axis=2).astype(np.float32))


@pytest.mark.parametrize("bs,nc,q,h,p,s", [
    (1, 2, 16, 2, 8, 16),
    (2, 1, 32, 4, 16, 32),
    (1, 2, 128, 4, 128, 256),   # the kernel's new domain: two P, S tiles
    (1, 2, 40, 6, 24, 40),      # H not a multiple of 4, q off 16
])
def test_ssd_chunk_matches_jax(bs, nc, q, h, p, s):
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jssd_ref
    from repro.kernels.ssd_chunk.ssd_chunk import ssd_chunk_pallas
    rng = np.random.default_rng(q + h)
    args = _ssd_inputs(rng, bs, nc, q, h, p, s)
    y, st = ssd_chunk(*_torch(args))
    assert tuple(y.shape) == (bs, nc, q, h, p)
    assert tuple(st.shape) == (bs, nc, h, p, s)
    jargs = [jnp.asarray(a) for a in args]
    for yw, sw in (ssd_chunk_pallas(*jargs, interpret=True),
                   jssd_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(sw), rtol=2e-4,
                                   atol=2e-4)


def test_ssd_chunk_steep_decay_stays_finite():
    """A steep cum makes cum_i − cum_j large above the diagonal; the plain
    version takes the exponential only where i >= j, so nothing
    overflows into inf · 0."""
    rng = np.random.default_rng(11)
    x, B, C, dt, _ = _ssd_inputs(rng, 1, 1, 16, 2, 8, 16)
    cum = -np.cumsum(np.full((1, 1, 16, 2), 10.0), axis=2).astype(np.float32)
    y, st = ssd_chunk(*_torch((x, B, C, dt, cum)))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


# ---- flash_attention's gradient -------------------------------------------


_BWD_CASES = [(1, 2, 1, 64, 16, True), (2, 8, 2, 96, 64, True),
              (2, 8, 2, 96, 16, False), (1, 4, 4, 64, 64, False)]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", _BWD_CASES)
def test_attention_bwd_ref_matches_autograd_and_jax_vjp(b, hq, hkv, s, d,
                                                        causal):
    """attention_bwd_ref (the formula written out) against torch autograd
    of attention_ref and jax.vjp of the JAX package's attention_ref, within
    1e-5 · max(1, max|ref|), over GQA (8/2), a ragged S = 96 and D in
    {16, 64}; Sq == Skv, where the two packages' causal masks agree."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import (
        attention_ref as jattention_ref)
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    rng = np.random.default_rng(b * hq + s + d)
    qkv = _qkv(rng, b, hq, hkv, s, s, d)
    do = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    q, k, v = _torch(qkv)
    out = attention_ref(q, k, v, causal)
    got = attention_bwd_ref(q, k, v, out, torch.from_numpy(do), causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    autograd = torch.autograd.grad(attention_ref(*leaves, causal), leaves,
                                   torch.from_numpy(do))
    _, vjp = jax.vjp(lambda *a: jattention_ref(*a, causal=causal),
                     *(jnp.asarray(a) for a in qkv))
    for g, a, j in zip(got, autograd, vjp(jnp.asarray(do))):
        for want in (a.numpy(), np.asarray(j)):
            lim = 1e-5 * max(1.0, float(np.abs(want).max()))
            assert float(np.abs(g.numpy() - want).max()) <= lim


def test_attention_bwd_ref_bf16_matches_jax_vjp():
    """bf16 inputs: within 2e-2 · max(1, max|ref|) of jax.vjp on the same
    bf16 inputs, in bf16."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import (
        attention_ref as jattention_ref)
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    rng = np.random.default_rng(11)
    qkv = _qkv(rng, 2, 8, 2, 96, 96, 64)
    do = rng.standard_normal((2, 8, 96, 64)).astype(np.float32)
    q, k, v = _torch(qkv, torch.bfloat16)
    dot = torch.from_numpy(do).to(torch.bfloat16)
    got = attention_bwd_ref(q, k, v, attention_ref(q, k, v), dot)
    _, vjp = jax.vjp(jattention_ref,
                     *(jnp.asarray(a, jnp.bfloat16) for a in qkv))
    for g, j in zip(got, vjp(jnp.asarray(do, jnp.bfloat16))):
        assert g.dtype == torch.bfloat16
        want = np.asarray(j, np.float32)
        lim = 2e-2 * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(g.float().numpy() - want).max()) <= lim


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (1, 4, 1, 96, 96, 16, True),       # GQA 4, ragged S
    (2, 8, 2, 130, 130, 64, True),
    (1, 4, 2, 70, 333, 32, False),     # Sq != Skv, ragged
    (2, 2, 2, 64, 40, 128, False)])
def test_attention_lse_ref_matches_jax_logsumexp(b, hq, hkv, sq, skv, d,
                                                 causal):
    """attention_lse_ref (what the forward kernel stores for the backward,
    base 2) against jax.nn.logsumexp of the JAX package's scaled, masked
    scores (attention_ref's) times log2(e), within 1e-5 · max(1,
    max|ref|); causal at Sq == Skv, where the two packages' masks
    agree."""
    import jax
    import jax.numpy as jnp
    from repro_torch.kernels.flash_attention import attention_lse_ref
    rng = np.random.default_rng(sq + skv + d)
    q, k, _ = _qkv(rng, b, hq, hkv, sq, skv, d)
    kx = jnp.repeat(jnp.asarray(k), hq // hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kx) / (d ** 0.5)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((sq, skv), bool), k=skv - sq), s,
                      -1e30)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)) * np.log2(np.e)
    got = attention_lse_ref(*_torch((q, k)), causal)
    assert got.dtype == torch.float32 and got.shape == (b, hq, sq)
    lim = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= lim


def test_flash_attention_cpu_grads_equal_plain_autograd(monkeypatch):
    """FlashAttentionFn's grads on CPU tensors equal autograd through
    attention_ref (GQA, ragged S); the forward keeps its log-sum-exp only
    when the call records a graph (not under no_grad, not on leaves that
    need none)."""
    rng = np.random.default_rng(9)
    qkv = _torch(_qkv(rng, 2, 6, 2, 50, 50, 32))
    do = torch.from_numpy(rng.normal(size=(2, 6, 50, 32)).astype(np.float32))
    asked = []
    real = flash_ops._forward
    monkeypatch.setattr(flash_ops, "_forward", lambda *a, **kw: (
        asked.append(kw.get("lse", False)) or real(*a, **kw)))
    leaves = [t.clone().requires_grad_() for t in qkv]
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    want = torch.autograd.grad(attention_ref(*leaves), leaves, do)
    for x, y in zip(got, want):
        lim = 1e-5 * max(1.0, y.abs().max().item())
        assert (x - y).abs().max().item() <= lim
    assert asked == [True]
    with torch.no_grad():
        flash_attention(*leaves)
    flash_attention(*qkv)
    assert asked == [True, False, False]
    out, lse = real(*qkv, causal=True, lse=True)
    assert torch.equal(out, attention_ref(*qkv))
    assert torch.equal(lse, attention_lse_ref(*qkv[:2]))


def test_flash_attention_cpu_backward_takes_the_plain_version():
    """On CPU tensors flash_attention_backward is attention_bwd_ref (no
    launch counted), and flash_attention under grad has a grad_fn."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, flash_attention_backward)
    rng = np.random.default_rng(5)
    q, k, v = _torch(_qkv(rng, 1, 4, 2, 40, 40, 16))
    o = attention_ref(q, k, v)
    do = torch.randn_like(o)
    before = dict(_build.LAUNCHES)
    for got, want in zip(flash_attention_backward(q, k, v, o, do),
                         attention_bwd_ref(q, k, v, o, do)):
        assert torch.equal(got, want)
    assert dict(_build.LAUNCHES) == before
    assert flash_attention(q.requires_grad_(), k, v).grad_fn is not None
    assert flash_attention(q.detach(), k, v).grad_fn is None
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_backward(q, k[:, :1].expand(1, 3, 40, 16), v, o, do)


# ---- the wrappers ------------------------------------------------------------


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device never
    reaches a plain-version fallback."""
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        knn(meta(4, 3), meta(8, 3), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(meta(1, 2, 4, 8), meta(1, 1, 4, 8), meta(1, 1, 4, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_chunk(meta(1, 1, 4, 2, 8), meta(1, 1, 4, 8), meta(1, 1, 4, 8),
                  meta(1, 1, 4, 2), meta(1, 1, 4, 2))


class _StubFn:
    """A ctypes function that counts the assignments of its signature."""

    def __init__(self):
        object.__setattr__(self, "sets", [])

    def __setattr__(self, name, value):
        self.sets.append(name)
        object.__setattr__(self, name, value)


class _StubLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _StubFn())


@pytest.mark.parametrize("ops,name,want", [
    (knn_ops, "knn", {
        "knn_forward": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
        "knn_scratch_bytes": [ctypes.c_int] * 3,
        "knn_plan": [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "knn_smem_bytes": [ctypes.c_int] * 3}),
    (ssd_ops, "ssd_chunk", {
        "ssd_chunk_forward": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_void_p],
        "ssd_chunk_plan": [ctypes.c_int] * 5 + [ctypes.c_void_p]}),
    (gather_ops, "gather_mlp", {
        "gather_mlp_forward": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
        + [ctypes.c_void_p],
        "gather_mlp_row_tile": [ctypes.c_int] * 3,
        "gather_mlp_route": [ctypes.c_int] * 5,
        "gather_mlp_rows": [ctypes.c_int] * 8,
        "gather_mlp_smem_bytes": [ctypes.c_int] * 9,
        "gather_mlp_scratch_bytes": [ctypes.c_int] * 8,
        "gather_mlp_wide_plan": [ctypes.c_int] * 8 + [ctypes.c_void_p],
        "gather_mlp_linear_plan": [ctypes.c_int] * 7 + [ctypes.c_void_p],
        "gather_mlp_split_weights": [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]}),
    (reuse_ops, "hub_reuse", {
        "hub_reuse_forward": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
        + [ctypes.c_void_p],
        "hub_reuse_layered": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
        + [ctypes.c_void_p],
        "hub_reuse_smem_bytes": [ctypes.c_int] * 10,
        "hub_reuse_plan": [ctypes.c_int] * 8 + [ctypes.c_void_p],
        "hub_reuse_linear_plan": [ctypes.c_int] * 8 + [ctypes.c_void_p],
        "hub_reuse_split_weights": [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]}),
    (flash_ops, "flash_attention", {
        "flash_attention_forward": [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 9 + [ctypes.c_void_p],
        "flash_attention_layout": [ctypes.c_int] * 3 + [ctypes.c_void_p]}),
])
def test_wrappers_declare_ctypes_signatures_once(monkeypatch, ops, name,
                                                 want):
    """The library's ctypes signatures are set when it loads, once, and
    not again by the calls after (a stub library: no kernel runs here)."""
    stub, opened = _StubLib(), []
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_build_locked", lambda names: 0.0)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: opened.append(path) or stub)
    for _ in range(3):
        assert ops._lib() is stub
    assert len(opened) == 1 and name in opened[0]
    for fn, argtypes in want.items():
        assert stub.fns[fn].sets == ["argtypes", "restype"]
        assert stub.fns[fn].argtypes == argtypes


def test_backward_library_declares_its_ctypes_signature_once(monkeypatch):
    stub, opened = _StubLib(), []
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_build_locked", lambda names: 0.0)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: opened.append(path) or stub)
    for _ in range(3):
        assert flash_ops._lib_bwd() is stub
    assert len(opened) == 1 and "flash_attention_bwd" in opened[0]
    fn = stub.fns["flash_attention_backward"]
    assert fn.sets == ["argtypes", "restype"]
    assert fn.argtypes == [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]


def test_check_operands_takes_dtypes_from_the_caller():
    cpu = torch.device("cpu")
    bf = torch.zeros(2, dtype=torch.bfloat16)
    _build.check_operands("t", {"q": bf}, cpu, {"q": torch.bfloat16})
    with pytest.raises(ValueError, match="dtype"):
        _build.check_operands("t", {"q": bf}, cpu)
    with pytest.raises(ValueError, match="dtype"):
        _build.check_operands("t", {"q": torch.zeros(2)}, cpu,
                              {"q": torch.bfloat16})


# ---- on the card -------------------------------------------------------------

# limits of ‖got − want‖ / ‖want‖ for flash_attention: with randn inputs
# most causal rows average hundreds of keys and are small (~0.03), so a
# max |Δ| of 3e-2 alone would pass a fault in those rows
_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


def _rel_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def _at_offset(t, off):
    """``t`` copied into a flat buffer at an offset of ``off`` elements."""
    flat = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = flat[off:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,k", [
    (130, 1000, 32), (64, 300, 64), (9, 64, 64),
    (512, 900, 96), (512, 900, 300),   # past the parent's k <= 64
    (64, 100, 100),                    # k = N, two warps a center
    (8192, 8192, 20),                  # dgcnn_s: every point a center
    (2560, 4096, 1600),                # lists past shared memory
    (64, 16384, 2000),                 # and with 8 warps a center
    (1, 1, 1),
])
def test_knn_kernel_matches_plain_on_card(s, n, k):
    """Random points: distances within 1e-5, indices exact wherever the
    order is decided (and, at the first three shapes, wherever a distance
    differs from the one before it); integer grid points (exact distances,
    most of them tied): every index and distance equal to the plain
    version's."""
    dev = _cuda()
    g = torch.Generator().manual_seed(s + n + k)
    c = torch.randn((s, 3), generator=g).to(dev)
    p = torch.randn((n, 3), generator=g).to(dev)
    d, i = knn(c, p, k)
    d0, i0 = knn_ref(c, p, min(k + 1, n))
    d_next = (d0[:, k:] if k < n else
              torch.full_like(d0[:, :1], float("inf"))).cpu().numpy()
    d0, i0 = d0[:, :k], i0[:, :k]
    torch.testing.assert_close(d, d0, rtol=1e-5, atol=1e-5)
    decided = torch.from_numpy(_knn_decided(d0.cpu().numpy(), d_next, 1e-5))
    assert bool((i.cpu() == i0.cpu())[decided].all())
    if (s, n, k) in ((130, 1000, 32), (64, 300, 64), (9, 64, 64)):
        unique = (d0[:, 1:] - d0[:, :-1]).abs() > 1e-5
        assert bool((i[:, 1:] == i0[:, 1:])[unique].all())
    c, p = (torch.randint(0, 8, (m, 3), generator=g).float().to(dev)
            for m in (s, n))
    d, i = knn(c, p, k)
    d0, i0 = knn_ref(c, p, k)
    assert torch.equal(d, d0) and torch.equal(i, i0)


@pytest.mark.cuda
def test_flash_attention_kernel_matches_plain_on_card():
    dev = _cuda()
    g = torch.Generator().manual_seed(0)
    for b, hq, hkv, sq, skv, d, causal in ((1, 4, 2, 130, 130, 128, True),
                                           (2, 4, 1, 64, 96, 32, False),
                                           (1, 2, 2, 64, 128, 80, True),
                                           (1, 4, 4, 130, 130, 256, True),
                                           (1, 8, 1, 70, 333, 256, False),
                                           (1, 2, 1, 40, 40, 200, True)):
        for dt, tol in ((torch.float32, 2e-3), (torch.bfloat16, 3e-2)):
            q, k, v = (torch.randn(shape, generator=g).to(dev, dt)
                       for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                     (b, hkv, skv, d)))
            got = flash_attention(q, k, v, causal=causal)
            want = attention_ref(q, k, v, causal=causal)
            assert got.dtype == dt
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            assert _rel_err(got, want) <= _REL_TOL[dt]
    # the mma route in bf16: D % 8 != 0 (ragged non-causal Skv, causal
    # Sq = Skv off the tile, odd D), D = 128 and D = 256 operands that are
    # not 16-byte aligned (views at one element into flat buffers), and
    # D = 256 aligned (GQA group 8, ragged non-causal Skv)
    for b, hq, hkv, sq, skv, d, causal, off in (
            (1, 8, 2, 200, 333, 100, False, 0),
            (2, 4, 4, 130, 130, 36, True, 0),
            (1, 4, 2, 130, 130, 65, True, 0),
            (1, 8, 2, 130, 200, 128, True, 1),
            (1, 4, 4, 130, 130, 256, True, 1),
            (1, 8, 1, 70, 333, 256, False, 0)):
        q, k, v = (_at_offset(torch.randn(shape, generator=g).to(
                       dev, torch.bfloat16), off)
                   for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d)))
        assert (off == 0) == (q.data_ptr() % 16 == 0)
        before = _build.LAUNCHES["flash_attention_mma"]
        got = flash_attention(q, k, v, causal=causal)
        assert _build.LAUNCHES["flash_attention_mma"] == before + 1
        want = attention_ref(q, k, v, causal=causal)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                   atol=3e-2)
        assert _rel_err(got, want) <= _REL_TOL[torch.bfloat16]
    # the bf16 tensor-core route: D padded to 64 or 128, Sq off the 128-row
    # tile, a ragged non-causal Skv, causal Sq != Skv (top-left), GQA
    # groups 1, 2 and 8; two calls bit-equal (no atomics)
    for b, hq, hkv, sq, skv, d, causal in ((1, 2, 2, 130, 130, 32, True),
                                           (2, 4, 2, 333, 333, 64, True),
                                           (1, 8, 1, 320, 1000, 80, False),
                                           (1, 4, 2, 64, 128, 128, True),
                                           (1, 16, 2, 333, 200, 128, True),
                                           (1, 8, 4, 256, 256, 16, False)):
        q, k, v = (torch.randn(shape, generator=g).to(dev, torch.bfloat16)
                   for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d)))
        before = _build.LAUNCHES["flash_attention_wgmma"]
        got = flash_attention(q, k, v, causal=causal)
        assert _build.LAUNCHES["flash_attention_wgmma"] == before + 1
        want = attention_ref(q, k, v, causal=causal)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                   atol=3e-2)
        assert _rel_err(got, want) <= _REL_TOL[torch.bfloat16]
        assert torch.equal(got, flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 2, 16, 2, 8, 16), (2, 3, 64, 6, 64, 128),
    (1, 16, 128, 80, 64, 128),   # Mamba2-2.7B at chunk 128
    (1, 2, 128, 6, 128, 256),    # two P and two S tiles
    (1, 3, 50, 7, 36, 100),      # H not a multiple of 4, ragged tiles
    (1, 2, 1, 3, 5, 7),          # one-row chunks
])
def test_ssd_chunk_kernel_matches_plain_on_card(shape):
    dev = _cuda()
    rng = np.random.default_rng(sum(shape))
    args = [t.to(dev) for t in _torch(_ssd_inputs(rng, *shape))]
    for got, want in zip(ssd_chunk(*args), ssd_chunk_ref(*args)):
        assert bool(torch.isfinite(got).all())
        tol = 2e-4 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
def test_ssd_chunk_kernel_refuses_chunks_past_its_limit():
    """Past the whole route's 128 rows (its limit until the tiled route
    took such chunks), q = 129 (a one-row last tile) launches the tiled
    route once and agrees with the plain version within 2e-4 · max(1,
    max|plain|)."""
    dev = _cuda()
    rng = np.random.default_rng(1)
    args = [t.to(dev) for t in _torch(_ssd_inputs(rng, 1, 1, 129, 2, 8,
                                                  16))]
    before = _build.LAUNCHES["ssd_chunk"]
    got = ssd_chunk(*args)
    assert _build.LAUNCHES["ssd_chunk"] == before + 1
    for g, want in zip(got, ssd_chunk_ref(*args)):
        assert bool(torch.isfinite(g).all())
        tol = 2e-4 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(g, want, rtol=0, atol=tol)


@pytest.mark.cuda
def test_flash_attention_forward_lse_matches_plain_on_card():
    """The forward's log-sum-exp on both routes (wgmma: bf16, D <= 128;
    mma: f32, bf16 at D = 256 and off 16 bytes) against attention_lse_ref
    within 1e-4 · max(1, max|ref|), and a null LSE leaves the output
    bit-equal."""
    dev = _cuda()
    g = torch.Generator().manual_seed(4)
    for b, hq, hkv, sq, skv, d, causal, dt, off, route in (
            (1, 8, 2, 333, 333, 128, True, torch.bfloat16, 0, "wgmma"),
            (2, 4, 4, 130, 200, 64, False, torch.bfloat16, 0, "wgmma"),
            (1, 4, 2, 130, 130, 256, True, torch.float32, 0, "mma"),
            (1, 4, 2, 130, 130, 256, True, torch.bfloat16, 0, "mma"),
            (1, 8, 1, 70, 333, 128, False, torch.bfloat16, 1, "mma"),
            (1, 4, 2, 200, 200, 80, True, torch.float32, 1, "mma")):
        q, k, v = (_at_offset(torch.randn(shape, generator=g).to(dev, dt),
                              off)
                   for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d)))
        before = _build.LAUNCHES[f"flash_attention_{route}"]
        out, lse = flash_ops._forward(q, k, v, causal, lse=True)
        assert _build.LAUNCHES[f"flash_attention_{route}"] == before + 1
        want = attention_lse_ref(q, k, causal)
        assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
        lim = 1e-4 * max(1.0, want.abs().max().item())
        assert (lse - want).abs().max().item() <= lim
        assert torch.equal(out, flash_ops._forward(q, k, v, causal))


# the backward kernel's limits against attention_bwd_ref on the same
# inputs: f32 max|Δ| <= 1e-4 · max(1, max|ref|) per output (3xTF32, sums
# in another order); bf16 ‖Δ‖ / ‖ref‖ <= 2e-2 (P and dS rounded to bf16)
_BWD_SHAPES = (
    (1, 4, 2, 130, 130, 128, True),     # GQA, a ragged last tile
    (2, 4, 1, 64, 96, 32, False),       # Sq != Skv, non-causal
    (1, 2, 2, 64, 128, 80, True),       # causal, Sq != Skv (top-left)
    (1, 4, 4, 130, 130, 256, True),     # D = 256: two column groups
    (1, 8, 1, 70, 333, 256, False),     # group 8, ragged Skv
    (2, 8, 2, 96, 96, 16, True),        # D = 16
    (1, 2, 1, 40, 40, 36, True),        # D % 8 != 0: scalar copies
    (1, 6, 2, 200, 200, 64, False),
    (1, 16, 2, 333, 333, 128, True),    # group 8 (a cluster of 8), ragged
    (1, 8, 2, 130, 130, 256, True),     # group 4 at D = 256
    (1, 8, 2, 200, 333, 64, True),      # GQA, causal, Sq < Skv: keys no
                                        # row sees get zero gradients
    (1, 12, 2, 300, 130, 128, True),    # group 6 (clusters of 6), Sq > Skv
)


def _bwd_route(dtype, d, off) -> str:
    return ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and d <= 128
            and off == 0 else "mma")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _BWD_SHAPES)
def test_flash_attention_backward_kernel_matches_plain_on_card(shape,
                                                               dtype):
    """dq, dk, dv of the kernel, given the forward's log-sum-exp, against
    attention_bwd_ref on the same inputs, at an address off 16 bytes too;
    the route counted per pass; two calls bit-equal, and bit-equal to the
    call that leaves the log-sum-exp to the wrapper."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, flash_attention_backward)
    dev = _cuda()
    b, hq, hkv, sq, skv, d, causal = shape
    g = torch.Generator().manual_seed(sum(shape))
    for off in (0, 1):
        q, k, v = (_at_offset(torch.randn(s, generator=g).to(dev, dtype),
                              off)
                   for s in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d)))
        o, lse = flash_ops._forward(q, k, v, causal, lse=True)
        do = _at_offset(torch.randn(o.shape, generator=g).to(dev, dtype),
                        off)
        route = _bwd_route(dtype, d, off)
        before = dict(_build.LAUNCHES)
        got = flash_attention_backward(q, k, v, o, do, causal, lse=lse)
        after = dict(_build.LAUNCHES)
        assert after["flash_attention_bwd"] == before.get(
            "flash_attention_bwd", 0) + 2
        for kernel in flash_ops.BWD_PASSES:
            name = f"flash_attention_bwd_{kernel}_{route}"
            assert after[name] == before.get(name, 0) + 1
        assert after.get("flash_attention", 0) == before.get(
            "flash_attention", 0)
        want = attention_bwd_ref(q, k, v, o, do, causal)
        for x, y in zip(got, want):
            assert x.dtype == dtype and bool(torch.isfinite(x).all())
            if dtype == torch.float32:
                lim = 1e-4 * max(1.0, y.abs().max().item())
                assert (x - y).abs().max().item() <= lim
            else:
                assert _rel_err(x, y) <= 2e-2
        again = flash_attention_backward(q, k, v, o, do, causal, lse=lse)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        before = _build.LAUNCHES["flash_attention"]
        rebuilt = flash_attention_backward(q, k, v, o, do, causal)
        assert _build.LAUNCHES["flash_attention"] == before + 1
        assert all(torch.equal(x, y) for x, y in zip(got, rebuilt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_grads_go_through_the_backward_kernel(dtype):
    """Autograd through flash_attention on the card launches the forward
    once and the backward's two kernels once each (no second forward for
    the log-sum-exp) and matches autograd through the plain version."""
    dev = _cuda()
    g = torch.Generator().manual_seed(3)
    leaves = [torch.randn(s, generator=g).to(dev, dtype).requires_grad_()
              for s in ((2, 4, 100, 64), (2, 2, 100, 64), (2, 2, 100, 64))]
    do = torch.randn((2, 4, 100, 64), generator=g).to(dev, dtype)
    before = dict(_build.LAUNCHES)
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    after = dict(_build.LAUNCHES)
    assert after["flash_attention"] == before.get("flash_attention", 0) + 1
    assert after["flash_attention_bwd"] == before.get(
        "flash_attention_bwd", 0) + 2
    want = torch.autograd.grad(attention_ref(*leaves), leaves, do)
    for x, y in zip(got, want):
        if dtype == torch.float32:
            assert (x - y).abs().max().item() <= 1e-4 * max(
                1.0, y.abs().max().item())
        else:
            assert _rel_err(x, y) <= 2e-2


@pytest.mark.cuda
def test_ssd_chunk_under_grad_on_card_has_a_grad_fn():
    """ssd_chunk on an input that requires grad on the card launches its
    forward kernel and hands autograd a result wired to its inputs (no
    NoBackwardError, no detached result), as it does under no_grad."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    ssd = [t.to(dev) for t in _torch(_ssd_inputs(rng, 1, 2, 16, 2, 8, 16))]
    ssd[0].requires_grad_()
    before = _build.LAUNCHES["ssd_chunk"]
    y, st = ssd_chunk(*ssd)
    assert _build.LAUNCHES["ssd_chunk"] == before + 1
    assert y.grad_fn is not None and st.grad_fn is not None
    with torch.no_grad():
        y0, st0 = ssd_chunk(*ssd)
    assert torch.equal(y, y0) and torch.equal(st, st0)


@pytest.mark.cuda
def test_kernels_without_a_backward_raise_under_grad_on_card():
    """gather_mlp, hub_reuse and knn refuse an input that requires grad on
    the card (no detached result, no plain fallback)."""
    from repro_torch.kernels import NoBackwardError
    from repro_torch.kernels.gather_mlp import gather_mlp
    from repro_torch.kernels.hub_reuse import hub_reuse
    dev = _cuda()
    pts = torch.randn((64, 3), device=dev, requires_grad=True)
    with pytest.raises(NoBackwardError, match="no knn backward"):
        knn(pts, pts, 4)
    r = lambda *s: torch.randn(s, device=dev)
    w1 = r(8, 16).requires_grad_()
    with pytest.raises(NoBackwardError, match="no gather_mlp backward"):
        gather_mlp(r(2, 4, 8, 8), r(2, 4, 3), w1, r(16), r(16, 8), r(8))
    slot = torch.zeros((2, 2, 4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(NoBackwardError, match="no hub_reuse backward"):
        hub_reuse(r(2, 2, 8, 8), slot, r(2, 2, 4, 8), w1, r(16), r(16, 8),
                  r(8))
