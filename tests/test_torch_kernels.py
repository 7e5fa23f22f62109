"""The port's entry-point kernels against the JAX package: ``knn``,
``flash_attention`` and ``ssd_chunk`` on CPU tensors (their plain versions)
against the Pallas kernels in interpret mode and the JAX oracles, the edge
cases where the port departs from the Pallas kernels, and, on a CUDA host,
each kernel against its plain version.

The JAX package is imported inside the tests that compare with it, so
the card tests (``pytest -m cuda tests/test_torch_kernels.py``) also run
on a host without JAX."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention.ops import _variant
from repro_torch.kernels.knn import knn, knn_ref
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref

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
    (torch.bfloat16, 257, 0, ValueError), (torch.float32, 257, 0, ValueError),
])
def test_flash_attention_variant(dtype, d, offset, want):
    """bf16 rows of a multiple of 16 bytes, D <= 128, at 16-byte aligned
    addresses take ``wgmma``; f32, other bf16 widths (D = 256 too) and a
    bf16 view at an offset of ``offset`` elements into a flat buffer
    (aligned when the offset is 16 bytes) the ``mma.sync`` kernel; D > 256
    raises, with no fallback."""
    flat = torch.zeros(offset + 4 * d, dtype=dtype)
    view = flat[offset:].view(4, d)
    assert flat.data_ptr() % 16 == 0
    if want is ValueError:
        for ptrs in ((), [flat.data_ptr()]):
            with pytest.raises(ValueError, match="D <= 256"):
                _variant(dtype, d, ptrs)
        return
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
def test_knn_kernel_matches_plain_on_card():
    dev = _cuda()
    g = torch.Generator().manual_seed(0)
    for s, n, k in ((130, 1000, 32), (64, 300, 64), (9, 64, 64)):
        c = torch.randn((s, 3), generator=g).to(dev)
        p = torch.randn((n, 3), generator=g).to(dev)
        d, i = knn(c, p, k)
        d0, i0 = knn_ref(c, p, k)
        torch.testing.assert_close(d, d0, rtol=1e-5, atol=1e-5)
        unique = (d0[:, 1:] - d0[:, :-1]).abs() > 1e-5
        assert bool((i[:, 1:] == i0[:, 1:])[unique].all())


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
def test_ssd_chunk_kernel_matches_plain_on_card():
    dev = _cuda()
    rng = np.random.default_rng(0)
    for shape in ((1, 2, 16, 2, 8, 16), (2, 3, 64, 6, 64, 128)):
        args = [t.to(dev) for t in _torch(_ssd_inputs(rng, *shape))]
        for got, want in zip(ssd_chunk(*args), ssd_chunk_ref(*args)):
            tol = 2e-4 * max(1.0, want.abs().max().item())
            torch.testing.assert_close(got, want, rtol=0, atol=tol)
