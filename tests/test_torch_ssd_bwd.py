"""The gradient of the port's ``ssd_chunk``: the closed form
``ssd_chunk_bwd_ref`` against ``jax.vjp`` of the JAX package's
``ssd_chunk_ref`` on the same seeded inputs, ``SsdChunkFn`` on CPU tensors
against autograd of the plain forward, and, on a CUDA host, the backward
kernel (``csrc/ssd_chunk_bwd.cu``) against the closed form.

The JAX package is imported inside the tests that compare with it, so
the card tests (``pytest -m cuda tests/test_torch_ssd_bwd.py``) also run
on a host without JAX."""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk import (SsdChunkFn, ssd_chunk,
                                           ssd_chunk_backward,
                                           ssd_chunk_bwd_ref, ssd_chunk_ref)
from repro_torch.kernels.ssd_chunk import ops as ssd_ops

torch.set_num_threads(1)

GRADS = ("dx", "dB", "dC", "ddt", "dcum")
# the closed form against jax.vjp: max|Δ| <= 1e-5 · max(1, max|ref|) per
# output (f32 sums in another order)
REF_TOL = 1e-5
# the kernel against the closed form on the card: 3xTF32 products, sums in
# another order
KERNEL_TOL = 1e-4

# (bs, nc, q, H, P, S): test_torch_kernels.py's ssd_chunk shapes, the
# ragged ones chip_smoke.py's SSD_PARITY holds the forward to (q, P, S off
# every tile, H not a multiple of a head group), and one-row chunks
SHAPES = [(1, 2, 16, 2, 8, 16), (2, 1, 32, 4, 16, 32),
          (1, 2, 128, 4, 128, 256), (1, 2, 40, 6, 24, 40),
          (1, 3, 50, 7, 36, 100), (2, 2, 100, 5, 130, 131),
          (1, 2, 1, 3, 5, 7)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(rng, bs, nc, q, h, p, s, steep=False):
    """x, B, C, dt, cum as tests/test_kernels.py draws them (cum
    non-increasing within a chunk), then dy and dst; ``steep``: cum falls
    by 10 a step, so cum_i − cum_j above the diagonal overflows exp."""
    cum = (-np.cumsum(np.full((bs, nc, q, h), 10.0), axis=2) if steep else
           -np.cumsum(rng.uniform(0.01, 0.2, (bs, nc, q, h)), axis=2))
    arrays = (rng.normal(size=(bs, nc, q, h, p)),
              rng.normal(size=(bs, nc, q, s)),
              rng.normal(size=(bs, nc, q, s)),
              rng.uniform(0.1, 1.0, (bs, nc, q, h)), cum,
              rng.normal(size=(bs, nc, q, h, p)),
              rng.normal(size=(bs, nc, h, p, s)))
    return [a.astype(np.float32) for a in arrays]


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _assert_close(got, want, tol, label=""):
    for name, g, w in zip(GRADS, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        assert bool(torch.isfinite(g).all()), f"{label} {name} non-finite"
        limit = tol * max(1.0, w.abs().max().item())
        err = (g - w).abs().max().item()
        assert err <= limit, f"{label} {name}: max|Δ| {err} > {limit}"


def _jax_ssd_chunk_ref_masked_exp(x, B, C, dt, cum):
    """repro.kernels.ssd_chunk.ref.ssd_chunk_ref with the exponential
    taken only where i >= j.  The JAX oracle differentiates exp above the
    diagonal too: where cum falls steeply it overflows there, and the
    gradient through jnp.where is inf · 0 = NaN in dcum (its other
    gradients stay finite).  The forward is the same function."""
    import jax.numpy as jnp
    q = x.shape[2]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = jnp.tril(jnp.ones((q, q), bool))[None, None, :, :, None]
    L = jnp.where(mask, jnp.exp(jnp.where(mask, seg, 0.0)), 0.0)
    CB = jnp.einsum("bnis,bnjs->bnij", C, B)
    y_in = jnp.einsum("bnij,bnijh,bnjh,bnjhp->bnihp", CB, L, dt, x)
    decay_to_end = jnp.exp(cum[:, :, -1:, :] - cum)
    states = jnp.einsum("bnjs,bnjh,bnjh,bnjhp->bnhps",
                        B, decay_to_end, dt, x)
    return y_in, states


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_chunk_bwd_ref_matches_jax_vjp(shape, steep):
    """The closed form against jax.vjp of the JAX oracle on every output;
    in the steep case the closed form stays finite, and its dcum is held
    against the masked-exponential form's (the oracle's is NaN), taken in
    float64: there the diagonal terms G_ii of dcum's two sums reach ~100
    while dcum stays under 0.05, so float32's own rounding of the oracle
    (~3e-5, which the closed form avoids by leaving G_ii out) would
    exceed the limit."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jssd_ref
    arrays = _inputs(np.random.default_rng(sum(shape)), *shape, steep=steep)
    got = ssd_chunk_bwd_ref(*_torch(arrays))
    cot = (jnp.asarray(arrays[5]), jnp.asarray(arrays[6]))
    jargs = [jnp.asarray(a) for a in arrays[:5]]
    want = [np.asarray(w) for w in jax.vjp(jssd_ref, *jargs)[1](cot)]
    if steep:
        assert shape[2] == 1 or not np.isfinite(want[4]).all()
        masked = jax.vjp(_jax_ssd_chunk_ref_masked_exp, *jargs)[1](cot)
        for w, m in zip(want[:4], masked[:4]):
            np.testing.assert_array_equal(w, np.asarray(m))
        with jax.enable_x64(True):
            wide = [jnp.asarray(a.astype(np.float64)) for a in arrays]
            dcum = jax.vjp(_jax_ssd_chunk_ref_masked_exp, *wide[:5])[1](
                tuple(wide[5:]))[4]
            want[4] = np.asarray(dcum).astype(np.float32)
    _assert_close(got, [torch.from_numpy(w) for w in want], REF_TOL)


@pytest.mark.parametrize("outputs", ["both", "y_in", "states"])
def test_ssd_chunk_fn_cpu_grads_equal_plain_autograd(outputs):
    """SsdChunkFn on CPU tensors (its backward the closed form) against
    autograd through ssd_chunk_ref, with either output alone reaching the
    loss too (autograd hands the backward zeros for the other): atol
    1e-5, but dcum.  dcum is the difference of two sums of
    G's terms that reach ~100 here, so float32 rounds it by ~2e-5 however
    it is summed: it is held against autograd in float64 by the limit the
    JAX comparison uses, 1e-5 · max(1, max|ref|)."""
    arrays = _inputs(np.random.default_rng(5), 2, 2, 24, 3, 16, 20)
    leaves = [t.requires_grad_() for t in _torch(arrays[:5])]
    dy, dst = _torch(arrays[5:])

    def loss(y, st):
        return ((y * dy).sum() * (outputs != "states")
                + (st * dst).sum() * (outputs != "y_in"))
    out = SsdChunkFn.apply(*leaves)
    assert out[0].grad_fn is not None and out[1].grad_fn is not None
    if outputs == "both":
        got = torch.autograd.grad(out, leaves, (dy, dst))
    else:
        got = torch.autograd.grad(out[outputs == "states"], leaves,
                                  dy if outputs == "y_in" else dst)
    want = list(torch.autograd.grad(loss(*ssd_chunk_ref(*leaves)), leaves))
    wide = [t.detach().double().requires_grad_() for t in leaves]
    dy, dst = dy.double(), dst.double()
    want[4] = torch.autograd.grad(loss(*ssd_chunk_ref(*wide)),
                                  wide[4])[0].float()
    for x, y in zip(got[:4], want[:4]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
    limit = REF_TOL * max(1.0, want[4].abs().max().item())
    assert (got[4] - want[4]).abs().max().item() <= limit


def test_ssd_chunk_goes_through_its_autograd_function():
    arrays = _inputs(np.random.default_rng(6), 1, 1, 8, 2, 4, 8)
    x = _torch(arrays[:1])[0].requires_grad_()
    y, st = ssd_chunk(x, *_torch(arrays[1:5]))
    assert type(y.grad_fn).__name__ == "SsdChunkFnBackward"
    assert torch.equal(y, ssd_chunk_ref(x, *_torch(arrays[1:5]))[0])


def test_ssd_chunk_backward_cpu_takes_the_plain_version():
    arrays = _torch(_inputs(np.random.default_rng(7), 1, 2, 16, 2, 8, 16))
    for got, want in zip(ssd_chunk_backward(*arrays),
                         ssd_chunk_bwd_ref(*arrays)):
        assert torch.equal(got, want)


def test_ssd_chunk_backward_refuses_other_devices_and_shapes():
    meta = [t.to("meta") for t in _torch(_inputs(
        np.random.default_rng(8), 1, 1, 4, 2, 8, 8))]
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_chunk_backward(*meta)
    with pytest.raises(ValueError, match="dst has shape"):
        ssd_ops._check_shapes("ssd_chunk_backward", meta[0], meta[1],
                              {"dst": meta[6][..., :4]})
    # a chunk past the whole route's 128 rows takes the tiled route
    long = torch.empty((1, 1, 129, 2, 8), device="meta")
    assert ssd_ops._check_shapes(
        "ssd_chunk_backward", long,
        torch.empty((1, 1, 129, 8), device="meta"), {}) == (1, 1, 129, 2,
                                                            8, 8)
    assert ssd_ops.route(128) == "whole" and ssd_ops.route(129) == "tiled"
    empty = torch.empty((1, 1, 0, 2, 8), device="meta")
    with pytest.raises(ValueError, match="q > 0"):
        ssd_ops._check_shapes("ssd_chunk_backward", empty,
                              torch.empty((1, 1, 0, 8), device="meta"), {})


class _StubFn:
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


def test_backward_library_declares_its_ctypes_signatures_once(monkeypatch):
    """Set when the library loads, once, and not again by the calls after
    (a stub library: no kernel runs here)."""
    stub, opened = _StubLib(), []
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_build_locked", lambda names: 0.0)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: opened.append(path) or stub)
    for _ in range(3):
        assert ssd_ops._lib_bwd() is stub
    assert len(opened) == 1 and "ssd_chunk_bwd" in opened[0]
    fn = stub.fns["ssd_chunk_backward"]
    assert fn.sets == ["argtypes", "restype"]
    assert fn.argtypes == [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    scratch = stub.fns["ssd_chunk_backward_scratch"]
    assert scratch.argtypes == [ctypes.c_int] * 5
    assert scratch.restype is ctypes.c_longlong
    plan = stub.fns["ssd_chunk_backward_plan"]
    assert plan.sets == ["argtypes", "restype"]
    assert plan.argtypes == [ctypes.c_int] * 5 + [ctypes.c_void_p]
    assert plan.restype is ctypes.c_int


def test_backward_is_a_registered_kernel():
    from repro_torch import kernels
    assert "ssd_chunk_bwd" in kernels.NAMES
    assert len(ssd_ops.SSD_BWD_PASSES) == 2


# ---- on the card ---------------------------------------------------------------


def _off16(t):
    """t's values in a contiguous view at a storage offset of one float:
    off 16 bytes, so the kernel takes its 4-byte copies."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return view.view(t.shape).copy_(t)


# (shape, operands off 16 bytes)
CARD_CASES = [(shape, False) for shape in SHAPES + [
    (1, 4, 64, 80, 64, 128),    # Mamba2-2.7B's layer, 4 of its chunks
    (2, 2, 128, 12, 64, 128),   # chunk 128
    (1, 1, 33, 3, 65, 65),      # P and S one past a tile
    (2, 2, 64, 80, 64, 128),    # the trainer's microbatch: 40 heads a group
    (1, 2, 128, 4, 64, 256),    # chunk 128, S = 256: B cannot stay whole
    (1, 2, 128, 4, 64, 250)]    # ... and its last S tile ragged
] + [((1, 2, 64, 6, 64, 128), True), ((1, 1, 33, 3, 65, 65), True),
     ((1, 2, 128, 4, 64, 256), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("shape, off16", CARD_CASES)
def test_ssd_chunk_backward_kernel_matches_plain_on_card(shape, off16,
                                                          steep):
    dev = _cuda()
    args = _torch(_inputs(np.random.default_rng(sum(shape)), *shape,
                          steep=steep), dev)
    if off16:
        args = [_off16(a) for a in args]
        assert all(a.data_ptr() % 16 for a in args)
    before = _build.LAUNCHES["ssd_chunk_bwd"]
    got = ssd_chunk_backward(*args)
    assert _build.LAUNCHES["ssd_chunk_bwd"] == before + len(
        ssd_ops.SSD_BWD_PASSES)
    _assert_close(got, ssd_chunk_bwd_ref(*args), KERNEL_TOL, str(shape))
    again = ssd_chunk_backward(*args)
    for name, a, b in zip(GRADS, got, again):
        assert torch.equal(a, b), f"{name}: two calls differ"


@pytest.mark.cuda
def test_ssd_chunk_grads_go_through_the_backward_kernel():
    """Autograd through ssd_chunk on the card launches the backward's two
    kernels once and matches autograd through the plain version."""
    dev = _cuda()
    arrays = _inputs(np.random.default_rng(9), 2, 3, 64, 6, 64, 128)
    leaves = [t.requires_grad_() for t in _torch(arrays[:5], dev)]
    dy, dst = _torch(arrays[5:], dev)
    before = dict(_build.LAUNCHES)
    out = ssd_chunk(*leaves)
    assert out[0].grad_fn is not None
    got = torch.autograd.grad(out, leaves, (dy, dst))
    assert _build.LAUNCHES["ssd_chunk_bwd"] == before.get(
        "ssd_chunk_bwd", 0) + len(ssd_ops.SSD_BWD_PASSES)
    assert _build.LAUNCHES["ssd_chunk"] == before.get("ssd_chunk", 0) + 1
    want = torch.autograd.grad(ssd_chunk_ref(*leaves), leaves, (dy, dst))
    _assert_close(got, want, KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("q, state_term_on_chip", [(64, True), (128, False)])
def test_backward_plan_at_mamba2_widths(q, state_term_on_chip):
    """Mamba2-2.7B's layer (H = 80, P = 64, S = 128): one 16-warp block an
    SM, a grid of at most one wave, B resident; at chunk 64 dB's state
    term stays in shared memory too, at chunk 128 C.B^T leaves no room."""
    _cuda()
    plan = ssd_ops.backward_plan(1, 2048 // q, q, 80, 64, 128)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert plan["warps"] == 16 and plan["blocks_an_sm"] == 1
    assert plan["groups"] * plan["heads_a_group"] >= 80
    assert (2048 // q) * plan["groups"] <= sms
    assert plan["b_resident"] == 1
    assert plan["state_term_on_chip"] == int(state_term_on_chip)
