"""The port's optimizers, schedule, token data and gradient codecs
(``repro_torch.{optim,data,dist}``) against the JAX package on the same
numpy trees: ``warmup_cosine``, AdamW (f32 and bf16 state, the decay rule,
side entries kept) and Adafactor within 1e-6, each also converging on a
quadratic as ``tests/test_substrate.py`` asks of JAX's; ``token_batch``
and ``TokenStream`` (resume, host slicing) exactly equal; ``int8`` and
``topk`` compression with error feedback within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "repro.dist", reason="repro.dist (sharding subsystem) not present")

from repro.data import loader as jloader
from repro.data import synthetic as jsyn
from repro.dist import compress as jcompress
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro_torch import tree
from repro_torch.data import loader as ploader
from repro_torch.data import synthetic as psyn
from repro_torch.dist import compress as pcompress
from repro_torch.lm.params import from_numpy
from repro_torch.optim import adafactor as padafactor
from repro_torch.optim import adamw as padamw
from repro_torch.optim import schedules as pschedules

torch.set_num_threads(1)
TOL = 1e-6


def close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    lim = tol * max(1.0, float(np.abs(want).max())) if want.size else tol
    assert err <= lim, f"max|Δ| {err:.3g} > {lim:.3g}"


def trees_close(got, want, tol=TOL):
    got_l, want_l = tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        close(g, w, tol)


def _params(rng, dtype=np.float32):
    """A params tree with matrices (decayed), vectors (not) and a list."""
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"w": r(6, 5), "b": r(5), "layers": [{"k": r(3, 4, 2)},
                                            {"norm": r(7)}]}
    return jax.tree.map(lambda a: a.astype(dtype), p)


def _np_bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


@pytest.mark.parametrize("step", [0, 1, 500, 999, 1000, 1001, 50000,
                                  99999, 100000, 250000])
def test_warmup_cosine_matches_jax(step):
    for kw in ({}, dict(warmup=10, total=100, floor=0.0)):
        close(pschedules.warmup_cosine(step, **kw),
              jschedules.warmup_cosine(step, **kw))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_matches_jax(state_dtype, weight_decay):
    """Three steps from a mid-training state, with an ``"ef"`` entry that
    must come through unchanged; params updated in their own dtype (a bf16
    params tree under f32 state too)."""
    rng = np.random.default_rng(0)
    cfg_kw = dict(state_dtype=state_dtype, weight_decay=weight_decay)
    jcfg, pcfg = jadamw.AdamWConfig(**cfg_kw), padamw.AdamWConfig(**cfg_kw)
    for pdtype in ("float32", "bfloat16"):
        params = _params(rng)
        if pdtype == "bfloat16":
            params = jax.tree.map(_np_bf16, params)
        st = jadamw.init_state(jcfg, params)
        st = {"m": jax.tree.map(lambda a: (0.01 * rng.standard_normal(
                  a.shape)).astype(a.dtype), jax.tree.map(np.asarray,
                                                          st["m"])),
              "v": jax.tree.map(lambda a: (1e-4 * rng.random(a.shape)
                                           + 1e-6).astype(a.dtype),
                                jax.tree.map(np.asarray, st["v"])),
              "step": np.int32(41),
              "ef": {"x": rng.standard_normal(4).astype(np.float32)}}
        jp, jst = params, st
        pp = from_numpy(params, "cpu")
        pst = from_numpy(st, "cpu")
        for i in range(3):
            grads = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                                 .astype(a.dtype), params)
            scale = 0.5 + 0.25 * i
            jp, jst = jadamw.apply_updates(jcfg, jp, grads, jst, scale)
            pp, pst = padamw.apply_updates(
                pcfg, pp, from_numpy(grads, "cpu"), pst, scale)
        for got, want in ((pp, jp), (pst["m"], jst["m"]),
                          (pst["v"], jst["v"])):
            for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
                assert str(g.dtype).endswith(str(w.dtype))
                close(g, w)
        assert int(pst["step"]) == int(jst["step"]) == 44
        close(pst["ef"]["x"], st["ef"]["x"], 0)


def test_adamw_decays_matrices_only():
    """Zero grads, zero state: only leaves of ndim >= 2 move (decay)."""
    cfg = padamw.AdamWConfig(weight_decay=0.5, lr=0.1,
                             state_dtype="float32")
    params = {"w": torch.ones(3, 3), "b": torch.ones(3)}
    st = padamw.init_state(cfg, params)
    padamw.apply_updates(cfg, params, tree.map(torch.zeros_like, params), st)
    assert torch.allclose(params["w"], torch.full((3, 3), 0.95))
    assert torch.equal(params["b"], torch.ones(3))


def test_adamw_converges_quadratic():
    cfg = padamw.AdamWConfig(lr=0.1, weight_decay=0.0,
                             state_dtype="float32")
    params = {"w": torch.tensor([2.0, -3.0])}
    state = padamw.init_state(cfg, params)
    for _ in range(200):
        padamw.apply_updates(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3


def test_adafactor_matches_jax():
    rng = np.random.default_rng(1)
    jcfg, pcfg = jadafactor.AdafactorConfig(), padafactor.AdafactorConfig()
    params = _params(rng)
    jp, jst = params, jadafactor.init_state(jcfg, params)
    pp = from_numpy(params, "cpu")
    pst = padafactor.init_state(pcfg, pp)
    for i in range(4):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                             .astype(a.dtype), params)
        jp, jst = jadafactor.apply_updates(jcfg, jp, grads, jst, 0.9)
        pp, pst = padafactor.apply_updates(
            pcfg, pp, from_numpy(grads, "cpu"), pst, 0.9)
    trees_close(pp, jp)
    trees_close(pst["f"], jst["f"])
    assert int(pst["step"]) == int(jst["step"]) == 4


def test_adafactor_converges_quadratic():
    cfg = padafactor.AdafactorConfig(lr=0.1)
    params = {"w": torch.ones(4, 3) * 2.0}
    state = padafactor.init_state(cfg, params)
    for _ in range(300):
        padafactor.apply_updates(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


@pytest.mark.parametrize("step,seed", [(0, 0), (7, 3), (123456, 2 ** 40)])
def test_token_batch_equals_jax(step, seed):
    a = psyn.token_batch(step, 4, 17, 1000, seed)
    b = jsyn.token_batch(step, 4, 17, 1000, seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_token_stream_resume_and_host_slicing_equal_jax():
    kw = dict(vocab=100, batch=8, seq_len=16, seed=7)
    p, j = ploader.TokenStream(**kw), jloader.TokenStream(**kw)
    batches = [p.next() for _ in range(5)]
    for b in batches:
        assert np.array_equal(b, j.next())
    assert p.state() == j.state() == {"seed": 7, "step": 5}
    rest = {k: v for k, v in kw.items() if k != "seed"}
    p2 = ploader.TokenStream.from_state({"seed": 7, "step": 3}, **rest)
    assert np.array_equal(p2.next(), batches[3])
    assert np.array_equal(p2.next(), batches[4])
    halves = [ploader.TokenStream(host_index=i, host_count=2, **kw).next()
              for i in range(2)]
    assert np.array_equal(np.concatenate(halves), batches[0])
    assert np.array_equal(halves[1], jloader.TokenStream(
        host_index=1, host_count=2, **kw).next())
    with pytest.raises(ValueError, match="split"):
        ploader.TokenStream(host_count=3, **kw)


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_compress_grads_with_error_feedback_matches_jax(codec):
    """Ten rounds of compression with error feedback carried across, on
    grads without ties in magnitude (topk's threshold is then one
    value)."""
    rng = np.random.default_rng(2)
    shapes = {"w": (40, 16), "b": (16,), "l": [(3, 5, 7)]}
    jg = jax.tree.map(lambda s: rng.permutation(np.prod(s)).reshape(s)
                      .astype(np.float32) / 7.0 - 40.0, shapes,
                      is_leaf=lambda s: isinstance(s, tuple))
    jef = jcompress.init_error_feedback(jg)
    pef = pcompress.init_error_feedback(from_numpy(jg, "cpu"))
    for _ in range(10):
        g = jax.tree.map(lambda a: (a * rng.uniform(0.5, 1.5, a.shape))
                         .astype(np.float32), jg)
        jdg, jef = jcompress.compress_grads(g, jef, codec=codec,
                                            topk_frac=0.25)
        pdg, pef = pcompress.compress_grads(from_numpy(g, "cpu"),
                                            pef, codec=codec, topk_frac=0.25)
        trees_close(pdg, jdg)
        trees_close(pef, jef)


def test_make_compressor_carries_ef_in_opt_state():
    comp = pcompress.make_compressor("int8")
    grads = {"w": torch.linspace(-1, 1, 10)}
    with pytest.raises(ValueError, match="ef"):
        comp(grads, {"step": torch.zeros((), dtype=torch.int32)})
    st = {"step": torch.zeros((), dtype=torch.int32),
          "ef": pcompress.init_error_feedback(grads)}
    dg, st2 = comp(grads, st)
    assert set(st2) == {"step", "ef"} and st2["step"] is st["step"]
    assert torch.allclose(dg["w"] + st2["ef"]["w"], grads["w"])


def test_grad_compression_error_feedback_unbiased():
    """tests/test_substrate.py's check on the port: over 50 steps the
    compressed grads average to the true ones."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64,))
                               .astype(np.float32))}
    ef = pcompress.init_error_feedback(g)
    total = torch.zeros(64)
    for _ in range(50):
        dg, ef = pcompress.compress_grads(g, ef)
        total = total + dg["w"]
    assert torch.allclose(total / 50, g["w"], atol=0.02)
