"""The shapes past the earlier routes' limits, which the port's kernels now
take as the JAX package's Pallas kernels do: hub_reuse past one resident
launch (the ``layered`` route: past 128 cache rows, or where they pass a
block's shared memory), ssd_chunk forward and backward at chunks over 128 rows (the
``tiled`` route; Mamba-2's published chunk is 256) and flash_attention
forward and backward at heads over 256 wide (the ``split`` route).

On the CPU the wrappers run their plain versions: those are held against
the JAX package at the new shapes (1e-4 against Pallas in interpret mode,
1e-5 against eager JAX, each times max(1, max|ref|)), the reduced
mamba2-2.7b at ``ssd_chunk=256`` against JAX's (logits and grads 1e-4),
and every published ``MODEL_ZOO`` spec's hub_reuse calls at
``cache_capacity_x`` 1, 2 and 4 have a plan that fits, which the
analysis's K rules pass.  The ``cuda``-marked tests run each new route
against its plain version on the card.

The JAX package is imported inside the tests that compare with it, so
the card tests (``pytest -m cuda tests/test_torch_kernel_domain.py``)
also run on a host without JAX."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.kernels import check_kernel_site, site_from_capture
from repro_torch.kernels import _build, plans, tiling
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
from repro_torch.kernels.hub_reuse import ops as hub_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_bwd_ref, ssd_chunk_ref

torch.set_num_threads(1)

PALLAS_TOL = 1e-4      # against a Pallas kernel in interpret mode
EAGER_TOL = 1e-5       # against eager JAX (f32 sums in another order)
LM_TOL = 1e-4          # the reduced mamba2-2.7b's logits and grads
CARD_TOL = 1e-4        # a kernel route against its plain version, f32
CACHE_X = (1.0, 2.0, 4.0)

# (H, C, M, K, D, Hd, F): D = 387 at C = 128 (pointvector_l's block 4
# under the paper's Fig. 22 cache size, cut in H, M, Hd and F) and D =
# 700, both past a 128-row resident block: the layered route
HUB_SHAPES = [(2, 128, 16, 8, 387, 32, 32), (2, 128, 16, 8, 700, 32, 32)]
SSD_QS = (129, 256, 512)
FLASH_DS = (257, 320, 512)


def _close(got, want, tol, label=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, label
    err = float(np.abs(got - want).max()) if got.size else 0.0
    lim = tol * max(1.0, float(np.abs(want).max()))
    assert err <= lim, f"{label}: max|Δ| {err:.3g} > {lim:.3g}"


def _hub_arrays(rng, h, c, m, k, d, hd, f):
    slot = rng.integers(-1, c, (h, m, k)).astype(np.int32)
    slot[:, ::5] = -1                            # subsets with no slot
    return (rng.normal(size=(h, c, d)).astype(np.float32), slot,
            rng.normal(size=(h, m, f)).astype(np.float32),
            (rng.normal(size=(d, hd)) * (2 / d) ** .5).astype(np.float32),
            (0.1 * rng.normal(size=hd)).astype(np.float32),
            (rng.normal(size=(hd, f)) * (2 / hd) ** .5).astype(np.float32),
            (0.1 * rng.normal(size=f)).astype(np.float32),
            (rng.random((h, m, k)) < 0.9).astype(np.int32))


def _ssd_arrays(rng, bs, nc, q, h, p, s):
    """x, B, C, dt, cum (cum non-increasing within a chunk), dy, dst."""
    arrays = (rng.normal(size=(bs, nc, q, h, p)),
              rng.normal(size=(bs, nc, q, s)),
              rng.normal(size=(bs, nc, q, s)),
              rng.uniform(0.1, 1.0, (bs, nc, q, h)),
              -np.cumsum(rng.uniform(0.01, 0.2, (bs, nc, q, h)), axis=2),
              rng.normal(size=(bs, nc, q, h, p)),
              rng.normal(size=(bs, nc, h, p, s)))
    return [a.astype(np.float32) for a in arrays]


def _qkv(rng, b, hq, hkv, s, d):
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, hq, s, d))]


def _t(arrays, device="cpu"):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


# ---- hub_reuse --------------------------------------------------------------

@pytest.mark.parametrize("shape", HUB_SHAPES)
def test_hub_reuse_ref_matches_pallas_past_shared_memory(shape):
    """The plain version against hub_reuse_pallas (interpret mode) at
    widths whose 128-row resident launch passes a block's shared memory
    (the layered route, no chunk); the plan is resolved before the
    CPU/CUDA split, so the route shows here."""
    import jax.numpy as jnp
    from repro.kernels.hub_reuse.hub_reuse import hub_reuse_pallas
    h, c, m, k, d, hd, f = shape
    arrays = _hub_arrays(np.random.default_rng(d), *shape)
    pool, slot, comp, w1, b1, w2, b2, live = _t(arrays)
    with plans.capture() as cap:
        got = hub_reuse(pool, slot, comp, w1, b1, w2, b2, live=live != 0)
    (rec,) = cap
    route = tiling.hub_reuse_route(1, h, c, m, k, d, f, tiling.H100_SMS)
    assert rec["plan"]["route"] == route == "layered"
    assert rec["plan"]["chunk"] is None
    want = hub_reuse_pallas(*[jnp.asarray(a) for a in arrays[:7]],
                            interpret=True, live=jnp.asarray(arrays[7]))
    _close(got.numpy(), want, PALLAS_TOL, f"hub_reuse D={d}")
    _close(hub_reuse_ref(pool, slot, comp, w1, b1, w2, b2,
                         live=live).numpy(), want, PALLAS_TOL)


def test_hub_reuse_plans_fall_to_64_rows_then_stream():
    """One resident launch wherever it covers the call (C <= 128 rows
    that fit a block: chunk 128); past 128 rows, resident in 128-row
    chunks where their grid B·H·ceil(F/64) covers 3/4 of the SMs; the
    layered route for every other call (128 rows of pointnext_s's and
    pointvector_l's block 4 at C = 128, C past 128 on a small grid, a D
    or a slot table too large for 64 rows), whose shared memory is
    fixed; the chunk knob acts on the resident route only; the layered
    plan's H splits follow the SM count; the autotuner offers no chunk on
    the layered route."""
    sms = tiling.H100_SMS
    assert tiling.hub_reuse_chunk(128, 64, 64, 128) == 128
    assert tiling.hub_reuse_chunk(64, 64, 32, 64) == 128
    assert tiling.hub_reuse_chunk(128, 64, 32, 387) == 64
    assert tiling.hub_reuse_route(8, 4, 128, 64, 64, 128, 256,
                                  sms) == "resident"
    # C = 256 at PointNet++(c)'s block 2: 8 clouds x 4 islands x 4
    # feature tiles = 128 blocks >= 99 take two 128-row launches, 4
    # clouds (64 blocks) the layered route; a card of 200 SMs needs 150
    assert tiling.hub_reuse_route(8, 4, 256, 64, 64, 128, 256,
                                  sms) == "resident"
    assert tiling.hub_reuse_route(4, 4, 256, 64, 64, 128, 256,
                                  sms) == "layered"
    assert tiling.hub_reuse_route(8, 4, 256, 64, 64, 128, 256,
                                  200) == "layered"
    for c, m, k, d in ((128, 64, 32, 259), (128, 64, 32, 387),
                       (128, 64, 32, 600), (64, 500, 64, 6),
                       (129, 4, 4, 4), (256, 64, 32, 387)):
        # (at C <= 128 whatever the grid)
        assert c > 128 or tiling.hub_reuse_route(
            64, 16, c, m, k, d, 512, sms) == "layered"
        assert tiling.hub_reuse_route(2, 1, c, m, k, d, 512,
                                      sms) == "layered", (c, d)
    assert tiling.LAYERED_SMEM <= tiling.MAX_SMEM
    dims = dict(b=2, hn=1, c=128, m=64, k=32, d=387, h=1536, f=768)
    for chunk in tiling.CHUNKS:
        assert "resident route" in tiling.infeasible("hub_reuse", dims,
                                                     {"chunk": chunk})
    assert tiling.infeasible("hub_reuse", dims, {}) is None
    with pytest.raises(ValueError, match="resident route"):
        hub_ops.plan(*dims.values(), "cpu", chunk=64)
    pl = hub_ops.plan(*dims.values(), "cpu")
    assert (pl["route"], pl["chunk"]) == ("layered", None)
    # layer 2's H split: ceil(SMs / tiles) where its tiles are fewer
    lp = tiling.hub_reuse_layered_plan(2, 1, 128, 1536, 768, 132)
    assert (lp["layer1"], lp["layer2"], lp["kper"]) == ((4, 24, 1),
                                                        (4, 12, 3), 512)
    assert lp["scratch"] == 256 * 1536 + 3 * 256 * 768
    assert tiling.hub_reuse_layered_plan(2, 4, 128, 1024, 512,
                                         132)["nsplit"] == 2
    assert tiling.hub_reuse_layered_plan(8, 4, 256, 128, 256,
                                         132)["nsplit"] == 1
    assert tiling.hub_reuse_layered_plan(2, 1, 128, 1536, 768,
                                         16)["nsplit"] == 1
    # the autotuner offers a chunk only where it acts
    from repro_torch.launch.autotune import candidate_plans
    per_cloud = {"variant": "per_cloud"}
    assert candidate_plans("hub_reuse", dims, sms=132) == [{}, per_cloud]
    assert candidate_plans("hub_reuse", dict(dims, d=128, h=128, f=256),
                           sms=132) == [{"chunk": 128}, {"chunk": 64},
                                        per_cloud]


@pytest.fixture(scope="module")
def zoo_hub_calls():
    """Every published spec's hub_reuse calls at each CACHE_X, captured
    from one lpcn forward of a 1024-point cloud (B = 1; the calls' widths
    do not depend on N)."""
    from repro_torch.data.synthetic import make_cloud
    from repro_torch.engine import Batch, PCNEngine
    from repro_torch.models import MODEL_ZOO
    rng = np.random.default_rng(0)
    calls = {}
    for name, (_, spec) in MODEL_ZOO.items():
        cloud = make_cloud(rng, 1024, scene_like=spec.task == "seg")
        feats = (None if spec.in_feats <= 3 else [np.concatenate(
            [cloud, rng.uniform(0, 1, (1024, spec.in_feats - 3))
             .astype(np.float32)], -1)])
        batch = Batch.from_clouds([cloud], feats=feats, n_pad=1024,
                                  device="cpu")
        for x in CACHE_X:
            eng = PCNEngine(spec, mode="lpcn", fc_backend="cuda",
                            isl_kw={"cache_capacity_x": x}, device="cpu")
            with plans.capture() as cap, torch.no_grad():
                eng.apply(eng.init(seed=0), batch)
            calls[name, x] = [r for r in cap if r["kernel"] == "hub_reuse"]
    return calls


@pytest.mark.parametrize("x", CACHE_X)
def test_every_zoo_hub_call_has_a_plan_the_k_rules_pass(zoo_hub_calls, x):
    """At cache_capacity_x 1, 2 and 4, every hub_reuse call of every
    published spec: C = x·k, the heuristic plan fits (``tiling.infeasible``
    None) and its launch site has no K001–K005 finding; block 4 of
    pointvector_l at x = 4 takes the layered route, and pointnext_s's
    (D = 259, one layer: no h tile) fits a resident block."""
    from repro_torch.models import MODEL_ZOO
    for name in MODEL_ZOO:
        recs = zoo_hub_calls[name, x]
        assert recs, name
        for i, rec in enumerate(recs):
            dims, plan = rec["dims"], rec["plan"]
            assert dims["c"] == int(x * dims["k"]), (name, dims)
            assert tiling.infeasible("hub_reuse", dims, {}) is None
            assert plan["chunk"] == (tiling.hub_reuse_chunk(
                dims["c"], dims["m"], dims["k"], dims["d"], dims["h"])
                if plan["route"] == "resident" else None)
            site = site_from_capture(rec, f"{name}:{x}:{i}", sms=132)
            assert check_kernel_site(site) == [], (name, x, dims)
    if x == 4.0:
        assert zoo_hub_calls["pointvector_l", x][-1]["plan"]["route"] \
            == "layered"
        assert zoo_hub_calls["pointnext_s", x][-1]["plan"]["route"] \
            == "resident"


def _resident_bytes(rows, m, k, d, h):
    """hub_reuse.cu's resident block worked by hand: the slot table (K to
    4), its liveness bytes (to 16), x at a row stride of D to 8 then to 8
    mod 32 (at least the 72 of y), h (none in one layer, h = 0), and three
    64 x 68 ring stages."""
    k4 = -(-k // 4) * 4
    dp = -(-d // 8) * 8
    xd = max(dp + (8 - dp) % 32, 72)
    return 4 * (m * k4 + -(-m * k // 16) * 4 + rows * xd
                + (rows * 72 if h else 0) + 3 * 64 * 68)


@pytest.mark.parametrize("x", CACHE_X)
def test_zoo_hub_routes_follow_the_rule(zoo_hub_calls, x):
    """Every published spec's hub_reuse call at cache_capacity_x 1, 2 and
    4 (one cloud): the wrapper's plan, tiling.py's route and the
    analysis's site name one route, the one the kernel's rule gives
    worked by hand (resident where C <= 128 and a block of min(C, 128)
    rows padded to 64 or 128, in the call's form, fits 227 KB, or where
    C > 128, 128 rows fit and B·H·ceil(F/64) >= 3/4 of 132 SMs; else
    layered); a resident call is one launch a 128 rows
    (``hub_reuse_launches``), a layered one a plan whose splits cover H
    (two layers) or D (one)."""
    layered = []
    for name, recs in ((n, zoo_hub_calls[n, y]) for n, y in zoo_hub_calls
                       if y == x):
        for rec in recs:
            d = rec["dims"]
            c, m, k, dd, h = d["c"], d["m"], d["k"], d["d"], d["h"]
            fits = _resident_bytes(64 if c <= 64 else 128, m, k,
                                   dd, h) <= 232448
            grid = d["b"] * d["hn"] * -(-d["f"] // 64)
            fits = fits and (c <= 128 or 4 * grid >= 3 * 132)
            want = "resident" if fits else "layered"
            site = site_from_capture(rec, f"{name}:{x}", sms=132)
            assert (rec["plan"]["route"], tiling.hub_reuse_route(
                d["b"], d["hn"], c, m, k, dd, d["f"], 132, h=h),
                site.launch["route"]) == (want,) * 3, (name, d)
            if fits:
                assert tiling.hub_reuse_launches(c, rec["plan"]["chunk"]) \
                    == site.launch["launches"] == [128] * (c // 128) + (
                        [c % 128] if c % 128 else [])
            else:
                layered.append(name)
                lp = tiling.hub_reuse_layered_plan(d["b"], d["hn"], c, h,
                                                   d["f"], 132, dd)
                depth = h or dd
                assert (lp["nsplit"] - 1) * lp["kper"] < depth <= \
                    lp["nsplit"] * lp["kper"]
                assert site.launch["nsplit"] == lp["nsplit"]
    # at x = 4: block 2 of the PointNet++ specs (C = 256) and block 4 of
    # pointvector_l (128 rows of D = 387, one layer); pointnext_s's block
    # 4 (D = 259) fits a one-layer resident block
    assert sorted(set(layered)) == ([] if x < 4 else [
        "pointnet2_c", "pointnet2_ps", "pointvector_l"])


# ---- ssd_chunk --------------------------------------------------------------

@pytest.mark.parametrize("q", SSD_QS)
def test_ssd_chunk_ref_matches_pallas_past_128_rows(q):
    """ssd_chunk_ref against ssd_chunk_pallas (interpret mode) at chunks
    of 129, 256 and 512 rows; the plan names the tiled route."""
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk.ssd_chunk import ssd_chunk_pallas
    arrays = _ssd_arrays(np.random.default_rng(q), 1, 1, q, 2, 8, 16)
    with plans.capture() as cap:
        got = ssd_ops._forward(*_t(arrays[:5]))
    assert cap[0]["plan"]["route"] == ssd_ops.route(q) == "tiled"
    want = ssd_chunk_pallas(*[jnp.asarray(a) for a in arrays[:5]],
                            interpret=True)
    for part, g, w in zip(("y_in", "states"), got, want):
        _close(g.numpy(), w, PALLAS_TOL, f"q={q} {part}")
    for g, w in zip(ssd_chunk_ref(*_t(arrays[:5])), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("q", SSD_QS)
def test_ssd_chunk_bwd_ref_matches_jax_vjp_past_128_rows(q):
    """ssd_chunk_bwd_ref against jax.vjp of the JAX package's
    ssd_chunk_ref at chunks of 129, 256 and 512 rows, every output."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jssd_ref
    arrays = _ssd_arrays(np.random.default_rng(q + 1), 1, 1, q, 2, 8, 16)
    got = ssd_chunk_bwd_ref(*_t(arrays))
    cot = (jnp.asarray(arrays[5]), jnp.asarray(arrays[6]))
    want = jax.vjp(jssd_ref, *[jnp.asarray(a) for a in arrays[:5]])[1](cot)
    for part, g, w in zip(("dx", "dB", "dC", "ddt", "dcum"), got, want):
        _close(g.numpy(), w, EAGER_TOL, f"q={q} {part}")


@pytest.fixture(scope="module")
def mamba2_c256():
    """The reduced mamba2-2.7b at ``ssd_chunk=256`` in float32, JAX's
    params and two token batches (S = 512: two chunks of 256; S = 200:
    one chunk of 200), as numpy."""
    import jax
    from repro.configs import get_config
    from repro.lm import model_zoo as jzoo
    cfg = dataclasses.replace(get_config("mamba2-2.7b", reduced=True),
                              dtype="float32", ssd_chunk=256)
    params = jax.tree.map(np.asarray, jzoo.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    batches = {s: rng.integers(0, cfg.vocab, (1, s + 1)).astype(np.int32)
               for s in (512, 200)}
    return cfg, params, batches


class _ExpBelowOverflow:
    """jax.numpy with ``exp``'s argument clamped at 80.  The JAX package's
    SSD (``repro/nn/ssm.py``) takes exp(cum_i - cum_j) above the diagonal
    too and masks it after: over a chunk of 256 rows cum_i - cum_j there
    passes 88, exp overflows to inf, and its gradient through the mask is
    inf · 0 = NaN in every leaf upstream of the first SSD layer.  Every
    exponential the forward keeps has an argument <= 0, so the clamp
    changes no forward value; it makes the masked entries' gradient 0, as
    the port's kernels (which take exp only where i >= j) and the masked
    oracle of tests/test_torch_ssd_bwd.py do."""

    def __getattr__(self, name):
        import jax.numpy as jnp
        return getattr(jnp, name)

    @staticmethod
    def exp(x):
        import jax.numpy as jnp
        return jnp.exp(jnp.minimum(x, 80.0))


@pytest.mark.parametrize("s", (512, 200))
def test_mamba2_at_chunk_256_matches_jax(mamba2_c256, s, monkeypatch):
    """Logits and every leaf's gradient of the reduced mamba2-2.7b at
    ssd_chunk = 256 against JAX's, the gradient with the JAX SSD's
    exponentials held below overflow (``_ExpBelowOverflow``; as it is,
    JAX's gradient is NaN at this chunk); the prefill's ssd_chunk calls
    take the tiled route."""
    import jax
    import jax.numpy as jnp
    import repro.nn.ssm
    from repro.lm import model_zoo as jzoo
    from repro.lm import transformer as jtfm
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.lm import transformer as ptfm
    from repro_torch.lm.params import from_numpy
    from repro_torch.lm.steps import loss_and_grads
    jcfg, params, batches = mamba2_c256
    pcfg = dataclasses.replace(get_config("mamba2-2.7b", reduced=True),
                               dtype="float32", ssd_chunk=256)
    toks = batches[s]
    pparams = from_numpy(params, "cpu")
    with plans.capture() as cap:
        logits, _ = ptfm.forward(pcfg, pparams,
                                 tokens=torch.from_numpy(toks[:, :-1]))
    routes = {r["plan"]["route"] for r in cap if r["kernel"] == "ssd_chunk"}
    assert routes == {"tiled"}
    want, _ = jtfm.forward(jcfg, params, tokens=jnp.asarray(toks[:, :-1]))
    _close(logits.detach().numpy(), want, LM_TOL, "logits")
    batch = {"tokens": toks}
    monkeypatch.setattr(repro.nn.ssm, "jnp", _ExpBelowOverflow())
    jg = jax.grad(lambda p, b: jzoo.loss_fn(jcfg, p, b)[0])(params, batch)
    got = loss_and_grads(pcfg, pparams,
                         {"tokens": torch.from_numpy(toks)})[2]
    paths = tree.paths(pparams)
    for path, g, w in zip(paths, got, jax.tree.leaves(jg)):
        _close(g.numpy(), w, LM_TOL, path)


# ---- flash_attention --------------------------------------------------------

@pytest.mark.parametrize("d", FLASH_DS)
def test_attention_ref_matches_pallas_past_256_wide(d):
    """attention_ref against flash_attention_pallas (interpret mode) at
    head widths 257, 320 and 512 (GQA, causal), and its gradient
    (attention_bwd_ref) against jax.vjp of the JAX package's
    attention_ref; the route is ``split``, in f32 and bf16."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention.flash_attention import (
        flash_attention_pallas)
    from repro.kernels.flash_attention.ref import (
        attention_ref as jattention_ref)
    q, k, v, do = _qkv(np.random.default_rng(d), 1, 2, 1, 128, d)
    for dt in (torch.float32, torch.bfloat16):
        assert flash_ops._variant(dt, d) == "split"
    with plans.capture() as cap:
        out = flash_ops._forward(*_t((q, k, v)), causal=True)
    assert cap[0]["plan"]["route"] == "split"
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, causal=True, tq=64, tk=64,
                                  interpret=True)
    _close(out.numpy(), want, PALLAS_TOL, f"D={d} forward")
    got = attention_bwd_ref(*_t((q, k, v)), out, torch.from_numpy(do),
                            causal=True)
    _, pull = jax.vjp(lambda a, b, c: jattention_ref(a, b, c, causal=True),
                      jq, jk, jv)
    for part, g, w in zip(("dq", "dk", "dv"), got, pull(jnp.asarray(do))):
        _close(g.numpy(), w, EAGER_TOL, f"D={d} {part}")


def test_attention_route_takes_every_width():
    from repro_torch.nn.attention import attention_route
    for d in (64, 256, 257, 512, 1024):
        assert attention_route("causal", d) == "flash"
        assert attention_route("bidir", d) == "flash"
    assert attention_route("causal", 512, 16) == "plain"
    with pytest.raises(ValueError, match="D >= 1"):
        flash_ops._variant(torch.float32, 0)



# flash_split.cuh's plan worked by hand: D -> the forward's and dQ pass's
# (blocks a cluster, slice, slice padded, sweeps) and the dK/dV pass's;
# c = ceil(D / wmax) with wmax 256 (128 in the dK/dV pass) where that is
# at most 8 (16 in the dK/dV pass, a non-portable cluster), else 8; the
# slice ceil(D / c) rounded up to 16, padded to 128, 192 or 256, one
# sweep; a slice past 256 streams in pieces of 128, a sweep a piece
SPLIT_PLANS = {
    257: ((2, 144, 192, 1), (3, 96, 128, 1)),
    264: ((2, 144, 192, 1), (3, 96, 128, 1)),
    320: ((2, 160, 192, 1), (3, 112, 128, 1)),
    512: ((2, 256, 256, 1), (4, 128, 128, 1)),
    640: ((3, 224, 256, 1), (5, 128, 128, 1)),
    1024: ((4, 256, 256, 1), (8, 128, 128, 1)),
    1025: ((5, 208, 256, 1), (9, 128, 128, 1)),
    1040: ((5, 208, 256, 1), (9, 128, 128, 1)),
    2048: ((8, 256, 256, 1), (16, 128, 128, 1)),
    2056: ((8, 272, 128, 3), (8, 272, 128, 3)),
    4100: ((8, 528, 128, 5), (8, 528, 128, 5))}
# a block's shared memory by hand (bytes), (float32, bfloat16), by padded
# slice: the forward (a 64 x 32 fp32 partial, q of 64 rows and two stages
# of K and V of 32 keys, rows wp + 8 apart, fp32 V wp + 4), the dQ pass
# (partials of S and dP, q and dO and their 2 x 64 floats, K and V in two
# stages) and the dK/dV
# pass (two partials, K and V of 64 keys, two stages of q, dO and their
# 2 x 32 floats, rows 136 apart; in fp32 16 rows a tile); each with a
# second buffer of its partials where that fits and keeps its blocks an
# SM: not the bf16 forward at 256 (109,568 B, two blocks an SM; 117,760
# one), nor the fp32 dQ pass (one stage at 256, past 227 KB with two),
# nor the fp32 dK/dV pass (112,896 B, two).  Streamed (a piece of 128,
# rows 136 apart, fp32 V 132; one stage, one buffer): the forward's
# partial, q, K and V (8,192 + 4 (96 x 136 + 32 x 132) in fp32), the dQ
# pass's two partials of 64 x 32, q, dO, K and V and 2 x 64 floats, the
# dK/dV pass's two partials of 64 x 16 (32 in bf16), K, V, q, dO and 2 x
# 16 (32) floats
SPLIT_SMEM = {
    "fwd": {192: (168960, 93184), 256: (218112, 109568),
            128: (77312, 43008)},
    "dq": {192: (221696, 135680), 256: (219648, 168448),
           128: (121344, 69120)},
    "dkv": {128: (112896, 102912)},
    "dkv_stream": (95360, 68864)}


@pytest.mark.parametrize("d", sorted(SPLIT_PLANS))
def test_flash_split_plan_follows_the_formula(d):
    """The analysis's copy of the split route's launch (clusters, slices,
    sweeps and shared memory of each pass) at heads of 257 to 4100:
    within 8 slices, past 8 blocks of 128 columns in the dK/dV pass (a
    cluster of up to 16) and past 8 slices of 256 (streamed), against
    the values worked by hand, and the route ``_variant`` names."""
    from repro_torch.analysis.kernels import flash_layout, flash_route
    fwd, dkv = SPLIT_PLANS[d]
    for i, dtype in enumerate(("float32", "bfloat16")):
        assert flash_route(dtype, d, True) == "split"
        assert flash_ops._variant(getattr(torch, dtype), d) == "split"
        lay = flash_layout("split", dtype, d)
        c, w, wp, sw = fwd
        assert (lay["bq"], lay["bk"], lay["dp"]) == (64, 32, wp)
        assert (lay["cluster"], lay["slice"], lay["sweeps"]) == (c, w, sw)
        assert (lay["dq_cluster"], lay["dq_slice"], lay["dq_sweeps"]) == (
            c, w, sw)
        assert (lay["dkv_cluster"], lay["dkv_slice"],
                lay["dkv_sweeps"]) == (dkv[0], dkv[1], dkv[3])
        assert lay["smem"] == SPLIT_SMEM["fwd"][wp][i]
        assert lay["dq_smem"] == SPLIT_SMEM["dq"][wp][i]
        assert lay["dkv_smem"] == (SPLIT_SMEM["dkv_stream"][i] if dkv[1] > 256
                                   else SPLIT_SMEM["dkv"][dkv[2]][i])
        for cl, sl, sweeps, most in ((c, w, sw, 8),
                                     (dkv[0], dkv[1], dkv[3], 16)):
            assert cl <= most and (cl - 1) * sl < d <= cl * sl
            if sl > 256:
                assert (cl, -(-sl // 128)) == (8, sweeps)


# the tiled route's forward launch (csrc/ssd_chunk.cu, tl::make_launch) on
# 132 SMs, worked by hand: n = ceil(q / 64) strips and max((n + 1) // 2,
# ceil(S / 64)) blocks a group; the window W the widest whose shared
# memory 4 (64 (64 min(2W, n + 1) + 16) + 2 * 64 * 68 + 64 W * 68 + 7 * 64 n
# + 128) fits 231,424 B (q = 256: 4 * 49,536); HG the first that minimises
# whole waves of one block an SM times HG ((n + 1) 64^2 * 64 nP + 64 nP *
# 64 * 64 n) + (n + 1) 64^2 * ceil32(S) (bs 1: HG 10, 8 x 16 = 128 blocks,
# one wave).  Mamba2-2.7B at chunk 256 (bs 1, 2: 8 and 16 chunks), ragged
# q and H, and q past one window.
SSD_TILED_PLANS = {
    # (bn, h, q, p, s): (qp, hg, grid_y, smem, window)
    (8, 80, 256, 64, 128): (256, 10, 16, 198144, 4),
    (16, 80, 256, 64, 128): (256, 20, 8, 198144, 4),
    (2, 7, 200, 64, 128): (256, 1, 14, 198144, 4),
    (1, 2, 300, 130, 260): (320, 1, 10, 216320, 4),
    (1, 2, 1000, 64, 128): (1024, 1, 16, 218624, 3),
}


@pytest.mark.parametrize("dims", sorted(SSD_TILED_PLANS))
def test_ssd_tiled_plan_follows_the_formula(dims):
    """The analysis's copy of the tiled forward's launch (heads a group,
    grid, shared memory and window) against the values worked by hand;
    the route is the tiled one past 128 rows."""
    from repro_torch.analysis.kernels import ssd_plan
    qp, hg, gy, smem, window = SSD_TILED_PLANS[dims]
    bn, h, q, p, s = dims
    assert ssd_ops.route(q) == "tiled"
    got = ssd_plan(*dims, 132)
    assert (got["qp"], got["hg"], got["grid"], got["smem"], got["tiled"],
            got["window"]) == (qp, hg, (bn, gy), smem, 1, window)


def _ssd_tool_edits():
    import importlib.util
    out = {}
    for tool in ("ssd_chunk_variants", "ssd_chunk_planted_faults"):
        path = Path(__file__).resolve().parents[1] / "tools" / f"{tool}.py"
        spec = importlib.util.spec_from_file_location(tool, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if tool == "ssd_chunk_variants":
            out.update({("variants-fwd", n): e for n, e in
                        mod.VARIANTS.items()})
            out.update({("variants-bwd", n): e for n, e in
                        mod.BWD_VARIANTS.items()})
        else:
            out.update({("faults-fwd", n): [e] for n, e in
                        mod.FAULTS.items()})
            out.update({("faults-bwd", n): [e] for n, e in
                        mod.BWD_FAULTS.items()})
    return out


_SSD_EDITS = _ssd_tool_edits()


@pytest.mark.parametrize("key", sorted(_SSD_EDITS),
                         ids=lambda k: f"{k[0]}-{k[1]}")
def test_ssd_variants_and_faults_apply_to_the_sources(key):
    """Each variant ``tools/ssd_chunk_variants.py`` times and each fault
    ``tools/ssd_chunk_planted_faults.py`` plants is an edit of the
    committed sources whose text occurs exactly once, applied in turn."""
    texts = {}
    for fname, old, new in _SSD_EDITS[key]:
        text = texts.get(fname) or (_build.CSRC / fname).read_text()
        assert text.count(old) == 1, (fname, old)
        texts[fname] = text.replace(old, new)


def _flash_variant_edits():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "tools" / "flash_variants.py"
    spec = importlib.util.spec_from_file_location("flash_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {**{("fwd", n): e for n, e in mod.VARIANTS.items()},
            **{("bwd", n): e for n, e in mod.BWD_VARIANTS.items()}}


_VARIANT_EDITS = _flash_variant_edits()


@pytest.mark.parametrize("key", sorted(_VARIANT_EDITS),
                         ids=lambda k: f"{k[0]}-{k[1]}")
def test_flash_variants_apply_to_the_sources(key):
    """Each design choice ``tools/flash_variants.py`` times is an edit of
    the committed sources whose text occurs exactly once, applied in
    turn, so the alternatives live in the tool and not as dead branches
    in the kernels."""
    texts = {}
    for fname, old, new in _VARIANT_EDITS[key]:
        text = texts.get(fname) or (_build.CSRC / fname).read_text()
        assert text.count(old) == 1, (fname, old)
        texts[fname] = text.replace(old, new)

def _fault_tool_edits():
    import importlib.util
    out = {}
    for tool in ("hub_reuse_variants", "hub_reuse_planted_faults",
                 "flash_planted_faults", "flash_bwd_planted_faults"):
        path = Path(__file__).resolve().parents[1] / "tools" / f"{tool}.py"
        spec = importlib.util.spec_from_file_location(tool, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if tool == "hub_reuse_variants":
            out.update({(tool, n): e for n, e in {
                **mod.VARIANTS, **mod.LAYERED_VARIANTS,
                **mod.LINEAR_VARIANTS}.items()})
        else:
            out.update({(tool, n): [e[:3]] for n, e in mod.FAULTS.items()})
    return out


_FAULT_EDITS = _fault_tool_edits()


@pytest.mark.parametrize("key", sorted(_FAULT_EDITS),
                         ids=lambda k: f"{k[0]}-{k[1]}")
def test_hub_and_flash_tool_edits_apply_to_the_sources(key):
    """Each variant ``tools/hub_reuse_variants.py`` times (the resident
    route's, the layered route's and the one-layer form's) and each fault
    ``tools/{hub_reuse,flash,flash_bwd}_planted_faults.py`` plants (the
    split route's sweeps and streamed kernels among them) is an edit of
    the committed sources whose text occurs exactly once."""
    texts = {}
    for fname, old, new in _FAULT_EDITS[key]:
        text = texts.get(fname) or (_build.CSRC / fname).read_text()
        assert text.count(old) == 1, (fname, old)
        texts[fname] = text.replace(old, new)


# ---- the routes on the card --------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 128, 64, 32, 387, 1536, 768),      # pointvector_l block 4, x = 4
    (2, 128, 64, 32, 259, 1024, 512),      # pointnext_s block 4, x = 4
    (4, 128, 64, 32, 700, 1024, 512),      # D past a 64-row block
    (4, 256, 64, 64, 128, 128, 256),       # C past 128, a 2-cloud grid
    (3, 200, 500, 64, 6, 8, 16),           # the slot table past a block
    (2, 50, 7, 300, 650, 70, 100),         # K past a warp's 32 slots
    (3, 333, 37, 13, 67, 96, 75),          # ragged: every width off 64
    (1, 500, 9, 20, 33, 40, 70)])          # past the gather's 384 staged
def test_hub_reuse_routes_match_plain_on_card(shape):
    """The layered route against the plain version, with and without
    liveness and with subsets whose every slot is dead (-BIG), at B = 2:
    1e-4 · max(1, max|plain|), the -BIG identity exactly, two calls
    bit-equal; the library's plan (route, H splits, scratch, shared
    memory) equal to tiling.py's; one launch a call, counted on the route;
    a forced chunk raises."""
    dev = _cuda()
    h, c, m, k, d, hd, f = shape
    rng = np.random.default_rng(d)
    clouds = [_hub_arrays(rng, *shape) for _ in range(2)]
    pool, slot, comp = (torch.from_numpy(np.stack([a[i] for a in clouds]))
                        .to(dev) for i in range(3))
    w1, b1, w2, b2 = _t(clouds[0][3:7], dev)
    live = torch.from_numpy(np.stack([a[7] for a in clouds]) != 0).to(dev)
    live[:, :, 1::4] = False                     # subsets with none live
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tiling.hub_reuse_route(2, h, c, m, k, d, f, sms) == "layered"
    lp = tiling.hub_reuse_layered_plan(2, h, c, hd, f, sms)
    assert hub_ops.library_plan(2, h, c, m, k, d, hd, f) == dict(
        route="layered", nsplit=lp["nsplit"], scratch=lp["scratch"],
        smem=tiling.LAYERED_SMEM)
    for lv in (live, None):
        before = _build.LAUNCHES["hub_reuse_layered"]
        got = hub_reuse(pool, slot, comp, w1, b1, w2, b2, live=lv)
        again = hub_reuse(pool, slot, comp, w1, b1, w2, b2, live=lv)
        assert _build.LAUNCHES["hub_reuse_layered"] == before + 2
        assert torch.equal(got, again)
        want = hub_reuse_ref(pool, slot, comp, w1, b1, w2, b2, lv)
        dead = want <= -1.7e38
        if lv is not None:
            assert bool(dead[:, :, 1::4].all())
        assert torch.equal(got[dead], want[dead])
        _close(got[~dead].cpu().numpy(), want[~dead].cpu().numpy(),
               CARD_TOL, f"{shape}")
    with pytest.raises(ValueError, match="resident route"):
        hub_reuse(pool, slot, comp, w1, b1, w2, b2, live=live, chunk=128)


@pytest.mark.cuda
def test_zoo_hub_plans_match_the_library_on_card(zoo_hub_calls):
    """Every published spec's hub_reuse call at cache_capacity_x 1, 2 and
    4, in the form the engine lowers it to: the built library's plan
    (route, H or D splits, scratch, shared memory; the wgmma kernel's
    block and W halves where ``tiling.reuse_linear_wgmma`` holds) equal
    to tiling.py's on this card."""
    dev = _cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (name, x), recs in zoo_hub_calls.items():
        for rec in recs:
            d = rec["dims"]
            c, m, k, dd = d["c"], d["m"], d["k"], d["d"]
            route = tiling.hub_reuse_route(d["b"], d["hn"], c, m, k, dd,
                                           d["f"], sms, h=d["h"])
            want = dict(route=route, nsplit=0, scratch=0,
                        smem=tiling.hub_reuse_smem(
                            c, m, k, dd, h=d["h"], b=d["b"], hn=d["hn"],
                            f=d["f"], sms=sms)
                        if route == "resident" else tiling.LAYERED_SMEM)
            if route == "resident" and d["h"] == 0 and \
                    tiling.reuse_linear_wgmma(d["b"], d["hn"], c, dd, d["f"]):
                want["scratch"] = tiling.reuse_linear_plan(
                    d["b"], d["hn"], c, dd, d["f"], sms)["scratch"] // 4
            if route == "layered":
                lp = tiling.hub_reuse_layered_plan(d["b"], d["hn"], c, d["h"],
                                                   d["f"], sms, dd)
                want.update(nsplit=lp["nsplit"], scratch=lp["scratch"])
            got = hub_ops.library_plan(d["b"], d["hn"], c, m, k, dd, d["h"],
                                       d["f"])
            assert got == want, (name, x, d)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 129, 3, 16, 8),
                                   (1, 2, 256, 4, 64, 128),
                                   (1, 1, 512, 2, 64, 128),
                                   (2, 1, 200, 3, 36, 100),
                                   (1, 1, 300, 2, 130, 260),
                                   (1, 2, 200, 7, 64, 128)])
def test_ssd_chunk_tiled_route_matches_plain_on_card(shape):
    """The tiled route's forward and backward against the plain versions
    (the backward's dcum against float64: its diagonal terms cancel),
    1e-4 · max(1, max|ref|); two backward calls bit-equal; one forward
    launch and two backward launches a call, on the tiled route; the
    library's forward plan equal to the analysis's formula (its heads a
    group, grid and shared memory), the backward's naming the tiled
    route and the scratch the wrapper allocates."""
    from repro_torch.analysis.kernels import ssd_plan
    dev = _cuda()
    arrays = _t(_ssd_arrays(np.random.default_rng(sum(shape)), *shape), dev)
    bs, nc, q, h, p, s = shape
    plan = ssd_ops.library_plan(bs * nc, h, q, p, s)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = ssd_plan(bs * nc, h, q, p, s, sms)
    assert plan == dict(qp=want["qp"], hg=want["hg"], grid_x=want["grid"][0],
                        grid_y=want["grid"][1], smem=want["smem"], tiled=1)
    bplan = ssd_ops.backward_plan(bs, nc, q, h, p, s)
    assert bplan["tiled"] == 1 and bplan["scratch"] == \
        ssd_ops._lib_bwd().ssd_chunk_backward_scratch(bs * nc, h, q, p, s)
    before = dict(_build.LAUNCHES)
    got = ssd_ops._forward(*arrays[:5])
    grads = ssd_ops.ssd_chunk_backward(*arrays)
    again = ssd_ops.ssd_chunk_backward(*arrays)
    assert _build.LAUNCHES["ssd_chunk_tiled"] == before.get(
        "ssd_chunk_tiled", 0) + 1
    assert _build.LAUNCHES["ssd_chunk_bwd_tiled"] == before.get(
        "ssd_chunk_bwd_tiled", 0) + 4
    for g, w in zip(got, ssd_chunk_ref(*arrays[:5])):
        _close(g.cpu().numpy(), w.cpu().numpy(), CARD_TOL)
    want = ssd_chunk_bwd_ref(*arrays)
    wide = ssd_chunk_bwd_ref(*[a.double() for a in arrays])
    for part, g, a, w, w64 in zip(("dx", "dB", "dC", "ddt", "dcum"), grads,
                                  again, want, wide):
        assert torch.equal(g, a), part
        ref = w64 if part == "dcum" else w
        _close(g.cpu().numpy(), ref.float().cpu().numpy(), CARD_TOL, part)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal", [
    (1, 4, 2, 200, 257, True), (1, 2, 1, 130, 320, False),
    (2, 2, 2, 300, 512, True),
    (1, 2, 2, 150, 264, True),             # an uneven last slice
    (1, 2, 1, 130, 1024, True),            # the widest cluster
    (1, 8, 2, 160, 384, True),             # GQA, a group of 4
    (1, 2, 1, (100, 230), 512, False),     # Sq != Skv
    (1, 2, 2, (230, 100), 320, True),
    (1, 2, 1, 96, 1040, True),             # the dK/dV pass past 8 blocks
    (1, 4, 2, (80, 130), 1040, False),
    (1, 2, 1, 96, 2056, True),             # streamed, in sweeps
    (1, 4, 2, (70, 90), 2057, False),
    (1, 2, 1, 64, 4100, True)])
def test_flash_split_route_matches_plain_on_card(b, hq, hkv, s, d, causal,
                                                 dtype):
    """The split routes' forward (and log-sum-exp) and backward against
    the plain versions at s = Sq = Skv or (Sq, Skv): f32 within 1e-4 ·
    max(1, max|ref|), bf16 by ‖Δ‖/‖ref‖ <= 2e-2; two backward calls
    bit-equal; launches counted on the route ``_variant`` names
    (``split`` at every D > 256); the library's layout (each pass's
    cluster, slice, sweeps and shared memory) equal to the analysis's."""
    from repro_torch.analysis.kernels import flash_layout
    dev = _cuda()
    dt = getattr(torch, dtype)
    sq, skv = s if isinstance(s, tuple) else (s, s)
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev).to(dt) for shape in (
            (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
            (b, hq, sq, d)))
    route = "split"
    assert flash_ops._variant(dt, d) == route
    want = flash_layout(route, dtype, d)
    lay = flash_ops.library_layout(route, dt, d)
    assert {n: lay[n] for n in want} == want
    before = dict(_build.LAUNCHES)
    out, lse = flash_ops._forward(q, k, v, causal, lse=True)
    grads = flash_ops.flash_attention_backward(q, k, v, out, do, causal,
                                               lse=lse)
    again = flash_ops.flash_attention_backward(q, k, v, out, do, causal,
                                               lse=lse)
    for name, n in ((f"flash_attention_{route}", 1),
                    (f"flash_attention_bwd_dq_{route}", 2),
                    (f"flash_attention_bwd_dkdv_{route}", 2)):
        assert _build.LAUNCHES[name] == before.get(name, 0) + n, name
    _close(lse.cpu().numpy(), attention_lse_ref(q, k, causal).cpu().numpy(),
           CARD_TOL, "lse")
    pairs = [("out", out, attention_ref(q, k, v, causal))]
    pairs += zip(("dq", "dk", "dv"), grads,
                 attention_bwd_ref(q, k, v, out, do, causal))
    for (part, g, w), a in zip(pairs, (None, *again)):
        if a is not None:
            assert torch.equal(g, a), part
        g, w = g.float(), w.float()
        if dt == torch.float32:
            _close(g.cpu().numpy(), w.cpu().numpy(), CARD_TOL, part)
        else:
            assert ((g - w).norm() / w.norm()).item() <= 2e-2, part
