"""hub_reuse's one-layer form: y = pool·W + b for each cache row, then the
compensated gather and masked max (the reuse dataflow's lowering of every
one-layer point-MLP, which the kernel took before as the split-sign
two-layer form relu(x·[W, −W] + [b, −b])·[I; −I]).

On the CPU: the engine's one-layer families and the Fig. 20 ``block_end``
model in lpcn mode through the "cuda" backend (the kernels' plain
versions) against the JAX package's "reference" engine, every hub_reuse
call captured at h = 0; the one-layer plain version against the
two-layer one on the split-sign weights; the route, chunk, shared memory
and layered plan the planner gives each family block; the analysis site;
an autotune cell; the form's 3xTF32 arithmetic emulated.  On a CUDA host
(``pytest -m cuda``): the kernel against its plain version on both
routes, and the library's plan against tiling.py's.

The JAX package is imported inside the tests that compare with it, so
the card tests also run on a host without JAX."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.engine import fc
from repro_torch.kernels import plans, tiling
from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
from repro_torch.kernels.hub_reuse import ops as hub_ops
from repro_torch.models import MODEL_ZOO

torch.set_num_threads(1)

TOL = 1e-4
BIG = 3.4e38
SIZES = (96, 70)                     # one full cloud, one padded
N = 96
ISL = dict(island_size=8, island_capacity=16)
# two blocks a family at narrow widths: (n_centers, k, mlp_dims, radius[,
# kind, sampler]), head, classes
CUTS = {
    "dgcnn_c": (((N, 8, (16,), 0.2, "edge", "all"),
                 (N, 8, (24,), 0.2, "edge", "all")), (16,), 10),
    "dgcnn_s": (((N, 8, (16,), 0.2, "edge", "all"),
                 (N, 8, (16,), 0.2, "edge", "all")), (16,), 5),
    "pointnext_s": (((32, 8, (16,), 0.1), (12, 8, (24,), 0.2)), (16,), 7),
    "pointvector_l": (((32, 8, (16,), 0.1), (12, 8, (24,), 0.2)), (16,), 7),
}
ONE_LAYER_FAMILIES = ("dgcnn_c", "dgcnn_s", "pointnext_s", "pointvector_l")


def _held(got, want, what):
    """Within 1e-4 · max(1, max|ref|) of JAX, not a trivial zero."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    lim = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert np.abs(want).max() > 0, what
    assert err <= lim, f"{what}: max|Δ| {err:.3g} > {lim:.3g}"


def _reuse_calls(captured, one_layer=True):
    """The captured hub_reuse calls, each asserted in the form named: h =
    0 (one layer), else h > 0."""
    calls = [c for c in captured if c["kernel"] == "hub_reuse"]
    for c in calls:
        assert (c["dims"]["h"] == 0) == one_layer, c
    return calls


@pytest.mark.parametrize("name", sorted(CUTS))
def test_one_layer_families_match_jax_in_lpcn(name):
    """dgcnn_c, dgcnn_s, pointnext_s and pointvector_l at two narrow
    blocks in lpcn mode: the port's "cuda" backend (every block's
    hub_reuse call one layer, h = 0) within 1e-4 · max(1, max|ref|) of the
    JAX engine's "reference" logits."""
    import jax
    from repro import engine as jengine
    from repro.data.synthetic import make_cloud
    from repro.models import MODEL_ZOO as JMODEL_ZOO
    blocks, head, ncls = CUTS[name]
    jspec = replace(JMODEL_ZOO[name][1], head_dims=head, n_classes=ncls,
                    blocks=tuple(jengine.BlockSpec(*b) for b in blocks))
    tspec = replace(MODEL_ZOO[name][1], head_dims=head, n_classes=ncls,
                    blocks=tuple(engine.BlockSpec(*b) for b in blocks))
    rng = np.random.default_rng(len(name) + 1)
    clouds = [np.asarray(make_cloud(rng, n), np.float32) for n in SIZES]
    feats = None
    if jspec.in_feats > 3:
        feats = [np.concatenate([c, rng.uniform(0, 1, (len(c),
                 jspec.in_feats - 3)).astype(np.float32)], -1)
                 for c in clouds]
    keys = jax.random.split(jax.random.PRNGKey(3), len(SIZES))
    jp = jengine.init(jax.random.PRNGKey(1), jspec)
    jp = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jp)
    jb = jengine.Batch.from_clouds(clouds, feats=feats, key=keys, n_pad=N)
    want = np.asarray(jax.jit(lambda p, b: jengine.apply(
        p, b, spec=jspec, mode="lpcn", fc_backend="reference",
        isl_kw=ISL))(jp, jb))
    tp = engine.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tb = engine.Batch.from_clouds(clouds, feats=feats, key=np.asarray(keys),
                                  n_pad=N, device="cpu")
    with plans.capture() as used:
        got = engine.apply(tp, tb, spec=tspec, mode="lpcn",
                           fc_backend="cuda", isl_kw=ISL,
                           device="cpu").numpy()
    assert len(_reuse_calls(used)) == len(blocks)
    _held(got, want, f"{name} lpcn")


@pytest.mark.parametrize("activation,comp", [("block_end", "linear"),
                                             ("block_end", "mlp"),
                                             ("per_layer", "linear")])
def test_fig20_model_matches_jax_in_lpcn(activation, comp):
    """The paper's Fig. 20 model in lpcn mode through "cuda" on 8 clouds
    within 1e-4 · max(1, max|ref|) of JAX's ``_forward``: with
    ``block_end`` MLPs (each composed into one map) both blocks' hub_reuse
    calls take the one-layer form, under either compensation; with
    ``per_layer`` MLPs (two layers) they keep the two-layer form."""
    import jax
    from benchmarks import accuracy as jacc
    from repro_torch import random as prandom
    from repro_torch.examples import accuracy as acc
    xs, _ = acc.gen_task(8, 256, 1, device="cpu")
    jinit = jax.tree.map(np.asarray, jacc._model_init(
        jax.random.PRNGKey(0), activation))
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax.jit(jax.vmap(
        lambda p, x: jacc._forward(p, x, "lpcn", key, comp, activation),
        in_axes=(None, 0)))(jinit, xs.numpy()))
    params = acc.params_from_numpy(jinit, "cpu")
    with torch.no_grad(), plans.capture() as used:
        got = acc.forward(params, xs, "lpcn", prandom.PRNGKey(0), comp,
                          activation, backend="cuda").numpy()
    assert len(_reuse_calls(used, activation == "block_end")) == 2
    _held(got, want, f"fig20 {activation} {comp}")


def _split_sign(w, b):
    """The two-layer form of x·w + b: relu(x·[w, −w] + [b, −b])·[I; −I]."""
    eye = torch.eye(w.shape[1], dtype=w.dtype)
    return (torch.cat([w, -w], 1), torch.cat([b, -b]),
            torch.cat([eye, -eye], 0), torch.zeros_like(b))


# (D, F) of every one-layer family block (the engine's lowering: DGCNN's
# edge input [f_j − c, c] is 2·F_in wide, the SA blocks' [xyz, f] 3 + F_in)
BLOCK_WIDTHS = {
    "dgcnn_c_blk1": (6, 64), "dgcnn_c_blk2": (128, 64),
    "dgcnn_c_blk3": (128, 128), "dgcnn_c_blk4": (256, 256),
    "dgcnn_s_blk1": (12, 64), "pointnext_s_blk1": (35, 64),
    "pointnext_s_blk2": (67, 128), "pointnext_s_blk3": (131, 256),
    "pointnext_s_blk4": (259, 512), "pointvector_l_blk1": (67, 96),
    "pointvector_l_blk2": (99, 192), "pointvector_l_blk3": (195, 384),
    "pointvector_l_blk4": (387, 768)}


@pytest.mark.parametrize("blk", sorted(BLOCK_WIDTHS))
def test_one_layer_ref_equals_two_layer_split_sign(blk):
    """At each family block's widths: the one-layer plain version (w2, b2
    None) equals the two-layer plain version on the split-sign weights
    within 1e-5, with ``live`` given and not; subsets with no cached slot
    and subsets whose cached slots are all dead are exactly -BIG in both;
    slots past the cache clamp at C − 1 (the last row's value); the
    wrapper takes the plain version for CPU tensors, batched or not."""
    d, f = BLOCK_WIDTHS[blk]
    b, hn, c, m, k = 2, 2, 12, 9, 5
    rng = np.random.default_rng(d * f)
    n = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))
    pool, comp = n(b, hn, c, d), n(b, hn, m, f)
    w, bias = n(d, f, scale=(2 / d) ** .5), n(f, scale=.1)
    slot = torch.from_numpy(rng.integers(-1, c + 3, (b, hn, m, k))
                            .astype(np.int32))
    slot[:, :, 0] = -1                              # no cached slot
    slot[:, :, 1] = c + 2                           # past the cache
    live = torch.from_numpy(rng.uniform(size=(b, hn, m, k)) < 0.7)
    live[:, :, 2] = False                           # cached, none live
    live[:, :, 1] = True
    for lv in (None, live):
        one = hub_reuse_ref(pool, slot, comp, w, bias, live=lv)
        two = hub_reuse_ref(pool, slot, comp, *_split_sign(w, bias),
                            live=lv)
        dead = two <= -BIG / 2
        assert torch.equal(one <= -BIG / 2, dead)
        assert bool(dead[:, :, 0].all()) and bool((one[dead] == -BIG).all())
        torch.testing.assert_close(one[~dead], two[~dead], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(hub_reuse(pool, slot, comp, w, bias, live=lv),
                           one)
        assert torch.equal(hub_reuse(pool[1], slot[1], comp[1], w, bias,
                                     live=None if lv is None else lv[1]),
                           one[1])
    assert bool((hub_reuse_ref(pool, slot, comp, w, bias, live=live)
                 [:, :, 2] == -BIG).all())
    # subset 1 reads only the last cache row (every slot clamped)
    last = (pool[:, :, -1] @ w + bias)[:, :, None, :] + comp[:, :, 1:2]
    only_last = slot.clone()
    only_last[:, :, 1] = c + 2
    got = hub_reuse_ref(pool, only_last, comp, w, bias)[:, :, 1:2]
    torch.testing.assert_close(got, last, rtol=1e-6, atol=1e-6)


def test_every_one_layer_block_lowers_to_one_layer():
    """Every block of the four one-layer families reaches hub_reuse as one
    linear map (h = 0) through the reuse dataflow's lowering
    (``dense_form``), at the widths of :data:`BLOCK_WIDTHS`; PointNet++'s
    keep two layers; ``two_layer_form`` still gives the split-sign form
    (Hd = 2F)."""
    seen = {}
    for name, (_, spec) in MODEL_ZOO.items():
        params = engine.init(spec, device="cpu")
        for i, mlp in enumerate(params.blocks, 1):
            prologue, weights = fc.dense_form(mlp)
            h, f = fc._widths(weights)
            assert (h == 0) == (name in ONE_LAYER_FAMILIES), (name, i)
            if h == 0:
                assert prologue is None, (name, i)
                seen[f"{name}_blk{i}"] = (weights[0].shape[0], f)
                _, split = fc.two_layer_form(mlp)
                assert split[0].shape == (weights[0].shape[0], 2 * f)
    assert {k: v for k, v in seen.items() if k in BLOCK_WIDTHS} \
        == BLOCK_WIDTHS
    assert set(seen) - set(BLOCK_WIDTHS) == {"dgcnn_s_blk2",
                                             "dgcnn_s_blk3"}
    assert seen["dgcnn_s_blk2"] == seen["dgcnn_s_blk3"] == (128, 64)


# each family's one-layer hub_reuse calls, (b, hn, m, k, D, F) at the
# families' batches and full width (DGCNN: islands of 32 subsets of 20;
# the SA families: 64 subsets of 32)
FAMILY_CALLS = {
    "dgcnn_c": [(8, 32, 64, 20, d, f) for d, f in
                ((6, 64), (128, 64), (128, 128), (256, 256))],
    "dgcnn_s": [(1, 256, 64, 20, d, 64) for d in (12, 128, 128)],
    "pointnext_s": [(2, hn, 64, 32, d, f) for hn, d, f in
                    ((64, 35, 64), (16, 67, 128), (4, 131, 256),
                     (1, 259, 512))],
    "pointvector_l": [(2, hn, 64, 32, d, f) for hn, d, f in
                      ((64, 67, 96), (16, 99, 192), (4, 195, 384),
                       (1, 387, 768))]}


def _one_layer_bytes(rows, m, k, d):
    """hub_reuse.cu's one-layer resident block worked by hand: the slot
    table (K to 4), its liveness (to 16), x at a row stride of D to 8 then
    to 8 mod 32 (at least the 72 of y), no h tile, three 64 x 68 ring
    stages."""
    k4 = -(-k // 4) * 4
    dp = -(-d // 8) * 8
    xd = max(dp + (8 - dp) % 32, 72)
    return 4 * (m * k4 + -(-m * k // 16) * 4 + rows * xd + 3 * 64 * 68)


@pytest.mark.parametrize("family", sorted(FAMILY_CALLS))
def test_planner_one_layer_at_every_family_block(family):
    """At cache_capacity_x 1, 2 and 4 (C = x·k), every block of the
    family in one layer: tiling's shared memory is the hand-worked
    one-layer block's (the two-layer block's less its R x 72-float h
    tile), its route resident where that fits 227 KB (C <= 128), its
    chunk 128; past it (pointvector_l's block 4 at x = 4, 128 rows of D =
    387) layered, one GEMM whose D splits cover D and whose scratch is
    the splits' partials of y alone.  pointnext_s's block 4 at x = 4 (D =
    259), layered in two layers, is resident in one."""
    layered = []
    for x in (1, 2, 4):
        for i, (b, hn, m, k, d, f) in enumerate(FAMILY_CALLS[family], 1):
            c = x * k
            rows = 64 if c <= 64 else 128
            smem = _one_layer_bytes(rows, m, k, d)
            assert tiling.hub_reuse_smem(c, m, k, d, h=0) == smem
            assert tiling.hub_reuse_smem(c, m, k, d, h=2 * f) == \
                smem + 4 * rows * 72
            route = tiling.hub_reuse_route(b, hn, c, m, k, d, f, 132, h=0)
            assert route == ("resident" if smem <= tiling.MAX_SMEM
                             else "layered"), (x, i)
            dims = dict(b=b, hn=hn, c=c, m=m, k=k, d=d, h=0, f=f)
            assert tiling.infeasible("hub_reuse", dims, {}) is None
            if route == "resident":
                assert tiling.hub_reuse_chunk(c, m, k, d, 0) == 128
                assert tiling.knobs_of("hub_reuse", dims) == ("chunk",)
                continue
            layered.append((x, i))
            assert tiling.knobs_of("hub_reuse", dims) == ()
            lp = tiling.hub_reuse_layered_plan(b, hn, c, 0, f, 132, d)
            n = b * hn * c
            assert lp["layer2"] is None and lp["n"] == n
            assert (lp["nsplit"] - 1) * lp["kper"] < d <= \
                lp["nsplit"] * lp["kper"]
            assert lp["scratch"] == lp["nsplit"] * n * f
            assert lp["layer1"] == (-(-n // 64), -(-f // 64), lp["nsplit"])
    assert layered == ([(4, 4)] if family == "pointvector_l" else [])
    if family == "pointnext_s":
        assert tiling.hub_reuse_route(2, 1, 128, 64, 32, 259, 512,
                                      132) == "layered"
        assert tiling.hub_reuse_route(2, 1, 128, 64, 32, 259, 512, 132,
                                      h=0) == "resident"


def test_cache_x4_layered_plan_and_knobs():
    """pointvector_l's block 4 under cache_capacity_x = 4 in one layer: N
    = 256 rows by F = 768 is 48 tiles on 132 SMs, so D = 387's seven
    64-deep stages split 3 ways (192 rows a split); scratch 3·256·768
    floats (no h); the chunk knob does not act (layered), and raises where
    given; the wrapper's plan names the route on the CPU."""
    lp = tiling.hub_reuse_layered_plan(2, 1, 128, 0, 768, 132, 387)
    assert (lp["layer1"], lp["nsplit"], lp["kper"], lp["scratch"]) == \
        ((4, 12, 3), 3, 192, 3 * 256 * 768)
    # the two-layer form of the same block split H = 1536 three ways too,
    # behind a layer 1 of N x 1536
    two = tiling.hub_reuse_layered_plan(2, 1, 128, 1536, 768, 132)
    assert two["scratch"] - lp["scratch"] == 256 * 1536
    with pytest.raises(ValueError, match="input width"):
        tiling.hub_reuse_layered_plan(2, 1, 128, 0, 768, 132)
    dims = dict(b=2, hn=1, c=128, m=64, k=32, d=387, h=0, f=768)
    assert "resident route" in tiling.infeasible("hub_reuse", dims,
                                                 {"chunk": 128})
    pl = hub_ops.plan(*dims.values(), "cpu")
    assert (pl["route"], pl["chunk"]) == ("layered", None)
    with pytest.raises(ValueError, match="resident route"):
        hub_ops.plan(*dims.values(), "cpu", chunk=64)
    assert hub_ops.plan(2, 1, 128, 64, 32, 259, 0, 512, "cpu")["route"] \
        == "resident"


def test_one_layer_wrapper_checks_on_cpu():
    """On the CPU a one-layer call (w2 and b2 None) resolves its plan with
    h = 0 before the plain version runs, takes the ``chunk`` knob on the
    resident route and ``variant``; w2 without b2 (or b2 without w2)
    raises."""
    b, hn, c, m, k, d, f = 2, 3, 20, 4, 5, 7, 6
    pool, comp = torch.zeros(b, hn, c, d), torch.zeros(b, hn, m, f)
    slot = torch.zeros(b, hn, m, k, dtype=torch.int32)
    w, bias = torch.zeros(d, f), torch.zeros(f)
    with plans.capture() as cap:
        out = hub_reuse(pool, slot, comp, w, bias, chunk=64,
                        variant="per_cloud")
    assert out.shape == (b, hn, m, f)
    (rec,) = cap
    assert rec["dims"] == dict(b=b, hn=hn, c=c, m=m, k=k, d=d, h=0, f=f)
    assert rec["plan"]["chunk"] == 64 and rec["plan"]["variant"] == \
        "per_cloud"
    with pytest.raises(ValueError, match="w2 and b2"):
        hub_reuse(pool, slot, comp, w, bias, w2=torch.zeros(f, f))
    with pytest.raises(ValueError, match="w2 and b2"):
        hub_reuse(pool, slot, comp, w, bias, b2=torch.zeros(f))


def test_engine_knobs_reach_the_one_layer_call():
    """The engine's ``kernel_kw`` chunk reaches a one-layer hub_reuse call
    on the resident route (the reuse dataflow plans it at h = 0)."""
    spec = replace(MODEL_ZOO["dgcnn_c"][1], head_dims=(16,), n_classes=4,
                   blocks=(engine.BlockSpec(N, 8, (16,), 0.2, "edge",
                                            "all"),))
    rng = np.random.default_rng(5)
    from repro_torch.data.synthetic import make_cloud
    clouds = [make_cloud(rng, n) for n in SIZES]
    batch = engine.Batch.from_clouds(clouds, n_pad=N, device="cpu")
    params = engine.init(spec, device="cpu")
    with plans.capture() as cap, torch.no_grad():
        engine.apply(params, batch, spec=spec, mode="lpcn",
                     fc_backend="cuda", isl_kw=ISL, device="cpu",
                     kernel_kw={"chunk": 64})
    (rec,) = _reuse_calls(cap)
    assert rec["plan"]["chunk"] == 64
    assert rec["plan"]["provenance"] == "override"


def test_one_layer_analysis_sites_are_clean():
    """The analysis derives both routes' one-layer launches from tiling.py
    with no finding: the resident site (dgcnn_c's block 4, on the wgmma
    kernel) takes that kernel's shared memory and a grid of its items,
    the layered site's D splits cover D; a planted resident site whose
    items write no tile, and a planted layered site whose splits fall
    short of D, fail their coverage (K003)."""
    import dataclasses

    from repro_torch.analysis.kernels import (check_kernel_site,
                                              site_from_capture)
    res = dict(b=8, hn=32, c=40, m=64, k=20, d=256, h=0, f=256)
    site = site_from_capture({"kernel": "hub_reuse", "dims": res,
                              "plan": {"route": "resident"}}, "t", sms=132)
    assert site.smem == tiling.hub_reuse_smem(40, 64, 20, 256, h=0, b=8,
                                              hn=32, f=256)
    assert site.launch["route"] == "resident" and site.launch["chunk"] == 128
    assert site.launch["items"] == site.grid[-1] == 512
    assert check_kernel_site(site) == []
    short = dataclasses.replace(site, out_map=lambda p: [])
    assert {f.rule for f in check_kernel_site(short)} == {"K003"}
    lay = dict(b=2, hn=1, c=128, m=64, k=32, d=387, h=0, f=768)
    site = site_from_capture({"kernel": "hub_reuse", "dims": lay,
                              "plan": {"route": "layered", "chunk": None}},
                             "t", sms=132)
    assert site.launch["route"] == "layered" and site.launch["nsplit"] == 3
    assert site.smem == tiling.LAYERED_SMEM
    assert "D=387" in site.coverage[0][0]
    assert check_kernel_site(site) == []
    short = dataclasses.replace(site, coverage=[
        ("x·W's 3 splits of 64 rows cover D=387", 3 * 64 >= 387)])
    assert {f.rule for f in check_kernel_site(short)} == {"K003"}


def test_one_layer_cells_autotune_on_cpu():
    """A one-layer resident cell of 128 cache rows (pointnext_s's block 3
    at cache_capacity_x = 4): its candidates are chunk 128, chunk 64 (two
    launches) and the per-cloud launch, and the tuner records a winner; a
    one-layer layered cell offers no chunk."""
    from repro_torch.launch import autotune
    dims = dict(b=2, hn=4, c=128, m=64, k=32, d=131, h=0, f=256)
    cands = autotune.candidate_plans("hub_reuse", dims, sms=132)
    assert cands == [{"chunk": 128}, {"chunk": 64}, {"variant": "per_cloud"}]
    store = plans.PlanStore()
    costs = {128: 2.0, 64: 1.0}
    entry = autotune.autotune_cell(
        "hub_reuse", dims, store=store, device="cpu", sms=132,
        timer=lambda call, knobs: costs.get(knobs.get("chunk"), 3.0))
    assert entry["chunk"] == 64 and entry["provenance"] == "autotuned"
    lay = dict(b=2, hn=1, c=128, m=64, k=32, d=387, h=0, f=768)
    assert autotune.candidate_plans("hub_reuse", lay, sms=132) == \
        [{}, {"variant": "per_cloud"}]


def _tf32(x):
    """``cvt.rna.tf32.f32``: the low 13 mantissa bits rounded off."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("blk", ["pointvector_l_blk4", "dgcnn_c_blk4"])
def test_tf32x3_keeps_the_one_layer_tolerance(blk):
    """The one-layer form's arithmetic, emulated at the block's widths
    (C = 64 cache rows): x·W in 3xTF32 (small parts rounded, ``split``),
    summed in fp32, b added, the gather and masked max with comp, stays
    within 1e-4 · max(1, |ref|) of fp64 (1e-5 in fact), and 1xTF32
    breaks that limit, which the kernel is held to."""
    d, f = BLOCK_WIDTHS[blk]
    c, m, k = 64, 64, 32
    rng = np.random.default_rng(d + f)
    n = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))
    pool, comp = n(1, c, d), n(1, m, f)
    w, bias = n(d, f, scale=(2 / d) ** .5), n(f, scale=.1)
    slot = torch.from_numpy(rng.integers(-1, c, (1, m, k)).astype(np.int32))
    ref = hub_reuse_ref(pool.double(), slot, comp.double(), w.double(),
                        bias.double())
    lim = max(1.0, ref[ref > -BIG / 2].abs().max().item())
    xb, wb = _tf32(pool), _tf32(w)
    err = {}
    for passes in (1, 3):
        y = xb @ wb
        if passes == 3:
            y = _tf32(pool - xb) @ wb + xb @ _tf32(w - wb) + y
        # the gather on y: hub_reuse_ref with y as its pool and W = I
        got = hub_reuse_ref(y, slot, comp, torch.eye(f), bias)
        live = ref > -BIG / 2
        assert torch.equal(got > -BIG / 2, live)
        err[passes] = (got[live].double() - ref[live]).abs().max().item()
    assert err[3] <= 1e-5 * lim, err
    assert err[1] > 1e-4 * lim, err


# on the card: (B, H, C, M, K, D, F) — resident at 64-row and 128-row
# blocks (C 40, 64, 100, 128), odd D and F (4-byte copies, an F tile
# ending inside an n8 tile), one D stage and several, pointnext_s's block
# 4 at C = 128 (resident only in one layer); on the wgmma kernel (2^28
# multiply-adds and more) one island of 40 a 64-row tile, three of 20,
# 64 of C = 1, M·K odd with F = 130, and D = 67 (x by cp.async); layered
# at pointvector_l's block 4 under cache_capacity_x = 4 (D split 3 ways
# at B = 2), D = 700, and C = 256 on a small grid
CARD_RESIDENT = ((2, 3, 40, 9, 20, 6, 64), (1, 2, 64, 16, 32, 35, 64),
                 (2, 2, 100, 9, 13, 131, 77), (2, 1, 128, 64, 32, 259, 512),
                 (1, 2, 64, 16, 32, 387, 768), (3, 2, 50, 7, 5, 33, 130),
                 (8, 256, 40, 64, 20, 64, 256), (4, 512, 20, 16, 8, 128, 256),
                 (1, 8192, 1, 3, 4, 256, 128), (2, 1024, 32, 5, 7, 64, 130),
                 (2, 1024, 32, 5, 7, 67, 130))
CARD_LAYERED = ((2, 1, 128, 64, 32, 387, 768), (2, 4, 128, 64, 32, 700, 512),
                (1, 2, 256, 16, 64, 128, 256), (2, 1, 129, 5, 9, 37, 70))


@pytest.mark.cuda
def test_one_layer_kernel_matches_plain_version_on_card():
    """On a CUDA host, both routes in one layer: against the plain version
    within 1e-4 (the -BIG identity exactly; live given and not), batched
    and per cloud, repeats bit-equal, one launch a call counted by route
    and form (``hub_reuse_<route>_linear``; the wgmma kernel's also as
    ``hub_reuse_linear_wgmma``, after one W split a call), within 1e-4 of
    the split-sign two-layer call; the library's plan (route, D splits,
    scratch, shared memory) equal to tiling.py's; the library refuses
    weights of the other form.  (Per cloud the layered route's D splits
    follow N, and one cloud may fall below the wgmma kernel's rule, so
    only a per-cloud call on the batch's resident kernel is bit-equal to
    the batch's.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes

    from repro_torch.kernels import LAUNCHES
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    for shapes, way in ((CARD_RESIDENT, "resident"),
                        (CARD_LAYERED, "layered")):
        for b, hn, c, m, k, d, f in shapes:
            route = tiling.hub_reuse_route(b, hn, c, m, k, d, f, sms, h=0)
            assert route == way, (b, hn, c, m, k, d, f)
            lib = hub_ops.library_plan(b, hn, c, m, k, d, 0, f)
            wgmma = way == "resident" and tiling.reuse_linear_wgmma(
                b, hn, c, d, f)
            want = dict(route=way, nsplit=0, scratch=0,
                        smem=tiling.hub_reuse_smem(c, m, k, d, h=0, b=b,
                                                   hn=hn, f=f, sms=sms))
            if wgmma:
                want["scratch"] = tiling.reuse_linear_plan(
                    b, hn, c, d, f, sms)["scratch"] // 4
            if way == "layered":
                lp = tiling.hub_reuse_layered_plan(b, hn, c, 0, f, sms, d)
                want.update(nsplit=lp["nsplit"], scratch=lp["scratch"],
                            smem=tiling.LAYERED_SMEM)
            assert lib == want, (lib, want)
            pool, comp = r(b, hn, c, d), r(b, hn, m, f)
            w, bias = r(d, f, scale=(2 / d) ** .5), r(f, scale=.1)
            slot = torch.randint(-1, c, (b, hn, m, k), generator=g,
                                 dtype=torch.int32)
            slot[:, :, ::4] = -1
            live = torch.rand(b, hn, m, k, generator=g) < .8
            live[:, :, 1::5] = False
            slot, live = slot.to(dev), live.to(dev)
            for lv in (None, live):
                want = hub_reuse_ref(pool, slot, comp, w, bias, live=lv)
                names = (f"hub_reuse_{way}_linear", "hub_reuse_linear_wgmma",
                         "hub_reuse_split_weights")
                before = [LAUNCHES[n] for n in names]
                got = hub_reuse(pool, slot, comp, w, bias, live=lv)
                torch.cuda.synchronize()
                assert [LAUNCHES[n] for n in names] == [
                    before[0] + 1, before[1] + wgmma, before[2] + wgmma]
                dead = want <= -BIG / 2
                assert torch.equal(got[dead], want[dead])
                lim = TOL * max(1.0, want[~dead].abs().max().item())
                assert (got[~dead] - want[~dead]).abs().max().item() <= lim
                assert torch.equal(hub_reuse(pool, slot, comp, w, bias,
                                             live=lv), got)
                two = hub_reuse(pool, slot, comp,
                                *(t.to(dev) for t in _split_sign(
                                    w.cpu(), bias.cpu())), live=lv)
                assert (two[~dead] - got[~dead]).abs().max().item() <= lim
                # per cloud: the resident kernel at B = 1 (the same bits);
                # the layered one splits D by its own, smaller N
                one = hub_reuse(pool[-1], slot[-1], comp[-1], w, bias,
                                live=None if lv is None else lv[-1])
                if way == "resident" and wgmma == \
                        tiling.reuse_linear_wgmma(1, hn, c, d, f):
                    assert torch.equal(one, got[-1])
                assert torch.equal(one[dead[-1]], want[-1][dead[-1]])
                assert (one[~dead[-1]] - want[-1][~dead[-1]]).abs().max() \
                    .item() <= lim
    # the library refuses w2 with Hd = 0, and none with Hd > 0
    so = hub_ops._lib()
    b, hn, c, m, k, d, f = CARD_RESIDENT[0]
    pool, comp, out = r(b, hn, c, d), r(b, hn, m, f), r(b, hn, m, f)
    slot = torch.zeros(b, hn, m, k, dtype=torch.int32, device=dev)
    w, bias = r(d, f), r(f)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (pool, slot, comp)] + [None]
    for w2, hd in ((w.data_ptr(), 0), (None, f)):
        code = so.hub_reuse_forward(*ptrs, w.data_ptr(), bias.data_ptr(), w2,
                                    bias.data_ptr() if w2 else None,
                                    out.data_ptr(), None, b, hn, c, m, k, d,
                                    hd, f, 0, 0, 128,
                                    ctypes.c_void_p(stream))
        assert code != 0
