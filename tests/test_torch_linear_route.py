"""gather_mlp's linear route: one layer, y = x·W + b, pooled over K (the
engine's lowering of every one-layer point-MLP, which the two-layer
routes took before as relu(x·[W, −W] + [b, −b])·[I; −I]).

On the CPU: the engine's one-layer families and the Fig. 20 ``block_end``
model through the "cuda" backend (the kernels' plain versions) against
the JAX package's "reference" engine, every gather_mlp call on the
linear route; the one-layer plain version against the two-layer one on
the split-sign weights; the route, row tile and shared memory the plans
give each call; the route's 3xTF32 arithmetic emulated.  On a CUDA host
(``pytest -m cuda``): the kernel against its plain version and tiling's
shared memory against the library's.

The JAX package is imported inside the tests that compare with it, so
the card tests also run on a host without JAX."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.engine import fc
from repro_torch.kernels import plans, tiling
from repro_torch.kernels.gather_mlp import gather_mlp, gather_mlp_ref
from repro_torch.models import MODEL_ZOO

torch.set_num_threads(1)

TOL = 1e-4
SIZES = (96, 70)                     # one full cloud, one padded
N = 96
ISL = dict(island_size=8, island_capacity=16)
# two blocks a family at narrow widths: (n_centers, k, mlp_dims, radius[,
# kind, sampler]), head, classes
CUTS = {
    "dgcnn_c": (((N, 8, (16,), 0.2, "edge", "all"),
                 (N, 8, (24,), 0.2, "edge", "all")), (16,), 10),
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


def _linear_calls(captured):
    """The captured gather_mlp calls, each asserted on the linear route."""
    calls = [c for c in captured if c["kernel"] == "gather_mlp"]
    for c in calls:
        assert c["dims"]["h"] == 0 and c["plan"]["route"] == "linear", c
    return calls


@pytest.mark.parametrize("mode", ["lpcn", "traditional"])
@pytest.mark.parametrize("name", sorted(CUTS))
def test_one_layer_families_match_jax(name, mode):
    """dgcnn_c, pointnext_s and pointvector_l at two narrow blocks: the
    port's "cuda" backend (every block's gather_mlp call one layer, on
    the linear route) within 1e-4 · max(1, max|ref|) of the JAX engine's
    "reference" logits."""
    import jax
    from repro import engine as jengine
    from repro.data.synthetic import make_cloud
    from repro.models import MODEL_ZOO as JMODEL_ZOO
    blocks, head, ncls = CUTS[name]
    jspec = replace(JMODEL_ZOO[name][1], head_dims=head, n_classes=ncls,
                    blocks=tuple(jengine.BlockSpec(*b) for b in blocks))
    tspec = replace(MODEL_ZOO[name][1], head_dims=head, n_classes=ncls,
                    blocks=tuple(engine.BlockSpec(*b) for b in blocks))
    rng = np.random.default_rng(len(name))
    clouds = [np.asarray(make_cloud(rng, n), np.float32) for n in SIZES]
    feats = None
    if jspec.in_feats > 3:
        feats = [np.concatenate([c, rng.uniform(0, 1, (len(c),
                 jspec.in_feats - 3)).astype(np.float32)], -1)
                 for c in clouds]
    keys = jax.random.split(jax.random.PRNGKey(2), len(SIZES))
    jp = jengine.init(jax.random.PRNGKey(0), jspec)
    jp = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jp)
    jb = jengine.Batch.from_clouds(clouds, feats=feats, key=keys, n_pad=N)
    want = np.asarray(jax.jit(lambda p, b: jengine.apply(
        p, b, spec=jspec, mode=mode, fc_backend="reference",
        isl_kw=ISL))(jp, jb))
    tp = engine.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tb = engine.Batch.from_clouds(clouds, feats=feats, key=np.asarray(keys),
                                  n_pad=N, device="cpu")
    with plans.capture() as used:
        got = engine.apply(tp, tb, spec=tspec, mode=mode, fc_backend="cuda",
                           isl_kw=ISL, device="cpu").numpy()
    assert len(_linear_calls(used)) == len(blocks)
    _held(got, want, f"{name} {mode}")


@pytest.mark.parametrize("mode,comp", [("traditional", "linear"),
                                       ("lpcn", "linear")])
def test_fig20_block_end_model_matches_jax(mode, comp):
    """The paper's Fig. 20 model with ``block_end`` MLPs (each composed
    into one map): ``examples.accuracy.forward`` through "cuda" on 8
    clouds, both blocks' gather_mlp calls on the linear route, within
    1e-4 · max(1, max|ref|) of JAX's ``_forward``."""
    import jax
    from benchmarks import accuracy as jacc
    from repro_torch import random as prandom
    from repro_torch.examples import accuracy as acc
    xs, _ = acc.gen_task(8, 256, 1, device="cpu")
    jinit = jax.tree.map(np.asarray, jacc._model_init(
        jax.random.PRNGKey(0), "block_end"))
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax.jit(jax.vmap(
        lambda p, x: jacc._forward(p, x, mode, key, comp),
        in_axes=(None, 0)))(jinit, xs.numpy()))
    params = acc.params_from_numpy(jinit, "cpu")
    with torch.no_grad(), plans.capture() as used:
        got = acc.forward(params, xs, mode, prandom.PRNGKey(0), comp,
                          backend="cuda").numpy()
    assert len(_linear_calls(used)) == 2
    _held(got, want, f"fig20 block_end {mode}")


def _split_sign(w, b):
    """The two-layer form of x·w + b: relu(x·[w, −w] + [b, −b])·[I; −I]."""
    eye = torch.eye(w.shape[1], dtype=w.dtype)
    return (torch.cat([w, -w], 1), torch.cat([b, -b]),
            torch.cat([eye, -eye], 0), torch.zeros_like(b))


# (S, K, D, Dc, F, masked, dead): subsets with no live row where dead
REF_CASES = {"masked": (9, 16, 13, 3, 24, True, False),
             "dead_subsets": (12, 8, 7, 7, 16, True, True),
             "k20_packing": (13, 20, 35, 3, 40, True, False),
             "d_past_256": (5, 32, 300, 3, 48, False, False)}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_one_layer_ref_equals_two_layer_split_sign(case):
    """The one-layer plain version (w2, b2 None) equals the two-layer plain
    version on the split-sign weights within 1e-5, dead subsets 0 in
    both: the function the engine's lowering hands the linear route is
    the one the two-layer routes computed."""
    s, k, d, dc, f, masked, dead = REF_CASES[case]
    rng = np.random.default_rng(s * k + d)
    n = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))
    raw, ctr = n(2, s, k, d), n(2, s, dc)
    w, b = n(d, f, scale=(2 / d) ** .5), n(f, scale=.1)
    mask = None
    if masked:
        mask = torch.from_numpy(rng.uniform(size=(2, s, k)) < 0.7)
        if dead:
            mask[:, ::3] = False
    one = gather_mlp_ref(raw, ctr, w, b, mask=mask)
    two = gather_mlp_ref(raw, ctr, *_split_sign(w, b), mask=mask)
    torch.testing.assert_close(one, two, rtol=1e-5, atol=1e-5)
    if dead:
        assert bool((one[:, ::3] == 0).all())
    # the wrapper takes the plain version for CPU tensors, batched or not
    assert torch.equal(gather_mlp(raw, ctr, w, b, mask=mask), one)
    assert torch.equal(gather_mlp(raw[1], ctr[1], w, b,
                                  mask=None if mask is None else mask[1]),
                       one[1])


def test_every_one_layer_block_routes_linear():
    """Every block of the four one-layer families lowers to one map (H =
    0) and takes the linear route, and no block of the zoo takes the wide
    one; the PointNet++ blocks keep their two-layer shapes.  A two-layer
    call keeps its route (D = 4000: wide), and a call of one layer takes
    the linear route whatever its widths."""
    for name, (_, spec) in MODEL_ZOO.items():
        params = engine.init(spec, device="cpu")
        for i, (blk, mlp) in enumerate(zip(spec.blocks, params.blocks), 1):
            k, d, dc, h, f = fc.dense_shape(blk.kind, blk.k, mlp)
            way = tiling.route(k, d, dc, h, f)
            assert way != "wide", (name, i)
            assert (way == "linear") == (name in ONE_LAYER_FAMILIES), \
                (name, i, way)
            if way == "linear":
                assert h == 0 and f == mlp.f_out, (name, i)
    assert tiling.route(32, 4000, 3, 512, 256) == "wide"
    assert tiling.route(32, 4000, 3, 0, 256) == "linear"
    assert tiling.route(1, 1, 1, 0, 1) == "linear"


# (b, s, k, f, sms) -> (rows, spt, n_tiles, groups, nft, n, stages)
LINEAR_PLANS = {
    (8, 1024, 20, 256, 132): (128, 6, 1, 1366, 1, 256, 4),  # dgcnn_c blk 4
    (2, 32, 32, 768, 132): (64, 2, 1, 32, 3, 256, 5),     # pointvector_l 4
    (1, 8192, 20, 64, 132): (128, 6, 1, 1366, 1, 64, 3),  # dgcnn_s block 1
    (1, 9, 200, 300, 132): (64, 1, 4, 9, 2, 192, 6),      # K past the tile
}


@pytest.mark.parametrize("key", sorted(LINEAR_PLANS))
def test_linear_plan(key):
    """The linear route's tiling: 128-row tiles of whole subsets packed K
    rows apart, 64 where 128-row tiles would give fewer items than 3/4
    of the persistent grid's blocks (one an SM, two at 64 columns), one
    subset over several tiles past the tile; F in ceil(F / 256)
    tiles of columns rounded up to 64 (768: 3 x 256, 300: 2 x 192); a
    ring of 16-deep stages, as many as fit up to 8.  A stage is both W
    halves (2 · N · 16 · 4 B), the x slice (R rows of 24 floats) and the
    centers (spt rows of 16), rounded up to 1024 B: at 128 rows of K = 20
    by 256 columns 32,768 + 12,288 + 384 -> 46,080 B, and 4 of them
    (184,320 B) fit beside 1024 B of alignment and a 41,088-B tail (y
    staged 64 columns at a time 128 · 72 · 4, mbarriers 16 · 8, live rows
    one a consumer thread 4 · 256, running max and its flags 8 · 256, the
    bias 4 · 256): 226,432 B, one block an SM; by 64 columns 8,192 +
    12,288 + 384 -> 21,504 B and two blocks an SM, each within 233,472 /
    2 - 1024 = 115,712 B: 3 stages, 105,088 B.  Whatever D."""
    b, s, k, f, sms = key
    p = tiling.linear_plan(b, s, k, f, sms)
    assert (p["rows"], p["spt"], p["n_tiles"], p["groups"], p["nft"],
            p["n"], p["stages"]) == LINEAR_PLANS[key]
    assert p["smem"] == tiling.linear_smem(p["rows"], p["spt"], p["n"])
    assert tiling.linear_stage_bytes(128, 256, 6) == 46080
    assert tiling.linear_smem(128, 6, 256) == 226432
    assert tiling.linear_stage_bytes(128, 64, 6) == 21504
    assert tiling.linear_smem(128, 6, 64) == 105088
    assert tiling.SMEM_SM < 2 * (tiling.linear_smem(64, 1, 128) + 1024)
    assert 2 * (tiling.linear_smem(128, 128, 64) + 1024) <= tiling.SMEM_SM
    for rows in tiling.ROWS:                  # the worst case still fits
        for n in (64, 128, 192, 256):
            assert tiling.linear_stages(rows, n, rows) >= 2
            assert tiling.linear_stages(rows, n, 6) >= 3
            assert tiling.linear_smem(rows, rows, n) <= tiling.MAX_SMEM
    dims = dict(b=b, s=s, k=k, d=4000, dc=3, h=0, f=f)
    assert tiling.gather_mlp_smem(*dims.values(), sms) == p["smem"]
    assert tiling.knobs_of("gather_mlp", dims, sms) == ("rows",)
    for rows in tiling.ROWS:                  # any D fits either tile
        assert tiling.feasible("gather_mlp", dims, {"rows": rows}, sms)
        assert tiling.linear_plan(b, s, k, f, sms, rows)["rows"] == rows


@pytest.mark.parametrize("f", [1, 40, 64, 77, 96, 100, 130, 192, 256, 257,
                               300, 384, 512, 513, 768, 769, 1000])
def test_linear_f_tiles_cover_f(f):
    """F's tiles: at most 256 columns a block, a multiple of 64, none
    empty, covering F; the scratch holds both halves of F_pad x D_pad."""
    nft, n = tiling.linear_tiles(f)
    assert n % 64 == 0 and n <= 256
    assert (nft - 1) * n < f <= nft * n
    assert nft == -(-f // 256)
    assert tiling.linear_scratch(35, f) == 2 * 4 * nft * n * 48


def test_linear_knobs_and_plan_on_cpu():
    """On the CPU a one-layer call resolves the linear route with the
    ``rows`` knob; ``nsplit`` (the wide route's) raises, as a knob of
    another route does; w2 without b2 raises."""
    from repro_torch.kernels.gather_mlp import ops
    pl = ops.plan(2, 16, 8, 5, 3, 0, 24, "cpu")
    assert pl["route"] == "linear" and pl["variant"] == "batched"
    assert ops.plan(2, 16, 8, 5, 3, 0, 24, "cpu", rows=64)["rows"] == 64
    raw, ctr = torch.zeros(2, 16, 8, 5), torch.zeros(2, 16, 3)
    w, b = torch.zeros(5, 24), torch.zeros(24)
    with pytest.raises(ValueError, match="another one"):
        gather_mlp(raw, ctr, w, b, nsplit=1)
    with pytest.raises(ValueError, match="w2 and b2"):
        gather_mlp(raw, ctr, w, b, w2=torch.zeros(24, 4))
    out = gather_mlp(raw, ctr, w, b, rows=128, variant="per_cloud")
    assert out.shape == (2, 16, 24)


def test_linear_cell_autotunes_on_cpu():
    """A linear cell's candidates are the heuristic's row tile, the other
    tile and the per-cloud launch, and the tuner records a winner."""
    from repro_torch.launch import autotune
    dims = dict(b=2, s=16, k=8, d=5, dc=3, h=0, f=24)
    cands = autotune.candidate_plans("gather_mlp", dims, sms=132)
    assert cands == [{"rows": 64}, {"rows": 128}, {"variant": "per_cloud"}]
    store = plans.PlanStore()
    costs = {64: 2.0, 128: 1.0}
    entry = autotune.autotune_cell(
        "gather_mlp", dims, store=store, device="cpu", sms=132,
        timer=lambda call, knobs: costs.get(knobs.get("rows"), 3.0))
    assert entry["rows"] == 128 and entry["provenance"] == "autotuned"


def test_linear_analysis_site_is_clean():
    """The analysis derives the linear launch from tiling.py: grid (1,
    groups, F tiles; F = 300 in two of 192), no finding; a planted site
    whose grid drops an F tile leaves output unwritten (K003)."""
    import dataclasses

    from repro_torch.analysis.kernels import (check_kernel_site,
                                              site_from_capture)
    dims = dict(b=2, s=64, k=20, d=35, dc=3, h=0, f=300)
    site = site_from_capture({"kernel": "gather_mlp", "dims": dims,
                              "plan": {"route": "linear"}}, "t", sms=132)
    assert site.grid == (1, 43, 2) and site.launch["rows"] == 64
    assert check_kernel_site(site) == []
    short = dataclasses.replace(site, grid=(1, 43, 1))
    assert {f.rule for f in check_kernel_site(short)} == {"K003"}


def _tf32(x):
    """``cvt.rna.tf32.f32``: the low 13 mantissa bits rounded off."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


# (S, K, D, Dc, F): dgcnn_c block 4's widths (K = 20, Dc = D) and
# pointvector_l block 4's (D = 387) at a small S
TF32_LINEAR = {"dgcnn_c_blk4": (24, 20, 256, 256, 256),
               "pointvector_l_blk4": (4, 32, 387, 3, 768)}


@pytest.mark.parametrize("blk", sorted(TF32_LINEAR))
def test_tf32x3_keeps_the_linear_tolerance(blk):
    """The linear route's arithmetic, emulated: one product in 3xTF32
    (small parts rounded, ``split``), summed in fp32, pooled, b added to
    the max, stays within 1e-5 · max(1, |ref|) of fp64 at chip_smoke.py's
    input scales, and 1xTF32 breaks the 1e-4 limit the kernel is held to."""
    s, k, d, dc, f = TF32_LINEAR[blk]
    rng = np.random.default_rng(k + d)
    n = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))
    raw, ctr = n(s, k, d), n(s, dc)
    w, b = n(d, f, scale=(2 / d) ** .5), n(f, scale=.1)
    ref = gather_mlp_ref(*(t.double() for t in (raw, ctr, w, b)))
    lim = max(1.0, ref.abs().max().item())
    x = torch.cat([raw[..., :dc] - ctr[:, None], raw[..., dc:]], dim=-1)
    xb, wb = _tf32(x), _tf32(w)
    err = {}
    for passes in (1, 3):
        y = xb @ wb
        if passes == 3:
            y = _tf32(x - xb) @ wb + xb @ _tf32(w - wb) + y
        err[passes] = (y.amax(1) + b - ref).abs().max().item()
    assert err[3] <= 1e-5 * lim, err
    assert err[1] > 1e-4 * lim, err


# W's widths (D, F): dgcnn_c block 4's, pointvector_l block 4's (F in
# three tiles), DGCNN block 1's D = 6, and edges in D and F
SPLIT_W = ((256, 256), (387, 768), (6, 64), (35, 100), (700, 300),
           (9, 40))


def _weights(d, f, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d, f)) * (2 / d) ** .5
    w[0, 0], w[-1, -1] = 1.5 + 2 ** -11, -(3 + 2 ** -10)   # ties of rna
    return torch.from_numpy(w.astype(np.float32))


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("d,f", SPLIT_W)
def test_split_weights_halves_are_tf32(d, f):
    """Both halves have their low 13 bits zero, so wgmma's truncation of
    a TF32 operand is a no-op on them; big + small equals W to 2⁻²²
    relative (small rounds a remainder of at most 2⁻¹¹·|W| to 11
    bits)."""
    from repro_torch.kernels.gather_mlp.ref import split_weights_ref
    w = _weights(d, f, d + f)
    big, small = split_weights_ref(w)
    assert bool(((_bits(big) & 0x1FFF) == 0).all())
    assert bool(((_bits(small) & 0x1FFF) == 0).all())
    back = (big.double() + small.double())[:f, :]       # (F, D_pad)
    order = np.argsort(np.asarray(_order(back.shape[1])))
    back = back[:, order][:, :d].t()
    err = (back - w.double()).abs()
    assert bool((err <= 2.0 ** -22 * w.double().abs()).all()), \
        float((err / w.double().abs().clamp_min(1e-30)).max())


def _order(d_pad):
    """The logical k at each position, as wgmma's A fragment fixes it: a
    thread's slots t and t + 4 of a k8 step hold x's columns 2t and 2t +
    1 (one 8-byte load), so slot j holds 2 (j % 4) + j // 4."""
    return [8 * (p // 8) + [0, 2, 4, 6, 1, 3, 5, 7][p % 8]
            for p in range(d_pad)]


@pytest.mark.parametrize("d,f", SPLIT_W)
def test_split_weights_layout_gathers_back(d, f):
    """The halves' layout: (2, F_pad, D_pad), F_pad the F tiles times the
    columns a block and D_pad D rounded up to 16; K-major (row n holds
    column n of W), logical k at position 8 (k // 8) + (k % 2)·4 +
    (k % 8) // 2 (the k order the A fragment's 8-byte loads need), zero
    past D and F: gathered back by that formula, big is rna(W) exactly
    and the padding is 0."""
    from repro_torch.kernels.gather_mlp.ref import (linear_k_order,
                                                    split_weights_ref)
    w = _weights(d, f, d * f)
    halves = split_weights_ref(w)
    nft, n = tiling.linear_tiles(f)
    d_pad = -(-d // 16) * 16
    assert halves.shape == (2, nft * n, d_pad) and halves.dtype == w.dtype
    assert linear_k_order(d_pad).tolist() == _order(d_pad)
    k = torch.arange(d)
    pos = 8 * (k // 8) + (k % 2) * 4 + (k % 8) // 2
    assert torch.equal(halves[0][:f][:, pos], _tf32(w).t())
    assert torch.equal(halves[1][:f][:, pos], _tf32(w - _tf32(w)).t())
    pad = torch.ones(d_pad, dtype=torch.bool)
    pad[pos] = False
    assert not bool(halves[:, :, pad].any()) and not bool(halves[:, f:].any())


@pytest.mark.parametrize("blk", sorted(TF32_LINEAR))
def test_split_weights_product_keeps_the_linear_tolerance(blk):
    """The linear route's arithmetic through the halves' layout: x padded
    to D_pad and read in the A fragment's k order, centered, split
    big / small, times W's halves as stored (small·big, big·small,
    big·big, summed in fp32), pooled, b added to the max: within 1e-5 ·
    max(1, |ref|) of fp64, as ``test_tf32x3_keeps_the_linear_tolerance``
    holds the route's arithmetic to."""
    from repro_torch.kernels.gather_mlp.ref import split_weights_ref
    s, k, d, dc, f = TF32_LINEAR[blk]
    rng = np.random.default_rng(k * d)
    n = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))
    raw, ctr = n(s, k, d), n(s, dc)
    w, b = n(d, f, scale=(2 / d) ** .5), n(f, scale=.1)
    ref = gather_mlp_ref(*(t.double() for t in (raw, ctr, w, b)))
    big_w, small_w = split_weights_ref(w)
    x = torch.cat([raw[..., :dc] - ctr[:, None], raw[..., dc:]], dim=-1)
    x = torch.nn.functional.pad(x, (0, big_w.shape[1] - d))
    x = x[..., _order(big_w.shape[1])]
    xb = _tf32(x)
    xs = _tf32(x - xb)
    y = xs @ big_w.t() + xb @ small_w.t() + xb @ big_w.t()
    got = y[..., :f].amax(1) + b
    lim = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= 1e-5 * lim


def _gather_tool_edits():
    import importlib.util
    from pathlib import Path
    out = {}
    for tool, table in (("gather_mlp_variants", "VARIANTS"),
                        ("gather_mlp_planted_faults", "FAULTS")):
        path = Path(__file__).resolve().parents[1] / "tools" / f"{tool}.py"
        spec = importlib.util.spec_from_file_location(tool, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for name, entry in getattr(mod, table).items():
            edits = entry[1] if table == "VARIANTS" else entry[0]
            out[(tool, name)] = edits
    return out


_GATHER_EDITS = _gather_tool_edits()


@pytest.mark.parametrize("key", sorted(_GATHER_EDITS),
                         ids=lambda k: f"{k[0]}-{k[1]}")
def test_gather_mlp_tool_edits_apply_to_the_sources(key):
    """Each variant ``tools/gather_mlp_variants.py`` times and each fault
    ``tools/gather_mlp_planted_faults.py`` plants (the linear route's
    among them: 1xTF32, F tiles of 128, x by cp.async, no product in
    flight, W's small half dropped, W's k order unpermuted, ...) is an
    edit of the committed sources whose text occurs exactly once."""
    from repro_torch.kernels import _build
    texts = {}
    for fname, old, new in _GATHER_EDITS[key]:
        text = texts.get(fname) or (_build.CSRC / fname).read_text()
        assert text.count(old) == 1, (fname, old)
        texts[fname] = text.replace(old, new)


# on the card: (B, S, K, D, Dc, F) — the six blocks the wide route took
# at a small B·S, K = 20 packed six to a 128-row tile on enough tiles for
# 128-row tiles, K past one and two tiles, K = 1, odd D and F (4-byte
# copies, an F tile ending inside an n8 tile), Dc = D off 4 (scalar
# center loads), D past 256
CARD_LINEAR = ((2, 37, 20, 256, 256, 256), (2, 21, 32, 131, 3, 256),
               (1, 16, 32, 259, 3, 512), (2, 19, 32, 99, 3, 192),
               (1, 13, 32, 195, 3, 384), (1, 9, 32, 387, 3, 768),
               (2, 1500, 20, 128, 128, 64), (1, 5, 200, 9, 3, 40),
               (1, 3, 130, 20, 5, 300), (1, 300, 1, 33, 3, 130),
               (3, 25, 13, 37, 37, 77), (2, 40, 20, 6, 6, 64),
               (1, 7, 32, 700, 3, 100))


@pytest.mark.cuda
def test_linear_kernel_matches_plain_version_on_card():
    """On a CUDA host: the linear route against its plain version within
    1e-4 (masked with all-dead subsets, and not), batched and per cloud,
    at both row tiles, repeats bit-equal, one ``gather_mlp_linear``
    launch (and one W split) a call; the library's route, rows, shared
    memory, plan and scratch bytes equal to tiling.py's; its first
    kernel, W's split, bit-equal to ``split_weights_ref``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.gather_mlp import ops
    from repro_torch.kernels.gather_mlp.ref import split_weights_ref
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    tiles = set()
    for b, s, k, d, dc, f in CARD_LINEAR:
        assert ops.library_route(k, d, dc, 0, f) == "linear"
        lp = tiling.linear_plan(b, s, k, f, sms)
        assert ops.plan(b, s, k, d, dc, 0, f, dev)["rows"] == lp["rows"]
        tiles.add(lp["rows"])
        for rows in (0, *tiling.ROWS):
            assert ops.library_smem(b, s, k, d, dc, 0, f, rows) == \
                tiling.linear_plan(b, s, k, f, sms, rows)["smem"]
            assert ops.library_linear_plan(b, s, k, d, dc, f, rows) == dict(
                tiling.linear_plan(b, s, k, f, sms, rows),
                x_tma=int(tiling.linear_x_tma(d)),
                scratch=tiling.linear_scratch(d, f))
        assert ops.library_scratch(b, s, k, d, dc, 0, f) == \
            tiling.linear_scratch(d, f)
        raw, ctr = r(b, s, k, d), r(b, s, dc)
        w, bias = r(d, f, scale=(2 / d) ** .5), r(f, scale=.1)
        assert torch.equal(ops.split_weights(w), split_weights_ref(w))
        mask = torch.rand(b, s, k, generator=g) < .7
        mask[:, ::5] = False                        # all-dead subsets
        mask = mask.to(dev)
        for m in (None, mask):
            want = gather_mlp_ref(raw, ctr, w, bias, mask=m)
            for rows in (None, *tiling.ROWS):
                before = (LAUNCHES["gather_mlp_linear"],
                          LAUNCHES["gather_mlp_split_weights"])
                got = gather_mlp(raw, ctr, w, bias, mask=m, rows=rows)
                torch.cuda.synchronize()
                assert (LAUNCHES["gather_mlp_linear"],
                        LAUNCHES["gather_mlp_split_weights"]) == (
                    before[0] + 1, before[1] + 1)
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
                assert torch.equal(
                    gather_mlp(raw, ctr, w, bias, mask=m, rows=rows), got)
            one = gather_mlp(raw[-1], ctr[-1], w, bias,
                             mask=None if m is None else m[-1])
            torch.testing.assert_close(one, want[-1], rtol=1e-4, atol=1e-4)
        assert bool((gather_mlp(raw, ctr, w, bias, mask=mask)[:, ::5]
                     == 0).all())
    assert tiles == set(tiling.ROWS), tiles
