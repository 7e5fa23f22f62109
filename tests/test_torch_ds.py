"""The port's other samplers and neighbor searches against the JAX package:
random and Morton-strided sampling, ball query, EdgePC's Morton window,
HgPCN's octree narrowing and Crescent's buckets, FPS hubs, every
registered sampler × neighbor pair through ``structure_block``, the
octree queries, ``np_morton_codes``, the registries' public extension
points and ``from_legacy`` / ``to_legacy`` — every integer output exactly
equal, padded and unpadded, ties included; and, on a CUDA host, one
PointNet++(c) forward per new neighbor through the "cuda" backend."""
from dataclasses import replace

import numpy as np
import pytest
import torch

try:        # the card tests at the end also run where JAX is not installed
    import jax
    import jax.numpy as jnp
    from repro.core import morton as jmorton
    from repro.core import neighbor as jnb
    from repro.core import octree as joct
    from repro.core import registry as jregistry
    from repro.core import sampling as jsamp
    from repro.core.islandize import islandize as jislandize
    from repro.core.pipeline import LPCNConfig as JCfg
    from repro.core.pipeline import structure_block as jstructure_block
except ImportError:
    jax = None
from repro_torch import engine
from repro_torch.core import morton, neighbor, octree, pipeline, registry
from repro_torch.core import sampling
from repro_torch.core.islandize import islandize
from repro_torch.core.pipeline import LPCNConfig, structure_block
from repro_torch.data.synthetic import make_cloud

torch.set_num_threads(1)

N = 192
SIZES = (192, 150, 97, 0)          # no padding, padding, an empty cloud
K = 16


def _clouds(seed=0, sizes=SIZES, ties=None):
    """Seeded clouds padded to N by repeating the last point.  ``ties``:
    "dups" duplicates every even point into the next row, "grid" puts the
    points on a 4^3 integer grid (many exact distance ties)."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((len(sizes), N, 3), np.float32)
    for i, n in enumerate(sizes):
        if n:
            c = np.asarray(make_cloud(rng, n), np.float32)
            if ties == "grid":
                c = rng.integers(0, 4, (n, 3)).astype(np.float32)
            xyz[i] = np.concatenate([c, np.repeat(c[-1:], N - n, 0)])
    if ties == "dups":
        xyz[:, 1::2] = xyz[:, 0::2]
    return xyz, np.asarray(sizes, np.int64)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "ui"
                            else a.copy())


def _eq(want, got, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if want.dtype != bool:
        want = want.astype(got.dtype)
    np.testing.assert_array_equal(want, got, err_msg=what)


def _trees(xyz, nv):
    """The same linear octrees from both packages (nv None: no padding)."""
    jt = jax.vmap(lambda x, n: joct.build(x, n_valid=n),
                  in_axes=(0, None if nv is None else 0))(
        jnp.asarray(xyz), None if nv is None else jnp.asarray(nv, jnp.int32))
    tt = octree.build(_t(xyz), n_valid=None if nv is None else _t(nv))
    return jt, tt


# (JAX, port) pairs of one neighbor search: f(tree, xyz, centers, n_valid)
NEIGHBORS = {
    "ball": (lambda t, x, c, n: jnb.ball_query(x, c, 0.2, K, n),
             lambda t, x, c, n: neighbor.ball_query(x, c, 0.2, K, n)),
    "ball_empty": (lambda t, x, c, n: jnb.ball_query(x, c, 0.03, K, n),
                   lambda t, x, c, n: neighbor.ball_query(x, c, 0.03, K, n)),
    "edgepc": (lambda t, x, c, n: jnb.knn_morton_window(t, x, c, K,
                                                        n_valid=n),
               lambda t, x, c, n: neighbor.knn_morton_window(t, x, c, K,
                                                             n_valid=n)),
    "edgepc_w32": (
        lambda t, x, c, n: jnb.knn_morton_window(t, x, c, K, window=32,
                                                 n_valid=n),
        lambda t, x, c, n: neighbor.knn_morton_window(t, x, c, K, window=32,
                                                      n_valid=n)),
    "crescent": (lambda t, x, c, n: jnb.knn_kdtree_approx(x, c, K,
                                                          n_valid=n),
                 lambda t, x, c, n: neighbor.knn_kdtree_approx(x, c, K,
                                                               n_valid=n)),
    "crescent_l16": (
        lambda t, x, c, n: jnb.knn_kdtree_approx(x, c, K, leaf=16,
                                                 n_valid=n),
        lambda t, x, c, n: neighbor.knn_kdtree_approx(x, c, K, leaf=16,
                                                      n_valid=n)),
    **{f"hgpcn_l{lv}": (
        lambda t, x, c, n, lv=lv: jnb.knn_octree(t, x, c, K, level=lv,
                                                 n_valid=n),
        lambda t, x, c, n, lv=lv: neighbor.knn_octree(t, x, c, K, level=lv,
                                                      n_valid=n))
       for lv in (1, 2, 3)},
}


TIES = (None, "dups", "grid")


@pytest.fixture(scope="module")
def jax_neighbors():
    """Every JAX neighbor search of ``NEIGHBORS`` on the clouds of each
    ``TIES`` kind, padded and not, in one jit (one compile, not 54)."""
    xyz = np.concatenate([_clouds(1, ties=t)[0] for t in TIES])
    nv = np.tile(np.asarray(SIZES, np.int32), len(TIES))

    def run(x, n_valid):
        def one(x, n):
            t = joct.build(x, n_valid=n)
            return {m: jf(t, x, x[::5], n) for m, (jf, _) in NEIGHBORS.items()}
        return jax.vmap(one, in_axes=(0, None if n_valid is None else 0))(
            x, n_valid)

    out = jax.jit(lambda x, n: (run(x, None), run(x, n)))(jnp.asarray(xyz),
                                                          jnp.asarray(nv))
    return {False: jax.tree.map(np.asarray, out[0]),
            True: jax.tree.map(np.asarray, out[1])}


@pytest.mark.parametrize("ties", TIES)
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("method", list(NEIGHBORS))
def test_neighbor_matches_jax(jax_neighbors, method, padded, ties):
    xyz, nv = _clouds(1, ties=ties)
    nv = nv if padded else None
    centers = xyz[:, ::5]                    # 39 centers, some padding rows
    _, tt = _trees(xyz, nv)
    i = TIES.index(ties) * len(SIZES)
    want = jax_neighbors[padded][method][i:i + len(SIZES)]
    got = NEIGHBORS[method][1](tt, _t(xyz), _t(centers),
                               None if nv is None else _t(nv))
    _eq(want, got, method)
    if padded:       # never a padding row (the empty cloud has no rows)
        assert (got[:3] < _t(nv[:3])[:, None, None]).all()


def _members(tt, xyz, centers, nv, level):
    """Valid points in each center's 27-node neighbourhood at ``level``."""
    lo, hi = neighbor.masked_bounds(xyz, nv)
    keys = morton.node_key(morton.morton_codes(centers, lo=lo, hi=hi), level)
    nkeys = octree.adjacent_node_keys(keys, level)
    pk = tt.node_keys(level)
    ok = torch.arange(N) < nv[:, None]
    return ((pk[:, None, :, None] == nkeys[:, :, None, :]).any(-1)
            & ok[:, None, :]).sum(-1)


def test_hgpcn_levels_take_both_rows():
    """The levels of ``test_neighbor_matches_jax`` reach both kinds of
    row: narrowed (>= k candidates) and the global fallback (< k)."""
    xyz, nv = _clouds(1)
    xyz, nv = xyz[:3], nv[:3]
    _, tt = _trees(xyz, nv)
    centers = _t(xyz[:, ::5])
    counts = {lv: _members(tt, _t(xyz), centers, _t(nv), lv)
              for lv in (1, 2, 3)}
    assert (counts[1] >= K).all()
    assert (counts[3] < K).any() and (counts[2] >= K).any()


@pytest.mark.parametrize("method", ["ball", "edgepc", "crescent",
                                    "hgpcn_l2"])
def test_padded_neighbor_equals_unpadded_prefix(method):
    xyz, nv = _clouds(2, (192, 130, 70, 0))
    centers = xyz[:, :40:2]
    _, tt = _trees(xyz, nv)
    tf = NEIGHBORS[method][1]
    padded = tf(tt, _t(xyz), _t(centers), _t(nv))
    for i, n in enumerate(nv[:3]):
        _, short_t = _trees(xyz[i:i + 1, :n], None)
        short = tf(short_t, _t(xyz[i:i + 1, :n]), _t(centers[i:i + 1]),
                   None)
        assert torch.equal(padded[i], short[0]), (method, i)


def test_hgpcn_level_follows_padded_n():
    """HgPCN's narrowing level comes from the padded N in both packages
    (``registry._hgpcn``), so a padded cloud can narrow at another level
    than its unpadded prefix and gather other neighbors: the port equals
    JAX on the padded cloud, where the ragged contract does not hold."""
    rng = np.random.default_rng(2)
    n, n_pad, k = 200, 1024, 16             # level 1 unpadded, 2 padded
    c = np.asarray(make_cloud(rng, n), np.float32)
    xyz = np.concatenate([c, np.repeat(c[-1:], n_pad - n, 0)])[None]
    centers = xyz[:, :n:3]
    kw = dict(k=k, radius=0.2, octree_level=4)
    jt, tt = _trees(xyz, [n])
    want = jax.vmap(lambda t, x, ce, nv: jregistry.NEIGHBORS.get("hgpcn")(
        x, ce, tree=t, n_valid=nv, **kw))(
        jt, jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray([n]))
    hg = registry.NEIGHBORS.get("hgpcn")
    got = hg(_t(xyz), _t(centers), tree=tt, n_valid=_t([n]), **kw)
    _eq(want, got)
    _, st = _trees(xyz[:, :n], None)
    short = hg(_t(xyz[:, :n]), _t(centers), tree=st, n_valid=None, **kw)
    assert not torch.equal(got, short)


@pytest.mark.parametrize("padded", [False, True])
def test_random_sampling(padded):
    """Per-cloud keys; slots past a short valid count repeat pick 0."""
    sizes = (192, 150, 20, 0)
    nv = np.asarray(sizes, np.int64)
    keys = jax.random.split(jax.random.PRNGKey(3), len(sizes))
    f = jax.vmap(lambda k, n: jsamp.random_sampling(k, N, 48, n),
                 in_axes=(0, 0 if padded else None))
    want = f(keys, jnp.asarray(nv, jnp.int32) if padded else None)
    got = sampling.random_sampling(_t(keys), N, 48,
                                   _t(nv) if padded else None)
    _eq(want, got)
    if padded:
        assert (got < _t(nv).clamp(min=1)[:, None]).all()
        short = sampling.random_sampling(_t(keys[1:2]), 150, 48)
        assert torch.equal(got[1], short[0])


@pytest.mark.parametrize("padded", [False, True])
def test_morton_strided_sampling(padded):
    xyz, nv = _clouds(3, (192, 150, 20, 0))
    jt, tt = _trees(xyz, nv if padded else None)
    f = jax.vmap(lambda o, n: jsamp.morton_strided_sampling(o, 48, n),
                 in_axes=(0, 0 if padded else None))
    want = f(jt.order, jnp.asarray(nv, jnp.int32) if padded else None)
    got = sampling.morton_strided_sampling(tt.order, 48,
                                           _t(nv) if padded else None)
    _eq(want, got)
    if padded:
        _, short = _trees(xyz[1:2, :150], None)
        assert torch.equal(got[1], sampling.morton_strided_sampling(
            short.order, 48)[0])


@pytest.mark.parametrize("padded", [False, True])
def test_islandize_fps_hubs(padded):
    xyz, _ = _clouds(5)
    centers = xyz[:, :64]
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    cv = np.arange(64)[None] < np.array([64, 40, 17, 0])[:, None]
    nhv = np.maximum(cv.sum(1) // 8, 1)
    if not padded:
        cv = nhv = None
    want = jax.jit(jax.vmap(lambda c, k, v, h: jislandize(
        c, 8, level=4, capacity=16, hub_select="fps", key=k,
        center_valid=v, n_hubs_valid=h),
        in_axes=(0, 0, None if cv is None else 0,
                 None if nhv is None else 0)))(
        jnp.asarray(centers), keys, None if cv is None else jnp.asarray(cv),
        None if nhv is None else jnp.asarray(nhv, jnp.int32))
    got = islandize(_t(centers), 8, level=4, capacity=16, hub_select="fps",
                    key=_t(keys), center_valid=None if cv is None
                    else _t(cv), n_hubs_valid=None if nhv is None
                    else _t(nhv))
    for f in ("members", "hub", "solo", "round_of"):
        _eq(getattr(want, f), getattr(got, f), f)
    with pytest.raises(ValueError, match="hub_select"):
        islandize(_t(centers), 8, hub_select="kmeans", key=_t(keys))


PAIRS = [(s, n) for s in ("fps", "random", "morton", "all")
         for n in ("pointacc", "hgpcn", "edgepc", "crescent", "ball")]


def _pair_cfg(sampler, method):
    """The pairs of the FPS sampler also take FPS hubs."""
    return dict(n_centers=48, k=12, island_size=8, island_capacity=16,
                sampler=sampler, neighbor=method, radius=0.3,
                hub_select="fps" if sampler == "fps" else "random")


@pytest.fixture(scope="module")
def pair_batch():
    """A padded batch with an empty cloud, and JAX's structure_block of
    every pair on it, in one jit (one compile, not 20)."""
    xyz, nv = _clouds(8)
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    jst = jax.jit(jax.vmap(lambda x, k, n: [jstructure_block(
        JCfg(**_pair_cfg(*p)), x, k, n_valid=n) for p in PAIRS]))(
        jnp.asarray(xyz), keys, jnp.asarray(nv, jnp.int32))
    return xyz, nv, keys, jst


@pytest.mark.parametrize("sampler,method", PAIRS)
def test_structure_block_every_pair(pair_batch, sampler, method):
    """Stage 1 exactly equal for every registered sampler × neighbor pair
    on a padded batch with an empty cloud."""
    assert set(registry.SAMPLERS.names()) == {p[0] for p in PAIRS}
    assert set(registry.NEIGHBORS.names()) == {p[1] for p in PAIRS}
    xyz, nv, keys, jsts = pair_batch
    jst = jsts[PAIRS.index((sampler, method))]
    got = structure_block(LPCNConfig(**_pair_cfg(sampler, method)), _t(xyz),
                          _t(keys), n_valid=_t(nv))
    for f in ("center_idx", "nbr", "center_valid", "nbr_valid"):
        _eq(getattr(jst, f), getattr(got, f), f)
    for f in ("members", "hub", "solo", "round_of"):
        _eq(getattr(jst.islands, f), getattr(got.islands, f), f)
    for f in ("pool_ids", "reuse_slot", "is_first", "subset_valid",
              "pos_live"):
        _eq(getattr(jst.schedule, f), getattr(got.schedule, f), f)


@pytest.mark.parametrize("box", [False, True])
def test_np_morton_codes(box):
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(5, 40, 3)).astype(np.float32)
    kw = dict(lo=np.full(3, -1.0), hi=np.full(3, 1.5)) if box else {}
    for depth in (4, 10):
        want = jmorton.np_morton_codes(pts, depth, **kw)
        got = morton.np_morton_codes(pts, depth, **kw)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


def test_octree_queries():
    """node_keys, node_range (sentinel keys wrap at 32 bits), contains
    and prune, batched over clouds, against the JAX tree per cloud."""
    xyz, nv = _clouds(7)
    jt, tt = _trees(xyz, nv)
    rng = np.random.default_rng(7)
    for level in (2, 5, 10):
        _eq(jax.vmap(lambda t: t.node_keys(level))(jt), tt.node_keys(level))
        keys = np.concatenate([
            np.asarray(jt.codes[:, ::9]) >> (3 * (10 - level)),
            rng.integers(0, 8 ** level, (4, 6)),
            np.full((4, 1), jmorton.SENTINEL >> (3 * (10 - level)))], 1)
        want = jax.vmap(lambda t, k: t.node_range(k, level))(
            jt, jnp.asarray(keys, jnp.uint32))
        got = tt.node_range(_t(keys), level)
        _eq(want[0], got[0]), _eq(want[1], got[1])
    q = np.concatenate([np.asarray(jt.codes[:, ::7]),
                        rng.integers(0, 2 ** 30, (4, 12))], 1)
    want = jax.vmap(lambda t, c: t.contains(c))(jt, jnp.asarray(q,
                                                                jnp.uint32))
    got = tt.contains(_t(q))
    _eq(want[0], got[0]), _eq(want[1], got[1])
    assert got[0].any() and not got[0].all()
    keep = np.sort(rng.choice(N, (4, 30)), 1)
    jp = jax.vmap(joct.prune)(jt, jnp.asarray(keep))
    tp = octree.prune(tt, _t(keep))
    _eq(jp.codes, tp.codes), _eq(jp.order, tp.order)
    assert tp.depth == jp.depth


def test_register_components():
    """The public extension points: a registered sampler and neighbor run
    through the engine; a duplicate name and an unknown name raise; a
    component without n_valid gets the named hint through the batched
    engine."""
    from repro_torch.models.pointnet2 import POINTNET2_C

    @engine.register_sampler("test_first_n")
    def first_n(xyz, *, tree, n_centers, key, n_valid=None):
        return torch.arange(n_centers).expand(xyz.shape[0], n_centers)

    engine.register_neighbor("test_knn", registry.NEIGHBORS.get("pointacc"))
    engine.register_sampler("test_no_nv",
                            lambda xyz, *, tree, n_centers, key:
                            torch.zeros(xyz.shape[0], n_centers,
                                        dtype=torch.int64))
    engine.register_fc_backend("test_ref",
                               registry.FC_BACKENDS.get("reference"))
    try:
        spec = replace(POINTNET2_C, blocks=(engine.BlockSpec(
            16, 4, (8, 16), sampler="test_first_n", neighbor="test_knn"),),
            global_mlp=(16,), head_dims=(8,), n_classes=3)
        params = engine.init(spec, device="cpu")
        xyz = np.random.default_rng(0).normal(size=(2, 40, 3)).astype(
            np.float32)
        out = engine.apply(params, xyz, spec=spec, fc_backend="test_ref",
                           device="cpu")
        ref = engine.apply(params, xyz, spec=replace(spec, blocks=(
            engine.BlockSpec(16, 4, (8, 16), sampler="test_first_n"),)),
            device="cpu")
        assert torch.equal(out, ref)
        with pytest.raises(ValueError, match="duplicate sampler "
                                             "'test_first_n'"):
            engine.register_sampler("test_first_n", first_n)
        with pytest.raises(ValueError, match="duplicate neighbor 'ball'"):
            engine.register_neighbor("ball", first_n)
        with pytest.raises(KeyError, match="unknown neighbor 'nope'"):
            engine.apply(params, xyz, spec=replace(spec, blocks=(
                engine.BlockSpec(16, 4, (8, 16), neighbor="nope"),)),
                device="cpu")
        with pytest.raises(KeyError, match="unknown fc_backend"):
            engine.PCNEngine(spec, fc_backend="nope", device="cpu")
        cfg = LPCNConfig(n_centers=8, k=4, sampler="test_no_nv")
        cidx, _ = pipeline.data_structuring(cfg, _t(xyz), _t(
            jax.random.split(jax.random.PRNGKey(0), 2)))
        assert cidx.shape == (2, 8)
        with pytest.raises(TypeError, match="sampler 'test_no_nv' does not "
                                            "accept n_valid"):
            engine.apply(params, xyz, spec=replace(spec, blocks=(
                engine.BlockSpec(8, 4, (8, 16), sampler="test_no_nv"),)),
                device="cpu")
    finally:
        for reg, name in ((registry.SAMPLERS, "test_first_n"),
                          (registry.SAMPLERS, "test_no_nv"),
                          (registry.NEIGHBORS, "test_knn"),
                          (registry.FC_BACKENDS, "test_ref")):
            reg._entries.pop(name, None)


@pytest.mark.parametrize("arch", ["pointnet2", "pointnext", "pointvector"])
def test_legacy_round_trip(arch):
    """from_legacy / to_legacy over the three layouts, as JAX's."""
    from repro.engine import params as jparams
    from repro_torch.models import MODEL_ZOO
    spec = {"pointnet2": "pointnet2_c", "pointnext": "pointnext_s",
            "pointvector": "pointvector_l"}[arch]
    p = engine.init(MODEL_ZOO[spec][1], device="cpu")
    legacy = engine.to_legacy(p, arch)
    jlegacy = jparams.to_legacy(jparams.PCNParams(*(
        getattr(p, f) for f in ("blocks", "head", "global_mlp", "stem",
                                "extras"))), arch)
    assert set(legacy) == set(jlegacy)
    back = engine.from_legacy(legacy)
    assert back == p
    assert engine.from_legacy(back) is back
    if arch == "pointnet2":
        assert legacy["global"] is p.global_mlp and not p.extras
    else:
        assert back.extras == p.extras and back.stem is p.stem


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["hgpcn", "edgepc", "crescent", "ball"])
def test_new_neighbors_on_card(method):
    """On a CUDA host: PointNet++(c) at full width under each new neighbor,
    one ragged (4, 1024) lpcn batch through the "cuda" backend within
    1e-4·max(1, max|ref|) of the "reference" backend on the card, one
    gather_mlp and one hub_reuse launch a block, and stage 1 on the card
    equal to the CPU's (``python3 chip_smoke.py`` does the same at B = 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import kernels
    from repro_torch.engine import archs
    from repro_torch.models.pointnet2 import POINTNET2_C
    spec = replace(POINTNET2_C, blocks=tuple(
        replace(b, neighbor=method) for b in POINTNET2_C.blocks))
    rng = np.random.default_rng(0)
    clouds = [make_cloud(rng, n) for n in (1024, 900, 700, 512)]
    batch = engine.Batch.from_clouds(clouds, key=np.asarray(
        [[0, i] for i in range(4)]), n_pad=1024, device="cuda")
    eng = engine.PCNEngine(spec, fc_backend="cuda")
    params = eng.init(seed=0)
    kernels.reset_launch_counts()
    out = eng.apply(params, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["gather_mlp"] == counts["hub_reuse"] == len(spec.blocks)
    want = engine.PCNEngine(spec, fc_backend="reference").apply(params, batch)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max() <= 1e-4 * max(1.0, want.abs().max())
    ctx = archs.EngineCtx.make("lpcn", "cuda")
    card, _ = archs._structure_stack_b(spec, ctx, batch.xyz, batch.keys,
                                       batch.n_valid)
    host_b = batch.to("cpu")
    host, _ = archs._structure_stack_b(spec, ctx, host_b.xyz, host_b.keys,
                                       host_b.n_valid)
    for c, h in zip(card, host):
        assert torch.equal(c.nbr.cpu(), h.nbr)
        assert torch.equal(c.islands.members.cpu(), h.islands.members)
