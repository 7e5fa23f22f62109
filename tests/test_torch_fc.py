"""The port's FC stage against the JAX package: the plain versions of the
two kernels against the JAX oracles and the per-cloud Pallas kernels in
interpret mode, the kernel lowering, the batched FC dataflows on
structures built by JAX, the 3xTF32 arithmetic of the two kernels,
and, on a CUDA host, each kernel against its plain version.

The JAX package is imported inside the tests that compare with it, so
the card test (``pytest -m cuda tests/test_torch_fc.py``) also runs on a
host without JAX."""
import numpy as np
import pytest
import torch

from repro_torch.core.delta_comp import compensation
from repro_torch.core.mlp import apply_mlp
from repro_torch.core.pipeline import (FC_BACKENDS, LPCNConfig,
                                       fc_lpcn_batched,
                                       fc_traditional_batched, lpcn_block)
from repro_torch.engine import fc
from repro_torch.engine.params import (_mlp_from_numpy,
                                       structure_from_numpy)
from repro_torch.kernels.gather_mlp import gather_mlp, gather_mlp_ref
from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref

torch.set_num_threads(1)

TOL = 1e-5
BIG = 3.4e38


def _arrays(rng, *shapes, scale=1.0):
    return [np.asarray(rng.normal(size=s) * scale, np.float32)
            for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s,k,d,dc,h,f", [(24, 8, 6, 3, 16, 32),
                                          (10, 16, 13, 1, 32, 24)])
def test_gather_mlp_plain_matches_jax(s, k, d, dc, h, f, masked):
    import jax.numpy as jnp
    from repro.kernels.gather_mlp.gather_mlp import gather_mlp_pallas
    from repro.kernels.gather_mlp.ref import gather_mlp_ref as jgather_ref
    rng = np.random.default_rng(s + k)
    raw, ctr, w1, b1, w2, b2 = _arrays(rng, (s, k, d), (s, dc), (d, h), (h,),
                                       (h, f), (f,), scale=0.5)
    mask = None
    if masked:
        mask = rng.uniform(size=(s, k)) < 0.7
        mask[::4] = False                       # all-dead subsets
    jargs = [jnp.asarray(a) for a in (raw, ctr, w1, b1, w2, b2)]
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jgather_ref(*jargs, mask=jm))
    kern = np.asarray(gather_mlp_pallas(
        *jargs, ts=8, interpret=True,
        mask=None if jm is None else jm.astype(jnp.int32)))
    targs = [_t(a) for a in (raw, ctr, w1, b1, w2, b2)]
    tm = None if mask is None else _t(mask)
    got = gather_mlp_ref(*targs, mask=tm)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), kern, rtol=TOL, atol=TOL)
    # the wrapper takes the plain version for CPU tensors, batched or not
    assert torch.equal(gather_mlp(*targs, mask=tm), got)
    batched = gather_mlp(targs[0][None].repeat(2, 1, 1, 1),
                         targs[1][None].repeat(2, 1, 1), *targs[2:],
                         mask=None if tm is None else tm[None].repeat(2, 1, 1))
    assert torch.equal(batched[1], got)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hn,c,m,k,d,h,f", [(3, 16, 6, 8, 5, 16, 24),
                                            (2, 24, 9, 12, 16, 32, 16)])
def test_hub_reuse_plain_matches_jax(hn, c, m, k, d, h, f, masked):
    import jax.numpy as jnp
    from repro.kernels.hub_reuse.hub_reuse import hub_reuse_pallas
    from repro.kernels.hub_reuse.ref import hub_reuse_ref as jreuse_ref
    rng = np.random.default_rng(hn + c)
    pool, comp, w1, b1, w2, b2 = _arrays(rng, (hn, c, d), (hn, m, f), (d, h),
                                         (h,), (h, f), (f,), scale=0.5)
    slot = rng.integers(-1, c, (hn, m, k)).astype(np.int32)
    slot[:, ::3] = -1                           # subsets with no cached slot
    live = (rng.uniform(size=(hn, m, k)) < 0.8) if masked else None
    jargs = [jnp.asarray(a) for a in (pool, slot, comp, w1, b1, w2, b2)]
    jl = None if live is None else jnp.asarray(live)
    want = np.asarray(jreuse_ref(*jargs, live=jl))
    kern = np.asarray(hub_reuse_pallas(
        *jargs, interpret=True,
        live=None if jl is None else jl.astype(jnp.int32)))
    targs = [_t(a) for a in (pool, slot, comp, w1, b1, w2, b2)]
    tl = None if live is None else _t(live)
    got = hub_reuse_ref(*targs, live=tl).numpy()
    empty = want <= -BIG / 2
    assert empty.any() and (got[empty] == want[empty]).all()  # -BIG kept
    np.testing.assert_allclose(got[~empty], want[~empty], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got[~empty], kern[~empty], rtol=TOL,
                               atol=TOL)
    assert (kern[empty] == want[empty]).all()
    assert torch.equal(hub_reuse(*targs, live=tl), torch.from_numpy(got))


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device never
    reaches a plain-version fallback."""
    meta = torch.empty((1, 2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_mlp(meta, meta[..., 0, :1], None, None, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        hub_reuse(meta, None, None, None, None, None, None)


MLPS = {
    "prologue": ([7, 16, 16, 24], "per_layer"),
    "two_layer": ([7, 16, 24], "per_layer"),
    "one_layer": ([7, 24], "per_layer"),
    "block_end": ([7, 16, 24], "block_end"),
}


@pytest.mark.parametrize("name", sorted(MLPS))
def test_two_layer_form_is_exact(name):
    """The kernels' relu-sandwich form of any point-MLP computes the MLP."""
    import jax
    from repro.core.mlp import init_mlp as jinit_mlp
    dims, act = MLPS[name]
    jm = jinit_mlp(jax.random.PRNGKey(1), dims, act)
    mlp = _mlp_from_numpy(jax.tree.map(np.asarray, jm), "cpu")
    for layer in mlp.layers:
        layer.b += 0.1
    x = torch.randn(50, dims[0], generator=torch.Generator().manual_seed(0))
    prologue, (w1, b1, w2, b2) = fc.two_layer_form(mlp)
    h = x if prologue is None else prologue(x)
    got = torch.relu(h @ w1 + b1) @ w2 + b2
    want = apply_mlp(mlp, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


N = 128
SIZES = (128, 90, 0)


def _setup(mode, mlp_name, kind="sa", seed=0):
    """JAX-built stacked structures and inputs for a small block."""
    import jax
    import jax.numpy as jnp
    from repro.core.mlp import init_mlp as jinit_mlp
    from repro.core.pipeline import LPCNConfig as JCfg
    from repro.core.pipeline import structure_block as jstructure_block
    from repro.data.synthetic import make_cloud
    rng = np.random.default_rng(seed)
    xyz = np.zeros((len(SIZES), N, 3), np.float32)
    for i, n in enumerate(SIZES):
        if n:
            c = np.asarray(make_cloud(rng, n), np.float32)
            xyz[i] = np.concatenate([c, np.repeat(c[-1:], N - n, 0)])
    feats = np.concatenate([xyz, rng.normal(size=(len(SIZES), N, 4))
                            .astype(np.float32)], -1)
    cfg = dict(n_centers=32, k=8, island_size=8, island_capacity=16,
               mode=mode, overflow_frac=0.25, block_kind=kind)
    nv = jnp.asarray(SIZES, jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(SIZES))
    jst = jax.jit(jax.vmap(lambda x, k, n: jstructure_block(
        JCfg(**cfg), x, k, n_valid=n)))(jnp.asarray(xyz), keys, nv)
    dims, act = MLPS[mlp_name]
    f_in = 3 + 7 if kind == "sa" else 2 * 7
    jm = jinit_mlp(jax.random.PRNGKey(seed + 1), [f_in, *dims[1:]], act)
    jm = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jm)
    return cfg, xyz, feats, jst, jm


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("mlp_name,kind", [("prologue", "sa"),
                                           ("block_end", "sa"),
                                           ("two_layer", "edge")])
def test_fc_traditional_batched_on_jax_structures(mlp_name, kind, backend):
    import jax
    import jax.numpy as jnp
    from repro.core.pipeline import (
        fc_traditional_batched as jfc_traditional_batched)
    from repro.core.pipeline import get_fc_backend as jget_fc_backend
    cfg, xyz, feats, jst, jm = _setup("traditional", mlp_name, kind)
    cf = jnp.take_along_axis(jnp.asarray(feats), jst.center_idx[..., None],
                             axis=1)
    want = jax.jit(lambda x, f, s, c: jfc_traditional_batched(
        jm, x, f, s.nbr, s.center_xyz, c, kind,
        backend=jget_fc_backend("reference"), nbr_valid=s.nbr_valid))(
        jnp.asarray(xyz), jnp.asarray(feats), jst, cf)
    st = structure_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    mlp = _mlp_from_numpy(jax.tree.map(np.asarray, jm), "cpu")
    got = fc_traditional_batched(mlp, _t(xyz), _t(feats), st.nbr,
                                 st.center_xyz, _t(np.asarray(cf)), kind,
                                 backend=FC_BACKENDS.get(backend),
                                 nbr_valid=st.nbr_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("mlp_name,kind", [("prologue", "sa"),
                                           ("two_layer", "sa"),
                                           ("block_end", "sa"),
                                           ("one_layer", "edge")])
def test_fc_lpcn_batched_on_jax_structures(mlp_name, kind, backend):
    import jax
    import jax.numpy as jnp
    from repro.core.pipeline import LPCNConfig as JCfg
    from repro.core.pipeline import fc_lpcn_batched as jfc_lpcn_batched
    from repro.core.pipeline import get_fc_backend as jget_fc_backend
    cfg, xyz, feats, jst, jm = _setup("lpcn", mlp_name, kind, seed=1)
    cf = jnp.take_along_axis(jnp.asarray(feats), jst.center_idx[..., None],
                             axis=1)
    jcfg = JCfg(**cfg)
    want = jax.jit(lambda x, f, s, c: jfc_lpcn_batched(
        jm, x, f, s.nbr, s.center_xyz, s.islands, s.schedule, jcfg, c,
        backend=jget_fc_backend("reference"), nbr_valid=s.nbr_valid))(
        jnp.asarray(xyz), jnp.asarray(feats), jst, cf)
    st = structure_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    mlp = _mlp_from_numpy(jax.tree.map(np.asarray, jm), "cpu")
    got = fc_lpcn_batched(mlp, _t(xyz), _t(feats), st.nbr, st.center_xyz,
                          st.islands, st.schedule, LPCNConfig(**cfg),
                          _t(np.asarray(cf)), backend=FC_BACKENDS.get(backend),
                          nbr_valid=st.nbr_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert np.abs(np.asarray(want)).max() > 0       # not a trivial zero


@pytest.mark.parametrize("mode", ["linear", "mlp"])
@pytest.mark.parametrize("kind", ["sa", "edge"])
def test_compensation(mode, kind):
    import jax
    import jax.numpy as jnp
    from repro.core.delta_comp import compensation as jcompensation
    from repro.core.mlp import init_mlp as jinit_mlp
    jm = jinit_mlp(jax.random.PRNGKey(3), [10, 16, 24], "per_layer")
    jm = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jm)
    delta = np.random.default_rng(0).normal(
        size=(4, 6, 3 if kind == "sa" else 5)).astype(np.float32)
    want = jcompensation(jm, jnp.asarray(delta), mode, kind)
    got = compensation(_mlp_from_numpy(jax.tree.map(np.asarray, jm), "cpu"),
                       _t(delta), mode, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_lpcn_block_matches_jax():
    """The per-cloud entry (the batched code at B = 1) on a padded cloud."""
    import jax
    import jax.numpy as jnp
    from repro.core.pipeline import LPCNConfig as JCfg
    from repro.core.pipeline import lpcn_block as jlpcn_block
    cfg, xyz, feats, jst, jm = _setup("lpcn", "prologue", seed=2)
    key = jax.random.PRNGKey(5)
    want_f, want_c = jax.jit(lambda x, f, k: (lambda o: (
        o.features, o.center_idx))(jlpcn_block(JCfg(**cfg), jm, x, f, k,
                                               n_valid=SIZES[1])))(
        jnp.asarray(xyz[1]), jnp.asarray(feats[1]), key)
    out = lpcn_block(LPCNConfig(**cfg),
                     _mlp_from_numpy(jax.tree.map(np.asarray, jm), "cpu"),
                     _t(xyz[1]), _t(feats[1]),
                     _t(np.asarray(key).astype(np.int64)), n_valid=SIZES[1])
    np.testing.assert_array_equal(out.center_idx.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(out.features.numpy(), np.asarray(want_f),
                               rtol=TOL, atol=TOL)


def _tf32(x):
    """``cvt.rna.tf32.f32`` on float32: the low 13 mantissa bits rounded
    off, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc(x):
    """A TF32 operand as ``mma.sync`` reads an fp32 register: the low 13
    mantissa bits dropped (``split_fast``'s small part)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes, fast=False):
    """a·b as the tensor cores take it in TF32 with fp32 sums: one pass
    (big·big) or three (small·big + big·small + big·big), the small parts
    rounded (``split``) or truncated (``fast``: ``split_fast``)."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    small = _trunc if fast else _tf32
    return small(a - ab) @ bb + ab @ small(b - bb) + ab @ bb


# (S, K, D, Dc, H, F): the PointNet++(c) block widths at a small S, and
# the wide route at pointvector_l block 4 (the widest; at S = 4, H split
# across blocks) and dgcnn_c block 4 (K = 20, three subsets a 64-row
# tile; S = 400 fills 132 SMs, so H is not split)
TF32_BLOCKS = {"blk1": (16, 32, 65, 1, 64, 128),
               "blk2": (8, 64, 129, 1, 128, 256),
               "pointvector_l_blk4": (4, 32, 387, 3, 1536, 768),
               "dgcnn_c_blk4": (400, 20, 256, 256, 512, 256)}


@pytest.mark.parametrize("blk", sorted(TF32_BLOCKS))
def test_tf32x3_keeps_the_kernel_tolerance(blk):
    """The gather_mlp kernel's arithmetic, emulated: 3xTF32 stays within
    1e-5 · max(1, |ref|) of fp64 at the block widths and chip_smoke.py's
    input scales, and 1xTF32 breaks the 1e-4 limit the kernel is held
    to (so the cheaper route is not open).  A wide-route shape sums y in
    the route's order (``wide_plan`` on a card of 132 SMs): h a 32-column
    chunk at a time, each chunk's product added to its H split's partial
    y in fp32, the splits summed in order, then b2; small TF32 parts
    truncated (``split_fast``)."""
    from repro_torch.kernels.gather_mlp.ops import route, wide_plan
    import jax.numpy as jnp
    from repro.kernels.gather_mlp.ref import gather_mlp_ref as jgather_ref
    s, k, d, dc, h, f = TF32_BLOCKS[blk]
    rng = np.random.default_rng(k + d)
    n = lambda *shape, scale=1.0: (rng.standard_normal(shape)
                                   * scale).astype(np.float32)
    ops = (n(s, k, d), n(s, dc), n(d, h, scale=(2 / d) ** .5),
           n(h, scale=.1), n(h, f, scale=(2 / h) ** .5), n(f, scale=.1))
    raw, ctr, w1, b1, w2, b2 = (torch.from_numpy(a) for a in ops)
    ref = gather_mlp_ref(*(t.double() for t in (raw, ctr, w1, b1, w2, b2)))
    lim = max(1.0, ref.abs().max().item())
    want = np.asarray(jgather_ref(*(jnp.asarray(a) for a in ops)))
    np.testing.assert_allclose(want, ref.numpy(), rtol=TOL, atol=TOL * lim)
    x = torch.cat([raw[..., :dc] - ctr[:, None], raw[..., dc:]], dim=-1)
    wide = route(k, d, dc, h, f) == "wide"
    assert wide == blk.startswith(("pointvector", "dgcnn"))
    splits = [[slice(0, h)]]
    if wide:
        plan = wide_plan(1, s, k, d, dc, h, f, sms=132)
        chunks = [slice(c, c + 32) for c in range(0, h, 32)]
        cps = plan["cps"]
        splits = [chunks[i:i + cps] for i in range(0, len(chunks), cps)]
        assert len(splits) == plan["nsplit"]
        assert (len(splits) > 1) == (blk == "pointvector_l_blk4")
    err = {}
    for passes in (1, 3):
        y = None
        for part in splits:
            yp = torch.zeros(s, k, f)
            for c in part:
                hid = torch.relu(_mm_tf32(x, w1[:, c], passes, wide) + b1[c])
                yp = yp + _mm_tf32(hid, w2[c], passes, wide)
            y = yp if y is None else y + yp
        y = (y + b2).amax(1)
        err[passes] = (y.double() - ref).abs().max().item()
    assert err[3] <= 1e-5 * lim, err
    assert err[1] > 1e-4 * lim, err


# the blocks whose two-layer form takes the wide route: the widest of
# dgcnn_c, pointnext_s and pointvector_l, as (K, D, Dc, H, F) of their
# one-layer MLPs embedded split-sign (H = 2F), the form the engine lowered
# them to before the linear route (it now gives them H = 0)
WIDE_BLOCKS = {("dgcnn_c", 4): (20, 256, 256, 512, 256),
               ("pointnext_s", 3): (32, 131, 3, 512, 256),
               ("pointnext_s", 4): (32, 259, 3, 1024, 512),
               ("pointvector_l", 2): (32, 99, 3, 384, 192),
               ("pointvector_l", 3): (32, 195, 3, 768, 384),
               ("pointvector_l", 4): (32, 387, 3, 1536, 768)}


def test_gather_mlp_route_follows_shared_memory():
    """The wrapper's route at the shapes the engine's lowering gives every
    block of every model: the linear route (H = 0, one layer) at every
    block whose MLP is one linear map, the narrow route (h whole, from the
    kernel's shared-memory formulas) at every two-layer block, the wide
    route at none.  The six ``WIDE_BLOCKS`` in their split-sign two-layer
    form still take the wide route, and so does a two-layer call past
    every 64-row tile's room (D = 4000), which it takes by streaming x in
    slices."""
    from repro_torch.engine import init
    from repro_torch.kernels.gather_mlp.ops import route
    from repro_torch.models import MODEL_ZOO
    seen, one_map = {}, set()
    for name, (_, spec) in MODEL_ZOO.items():
        params = init(spec, device="cpu")
        for i, (b, mlp) in enumerate(zip(spec.blocks, params.blocks), 1):
            seen[name, i] = fc.dense_shape(b.kind, b.k, mlp)
            if mlp.activation == "block_end" or len(mlp.layers) == 1:
                one_map.add((name, i))
    routes = {key: route(*shp) for key, shp in seen.items()}
    assert "wide" not in routes.values()
    assert {key for key, way in routes.items() if way == "linear"} == \
        one_map == {key for key, shp in seen.items() if shp[3] == 0}
    assert all(way == "narrow" for key, way in routes.items()
               if key not in one_map)
    for key, (k, d, dc, h, f) in WIDE_BLOCKS.items():
        assert seen[key] == (k, d, dc, 0, f) and h == 2 * f
        assert route(k, d, dc, h, f) == "wide"
    assert seen["pointnet2_c", 1] == (32, 65, 1, 64, 128)
    assert seen["pointnet2_c", 2] == (64, 129, 1, 128, 256)
    assert route(32, 4000, 3, 512, 256) == "wide"


# (H, C, M, K, D, Hd, F): hub_reuse at the PointNet++(c) block widths and
# at pointvector_l block 4 (the widest Hd), at a small H and M
TF32_REUSE = {"blk1": (2, 64, 8, 32, 64, 64, 128),
              "blk2": (2, 128, 8, 64, 128, 128, 256),
              "pointvector_l_blk4": (1, 64, 8, 32, 387, 1536, 768)}


@pytest.mark.parametrize("blk", sorted(TF32_REUSE))
def test_tf32x3_keeps_the_hub_reuse_tolerance(blk):
    """The hub_reuse kernel's arithmetic, emulated: pool MLP in 3xTF32,
    then the max of y over the live slots plus comp, ``-BIG`` where none
    is live.  3xTF32 stays within 1e-5 · max(1, |ref|) of fp64 at
    chip_smoke.py's input scales with the ``-BIG`` rows identical, and
    1xTF32 breaks the kernel's 1e-4 limit at every width."""
    import jax.numpy as jnp
    from repro.kernels.hub_reuse.ref import hub_reuse_ref as jreuse_ref
    hn, c, m, k, d, hd, f = TF32_REUSE[blk]
    rng = np.random.default_rng(c + d)
    n = lambda *shape, scale=1.0: (rng.standard_normal(shape)
                                   * scale).astype(np.float32)
    slot = rng.integers(-1, c, (hn, m, k)).astype(np.int32)
    slot[:, ::3] = -1                           # subsets with no cached slot
    live = rng.uniform(size=(hn, m, k)) < 0.9
    ops = (n(hn, c, d), slot, n(hn, m, f), n(d, hd, scale=(2 / d) ** .5),
           n(hd, scale=.1), n(hd, f, scale=(2 / hd) ** .5), n(f, scale=.1))
    pool, tslot, comp, w1, b1, w2, b2 = (torch.from_numpy(a) for a in ops)
    tlive = torch.from_numpy(live)
    ref = hub_reuse_ref(*(t if t.dtype == torch.int32 else t.double()
                          for t in (pool, tslot, comp, w1, b1, w2, b2)),
                        live=tlive)
    empty = ref <= -BIG / 2
    assert empty.any() and not empty.all()
    lim = max(1.0, ref[~empty].abs().max().item())
    want = np.asarray(jreuse_ref(*(jnp.asarray(a) for a in ops),
                                 live=jnp.asarray(live)))
    assert (want[empty.numpy()] == np.float32(-BIG)).all()
    np.testing.assert_allclose(want[~empty.numpy()], ref[~empty].numpy(),
                               rtol=TOL, atol=TOL * lim)
    ok = (tslot >= 0) & tlive
    safe = tslot.clamp(0, c - 1).long()
    err = {}
    for passes in (1, 3):
        y = _mm_tf32(torch.relu(_mm_tf32(pool, w1, passes) + b1), w2,
                     passes) + b2                             # (H, C, F)
        g = torch.gather(y, 1, safe.reshape(hn, m * k, 1).expand(-1, -1, f))
        g = torch.where(ok[..., None], g.reshape(hn, m, k, f), -torch.inf)
        top = g.amax(2)
        got = torch.where(top == -torch.inf, torch.tensor(-BIG), top + comp)
        assert torch.equal(got[empty], ref[empty].float())
        err[passes] = (got[~empty].double() - ref[~empty]).abs().max().item()
    assert err[3] <= 1e-5 * lim, err
    assert err[1] > 1e-4 * lim, err


# gather_mlp on the card: (B, S, K, D, Dc, H, F) — K padded inside a
# 16-row group (8, 20), subsets that leave rows of a tile unused (48) or
# span several tiles (200), odd D and H/F off a multiple of 4 (4-byte
# weight copies), H above one 128-column chunk (h beside x), B·S leaving
# the last tile partial, and shapes large enough for 128-row tiles
CARD_DENSE = ((2, 24, 8, 9, 3, 16, 40), (3, 25, 20, 65, 1, 64, 128),
              (1, 13, 64, 129, 1, 128, 256), (2, 7, 48, 65, 3, 128, 40),
              (1, 5, 200, 9, 3, 16, 256), (2, 9, 20, 9, 1, 18, 37),
              (1, 6, 24, 33, 3, 200, 72), (2, 1100, 16, 9, 3, 16, 40),
              (2, 601, 20, 65, 1, 128, 256), (1, 515, 64, 129, 1, 128, 256))


# hub_reuse on the card: (B, H, C, M, K, D, Hd, F) — C off 16 (dgcnn_c's
# 40) and above 64 (128-row tiles), Hd over several 64-column chunks and
# off one, odd D (4-byte copies), F off the 64-column tile, K off 4 with
# M·K off 4 (liveness by bytes), the block-4 widths of dgcnn_c,
# pointnext_s and pointvector_l (block 3 too), and C past one launch's 128
# rows: 129 (a one-row second chunk) and 256 (pointnet2_c block 2 at
# cache_capacity_x = 4)
CARD_REUSE = ((2, 3, 16, 5, 8, 9, 16, 40), (2, 3, 24, 5, 7, 16, 72, 40),
              (2, 3, 40, 9, 20, 256, 512, 256),
              (1, 3, 100, 7, 12, 33, 200, 37), (2, 4, 128, 16, 64, 128, 128,
                                                 256),
              (2, 5, 64, 64, 32, 64, 64, 128),
              (2, 2, 64, 16, 32, 259, 1024, 512),
              (1, 2, 64, 16, 32, 195, 768, 384),
              (1, 2, 64, 16, 32, 387, 1536, 768),
              (2, 3, 129, 9, 20, 65, 128, 100),
              (2, 4, 256, 64, 64, 129, 128, 256))


# gather_mlp's wide route on the card: the six WIDE_BLOCKS at a small B
# and S (H split across blocks), then K over one 64-row tile (several
# tiles a subset), K = 8 (eight subsets a tile), H and F off a multiple of
# 4 and F off the 64-column tile, Dc = D (EdgeConv's centers); K = 20
# packed three to a tile on enough tiles to fill the card (no split), D
# past the PR 18 route's ~600 (x streamed in slices), F > 256 (three F
# tiles), a long subset with x streamed, and D = 300 streamed unsplit
CARD_WIDE = tuple((b, s, *shp) for (b, s), shp in zip(
    ((2, 37), (2, 21), (1, 16), (2, 19), (1, 13), (1, 9)),
    WIDE_BLOCKS.values())) + ((1, 3, 100, 99, 3, 384, 200),
                              (2, 11, 8, 200, 200, 400, 100),
                              (2, 5, 20, 131, 3, 510, 77),
                              (2, 200, 20, 256, 256, 512, 256),
                              (1, 9, 32, 700, 3, 1024, 512),
                              (2, 70, 20, 99, 3, 384, 600),
                              (1, 2, 150, 700, 5, 300, 300),
                              (3, 100, 32, 300, 3, 640, 130))


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """On a CUDA host: each kernel against its plain version, batched and
    per cloud, masked (all-dead subsets included) and not, repeats
    bit-equal; gather_mlp over its tile edges in both row tilings and on
    both routes (the library's route and wide plan equal to the
    wrapper's), hub_reuse over its own and past one launch's 128 cache
    rows (``python3 chip_smoke.py`` does the same at the model shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.gather_mlp.ops import (library_plan,
                                                    library_route, route,
                                                    row_tile, wide_plan)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    tilings, routes = set(), set()
    for b, s, k, d, dc, h, f in CARD_DENSE + CARD_WIDE:
        way = route(k, d, dc, h, f)
        assert library_route(k, d, dc, h, f) == way
        if way == "wide":
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            assert library_plan(b, s, k, d, dc, h, f) == wide_plan(
                b, s, k, d, dc, h, f, sms=sms)
        routes.add(way)
        before = LAUNCHES[f"gather_mlp_{way}"]
        raw, ctr = r(b, s, k, d), r(b, s, dc)
        w1, b1 = r(d, h, scale=(2 / d) ** .5), r(h, scale=.1)
        w2, b2 = r(h, f, scale=(2 / h) ** .5), r(f, scale=.1)
        mask = torch.rand(b, s, k, generator=g) < .7
        mask[:, ::5] = False                        # all-dead subsets
        mask = mask.to(dev)
        tilings.add(row_tile(b, s, k))
        for m in (None, mask):
            want = gather_mlp_ref(raw, ctr, w1, b1, w2, b2, mask=m)
            got = gather_mlp(raw, ctr, w1, b1, w2, b2, mask=m)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            assert torch.equal(gather_mlp(raw, ctr, w1, b1, w2, b2, mask=m),
                               got)
            one = gather_mlp(raw[-1], ctr[-1], w1, b1, w2, b2,
                             mask=None if m is None else m[-1])
            torch.testing.assert_close(one, want[-1], rtol=1e-4, atol=1e-4)
        assert bool((gather_mlp(raw, ctr, w1, b1, w2, b2, mask=mask)
                     [:, ::5] == 0).all())
        assert LAUNCHES[f"gather_mlp_{way}"] == before + 7
    assert tilings == {64, 128}, tilings
    assert routes == {"narrow", "wide"}, routes
    # the same shapes' one-layer calls take the linear route
    for b, s, k, d, dc, h, f in CARD_DENSE[:3] + CARD_WIDE[:3]:
        raw, ctr = r(b, s, k, d), r(b, s, dc)
        w, bias = r(d, f, scale=(2 / d) ** .5), r(f, scale=.1)
        before = LAUNCHES["gather_mlp_linear"]
        got = gather_mlp(raw, ctr, w, bias)
        torch.testing.assert_close(got, gather_mlp_ref(raw, ctr, w, bias),
                                   rtol=1e-4, atol=1e-4)
        assert LAUNCHES["gather_mlp_linear"] == before + 1
    for b, hn, c, m, k, d, h, f in CARD_REUSE:
        pool, comp = r(b, hn, c, d), r(b, hn, m, f)
        w1, b1 = r(d, h, scale=(2 / d) ** .5), r(h, scale=.1)
        w2, b2 = r(h, f, scale=(2 / h) ** .5), r(f, scale=.1)
        slot = torch.randint(-1, c, (b, hn, m, k), generator=g,
                             dtype=torch.int32)
        slot[:, :, ::4] = -1                        # no cached slot
        live = torch.rand(b, hn, m, k, generator=g) < .8
        live[:, :, 1::5] = False                    # cached, none live
        slot, live = slot.to(dev), live.to(dev)
        ops = (pool, slot, comp, w1, b1, w2, b2)
        before = LAUNCHES["hub_reuse"]
        for lv in (None, live):
            want = hub_reuse_ref(*ops, live=lv)
            got = hub_reuse(*ops, live=lv)
            _held_reuse(got, want)
            assert torch.equal(hub_reuse(*ops, live=lv), got)
            one = hub_reuse(pool[-1], slot[-1], comp[-1], w1, b1, w2, b2,
                            live=None if lv is None else lv[-1])
            _held_reuse(one, want[-1])
            assert torch.equal(one, got[-1])
        # six calls: one launch each (resident, which covers C in one,
        # or the layered route past 128 rows on so small a grid)
        from repro_torch.kernels.hub_reuse import ops as hub_ops
        pl = hub_ops.plan(b, hn, c, m, k, d, h, f, dev)
        assert pl["route"] == ("layered" if c > 128 else "resident")
        assert LAUNCHES["hub_reuse"] == before + 6


def _held_reuse(got, want):
    """hub_reuse against its plain version: the -BIG identity exactly
    (and present), the rest within 1e-4 · max(1, |want|) and rtol/atol
    1e-4."""
    empty = want <= -BIG / 2
    assert bool(empty.any()) and torch.equal(got[empty], want[empty])
    lim = 1e-4 * max(1.0, want[~empty].abs().max().item())
    assert (got[~empty] - want[~empty]).abs().max().item() <= lim
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
