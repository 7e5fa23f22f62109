"""The port's workload reports and per-cloud block API against the JAX
package: ``analyze`` counters exactly equal per cloud, the report's
derived savings, ``overlap_histogram`` within 1e-6, ``lpcn_block`` with
its report, the per-cloud FC entries, and ``apply_with_reports`` on a
two-block PointNet++ with padding for every DS variant of the paper's
baselines (logits within 1e-4, counters exactly equal, and equal with
and without padding)."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import pipeline as jpipeline
from repro.core import workload as jworkload
from repro.core.mlp import init_mlp as jinit_mlp
from repro.data.synthetic import make_cloud
from repro.models import pointnet2 as jpointnet2
from repro_torch import engine
from repro_torch.core import pipeline, workload
from repro_torch.core.neighbor import knn_bruteforce
from repro_torch.core.sampling import farthest_point_sampling
from repro_torch.engine.params import _mlp_from_numpy, structure_from_numpy
from repro_torch.models import pointnet2

torch.set_num_threads(1)

COUNTERS = workload.COUNTERS
BLOCKS = ((48, 8, (16, 16, 32)), (16, 8, (32, 32, 48)))
SIZES = (160, 120, 75, 0)          # full, padded, padded, an empty fill
# the DS variants of the paper's baselines: (sampler, neighbor, isl_kw)
VARIANTS = {
    "pointacc": ("fps", "pointacc", {}),
    "hgpcn": ("fps", "hgpcn", {}),
    "edgepc": ("fps", "edgepc", {}),
    "crescent": ("fps", "crescent", {}),
    "ball": ("fps", "ball", {}),
    "random": ("random", "pointacc", {}),
    "fractal": ("morton", "edgepc", {}),
    "fps_hubs": ("fps", "pointacc", {"hub_select": "fps"}),
}


def _spec(base, mk, sampler, method):
    return replace(base, blocks=tuple(mk(*b, sampler=sampler,
                                         neighbor=method) for b in BLOCKS),
                   global_mlp=(32, 64), head_dims=(32,), n_classes=10)


def _counters(report):
    return np.stack([np.asarray(getattr(report, c)) for c in COUNTERS])


@pytest.fixture(scope="module")
def variants():
    """One ragged batch, JAX weights (nonzero biases) carried across, and
    JAX's ``apply_with_reports`` of every variant in one jit."""
    rng = np.random.default_rng(0)
    clouds = [np.asarray(make_cloud(rng, n), np.float32) if n
              else np.zeros((0, 3), np.float32) for n in SIZES]
    keys = jax.random.split(jax.random.PRNGKey(1), len(SIZES))
    jspec = _spec(jpointnet2.POINTNET2_C, jengine.BlockSpec, "fps",
                  "pointacc")
    jp = jengine.init(jax.random.PRNGKey(0), jspec)
    jp = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jp)
    tp = engine.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jb = jengine.Batch.from_clouds(clouds, key=keys)
    tb = engine.Batch.from_clouds(clouds, key=np.asarray(keys),
                                  device="cpu")
    want = jax.jit(lambda p, b: {
        name: jengine.apply_with_reports(
            p, b, spec=_spec(jpointnet2.POINTNET2_C, jengine.BlockSpec, s,
                             m), isl_kw=kw)
        for name, (s, m, kw) in VARIANTS.items()})(jp, jb)
    return clouds, np.asarray(keys), tp, tb, jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_apply_with_reports_matches_jax(variants, variant):
    """Logits within 1e-4 of JAX, the (B,) counters exactly equal."""
    clouds, keys, tp, tb, want = variants
    sampler, method, kw = VARIANTS[variant]
    spec = _spec(pointnet2.POINTNET2_C, engine.BlockSpec, sampler, method)
    logits, report = engine.apply_with_reports(tp, tb, spec=spec, isl_kw=kw,
                                               device="cpu")
    jlogits, jreport = want[variant]
    assert logits.shape == (len(SIZES), 10)
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(_counters(report), _counters(jreport))
    assert report.k == jreport.k == BLOCKS[0][1]
    assert (report.baseline_fetches > 0).all()
    # apply's logits are the same forward's
    np.testing.assert_array_equal(
        logits.numpy(), engine.apply(tp, tb, spec=spec, isl_kw=kw,
                                     device="cpu").numpy())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reports_equal_with_and_without_padding(variants, variant):
    """Each cloud's counters in the padded batch equal ``apply_single``'s
    on its unpadded prefix (0-d counters)."""
    clouds, keys, tp, tb, _ = variants
    sampler, method, kw = VARIANTS[variant]
    eng = engine.PCNEngine(_spec(pointnet2.POINTNET2_C, engine.BlockSpec,
                                 sampler, method), isl_kw=kw, device="cpu")
    logits, report = engine.apply_with_reports(
        tp, tb, spec=eng.spec, isl_kw=kw, device="cpu")
    for i, c in enumerate(clouds[:3]):
        one, rep = eng.apply_single(tp, c, key=keys[i], with_report=True)
        np.testing.assert_allclose(one.numpy(), logits[i].numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert all(getattr(rep, f).dim() == 0 for f in COUNTERS)
        np.testing.assert_array_equal(_counters(rep),
                                      _counters(report)[:, i])


def test_traditional_mode_has_no_report(variants):
    clouds, keys, tp, tb, _ = variants
    spec = _spec(pointnet2.POINTNET2_C, engine.BlockSpec, "fps", "pointacc")
    logits, report = engine.apply_with_reports(
        tp, tb, spec=spec, mode="traditional", device="cpu")
    assert report is None and logits.shape == (len(SIZES), 10)
    out, rep = engine.apply_single(tp, clouds[0], key=keys[0], spec=spec,
                                   mode="traditional", with_report=True,
                                   device="cpu")
    assert rep is None
    # legacy param dicts are accepted, as in the JAX package
    legacy = engine.to_legacy(tp, "pointnet2")
    np.testing.assert_array_equal(
        engine.apply(legacy, tb, spec=spec, mode="traditional",
                     device="cpu").numpy(), logits.numpy())


CFG = dict(n_centers=48, k=12, island_size=8, island_capacity=16,
           neighbor="ball", radius=0.25)


@pytest.fixture(scope="module")
def blocks():
    """A padded batch (an empty cloud too) and JAX's ``lpcn_block`` with
    its report on every cloud, in one jit."""
    rng = np.random.default_rng(5)
    n = 192
    xyz = np.zeros((4, n, 3), np.float32)
    for i, m in enumerate((192, 150, 97, 0)):
        if m:
            c = np.asarray(make_cloud(rng, m), np.float32)
            xyz[i] = np.concatenate([c, np.repeat(c[-1:], n - m, 0)])
    nv = np.asarray((192, 150, 97, 0), np.int64)
    feats = np.concatenate([xyz, rng.normal(size=(4, n, 2)).astype(
        np.float32)], -1)
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    jm = jinit_mlp(jax.random.PRNGKey(3), [3 + 5, 16, 24], "per_layer")
    jm = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jm)
    fields = ("center_idx", "center_xyz", "features", "islands", "schedule",
              "nbr_idx", "report", "center_valid")
    out = jax.jit(jax.vmap(lambda x, f, k, v: (lambda o: {
        n: getattr(o, n) for n in fields})(jpipeline.lpcn_block(
            jpipeline.LPCNConfig(**CFG), jm, x, f, k, with_report=True,
            n_valid=v))))(jnp.asarray(xyz), jnp.asarray(feats), keys,
                          jnp.asarray(nv, jnp.int32))
    tm = _mlp_from_numpy(jax.tree.map(np.asarray, jm), "cpu")
    return xyz, feats, nv, np.asarray(keys), jm, tm, jpipeline.BlockOutput(
        **jax.tree.map(np.asarray, out))


def _tt(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "ui"
                            else a.copy())


def test_analyze_matches_jax(blocks):
    """``analyze`` on the port's own batched structure and on JAX's
    (converted) equals JAX's per-cloud counters."""
    xyz, feats, nv, keys, jm, tm, jout = blocks
    st = pipeline.structure_block(pipeline.LPCNConfig(**CFG), _tt(xyz),
                                  _tt(keys), n_valid=_tt(nv))
    conv = structure_from_numpy(jpipeline.BlockStructure(
        jout.center_idx, jout.center_xyz, jout.nbr_idx, jout.islands,
        jout.schedule, jout.center_valid, None), device="cpu")
    for s in (st, conv):
        rep = workload.analyze(s.islands, s.schedule, CFG["k"])
        assert all(getattr(rep, f).shape == (4,) for f in COUNTERS)
        np.testing.assert_array_equal(_counters(rep), _counters(jout.report))
    assert int(rep.n_subsets[3]) == 0 and int(rep.n_subsets[0]) > 0


def test_lpcn_block_with_report_matches_jax(blocks):
    """The per-cloud entry: a BlockOutput with per-cloud structure,
    features within 1e-5 and a report of 0-d counters."""
    xyz, feats, nv, keys, jm, tm, jout = blocks
    for i in range(3):
        out = pipeline.lpcn_block(pipeline.LPCNConfig(**CFG), tm,
                                  _tt(xyz[i]), _tt(feats[i]), _tt(keys[i]),
                                  with_report=True, n_valid=int(nv[i]))
        assert isinstance(out, pipeline.BlockOutput)
        for f, j in (("center_idx", jout.center_idx), ("nbr_idx",
                                                        jout.nbr_idx),
                     ("center_valid", jout.center_valid)):
            np.testing.assert_array_equal(getattr(out, f).numpy(), j[i])
        np.testing.assert_array_equal(out.islands.members.numpy(),
                                      jout.islands.members[i])
        np.testing.assert_array_equal(out.schedule.reuse_slot.numpy(),
                                      jout.schedule.reuse_slot[i])
        np.testing.assert_allclose(out.features.numpy(), jout.features[i],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(_counters(out.report),
                                      _counters(jout.report)[:, i])
    trad = pipeline.lpcn_block(
        pipeline.LPCNConfig(**{**CFG, "mode": "traditional"}), tm,
        _tt(xyz[0]), _tt(feats[0]), _tt(keys[0]), with_report=True)
    assert trad.report is None and trad.islands is None


def test_per_cloud_fc_entries_match_jax(blocks):
    """``fc_traditional``, ``fc_lpcn`` and ``compute_block_features`` on
    one cloud's structure (built by JAX) within 1e-5 of JAX: the last two
    against ``lpcn_block``'s features (every center of the cloud valid),
    the first against JAX's ``fc_traditional``."""
    xyz, feats, nv, keys, jm, tm, jout = blocks
    i = 1
    assert jout.center_valid[i].all()
    pick = lambda t: jax.tree.map(lambda a: a[i], t)          # noqa: E731
    tst = _first_structure(jpipeline.BlockStructure(
        jout.center_idx[i], jout.center_xyz[i], jout.nbr_idx[i],
        pick(jout.islands), pick(jout.schedule), jout.center_valid[i],
        jout.nbr_idx[i] >= 0))
    tcfg = pipeline.LPCNConfig(**CFG)
    x, f = _tt(xyz[i]), _tt(feats[i])
    cf = f[tst.center_idx]
    trad = jax.jit(lambda x, f, n, c, cf: jpipeline.fc_traditional(
        jm, x, f, n, c, cf, "sa", nbr_valid=n >= 0))(
        xyz[i], feats[i], jout.nbr_idx[i], jout.center_xyz[i],
        feats[i][jout.center_idx[i]])
    want = {"trad": trad, "lpcn": jout.features[i],
            "block": jout.features[i]}
    got = {
        "trad": pipeline.fc_traditional(
            tm, x, f, tst.nbr, tst.center_xyz, cf, "sa",
            nbr_valid=tst.nbr_valid),
        "lpcn": pipeline.fc_lpcn(
            tm, x, f, tst.nbr, tst.center_xyz, tst.islands, tst.schedule,
            tcfg, cf, nbr_valid=tst.nbr_valid),
        "block": pipeline.compute_block_features(tcfg, tm, x, f, tst)}
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _first_structure(jst):
    """A per-cloud JAX structure (numpy leaves) as the port's."""
    lifted = jax.tree.map(lambda a: np.asarray(a)[None], jst)
    return pipeline._first(structure_from_numpy(lifted, device="cpu"))


def test_overlap_histogram_matches_jax():
    """Fig. 4(b)'s overlap groups on FPS centers and their kNN, and on a
    ball query's rows with -1 slots, within 1e-6 of JAX."""
    rng = np.random.default_rng(9)
    xyz = np.asarray(make_cloud(rng, 400), np.float32)
    t = torch.from_numpy(xyz)
    cidx = farthest_point_sampling(t, 96)
    centers = t[cidx]
    from repro_torch.core.neighbor import ball_query
    for nbr in (knn_bruteforce(t, centers, 16),
                ball_query(t, centers, 0.08, 16, n_valid=torch.tensor(300))):
        want = jworkload.overlap_histogram(jnp.asarray(nbr.numpy()),
                                           jnp.asarray(centers.numpy()))
        got = workload.overlap_histogram(nbr, centers)
        assert list(got) == list(want)
        for g in want:
            np.testing.assert_allclose(got[g], want[g], rtol=1e-6,
                                       atol=1e-6, err_msg=g)
    assert (nbr < 0).any()


def test_report_methods_match_jax():
    """Savings, the memory model, ``scaled``, ``concrete``,
    ``sum_counters`` and ``total`` on (B,) and 0-d counters."""
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 5000, (6, 3))
    vals[1] = np.minimum(vals[1], vals[0])
    vals[:, 2] = 0                                     # an empty cloud
    t = workload.WorkloadReport(*(torch.from_numpy(v) for v in vals), k=32)
    j = jworkload.WorkloadReport(*(jnp.asarray(v) for v in vals), k=32)
    for a, b in ((t.fetch_saving, j.fetch_saving),
                 (t.compute_saving, j.compute_saving),
                 (t.memory_saving(64, 4096), j.memory_saving(64, 4096))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
    assert t.scaled(10)["lpcn_flops"].tolist() == (vals[3] * 10).tolist()
    c = t.concrete()
    assert isinstance(c.baseline_fetches, np.ndarray)
    one = workload.WorkloadReport(*(torch.tensor(int(v[0])) for v in vals),
                                  k=8).concrete()
    assert isinstance(one.lpcn_fetches, int)
    tot = workload.WorkloadReport.total([one, one])
    jtot = jworkload.WorkloadReport.total(
        [jworkload.WorkloadReport(*(int(v[0]) for v in vals), k=8)] * 2)
    assert tot.counters() == jtot.tree_flatten()[0] and tot.k == jtot.k
    assert workload.WorkloadReport.total([]).counters() == (0,) * 6
    s = workload.WorkloadReport.sum_counters([t, one])
    assert s.k == 32 and s.n_subsets.tolist() == (vals[4] + vals[4, 0]
                                                  ).tolist()
