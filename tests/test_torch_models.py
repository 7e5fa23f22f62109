"""Every model family of the port against the JAX package on the CPU, at a
small size: the six specs beyond PointNet++(c) (part and semantic
segmentation PointNet++, DGCNN cls and seg, PointNeXt, PointVector), cut
the same way on both sides, with one empty and two padded clouds and
weights carried across with ``params_from_numpy``; padded == unpadded with
seg padding rows exactly 0; the "all" sampler's structures exactly equal;
and the FP decoder's interpolation."""
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core.pipeline import LPCNConfig as JCfg
from repro.core.pipeline import structure_block as jstructure_block
from repro.data.synthetic import make_cloud
from repro.engine.archs import feature_propagation as jfeature_propagation
from repro.models import MODEL_ZOO as JMODEL_ZOO
from repro_torch import engine
from repro_torch.core.pipeline import LPCNConfig, structure_block
from repro_torch.engine.archs import feature_propagation
from repro_torch.models import MODEL_ZOO

torch.set_num_threads(1)

N = 128
SIZES = (128, 100, 77, 0)          # full, padded, padded, an empty fill
ISL = dict(island_size=8, island_capacity=16)
TOL = 1e-4
# (n_centers, k, mlp_dims, radius[, kind, sampler]) per block, head, classes
CUTS = {
    "pointnet2_ps": (((48, 8, (16, 16, 32), 0.2),
                      (16, 8, (32, 32, 32), 0.4)), (32,), 10),
    "pointnet2_s": (((48, 8, (16, 16, 24), 0.1),
                     (16, 8, (24, 24, 32), 0.2)), (16,), 7),
    "dgcnn_c": (((N, 8, (16,), 0.2, "edge", "all"),
                 (N, 8, (32,), 0.2, "edge", "all")), (32,), 10),
    "dgcnn_s": (((N, 8, (16,), 0.2, "edge", "all"),
                 (N, 8, (24,), 0.2, "edge", "all")), (16,), 7),
    "pointnext_s": (((48, 8, (16,), 0.1), (16, 8, (32,), 0.2)), (16,), 7),
    "pointvector_l": (((48, 8, (16,), 0.1), (16, 8, (32,), 0.2)), (16,), 7),
}
NAMES = sorted(CUTS)


def _specs(name):
    """The spec cut to size, as the JAX package's and the port's type."""
    blocks, head, ncls = CUTS[name]
    out = []
    for zoo, bs in ((JMODEL_ZOO, jengine.BlockSpec),
                    (MODEL_ZOO, engine.BlockSpec)):
        out.append(replace(zoo[name][1], blocks=tuple(bs(*b) for b in blocks),
                           head_dims=head, n_classes=ncls))
    return out


_SETUPS: dict = {}


def _setup(name):
    """Clouds, keys, JAX and port params and batches for one spec (built
    once per test process)."""
    if name in _SETUPS:
        return _SETUPS[name]
    jspec, tspec = _specs(name)
    rng = np.random.default_rng(0)
    clouds = [np.asarray(make_cloud(rng, n), np.float32) if n
              else np.zeros((0, 3), np.float32) for n in SIZES]
    feats = None
    if jspec.in_feats > 3:
        feats = [np.concatenate([c, rng.uniform(0, 1, (len(c),
                 jspec.in_feats - 3)).astype(np.float32)], -1)
                 for c in clouds]
    keys = jax.random.split(jax.random.PRNGKey(1), len(SIZES))
    jp = jengine.init(jax.random.PRNGKey(0), jspec)
    # nonzero biases, so a bias handled wrongly shows
    jp = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jp)
    tp = engine.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jb = jengine.Batch.from_clouds(clouds, feats=feats, key=keys, n_pad=N)
    tb = engine.Batch.from_clouds(clouds, feats=feats, key=np.asarray(keys),
                                  n_pad=N, device="cpu")
    _SETUPS[name] = (jspec, tspec, clouds, feats, np.asarray(keys), jp, tp,
                     jb, tb)
    return _SETUPS[name]


def _jax_logits(name, mode, backend):
    jspec, _, _, _, _, jp, _, jb, _ = _setup(name)
    return np.asarray(jax.jit(partial(
        jengine.apply, spec=jspec, mode=mode, fc_backend=backend,
        isl_kw=ISL))(jp, jb))


def _port_logits(name, mode, backend):
    _, tspec, _, _, _, _, tp, _, tb = _setup(name)
    return engine.apply(tp, tb, spec=tspec, mode=mode, fc_backend=backend,
                        isl_kw=ISL, device="cpu").numpy()


def _held(got, want, what):
    """Within TOL of JAX.  Every cloud with points is finite; the empty
    fill cloud is held as it is: DGCNN's cls head on its -BIG global max
    is not finite in either package (NaN where JAX has NaN)."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    real = np.asarray(SIZES) > 0
    assert np.isfinite(got[real]).all(), what
    assert np.abs(want[real]).max() > 0, what      # not a trivial zero
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("mode", ["lpcn", "traditional"])
@pytest.mark.parametrize("name", NAMES)
def test_logits_match_jax(name, mode):
    """≤1e-4 against JAX "reference", for both of the port's backends
    ("cuda" takes the kernels' plain versions on the CPU)."""
    want = _jax_logits(name, mode, "reference")
    seg = _specs(name)[0].task == "seg"
    assert want.shape == ((len(SIZES), N, CUTS[name][2]) if seg
                          else (len(SIZES), CUTS[name][2]))
    for be in ("reference", "cuda"):
        _held(_port_logits(name, mode, be), want, f"{name} {mode} {be}")


@pytest.mark.parametrize("mode", ["lpcn", "traditional"])
@pytest.mark.parametrize("name", ["pointnext_s", "dgcnn_s"])
def test_logits_match_jax_pallas_vmap(name, mode):
    """One seg family and DGCNN against JAX "pallas_vmap" (per-cloud Pallas
    kernels in interpret mode)."""
    want = _jax_logits(name, mode, "pallas_vmap")
    _held(_port_logits(name, mode, "cuda"), want, f"{name} {mode}")


@pytest.mark.parametrize("name", NAMES)
def test_padded_matches_unpadded(name):
    """Each cloud of the padded batch equals the cloud alone; seg rows past
    a cloud's count are exactly 0 (the empty fill cloud's every row)."""
    _, tspec, clouds, feats, keys, _, tp, _, tb = _setup(name)
    eng = engine.PCNEngine(tspec, fc_backend="cuda", isl_kw=ISL,
                           device="cpu")
    out = eng.apply(tp, tb)
    seg = tspec.task == "seg"
    for i, c in enumerate(clouds):
        if seg:
            assert bool((out[i, len(c):] == 0).all()), i
        if len(c):
            one = eng.apply_single(tp, c, None if feats is None
                                   else feats[i], key=keys[i])
            got = out[i, :len(c)] if seg else out[i]
            assert one.shape == got.shape
            np.testing.assert_allclose(got.numpy(), one.numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["lpcn", "traditional"])
def test_all_sampler_structures_equal_jax(mode):
    """Every center a center, padding rows kept in the list and masked:
    every integer structure equal to JAX's, the hub counts following
    N // island_size and the valid count."""
    rng = np.random.default_rng(3)
    xyz = np.zeros((len(SIZES), N, 3), np.float32)
    for i, n in enumerate(SIZES):
        if n:
            c = np.asarray(make_cloud(rng, n), np.float32)
            xyz[i] = np.concatenate([c, np.repeat(c[-1:], N - n, 0)])
    nv = np.asarray(SIZES, np.int64)
    keys = jax.random.split(jax.random.PRNGKey(4), len(SIZES))
    cfg = dict(n_centers=7, k=8, sampler="all", mode=mode, **ISL)
    jst = jax.jit(jax.vmap(lambda x, k, n: jstructure_block(
        JCfg(**cfg), x, k, n_valid=n)))(jnp.asarray(xyz), keys,
                                        jnp.asarray(nv, jnp.int32))
    st = structure_block(LPCNConfig(**cfg), torch.from_numpy(xyz),
                         torch.from_numpy(np.asarray(keys).astype(np.int64)),
                         n_valid=torch.from_numpy(nv))
    assert st.center_idx.dtype == torch.int64
    assert torch.equal(st.center_idx, torch.arange(N).expand(len(SIZES), N))
    fields = [("center_idx", jst.center_idx, st.center_idx),
              ("nbr", jst.nbr, st.nbr),
              ("center_valid", jst.center_valid, st.center_valid),
              ("nbr_valid", jst.nbr_valid, st.nbr_valid)]
    if mode == "lpcn":
        assert st.islands.members.shape[1] == N // ISL["island_size"]
        fields += [(f, getattr(jst.islands, f), getattr(st.islands, f))
                   for f in ("members", "hub", "solo", "round_of")]
        fields += [(f, getattr(jst.schedule, f), getattr(st.schedule, f))
                   for f in ("pool_ids", "reuse_slot", "is_first",
                             "subset_valid", "pos_live")]
    for f, want, got in fields:
        want = np.asarray(want)
        np.testing.assert_array_equal(
            want if want.dtype == bool else want.astype(np.int64),
            got.numpy(), err_msg=f)


def test_feature_propagation_matches_jax():
    """Within 1e-5 of JAX, with destinations that are also sources
    (distance exactly 0, weight 1e8), duplicated sources (ties to the lower
    index), and padding sources masked by ``src_n_valid`` (one cloud with
    fewer valid sources than neighbors)."""
    rng = np.random.default_rng(5)
    b, nd, ns, f = 3, 40, 12, 5
    src = rng.normal(size=(b, ns, 3)).astype(np.float32)
    src[:, 6:9] = src[:, 0:3]                       # duplicated sources
    dst = rng.normal(size=(b, nd, 3)).astype(np.float32)
    dst[:, :ns] = src                               # every source a dest
    fs = rng.normal(size=(b, ns, f)).astype(np.float32)
    nv = np.array([ns, 9, 2], np.int64)
    for src_nv in (nv, None):
        want = jax.vmap(lambda d, s, x, v: jfeature_propagation(
            d, s, x, src_n_valid=v),
            in_axes=(0, 0, 0, None if src_nv is None else 0))(
            jnp.asarray(dst), jnp.asarray(src), jnp.asarray(fs),
            None if src_nv is None else jnp.asarray(src_nv, jnp.int32))
        got = feature_propagation(
            torch.from_numpy(dst), torch.from_numpy(src),
            torch.from_numpy(fs),
            src_n_valid=None if src_nv is None else torch.from_numpy(src_nv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # a destination on a lone source takes that source's features
    np.testing.assert_allclose(got[:, 3:6].numpy(), fs[:, 3:6], rtol=1e-5,
                               atol=1e-5)
