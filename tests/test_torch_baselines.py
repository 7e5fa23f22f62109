"""The port's Mesorasi baseline (``repro_torch.models.baselines``) and
dataset generator (``repro_torch.data.synthetic.make_dataset``) against
the JAX package on the CPU: ``make_dataset`` byte for byte for every
``DATASETS`` entry, ``mesorasi_fc`` within 1e-5 in both of its forms
(per cloud and under leading batch axes), equal to ``fc_traditional``
for a linear MLP (delayed aggregation is exact there), and
``mesorasi_workload``'s counters exactly."""
import numpy as np
import pytest
import torch

from repro_torch.core.pipeline import LPCNConfig, data_structuring
from repro_torch.core.pipeline import fc_traditional
from repro_torch.data.synthetic import DATASETS, make_cloud, make_dataset
from repro_torch.engine.params import _mlp_from_numpy
from repro_torch.models import mesorasi_fc, mesorasi_workload
from repro_torch import random

torch.set_num_threads(1)

TOL = 1e-5


def test_datasets_table_equals_jax():
    from repro.data.synthetic import DATASETS as JDATASETS
    assert DATASETS == JDATASETS


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_make_dataset_byte_equal_to_jax(name):
    """The same seed gives the same bytes (the numpy draws in the JAX
    package's order); s3dis_large is 65,536 points a cloud, so one."""
    from repro.data.synthetic import make_dataset as jmake_dataset
    n = 1 if name == "s3dis_large" else 2
    got = make_dataset(name, n, seed=5)
    want = jmake_dataset(name, n, seed=5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    n_pts, f_dim = DATASETS[name][:2]
    assert got[1].shape == (n, n_pts, f_dim)


def _mlp(rng, dims, activation, bias=0.1):
    """numpy weights (biases drawn at scale ``bias``), as both packages'
    MLP."""
    import jax.numpy as jnp
    from repro.core.mlp import MLP as JMLP, Dense as JDense
    layers = [(np.asarray(rng.normal(size=(a, b)) * (2 / a) ** .5,
                          np.float32),
               np.asarray(rng.normal(size=(b,)) * bias, np.float32))
              for a, b in zip(dims[:-1], dims[1:])]
    jm = JMLP(layers=[JDense(w=jnp.asarray(w), b=jnp.asarray(b))
                      for w, b in layers], activation=activation)
    tm = _mlp_from_numpy({"layers": [{"w": w, "b": b} for w, b in layers],
                          "activation": activation}, "cpu")
    return jm, tm


def _case(kind, seed, lead=()):
    """Clouds, neighbors and centers of one case (leading axes ``lead``):
    sa takes xyz (N, 3) and feats (N, 3); edge feats (N, 5)."""
    rng = np.random.default_rng(seed)
    b = int(np.prod(lead)) if lead else 1
    n, s, k = 96, 24, 8
    f = 3 if kind == "sa" else 5
    xyz = np.stack([make_cloud(rng, n) for _ in range(b)])
    feats = (xyz.copy() if kind == "sa" else
             rng.normal(size=(b, n, f)).astype(np.float32))
    nbr = rng.integers(0, n, (b, s, k)).astype(np.int32)
    cidx = rng.integers(0, n, (b, s))
    cxyz = np.take_along_axis(xyz, cidx[..., None], 1)
    cf = np.take_along_axis(feats, cidx[..., None], 1)
    shape = lambda a: a.reshape(lead + a.shape[1:]) if lead else a[0]
    return tuple(shape(a) for a in (xyz, feats, nbr, cxyz, cf)), f


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)],
                         ids=["one_cloud", "batch", "two_axes"])
@pytest.mark.parametrize("kind", ["sa", "edge"])
def test_mesorasi_fc_matches_jax(kind, lead):
    import jax
    import jax.numpy as jnp
    from repro.models.baselines import mesorasi_fc as jmesorasi_fc
    (xyz, feats, nbr, cxyz, cf), f = _case(kind, 3, lead)
    dims = [3 + f, 16, 32] if kind == "sa" else [2 * f, 16, 32]
    jm, tm = _mlp(np.random.default_rng(7), dims, "per_layer")

    def jfn(x, ft, nb, c, cfe):
        return jmesorasi_fc(jm, x, ft, nb, c, cfe, kind=kind)

    for _ in lead:                       # JAX's is per cloud: vmap it
        jfn = jax.vmap(jfn)
    want = np.asarray(jfn(*(jnp.asarray(a) for a in
                            (xyz, feats, nbr, cxyz, cf))))
    got = mesorasi_fc(tm, *(torch.from_numpy(np.array(a)) for a in
                            (xyz, feats, nbr, cxyz)),
                      torch.from_numpy(np.array(cf)), kind=kind)
    assert got.shape == want.shape == lead + (24, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["sa", "edge"])
def test_mesorasi_fc_exact_for_linear_mlp(kind):
    """Delayed aggregation is exact for a linear MLP (``block_end``) with
    zero biases, as ``init_mlp`` makes them (the sa form drops b where it
    subtracts MLP(c, 0)): it equals the traditional FC within 1e-4, as the
    JAX package's ``test_mesorasi_exact_for_linear_mlp`` holds (sa there;
    edge here too)."""
    rng = np.random.default_rng(4)
    xyz = torch.from_numpy(make_cloud(rng, 512))
    feats = (xyz.clone() if kind == "sa" else
             torch.from_numpy(rng.normal(size=(512, 4)).astype(np.float32)))
    d = 6 if kind == "sa" else 8
    _, mlp = _mlp(np.random.default_rng(9), [d, 64], "block_end", bias=0.0)
    cfg = LPCNConfig(n_centers=128, k=16)
    cidx, nbr = data_structuring(cfg, xyz[None], random.PRNGKey(0)[None])
    cidx, nbr = cidx[0], nbr[0]
    t = fc_traditional(mlp, xyz, feats, nbr, xyz[cidx], feats[cidx], kind)
    m = mesorasi_fc(mlp, xyz, feats, nbr, xyz[cidx], feats[cidx], kind)
    torch.testing.assert_close(m, t, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,s,k", [(1024, 512, 32), (512, 128, 64),
                                   (8192, 2048, 20), (1, 1, 1)])
def test_mesorasi_workload_equals_jax(n, s, k):
    from repro.models.baselines import mesorasi_workload as jworkload
    got, want = mesorasi_workload(n, s, k), jworkload(n, s, k)
    assert got == type(got)(**{f: getattr(want, f) for f in (
        "baseline_fetches", "lpcn_fetches", "baseline_mlp_evals",
        "lpcn_mlp_evals", "n_subsets", "n_islands_used", "k")})
    assert got.fetch_saving == want.fetch_saving
    assert got.compute_saving == want.compute_saving
