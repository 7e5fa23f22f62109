"""The port's structure stage against the JAX package: Morton codes, the
linear octree, FPS, brute-force kNN, islandization and the hub schedule
are exactly equal, padded and unpadded."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hub_schedule import build_schedule as jbuild_schedule
from repro.core.islandize import islandize as jislandize
from repro.core import morton as jmorton
from repro.core import neighbor as jnb
from repro.core import octree as joct
from repro.core import sampling as jsamp
from repro.core.pipeline import LPCNConfig as JCfg
from repro.core.pipeline import structure_block as jstructure_block
from repro.data.synthetic import make_cloud
from repro_torch.core import hub_schedule, islandize, morton, neighbor
from repro_torch.core import octree, sampling
from repro_torch.core.pipeline import LPCNConfig, structure_block
from repro_torch.engine.params import structure_from_numpy

torch.set_num_threads(1)

N = 192
SIZES = (192, 150, 97, 0)          # no padding, padding, an empty cloud


def _clouds(seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    xyz = np.zeros((len(sizes), N, 3), np.float32)
    for i, n in enumerate(sizes):
        if n:
            c = np.asarray(make_cloud(rng, n), np.float32)
            xyz[i] = np.concatenate([c, np.repeat(c[-1:], N - n, 0)])
    return xyz, np.asarray(sizes, np.int64)


def _t(a):
    return torch.from_numpy(np.array(a).astype(np.int64)
                            if np.asarray(a).dtype.kind in "ui"
                            else np.array(a))


def _eq(want, got, what=""):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype != bool:
        want = want.astype(got.dtype)
    np.testing.assert_array_equal(want, got, err_msg=what)


@pytest.mark.parametrize("masked", [False, True])
def test_morton_codes(masked):
    xyz, nv = _clouds(1, (192, 120, 30, 5))
    valid = np.arange(N)[None] < nv[:, None]
    for i in range(xyz.shape[0]):
        v = jnp.asarray(valid[i]) if masked else None
        lo, hi = jmorton.masked_bounds(jnp.asarray(xyz[i]), v)
        want = jmorton.node_key(jmorton.morton_codes(
            jnp.asarray(xyz[i]), lo=lo, hi=hi), 4)
        tv = torch.from_numpy(valid[i]) if masked else None
        tlo, thi = morton.masked_bounds(torch.from_numpy(xyz[i]), tv)
        got = morton.node_key(morton.morton_codes(
            torch.from_numpy(xyz[i]), lo=tlo, hi=thi), 4)
        _eq(want, got, f"cloud {i}")
        _eq(jmorton.decode(want), morton.decode(got))


def test_octree_build_and_adjacency():
    xyz, nv = _clouds(2)
    for i in range(3):
        jt = joct.build(jnp.asarray(xyz[i]), n_valid=int(nv[i]))
        tt = octree.build(torch.from_numpy(xyz[i]),
                          n_valid=torch.tensor(int(nv[i])))
        _eq(jt.codes, tt.codes)
        _eq(jt.order, tt.order)
        keys = joct.morton.node_key(jt.codes[:int(nv[i])], 3)
        _eq(joct.adjacent_node_keys(keys, 3),
            octree.adjacent_node_keys(_t(keys), 3))


def test_fps():
    xyz, nv = _clouds(3)
    valid = np.arange(N)[None] < nv[:, None]
    fps = jax.jit(jax.vmap(partial(jsamp.farthest_point_sampling,
                                   n_samples=48)))
    want = fps(jnp.asarray(xyz), valid=jnp.asarray(valid))
    got = sampling.farthest_point_sampling(torch.from_numpy(xyz), 48,
                                           valid=torch.from_numpy(valid))
    _eq(want, got)
    # more samples than valid points: the argmax saturates the same way
    small = valid & (np.arange(N)[None] < 20)
    _eq(fps(jnp.asarray(xyz), valid=jnp.asarray(small)),
        sampling.farthest_point_sampling(torch.from_numpy(xyz), 48,
                                         valid=torch.from_numpy(small)))


@pytest.mark.parametrize("dups", [False, True])
def test_knn_bruteforce(dups):
    """Nearest first, ties to the lower index, -1 past the valid count."""
    xyz, nv = _clouds(4, (192, 150, 9, 0))
    if dups:                      # exact distance ties
        xyz[:, 1::2] = xyz[:, 0::2]
    centers = xyz[:, :40]
    knn = jax.jit(jax.vmap(partial(jnb.knn_bruteforce, k=16)))
    want = knn(jnp.asarray(xyz), jnp.asarray(centers),
               n_valid=jnp.asarray(nv, jnp.int32))
    got = neighbor.knn_bruteforce(torch.from_numpy(xyz),
                                  torch.from_numpy(centers), 16,
                                  torch.from_numpy(nv))
    _eq(want, got)
    _eq(jax.jit(jax.vmap(partial(jnb.knn_bruteforce, k=16)))(
            jnp.asarray(xyz), jnp.asarray(centers)),
        neighbor.knn_bruteforce(torch.from_numpy(xyz),
                                torch.from_numpy(centers), 16))


def _islands_pair(centers, keys, n_hubs, cv=None, nhv=None, capacity=16):
    f = jax.jit(jax.vmap(lambda c, k, v, h: jislandize(
        c, n_hubs, level=4, capacity=capacity, key=k, center_valid=v,
        n_hubs_valid=h), in_axes=(0, 0, None if cv is None else 0,
                                  None if nhv is None else 0)))
    want = f(jnp.asarray(centers), keys,
             None if cv is None else jnp.asarray(cv),
             None if nhv is None else jnp.asarray(nhv, jnp.int32))
    got = islandize.islandize(
        torch.from_numpy(centers), n_hubs, level=4, capacity=capacity,
        key=_t(keys), center_valid=None if cv is None else
        torch.from_numpy(cv), n_hubs_valid=None if nhv is None else
        torch.from_numpy(np.asarray(nhv, np.int64)))
    return want, got


def _eq_islands(want, got):
    for f in ("members", "hub", "solo", "round_of"):
        _eq(getattr(want, f), getattr(got, f), f)


@pytest.mark.parametrize("padded", [False, True])
def test_islandize(padded):
    xyz, nv = _clouds(5)
    centers = xyz[:, :64]
    keys = jax.random.split(jax.random.PRNGKey(9), centers.shape[0])
    cv = nhv = None
    if padded:
        cv = np.arange(64)[None] < np.array([64, 40, 17, 0])[:, None]
        nhv = np.maximum(cv.sum(1) // 8, 1)
    want, got = _islands_pair(centers, keys, 8, cv, nhv)
    _eq_islands(want, got)


def test_islandize_two_hubs_in_one_voxel():
    """Hubs sharing a voxel: the seed scatter keeps the later hub, as the
    JAX scatter does."""
    rng = np.random.default_rng(6)
    c = np.concatenate([rng.uniform(0, 0.01, (60, 3)),
                        [[0, 0, 0], [1, 1, 1], [1, 0, 1], [0, 1, 1]]]
                       ).astype(np.float32)[None].repeat(3, 0)
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    want, got = _islands_pair(c, keys, 8)
    hub_vox = jmorton.node_key(jmorton.morton_codes(jnp.asarray(c[0])),
                               4)[np.asarray(want.hub[0])]
    assert len(set(np.asarray(hub_vox).tolist())) < 8   # shared voxels
    _eq_islands(want, got)


@pytest.mark.parametrize("padded", [False, True])
def test_build_schedule(padded):
    """On islands built by JAX (converted) and by the port."""
    xyz, nv = _clouds(7)
    nvj = jnp.asarray(nv, jnp.int32) if padded else None
    cfg = dict(n_centers=48, k=12, island_size=8, island_capacity=16)
    jst = jax.jit(jax.vmap(lambda x, k, n: jstructure_block(
        JCfg(**cfg), x, k, n_valid=n), in_axes=(0, 0, 0 if padded else None)
    ))(jnp.asarray(xyz), jax.random.split(jax.random.PRNGKey(1), 4), nvj)
    st = structure_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    got = hub_schedule.build_schedule(st.islands, st.nbr, 24)
    for f in ("pool_ids", "reuse_slot", "is_first", "subset_valid",
              "pos_live"):
        _eq(getattr(jst.schedule, f), getattr(got, f), f)
    want = jax.jit(jax.vmap(lambda i, n: jbuild_schedule(i, n, 24)))(
        jst.islands, jst.nbr)
    _eq(want.reuse_slot, got.reuse_slot)


@pytest.mark.parametrize("mode", ["traditional", "lpcn"])
@pytest.mark.parametrize("padded", [False, True])
def test_structure_block(mode, padded):
    """The whole stage-1 chain, keys included."""
    xyz, nv = _clouds(8)
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    cfg = dict(n_centers=64, k=16, island_size=8, island_capacity=16,
               mode=mode)
    jst = jax.jit(jax.vmap(lambda x, k, n: jstructure_block(
        JCfg(**cfg), x, k, n_valid=n), in_axes=(0, 0, 0 if padded else None)
    ))(jnp.asarray(xyz), keys,
       jnp.asarray(nv, jnp.int32) if padded else None)
    got = structure_block(LPCNConfig(**cfg), torch.from_numpy(xyz), _t(keys),
                          n_valid=torch.from_numpy(nv) if padded else None)
    for f in ("center_idx", "nbr", "center_valid", "nbr_valid"):
        if getattr(jst, f) is None:
            assert getattr(got, f) is None
        else:
            _eq(getattr(jst, f), getattr(got, f), f)
    np.testing.assert_array_equal(np.asarray(jst.center_xyz),
                                  got.center_xyz.numpy())
    if mode == "lpcn":
        _eq_islands(jst.islands, got.islands)
        for f in ("pool_ids", "reuse_slot", "is_first", "subset_valid",
                  "pos_live"):
            _eq(getattr(jst.schedule, f), getattr(got.schedule, f), f)


def test_padded_structure_equals_unpadded_prefix():
    """The port's own ragged contract: a padded cloud gets the structure of
    its unpadded prefix."""
    xyz, nv = _clouds(9, (192, 130, 130, 0))
    keys = _t(jax.random.split(jax.random.PRNGKey(8), 4))
    cfg = LPCNConfig(n_centers=48, k=12, island_size=8, island_capacity=16)
    padded = structure_block(cfg, torch.from_numpy(xyz), keys,
                             n_valid=torch.from_numpy(nv))
    short = structure_block(cfg, torch.from_numpy(xyz[1:2, :130]),
                            keys[1:2], n_valid=None)
    for f in ("center_idx", "nbr"):
        assert torch.equal(getattr(padded, f)[1], getattr(short, f)[0])
    assert torch.equal(padded.islands.members[1], short.islands.members[0])
    assert torch.equal(padded.schedule.reuse_slot[1],
                       short.schedule.reuse_slot[0])
