"""repro_torch.random against jax.random: threefry2x32 keys, split,
fold_in, uniform and index_uniform are bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sampling import index_uniform as jax_index_uniform
from repro_torch import random as R
from repro_torch.core.sampling import index_uniform

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 42, 2 ** 31 - 1, -3, 123456789]


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(_np(jax.random.PRNGKey(seed)),
                                  R.PRNGKey(seed).numpy())


@pytest.mark.parametrize("num", [2, 3, 8, 33])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_split(seed, num):
    np.testing.assert_array_equal(
        _np(jax.random.split(jax.random.PRNGKey(seed), num)),
        R.split(R.PRNGKey(seed), num).numpy())


@pytest.mark.parametrize("data", [0, 1, 5, 1000, 2 ** 31 + 5, 2 ** 32 - 1])
def test_fold_in(data):
    for seed in SEEDS[:3]:
        np.testing.assert_array_equal(
            _np(jax.random.fold_in(jax.random.PRNGKey(seed), data)),
            R.fold_in(R.PRNGKey(seed), data).numpy())


def test_uniform_bits():
    keys = jax.random.split(jax.random.PRNGKey(11), 64)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys))
    got = R.uniform(torch.from_numpy(_np(keys))).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("n", [1, 17, 256])
def test_index_uniform(n):
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = np.asarray(jax.jit(jax.vmap(jax_index_uniform, (0, None)),
                              static_argnums=1)(keys, n))
    got = index_uniform(torch.from_numpy(_np(keys)), n).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    # per-index: a prefix of a longer draw is the shorter draw
    longer = index_uniform(torch.from_numpy(_np(keys)), n + 9).numpy()
    np.testing.assert_array_equal(longer[:, :n], got)


def test_batched_split_is_vmapped_split():
    """The engine's key chain (split per block, then per stage) on a (B, 2)
    stack of keys equals jax's vmapped splits."""
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    tk = torch.from_numpy(_np(keys))
    jk = keys
    for _ in range(3):
        jks = jax.vmap(jax.random.split)(jk)
        tks = R.split(tk)
        np.testing.assert_array_equal(_np(jks), tks.numpy())
        jk, tk = jks[:, 0], tks[:, 0]
    np.testing.assert_array_equal(
        _np(jax.vmap(jax.random.fold_in, (0, None))(jk, jnp.uint32(9))),
        R.fold_in(tk, 9).numpy())
