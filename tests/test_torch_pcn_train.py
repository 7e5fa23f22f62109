"""PCN training and the paper's Fig. 20 accuracy run
(``repro_torch.examples.accuracy``) against the JAX package's
``benchmarks/accuracy.py`` on the CPU, JAX's ``_model_init`` weights
carried across with ``params_from_numpy``: the task bit for bit, forward
logits in every mode within 1e-4 · max(1, max|jax|), the loss within
1e-5 relative and every leaf's grad within 1e-4 · max(1, max|g|) of
``jax.value_and_grad``, three SGD steps, and the quick accuracy run's
table.  JAX's functions are built in the tests (one jit a mode, shared
through ``functools.lru_cache``), so collection stays cheap."""
import functools

import numpy as np
import pytest
import torch

from repro_torch import random as prandom
from repro_torch.examples import accuracy as acc

torch.set_num_threads(1)
TOL = 1e-4
LOSS_RTOL = 1e-5
MARGIN = 1e-3          # JAX top-two logit margin below which a cloud's
                       # prediction may flip under float reordering
N_POINTS = 256
# the table JAX's own run_accuracy(quick=True) returns on a CPU (jax 0.9.0)
JAX_QUICK_TABLE = {
    "block_end": dict(traditional=0.28125, lpcn_linear=0.28125,
                      lpcn_mlp=0.28125, mesorasi=0.28125),
    "per_layer": dict(traditional=0.09375, lpcn_linear=0.15625,
                      lpcn_mlp=0.125, mesorasi=0.15625)}


def jax_mods():
    import jax
    import jax.numpy as jnp
    from benchmarks import accuracy as jacc
    return jax, jnp, jacc


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    lim = tol * max(1.0, float(np.abs(want).max()))
    assert err <= lim, f"max|Δ| {err:.3g} > {lim:.3g}"


@functools.lru_cache(maxsize=None)
def jax_forward(mode, comp):
    """``jax.jit(jax.vmap(_forward))`` as ``run_accuracy`` builds it, one
    key for every cloud."""
    jax, _, jacc = jax_mods()
    key = jax.random.PRNGKey(0)
    return jax.jit(jax.vmap(lambda p, x: jacc._forward(p, x, mode, key, comp),
                            in_axes=(None, 0)))


@functools.lru_cache(maxsize=None)
def jax_value_and_grad():
    """``run_accuracy``'s ``loss_fn`` under ``jax.value_and_grad``."""
    jax, jnp, _ = jax_mods()
    fwd = jax_forward("traditional", "linear")

    def loss_fn(p, xs, ys):
        lp = jax.nn.log_softmax(fwd(p, xs))
        return -jnp.mean(lp[jnp.arange(ys.shape[0]), ys])

    return jax.jit(jax.value_and_grad(loss_fn))


@functools.lru_cache(maxsize=None)
def jax_init(activation):
    """JAX's ``_model_init(PRNGKey(0), activation)`` with numpy leaves."""
    jax, _, jacc = jax_mods()
    return jax.tree.map(np.asarray,
                        jacc._model_init(jax.random.PRNGKey(0), activation))


@functools.lru_cache(maxsize=None)
def task(n, seed):
    """The same clouds for both packages: (numpy xs, ys, port xs, ys)."""
    xs, ys = acc.gen_task(n, N_POINTS, seed, device="cpu")
    return xs.numpy(), ys.numpy().astype(np.int32), xs, ys


def port_params(activation):
    return acc.params_from_numpy(jax_init(activation), "cpu")


def jax_leaves(tree):
    jax, _, _ = jax_mods()
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("seed,n", [(1, 64), (2, 32)])
def test_gen_task_bit_equal(seed, n):
    _, _, jacc = jax_mods()
    want_x, want_y = jacc._gen_task(n, N_POINTS, seed=seed)
    xs, ys = acc.gen_task(n, N_POINTS, seed, device="cpu")
    assert xs.dtype == torch.float32 and xs.shape == (n, N_POINTS, 3)
    assert np.array_equal(xs.numpy(), np.asarray(want_x))
    assert np.array_equal(ys.numpy(), np.asarray(want_y))


@pytest.mark.parametrize("activation", acc.ACTIVATIONS)
@pytest.mark.parametrize("mode,comp", acc.EVALS)
def test_forward_logits_match_jax(activation, mode, comp):
    """8 clouds, the port's "reference" and "cuda" backends (the kernels'
    plain versions here) against JAX's reference."""
    jxs, _, xs, _ = task(8, 1)
    want = np.asarray(jax_forward(mode, comp)(jax_init(activation), jxs))
    params = port_params(activation)
    key = prandom.PRNGKey(0)
    with torch.no_grad():
        close(acc.forward(params, xs, mode, key, comp, activation), want)
    close(acc.predict(params, xs, mode, comp, key), want)


@pytest.mark.parametrize("activation", acc.ACTIVATIONS)
def test_loss_and_grads_match_jax(activation):
    """Batch 16: the loss within 1e-5 relative, each leaf's grad within
    1e-4 · max(1, max|g|) of JAX's, in JAX's leaf order."""
    jxs, jys, xs, ys = task(64, 1)
    loss_j, g_j = jax_value_and_grad()(jax_init(activation), jxs[:16],
                                       jys[:16])
    loss, g = acc.grads(port_params(activation), xs[:16], ys[:16],
                        prandom.PRNGKey(0))
    assert abs(float(loss) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    want = jax_leaves(g_j)
    assert len(g) == len(want) == 12
    for have, w in zip(g, want):
        close(have, w)


@pytest.mark.parametrize("activation", acc.ACTIVATIONS)
def test_three_sgd_steps_match_jax(activation):
    """``train`` over 48 clouds (three steps of 16) against JAX's
    ``p - lr·g``: losses within 1e-5 relative, params within 1e-4."""
    jax, _, _ = jax_mods()
    jxs, jys, xs, ys = task(64, 1)
    p_j, losses_j = jax_init(activation), []
    for i in range(0, 48, 16):
        loss, g = jax_value_and_grad()(p_j, jxs[i:i + 16], jys[i:i + 16])
        p_j = jax.tree.map(lambda p, gg: p - 3e-3 * gg, p_j, g)
        losses_j.append(float(loss))
    params = port_params(activation)
    losses = acc.train(params, xs[:48], ys[:48], epochs=1)
    assert len(losses) == 3
    for have, want in zip(losses, losses_j):
        assert abs(have - want) <= LOSS_RTOL * abs(want)
    for have, want in zip(acc.leaves(params), jax_leaves(p_j)):
        close(have, want)


@pytest.mark.parametrize("activation", acc.ACTIVATIONS)
def test_cuda_backend_grads_equal_reference_on_cpu(activation):
    """On CPU tensors the "cuda" backend runs the kernels' plain versions,
    which carry a gradient: the same loss and grads as "reference"."""
    _, _, xs, ys = task(64, 1)
    params = port_params(activation)
    key = prandom.PRNGKey(0)
    loss_r, g_r = acc.grads(params, xs[:16], ys[:16], key, "reference")
    loss_c, g_c = acc.grads(params, xs[:16], ys[:16], key, "cuda")
    assert abs(float(loss_c) - float(loss_r)) <= LOSS_RTOL * abs(
        float(loss_r))
    for have, want in zip(g_c, g_r):
        close(have, want.numpy())


def jax_quick_run():
    """JAX's ``run_accuracy(quick=True)`` step for step (its sizes, its
    batch order, lr 3e-3, ``PRNGKey(0)`` for init and forward), with its
    per-step losses and test logits kept; the test clouds are evaluated 8
    at a time through the jits the forward test compiled."""
    jax, _, jacc = jax_mods()
    n_train, n_test, _, epochs = acc.sizes(True)
    jxtr, jytr, _, _ = task(n_train, 1)
    jxte, _, _, _ = task(n_test, 2)
    out = {}
    for act in acc.ACTIVATIONS:
        params, losses = jax_init(act), []
        for _ in range(epochs):
            for i in range(0, n_train, 16):
                loss, g = jax_value_and_grad()(params, jxtr[i:i + 16],
                                               jytr[i:i + 16])
                params = jax.tree.map(lambda p, gg: p - 3e-3 * gg, params,
                                      g)
                losses.append(float(loss))
        logits = {acc.tag(m, c): np.concatenate(
            [np.asarray(jax_forward(m, c)(params, jxte[i:i + 8]))
             for i in range(0, n_test, 8)]) for m, c in acc.EVALS}
        out[act] = losses, logits
    return out


def test_run_accuracy_quick_matches_jax():
    """The port's ``run_accuracy(quick=True)`` from JAX's init against
    JAX's run (whose table is JAX's ``run_accuracy``'s): per-step losses
    within 1e-5 relative over the 16 steps, the same prediction on every
    test cloud whose JAX top-two margin is >= 1e-3 and, where no cloud is
    excepted, the same accuracy.  Excepted here: none (the smallest
    margin is 2.98e-3)."""
    _, yte, _, _ = task(acc.sizes(True)[1], 2)
    want = jax_quick_run()
    run = acc.run_accuracy(True, "cpu",
                           init={a: port_params(a) for a in acc.ACTIVATIONS})
    excepted = {}
    for act in acc.ACTIVATIONS:
        losses_j, logits_j = want[act]
        assert len(run.losses[act]) == len(losses_j) == 16
        for have, w in zip(run.losses[act], losses_j):
            assert abs(have - w) <= LOSS_RTOL * abs(w), (act, have, w)
        for name, lj in logits_j.items():
            top2 = np.sort(lj, axis=-1)[:, -2:]
            low = np.flatnonzero(top2[:, 1] - top2[:, 0] < MARGIN)
            excepted[act, name] = low.tolist()
            pred = run.logits[act][name].argmax(-1).numpy()
            keep = np.setdiff1d(np.arange(len(yte)), low)
            assert np.array_equal(pred[keep], lj.argmax(-1)[keep]), (act,
                                                                    name)
            assert float((lj.argmax(-1) == yte).mean()) == \
                JAX_QUICK_TABLE[act][name]
            if not len(low):
                assert run.table[act][name] == JAX_QUICK_TABLE[act][name]
    assert not any(excepted.values()), excepted
