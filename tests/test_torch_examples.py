"""The four examples of ``repro_torch.examples`` on the CPU: each ``main``
runs with ``--device cpu``; quickstart's two checks hold; the
islandization demo prints what the JAX package's example prints (run in
a subprocess; its integer structures are exact); lm_decode's greedy
tokens equal JAX's on the float32 reduced configs, JAX's ``zoo.init``
weights carried across.  The JAX package is imported inside the tests
that compare with it; the ``cuda`` test checks, on the card, that a PCN
training step through the "cuda" FC backend is refused."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import random as prandom
from repro_torch.examples import (accuracy, islandization_demo, lm_decode,
                                  quickstart, train_pointnet2)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_checks_hold(capsys):
    errs = quickstart.main(["--device", "cpu"])
    assert errs["exact"] < 1e-3 and errs["kernels"] < 1e-4
    out = capsys.readouterr().out
    assert "batched logits: (4, 10)" in out
    assert "feature fetches:" in out and "MLP point-evals:" in out


def test_train_pointnet2_main_runs(capsys):
    assert train_pointnet2.main(["--device", "cpu", "--steps", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("step    0  loss ")
    assert [ln[:28] for ln in lines[1:]] == [
        "test accuracy [traditional ]", "test accuracy [lpcn        ]"]


def test_lm_decode_main_runs(capsys):
    assert lm_decode.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(lm_decode.ARCHS)
    assert all("generated 4x12 tokens" in ln for ln in lines)


def test_islandization_demo_prints_what_jax_prints(capsys):
    """The whole output: the registered samplers, the island table, the
    ASCII map and the cached share."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    want = subprocess.run(
        [sys.executable, "examples/islandization_demo.py"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300, check=True)
    assert islandization_demo.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    want = want.stdout.splitlines()
    assert "island | size | hub idx | BFS rounds (inside->outside)" in got
    assert got[-1].startswith("cached positions: ")
    assert got == want


def test_examples_import_no_jax_repro_or_benchmarks():
    """The examples stand on the port alone: importing every one pulls in
    nothing of JAX, the JAX package or its benchmarks."""
    code = ("import sys, repro_torch.examples.accuracy, "
            "repro_torch.examples.train_pointnet2, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.islandization_demo, "
            "repro_torch.examples.lm_decode; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": "src"})
    assert res.returncode == 0, res.stdout + res.stderr


def first_tokens(arch, vocab):
    """The example's first tokens of ``arch``: one draw a config, in
    order, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    for a in lm_decode.ARCHS[:lm_decode.ARCHS.index(arch)]:
        rng.integers(0, vocab, (lm_decode.B,))
    return rng.integers(0, vocab, (lm_decode.B,)).astype(np.int32)


@pytest.mark.parametrize("arch", lm_decode.ARCHS)
def test_lm_decode_tokens_equal_jax(arch):
    """JAX's example loop (``zoo.init(PRNGKey(0))``, a cache of 64, 12
    jitted greedy steps) in float32 against :func:`lm_decode.decode`."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.lm import model_zoo as jzoo
    from repro.lm import steps as jsteps
    from repro_torch.configs import get_config
    from repro_torch.lm.params import from_numpy

    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    assert jcfg.vocab == cfg.vocab
    tok0 = first_tokens(arch, cfg.vocab)
    params = jzoo.init(jax.random.PRNGKey(0), jcfg)
    cache = jzoo.make_cache(jcfg, params, lm_decode.B, lm_decode.CACHE)
    decode = jax.jit(jsteps.make_decode_step(jcfg))
    tok, want = jnp.asarray(tok0), []
    for pos in range(lm_decode.GEN):
        tok, _logits, cache = decode(params, tok, cache, jnp.int32(pos))
        want.append(np.asarray(tok))
    got = lm_decode.decode(cfg, from_numpy(jax.tree.map(np.asarray, params),
                                           device="cpu"),
                           torch.from_numpy(tok0), "cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, np.stack(want, 1))


@pytest.mark.cuda
def test_pcn_grad_through_the_kernels_is_refused_on_card():
    """A training step through the "cuda" FC backend raises
    NoBackwardError on the card (no detached result, no plain fallback);
    the "reference" backend trains there."""
    from repro_torch.kernels import NoBackwardError
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    xs, ys = accuracy.gen_task(4, 256, 1, device=dev)
    params = accuracy.model_init(torch.Generator().manual_seed(0),
                                 "block_end", dev)
    key = prandom.PRNGKey(0, dev)
    with pytest.raises(NoBackwardError,
                       match='no gather_mlp backward kernel.*"reference"'):
        accuracy.grads(params, xs, ys, key, backend="cuda")
    loss, grads = accuracy.grads(params, xs, ys, key)
    assert torch.isfinite(loss) and all(
        bool(torch.isfinite(g).all()) for g in grads)
