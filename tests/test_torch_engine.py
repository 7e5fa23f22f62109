"""The port's engine end to end against the JAX package: PointNet++ logits
on a ragged batch with an empty fill cloud, weights carried across with
``params_from_numpy``; padded == unpadded; and the port's package rules
(no JAX, nothing of ``repro``, the GPU by default)."""
import ast
import os
import subprocess
import sys
from dataclasses import fields, replace
from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.data.synthetic import make_cloud
from repro.models import pointnet2 as jpointnet2
from repro_torch import engine
from repro_torch.models import pointnet2

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
BLOCKS = ((48, 8, (16, 16, 32)), (16, 8, (32, 32, 48)))
JSPEC = replace(jpointnet2.POINTNET2_C,
                blocks=tuple(jengine.BlockSpec(*b) for b in BLOCKS),
                global_mlp=(32, 64), head_dims=(32,), n_classes=10)
TSPEC = replace(pointnet2.POINTNET2_C,
                blocks=tuple(engine.BlockSpec(*b) for b in BLOCKS),
                global_mlp=(32, 64), head_dims=(32,), n_classes=10)
SIZES = (160, 120, 75, 0)          # full, padded, padded, an empty fill


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    clouds = [np.asarray(make_cloud(rng, n), np.float32) if n
              else np.zeros((0, 3), np.float32) for n in SIZES]
    keys = jax.random.split(jax.random.PRNGKey(1), len(SIZES))
    jp = jengine.init(jax.random.PRNGKey(0), JSPEC)
    # nonzero biases, so a bias handled wrongly shows
    jp = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jp)
    tp = engine.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jb = jengine.Batch.from_clouds(clouds, key=keys)
    tb = engine.Batch.from_clouds(clouds, key=np.asarray(keys),
                                  device="cpu")
    return clouds, np.asarray(keys), jp, tp, jb, tb


@pytest.mark.parametrize("mode", ["lpcn", "traditional"])
def test_logits_match_jax(setup, mode):
    """≤1e-4 against JAX "reference" and "pallas_vmap" (per-cloud Pallas
    kernels, interpret mode), for both of the port's backends."""
    clouds, keys, jp, tp, jb, tb = setup
    want = {be: np.asarray(jax.jit(partial(
        jengine.apply, spec=JSPEC, mode=mode, fc_backend=be))(jp, jb))
        for be in ("reference", "pallas_vmap")}
    for be in ("reference", "cuda"):
        got = engine.apply(tp, tb, spec=TSPEC, mode=mode, fc_backend=be,
                           device="cpu").numpy()
        assert got.shape == (len(SIZES), 10) and np.isfinite(got).all()
        for jbe, w in want.items():
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{be} vs JAX {jbe}")


@pytest.mark.parametrize("mode", ["lpcn", "traditional"])
def test_padded_matches_unpadded(setup, mode):
    clouds, keys, jp, tp, jb, tb = setup
    eng = engine.PCNEngine(TSPEC, mode=mode, fc_backend="cuda", device="cpu")
    out = eng.apply(tp, tb)
    for i, c in enumerate(clouds):
        if len(c):
            one = eng.apply_single(tp, c, key=keys[i])
            np.testing.assert_allclose(out[i].numpy(), one.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_bucket_callable_serves_ragged_batches(setup):
    clouds, keys, jp, tp, jb, tb = setup
    eng = engine.PCNEngine(TSPEC, fc_backend="cuda", device="cpu")
    serve = eng.bucket_callable(tp, 4, 200)
    b = engine.Batch.from_clouds(clouds, key=keys, n_pad=200, device="cpu")
    out = serve(b)
    assert out.shape == (4, 10) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), eng.apply(tp, tb).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_batch_from_clouds():
    rng = np.random.default_rng(2)
    clouds = [rng.normal(size=(n, 3)).astype(np.float32) for n in (5, 3, 0)]
    key = jax.random.PRNGKey(4)
    tb = engine.Batch.from_clouds(clouds, key=np.asarray(key), n_pad=6,
                                  device="cpu")
    jb = jengine.Batch.from_clouds(clouds, key=key, n_pad=6)
    for f in ("xyz", "feats", "n_valid"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    np.testing.assert_array_equal(tb.keys.numpy(),
                                  np.asarray(jb.keys).astype(np.int64))
    with pytest.raises(ValueError, match="shorter"):
        engine.Batch.from_clouds(clouds, n_pad=4, device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        engine.Batch.from_clouds([np.full((2, 3), np.nan, np.float32)],
                                 validate=True, device="cpu")


def test_spec_copies_equal_jax():
    for name in ("POINTNET2_C", "POINTNET2_PS", "POINTNET2_S"):
        j, t = getattr(jpointnet2, name), getattr(pointnet2, name)
        for f in fields(j):
            jv, tv = getattr(j, f.name), getattr(t, f.name)
            if f.name == "blocks":
                assert [b.__dict__ for b in jv] == [b.__dict__ for b in tv]
            else:
                assert jv == tv, (name, f.name)


def test_default_device_is_cuda():
    """Entry points run on the card unless told otherwise; without one
    they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.PCNEngine(pointnet2.POINTNET2_C)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.Batch.make(np.zeros((1, 4, 3), np.float32))


def test_server_default_device_is_cuda():
    """The server and the serving CLI on an engine with no explicit
    device raise the port's no-CUDA error here, as the engine does."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch import serve
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="no CUDA|none is available"):
        serve.PCNServer(engine.PCNEngine(TSPEC), None,
                        serve.BucketSet.make([64], batch=2))
    with pytest.raises(RuntimeError, match="none is available"):
        main(["--arch", "pointnet2_c", "--trace", "2", "--serve-json", ""])


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch, repro_torch.engine, "
            "repro_torch.kernels, repro_torch.models.pointnet2, "
            "repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.data.synthetic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path}: imports {n}"
