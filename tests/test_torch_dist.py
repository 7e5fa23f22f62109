"""The port's multi-device slice on the CPU (``repro_torch.dist``,
``repro_torch.launch.mesh``, the PCN engine's data mesh):

* the sharding rules against the JAX package's pure functions:
  ``param_spec`` for every leaf of the ten reduced configs, and the specs
  of ``param_shardings`` / ``batch_shardings`` / ``cache_shardings``,
  ``fit_spec`` and ``_physical`` on meshes of (4,), (2, 2), (4, 2),
  (16, 16) and (2, 16, 16) (JAX's ``AbstractMesh``: the rules read only
  ``dict(mesh.shape)`` and ``axis_names``, and so do the port's);
* ``pipeline_apply`` over 4 gloo ranks against JAX's on 4 forced CPU
  devices (a subprocess, as ``tests/test_distributed.py`` runs it),
  within 1e-5, and its errors;
* ``engine.apply`` and ``PCNEngine(mesh=)`` on a (4, 1) gloo mesh against
  the mesh-free forward (two small specs x both modes x both backends, a
  ragged ``n_valid`` mix) within 1e-5, JAX's own limit; bit-equal on a
  (1, 1) mesh; the ``--mesh-data`` CLI over 4 ranks answering every
  request of a trace;
* the ``mesh=None`` path importing no ``repro_torch.dist`` and no
  ``torch.distributed`` module beyond those ``import torch`` loads, and
  starting no process group (a fresh subprocess);
* ``launch.train`` over 4 gloo ranks under ``local_mesh()`` ((1, 4));
* every kernel wrapper refusing a DTensor (a world of one over gloo; the
  ``cuda`` test repeats it on the card).

Ranks are spawned processes meeting through a ``FileStore`` under
``tmp_path``, one thread each, each spawn under its own timeout; JAX runs
only in the test process or its subprocess."""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.dist import sharding as shd

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("phi3-medium-14b", "olmo-1b", "gemma-7b", "qwen2-72b",
         "mamba2-2.7b", "recurrentgemma-2b", "paligemma-3b",
         "llama4-maverick-400b-a17b", "grok-1-314b", "whisper-large-v3")
MESHES = {"4": ((4,), ("model",)), "4d": ((4,), ("data",)),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SPAWN_TIMEOUT = 240


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------

def init_rank(rank: int, n: int, store: str) -> None:
    """In a spawned rank: one thread, a gloo world of ``n`` through the
    file store."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT))


def _rank_main(rank: int, fn, n: int, store: str, out: str, *args):
    """A spawned rank: ``fn``, then, where it made a process group, a
    barrier and the group's end, so that no rank exits with the group's
    threads still running (which aborts it at exit, under load)."""
    import torch.distributed as dist
    fn(rank, n, store, out, *args)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def spawn(fn, n: int, tmp_path, *args):
    """Run ``fn(rank, n, store, out, *args)`` in ``n`` spawned ranks; ->
    what rank 0 wrote to ``out`` (JSON)."""
    import torch.multiprocessing as mp
    store, out = str(tmp_path / "store"), str(tmp_path / "out.json")
    ctx = mp.start_processes(_rank_main, args=(fn, n, store, out) + args,
                             nprocs=n, join=False, start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=SPAWN_TIMEOUT)
    try:
        while not ctx.join(timeout=5):
            if datetime.datetime.now() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with open(out) as f:
        return json.load(f)


def dump(out: str, obj) -> None:
    with open(out, "w") as f:
        json.dump(obj, f)


# ---------------------------------------------------------------------------
# the rules against JAX
# ---------------------------------------------------------------------------

def abstract(name):
    from jax.sharding import AbstractMesh
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def jax_specs(named_tree):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(
        named_tree, is_leaf=lambda x: hasattr(x, "spec"))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(ns.spec) for path, ns in flat}


def port_specs(sh_tree):
    return dict(zip(tree.paths(sh_tree),
                    (s.spec for s in tree.leaves(sh_tree))))


@pytest.fixture(scope="module")
def reduced():
    """(JAX config, the JAX params' shapes, the port's params) of each
    reduced config."""
    import jax
    from repro.configs import get_config as jget
    from repro.lm import model_zoo as jzoo
    from repro_torch.configs import get_config
    from repro_torch.lm import model_zoo as pzoo
    out = {}
    for arch in ARCHS:
        jcfg = jget(arch, reduced=True)
        shapes = jax.eval_shape(lambda k, c=jcfg: jzoo.init(k, c),
                                jax.random.PRNGKey(0))
        params = pzoo.init(torch.Generator().manual_seed(0),
                           get_config(arch, reduced=True), "cpu")
        out[arch] = (jcfg, shapes, params)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_jax(arch, reduced):
    """param_spec leaf for leaf, and param_shardings' specs on every
    mesh, for the config's own moe_shard and for the other one."""
    from repro.dist import sharding as jsh
    jcfg, shapes, params = reduced[arch]
    assert tree.paths(params) == list(jax_specs(jsh.param_shardings(
        shapes, abstract("2x2"), jcfg.moe_shard)))
    for path, leaf in zip(tree.paths(params), tree.leaves(params)):
        for moe in ("ep", "tp"):
            assert shd.param_spec(path, leaf, moe) == jsh.param_spec(
                path, leaf, moe), path
    for name in MESHES:
        mesh = abstract(name)
        for moe in ("ep", "tp"):
            want = jax_specs(jsh.param_shardings(shapes, mesh, moe))
            got = port_specs(shd.param_shardings(params, mesh, moe))
            assert got == want, (name, moe)


@pytest.mark.parametrize("arch", ARCHS[:-1])
def test_batch_and_cache_shardings_match_jax(arch, reduced):
    """The decode caches of the decoder-only configs and a step's batch:
    the specs JAX gives on every mesh."""
    import jax
    import jax.numpy as jnp
    from repro.dist import sharding as jsh
    from repro.lm import transformer as jtfm
    from repro_torch.configs import get_config
    from repro_torch.lm import transformer as ptfm
    jcfg = reduced[arch][0]
    jcache = jax.eval_shape(lambda: jtfm.init_cache(jcfg, 4, 16))
    pcache = ptfm.init_cache(get_config(arch, reduced=True), 4, 16, "cpu")
    batch = {"tokens": np.zeros((4, 17), np.int32),
             "patches": np.zeros((4, 3, 8), np.float32),
             "step": np.zeros((), np.int32)}
    for name in MESHES:
        mesh = abstract(name)
        assert port_specs(shd.cache_shardings(pcache, mesh)) == jax_specs(
            jsh.cache_shardings(jcache, mesh)), name
        assert port_specs(shd.batch_shardings(batch, mesh)) == jax_specs(
            jsh.batch_shardings(jax.tree.map(jnp.asarray, batch), mesh)), \
            name


@pytest.mark.parametrize("name", sorted(MESHES))
def test_fit_spec_and_physical_match_jax(name):
    from jax.sharding import PartitionSpec as P
    from repro.dist import sharding as jsh
    mesh = abstract(name)
    for sp in (True, False):
        for profile in ("tp", "flat_dp"):
            assert shd._physical(mesh, sp, profile) == jsh._physical(
                mesh, sp, profile)
    axes = list(mesh.axis_names)
    entries = [None] + axes + [tuple(axes[:2])] + [tuple(axes[-2:])]
    rng = np.random.default_rng(0)
    for _ in range(200):
        nd = int(rng.integers(1, 4))
        spec = tuple(entries[int(rng.integers(len(entries)))]
                     for _ in range(int(rng.integers(0, nd + 1))))
        if len({a for e in spec if e for a in
                (e if isinstance(e, tuple) else (e,))}) < sum(
                len(e) if isinstance(e, tuple) else 1 for e in spec if e):
            continue                    # an axis named twice
        shape = tuple(int(rng.choice([1, 2, 3, 4, 8, 16, 48, 50, 512]))
                      for _ in range(nd))
        assert shd.fit_spec(spec, shape, mesh) == tuple(
            jsh.fit_spec(P(*spec), shape, mesh)), (spec, shape)


def test_use_mesh_nests_and_constrain_is_a_no_op_off_a_mesh():
    outer, inner = abstract("2x2"), abstract("4x2")
    x = torch.ones(4, 8)
    assert shd.active_mesh() is None
    assert shd.constrain(x, "dp", None) is x
    assert shd.constrain_heads(x[None, None], 1).shape == (1, 1, 4, 8)
    with shd.use_mesh(outer):
        with shd.use_mesh(inner, sp=False):
            assert shd.active_mesh() is inner
            assert shd.constrain(x, "dp", "sp") is x   # plain: as it is
        assert shd.active_mesh() is outer
    assert shd.active_mesh() is None


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = abstract("2x16x16")
    assert shd.Sharding(mesh, (("pod", "data"), None, "model")).placements \
        == (Shard(0), Shard(0), Shard(2))
    assert shd.Sharding(mesh, (None, "data")).placements == (
        Replicate(), Shard(1), Replicate())
    assert shd.Sharding(mesh, ()).placements == (Replicate(),) * 3


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_mesh_errors_name_the_world_they_need():
    import torch.distributed as dist
    from repro_torch.launch import mesh as pmesh
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="--nproc-per-node 4"):
        pmesh.data_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="n_data must be >= 1"):
        pmesh.data_mesh(0, device="cpu")
    with pytest.raises(RuntimeError, match="needs 256 ranks.*has 1"):
        pmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        pmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert not dist.is_initialized()
    try:
        m = pmesh.local_mesh("cpu")
        assert m.shape == {"data": 1, "model": 1}
        assert m.axis_names == ("data", "model") and m.size == 1
        assert dist.get_world_size() == 1
    finally:
        pmesh.release_world()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# pipeline_apply against JAX
# ---------------------------------------------------------------------------

N_STAGE, N_MICRO, MB, D = 4, 8, 2, 16


def _pipeline_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(N_STAGE, D, D)) * 0.2).astype(np.float32)
    x = rng.normal(size=(N_MICRO, MB, D)).astype(np.float32)
    return ws, x


def _pipeline_rank(rank, n, store, out, ws, x):
    init_rank(rank, n, store)
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((n,), ("stage",), device="cpu")
    ws, x = torch.from_numpy(ws), torch.from_numpy(x)
    fn = lambda w, v: torch.tanh(v @ w)                    # noqa: E731
    y = pipeline_apply(mesh, "stage", N_MICRO, fn, ws, x)
    errors = []
    for bad in ((ws[:3], x, N_MICRO), (ws, x, N_MICRO - 1)):
        try:
            pipeline_apply(mesh, "stage", bad[2], fn, bad[0], bad[1])
        except ValueError as e:
            errors.append(str(e))
    ys = [torch.empty_like(y) for _ in range(n)]
    torch.distributed.all_gather(ys, y)
    if rank == 0:
        dump(out, {"y": y.tolist(), "same": all(torch.equal(a, y)
                                                for a in ys),
                   "errors": errors})


def test_pipeline_matches_jax(tmp_path):
    ws, x = _pipeline_inputs()
    np.savez(tmp_path / "in.npz", ws=ws, x=x)
    code = f"""
import numpy as np, jax, jax.numpy as jnp
from repro.dist.pipeline import pipeline_apply
from repro.launch.mesh import make_mesh
a = np.load({str(tmp_path / 'in.npz')!r})
mesh = make_mesh(({N_STAGE},), ("stage",))
y = pipeline_apply(mesh, "stage", {N_MICRO},
                   lambda w, v: jnp.tanh(v @ w), jnp.asarray(a["ws"]),
                   jnp.asarray(a["x"]))
np.save({str(tmp_path / 'jax.npy')!r}, np.asarray(y))
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={N_STAGE}"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "jax.npy")
    got = spawn(_pipeline_rank, N_STAGE, tmp_path, ws, x)
    y = np.asarray(got["y"], np.float32)
    assert got["same"]                       # every rank holds the result
    assert float(np.abs(y - want).max()) <= 1e-5
    ref = x
    for s in range(N_STAGE):
        ref = np.tanh(ref @ ws[s])
    assert float(np.abs(y - ref).max()) <= 1e-5
    assert len(got["errors"]) == 2
    assert "leading dims [3] != mesh axis 'stage' size 4" in got["errors"][0]
    assert "x has 8 microbatches, expected 7" in got["errors"][1]


# ---------------------------------------------------------------------------
# the PCN engine on a data mesh
# ---------------------------------------------------------------------------

PCN_N = 96
NV = [96, 70, 50, 96, 33, 80, 60, 90]


def _pcn_specs():
    from repro_torch.engine import BlockSpec
    from repro_torch.models import dgcnn, pointnet2
    return {
        "pointnet2_c": dataclasses.replace(pointnet2.POINTNET2_C, blocks=(
            BlockSpec(32, 8, (16, 32)), BlockSpec(16, 8, (32, 48)))),
        "dgcnn_c": dataclasses.replace(
            dgcnn.with_points(dgcnn.DGCNN_C, PCN_N), blocks=(
                BlockSpec(PCN_N, 8, (24,), kind="edge", sampler="all"),
                BlockSpec(PCN_N, 8, (32,), kind="edge", sampler="all"))),
    }


def _pcn_batch(device="cpu"):
    from repro_torch import random
    from repro_torch.data.synthetic import make_cloud
    from repro_torch.engine import Batch
    rng = np.random.default_rng(0)
    xyz = np.stack([make_cloud(rng, PCN_N) for _ in range(8)])
    return Batch.make(xyz, key=random.PRNGKey(1), n_valid=NV, device=device)


def _pcn_rank(rank, n, store, out):
    init_rank(rank, n, store)
    from repro_torch import engine
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import data_mesh
    mesh = data_mesh(n, device="cpu")
    res = {"cases": {}}
    batch = _pcn_batch()
    for name, spec in _pcn_specs().items():
        params = engine.init(spec, seed=0, device="cpu")
        for mode in ("traditional", "lpcn"):
            for be in ("reference", "cuda"):
                kw = dict(spec=spec, mode=mode, fc_backend=be, device="cpu")
                ref = engine.apply(params, batch, **kw)
                got = engine.apply(params, batch, mesh=mesh, **kw)
                eng = engine.PCNEngine(spec, mode=mode, fc_backend=be,
                                       device="cpu", mesh=mesh)
                obj = eng.apply(params, batch)
                res["cases"][f"{name}-{mode}-{be}"] = dict(
                    err=float((got - ref).abs().max()),
                    obj_equal=bool(torch.equal(obj, got)),
                    finite=bool(torch.isfinite(ref).all()),
                    shape=list(got.shape))
    # the serving CLI: rank 0 serves the trace, the others follow
    rep = serve.main(["--arch", "pointnet2_c", "--reduced", "--device",
                      "cpu", "--mesh-data", str(n), "--batch", str(n),
                      "--points", "128", "--trace", "12", "--rate", "400",
                      "--serve-json", "", "--faults", "fail@1"])
    if rank == 0:
        res["cli"] = {k: rep[k] for k in ("answered", "failed", "shed",
                                           "mesh_data")}
        res["cli"]["degraded"] = rep["faults"]["degraded_dispatches"]
        dump(out, res)
    else:
        assert rep is None


@pytest.fixture(scope="module")
def pcn_mesh_run(tmp_path_factory):
    return spawn(_pcn_rank, 4, tmp_path_factory.mktemp("pcn"))


@pytest.mark.parametrize("case", [
    f"{n}-{m}-{b}" for n in ("pointnet2_c", "dgcnn_c")
    for m in ("traditional", "lpcn") for b in ("reference", "cuda")])
def test_engine_data_mesh_matches_mesh_free(case, pcn_mesh_run):
    """(4, 1) over 4 gloo ranks == the mesh-free forward (<= 1e-5, JAX's
    limit in tests/test_distributed.py), the object API == the
    functional one."""
    r = pcn_mesh_run["cases"][case]
    assert r["shape"][0] == 8
    assert r["err"] <= 1e-5, r
    assert r["obj_equal"]
    if not case.startswith("dgcnn"):    # DGCNN's NaN rows: as mesh-free
        assert r["finite"]


def test_mesh_data_cli_answers_every_request(pcn_mesh_run):
    cli = pcn_mesh_run["cli"]
    assert cli == {"answered": 12, "failed": 0, "shed": 0, "mesh_data": 4,
                   "degraded": 1}


def test_engine_mesh_noop_bit_identical():
    """A (1, 1) mesh (a world of one, in-process) changes no bit."""
    from repro_torch import engine
    from repro_torch.launch.mesh import data_mesh, release_world
    spec = _pcn_specs()["pointnet2_c"]
    params = engine.init(spec, seed=0, device="cpu")
    batch = _pcn_batch()
    try:
        mesh = data_mesh(1, device="cpu")
        for mode in ("traditional", "lpcn"):
            eng = engine.PCNEngine(spec, mode=mode, fc_backend="cuda",
                                   device="cpu")
            meng = engine.PCNEngine(spec, mode=mode, fc_backend="cuda",
                                    device="cpu", mesh=mesh)
            assert torch.equal(meng.apply(params, batch),
                               eng.apply(params, batch))
            assert "mesh={'data': 1, 'model': 1}" in repr(meng)
    finally:
        release_world()


def test_engine_mesh_needs_a_data_axis():
    from repro_torch import engine
    with pytest.raises(ValueError, match="'data' axis"):
        engine.PCNEngine(_pcn_specs()["pointnet2_c"], device="cpu",
                         mesh=abstract("4"))


def test_mesh_free_path_imports_no_dist(tmp_path):
    code = """
import sys, numpy as np, torch
base = {m for m in sys.modules if m.startswith("torch.distributed")}
from repro_torch.engine import Batch, PCNEngine
from repro_torch.models.pointnet2 import POINTNET2_C
eng = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda", device="cpu")
x = np.random.default_rng(0).standard_normal((2, 256, 3)).astype("f4")
eng.apply(eng.init(0), Batch.make(x, device="cpu"))
new = sorted(m for m in sys.modules if m.startswith("repro_torch.dist")
             or (m.startswith("torch.distributed") and m not in base))
assert not new, new
assert not torch.distributed.is_initialized()
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


# ---------------------------------------------------------------------------
# the trainer's backward under a mesh
# ---------------------------------------------------------------------------

def test_remat_recompute_carries_the_mesh_to_another_thread():
    """On the card autograd runs the backward, and with it remat's
    recompute of each layer, on a thread of its own, where ``use_mesh``'s
    context is not set; each layer carries it (``sharding.carry``).  Here
    the backward runs on another thread: the grads under a (1, 1) mesh
    equal the mesh-free ones bit for bit."""
    import threading
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import local_mesh, release_world
    from repro_torch.lm import model_zoo as zoo
    cfg = dataclasses.replace(get_config("olmo-1b", reduced=True),
                              dtype="float32")
    assert cfg.remat
    params = zoo.init(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (2, 17), generator=torch.Generator().manual_seed(1))}
    flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
    want = torch.autograd.grad(
        zoo.loss_fn(cfg, tree.unflatten(params, flat), batch)[0], flat)
    got = {}

    def backward(loss, leaves):
        try:
            got["grads"] = torch.autograd.grad(loss, leaves)
        except Exception as e:             # noqa: BLE001 (reported below)
            got["error"] = e
    try:
        mesh = local_mesh("cpu")
        with shd.use_mesh(mesh):
            leaves = [p.requires_grad_() for p in tree.leaves(shd.distribute(
                params, shd.param_shardings(params, mesh)))]
            loss, _ = zoo.loss_fn(cfg, tree.unflatten(params, leaves),
                                  shd.distribute(batch, shd.batch_shardings(
                                      batch, mesh)))
        thread = threading.Thread(target=backward, args=(loss, leaves))
        thread.start()
        thread.join()
        assert "error" not in got, got.get("error")
        for g, w in zip(got["grads"], want):
            assert torch.equal(shd.whole(g), w)
    finally:
        release_world()


# ---------------------------------------------------------------------------
# the trainer's CLI over gloo
# ---------------------------------------------------------------------------

def _cli_rank(rank, n, store, out):
    init_rank(rank, n, store)
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    history = []
    with contextlib.redirect_stdout(buf):
        losses = train.main(["--arch", "olmo-1b", "--reduced", "--device",
                             "cpu", "--steps", "2", "--batch", "2",
                             "--seq", "16"], history)
    lines = [line.split(":")[0] for line in buf.getvalue().splitlines()]
    gathered = [None] * n
    torch.distributed.all_gather_object(gathered, (losses, lines))
    if rank == 0:
        dump(out, {"ranks": gathered, "history": history})


def test_cli_under_local_mesh_over_gloo(tmp_path):
    """``launch.train`` in 4 ranks: local_mesh() is (1, 4); every rank
    sees the same losses, rank 0 alone prints the step lines."""
    got = spawn(_cli_rank, 4, tmp_path)
    losses0, lines0 = got["ranks"][0]
    assert lines0 == ["step 0", "step 1"]
    assert np.all(np.isfinite(losses0)) and len(losses0) == 2
    for losses, lines in got["ranks"][1:]:
        assert losses == losses0 and lines == []
    assert [h["loss"] for h in got["history"]] == losses0
    assert all(np.isfinite(h["grad_norm"]) for h in got["history"])


# ---------------------------------------------------------------------------
# no DTensor reaches a kernel
# ---------------------------------------------------------------------------

def _wrapper_calls(device):
    """(name, call) of every kernel wrapper on small operands of
    ``device``, each a DTensor on a world of one."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.gather_mlp import gather_mlp
    from repro_torch.kernels.hub_reuse import hub_reuse
    from repro_torch.kernels.knn import knn
    from repro_torch.kernels.ssd_chunk import ops as ssd
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1,), ("data",), device=device.type)
    g = torch.Generator().manual_seed(0)

    def dt(*shape):
        t = torch.randn(*shape, generator=g).to(device)
        return DTensor.from_local(t, mesh.device_mesh, [Replicate()])

    q = dt(1, 2, 16, 32)
    x, B = dt(1, 2, 16, 2, 8), dt(1, 2, 16, 4)
    dtt = dt(1, 2, 16, 2)
    slot = DTensor.from_local(torch.zeros(1, 2, 4, 3, dtype=torch.int32,
                                          device=device),
                              mesh.device_mesh, [Replicate()])
    return [
        ("flash_attention", lambda: fl.flash_attention(q, q, q)),
        ("flash_attention_backward",
         lambda: fl.flash_attention_backward(q, q, q, q, q)),
        ("ssd_chunk", lambda: ssd.ssd_chunk(x, B, B, dtt, dtt)),
        ("ssd_chunk_backward", lambda: ssd.ssd_chunk_backward(
            x, B, B, dtt, dtt, x, dt(1, 2, 2, 8, 4))),
        ("gather_mlp", lambda: gather_mlp(dt(1, 4, 3, 3), dt(1, 4, 3),
                                          dt(3, 8), dt(8), dt(8, 4),
                                          dt(4))),
        ("hub_reuse", lambda: hub_reuse(dt(1, 2, 5, 3), slot,
                                        dt(1, 2, 4, 4), dt(3, 8), dt(8),
                                        dt(8, 4), dt(4))),
        ("knn", lambda: knn(dt(4, 3), dt(8, 3), 2)),
    ]


def _refuses_dtensors(device):
    from repro_torch.launch.mesh import release_world
    try:
        calls = _wrapper_calls(device)
        assert len(calls) == 7
        for name, call in calls:
            with pytest.raises(TypeError, match=f"{name}: handed a DTensor"):
                call()
    finally:
        release_world()


def test_kernel_wrappers_refuse_dtensors():
    """On the CPU too: a DTensor raises before any plain fallback."""
    _refuses_dtensors(torch.device("cpu"))


@pytest.mark.cuda
def test_kernel_wrappers_refuse_dtensors_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _refuses_dtensors(torch.device("cuda"))
