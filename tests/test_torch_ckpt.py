"""The port's checkpoints and training CLI (``repro_torch.ckpt.manager``,
``repro_torch.launch.train``) on the CPU: the round trip (bf16 leaves as
uint16 views), GC keeping the newest, an uncommitted checkpoint ignored
(as ``tests/test_substrate.py`` asks of JAX's), a checkpoint written by
either package restored by the other leaf for leaf, a save under a mesh
gathering one leaf at a time, and the CLI resuming bit-exactly (the
counterpart of ``tests/test_train_ckpt.py``), running ``--compress
int8``, training a world of one without a mesh (and bit-equal under one
handed to it), and refusing ``--production-mesh`` in a world of one."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "repro.dist", reason="repro.dist (sharding subsystem) not present")

from repro.ckpt.manager import CheckpointManager as JaxManager
from repro_torch import tree
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.launch import train as train_mod

torch.set_num_threads(1)
CLI = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--batch", "2",
       "--seq", "32"]


def _trees():
    params = {"a": torch.ones((4, 4), dtype=torch.bfloat16) * 1.5,
              "b": [torch.arange(3, dtype=torch.float32)],
              "c": {"z": torch.full((2,), -2.25, dtype=torch.bfloat16)}}
    opt = {"m": {"a": torch.full((4, 4), 0.5, dtype=torch.bfloat16),
                 "b": [torch.ones(3)], "c": {"z": torch.zeros(2)}},
           "step": torch.tensor(5, dtype=torch.int32)}
    return params, opt


def _zeros_like(t):
    return tree.map(torch.zeros_like, t)


def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params, opt = _trees()
    mgr.save(5, params, opt, {"seed": 1, "step": 5})
    step, p2, o2, ds = mgr.restore(_zeros_like(params), _zeros_like(opt))
    assert step == 5 and ds == {"seed": 1, "step": 5}
    for got, want in zip(tree.leaves((p2, o2)), tree.leaves((params, opt))):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert sorted(os.listdir(tmp_path / "step_000000005")) == [
        "COMMIT", "host_000.npz", "meta.json"]


def test_ckpt_restore_checks_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    params, opt = _trees()
    mgr.save(1, params, opt, {})
    params["b"] = [torch.zeros(4)]
    with pytest.raises(ValueError, match="params/b/0"):
        mgr.restore(params, opt)


def test_ckpt_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    p = {"a": torch.ones(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, p, {"m": p}, {})
    assert mgr.latest_step() == 4
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_000000003",
                                                "step_000000004"]


def test_uncommitted_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    p = {"a": torch.ones(2)}
    mgr.save(1, p, {"m": p}, {})
    os.makedirs(tmp_path / "step_000000002")     # a torn save
    os.makedirs(tmp_path / "step_000000003.tmp")
    assert mgr.latest_step() == 1
    assert CheckpointManager(str(tmp_path)).restore(p, {"m": p})[0] == 1


def test_ckpt_crosses_between_packages(tmp_path):
    """The port restores what JAX wrote and JAX what the port wrote, every
    leaf equal in value and dtype (bf16 included)."""
    params, opt = _trees()
    as_jax = lambda t: tree.map(lambda x: jnp.asarray(
        x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else
            jnp.int32 if x.dtype == torch.int32 else jnp.float32), t)
    JaxManager(str(tmp_path / "jax")).save(7, as_jax(params), as_jax(opt),
                                           {"seed": 3, "step": 7})
    step, p2, o2, ds = CheckpointManager(str(tmp_path / "jax")).restore(
        _zeros_like(params), _zeros_like(opt))
    assert (step, ds) == (7, {"seed": 3, "step": 7})
    for got, want in zip(tree.leaves((p2, o2)), tree.leaves((params, opt))):
        assert got.dtype == want.dtype and torch.equal(got, want)

    CheckpointManager(str(tmp_path / "port")).save(9, params, opt,
                                                   {"seed": 4, "step": 9})
    step, jp, jo, ds = JaxManager(str(tmp_path / "port")).restore(
        as_jax(_zeros_like(params)), as_jax(_zeros_like(opt)))
    assert (step, ds) == (9, {"seed": 4, "step": 9})
    for got, want in zip(tree.leaves((jp, jo)), tree.leaves((params, opt))):
        assert str(got.dtype) == str(want.dtype).replace("torch.", "")
        assert np.array_equal(np.asarray(got, np.float32),
                              want.float().numpy())


def test_cli_resume_bit_exact(tmp_path):
    """6 steps straight, and 3 + 3 with a restart from the checkpoint:
    the same losses (|Δ| < 1e-6, as tests/test_train_ckpt.py asks)."""
    base = CLI + ["--ckpt-every", "2"]
    ref = train_mod.main(base + ["--steps", "6", "--ckpt",
                                 str(tmp_path / "ref")])
    part1 = train_mod.main(base + ["--steps", "3", "--ckpt",
                                   str(tmp_path / "run")])
    part2 = train_mod.main(base + ["--steps", "6", "--ckpt",
                                   str(tmp_path / "run")])
    assert len(part1) == 3 and len(part2) == 3
    for a, b in zip(ref, part1 + part2):
        assert abs(a - b) < 1e-6, (ref, part1 + part2)
    assert not torch.are_deterministic_algorithms_enabled()


def test_cli_compress_runs(capsys):
    losses = train_mod.main(CLI + ["--steps", "3", "--compress", "int8",
                                   "--microbatches", "2"])
    assert len(losses) == 3 and np.all(np.isfinite(losses)), losses
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "step 0", "step 1", "step 2"]


def test_cli_refuses_production_mesh():
    """In a world of one the 16 x 16 mesh is refused, naming the world it
    needs."""
    with pytest.raises(SystemExit, match="needs 256 ranks.*has 1.*"
                                         "--nproc-per-node 256"):
        train_mod.main(CLI + ["--production-mesh"])
    assert not torch.distributed.is_initialized()


def test_cli_world_of_one_runs_without_a_mesh(monkeypatch):
    """A world of one trains on plain tensors with no process group; a
    (1, 1) mesh handed to ``main`` runs the DTensor path, its losses and
    grad norms bit-equal."""
    from repro_torch.launch.mesh import make_mesh, release_world
    seen = []
    inner = train_mod._train

    def spy(args, dev, mesh, history):
        seen.append((mesh, torch.distributed.is_initialized()))
        return inner(args, dev, mesh, history)
    monkeypatch.setattr(train_mod, "_train", spy)
    argv = CLI + ["--steps", "2", "--microbatches", "2"]
    free, meshed = [], []
    train_mod.main(argv, free)
    assert seen == [(None, False)]
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        train_mod.main(argv, meshed, mesh)
    finally:
        release_world()
    assert seen[1][0] is mesh and len(meshed) == 2
    assert meshed == free


def test_save_under_a_mesh_gathers_one_leaf_at_a_time(tmp_path,
                                                      monkeypatch):
    """Under a mesh each leaf is gathered whole and copied to host memory
    before the next is gathered (a device never holds the whole state);
    the checkpoint restores bit-equal without a mesh."""
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import manager as mgr_mod
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_mesh, release_world
    params, opt = _trees()
    events = []
    gather, to_host = DTensor.full_tensor, mgr_mod._to_numpy

    def full_tensor(self, *a, **k):
        events.append("gather")
        return gather(self, *a, **k)

    def host(t):
        events.append("host")
        return to_host(t)
    monkeypatch.setattr(DTensor, "full_tensor", full_tensor)
    monkeypatch.setattr(mgr_mod, "_to_numpy", host)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        state = shd.distribute((params, opt), shd.param_shardings(
            (params, opt), mesh))
        CheckpointManager(str(tmp_path)).save(3, *state, {"step": 3})
    finally:
        release_world()
    n = len(tree.leaves((params, opt)))
    assert events == ["gather", "host"] * n
    step, p2, o2, _ = CheckpointManager(str(tmp_path)).restore(
        _zeros_like(params), _zeros_like(opt))
    for got, want in zip(tree.leaves((p2, o2)), tree.leaves((params, opt))):
        assert got.dtype == want.dtype and torch.equal(got, want)
