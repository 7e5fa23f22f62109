"""Fig. 20: end-task accuracy of L-PCN's selective approximation against
traditional (exact) and Mesorasi (fully approximate) execution, the port
of the JAX package's ``benchmarks/accuracy.py``.

A small PointNet++ classifier is trained on a synthetic 8-class shape task
through the TRADITIONAL path with the "reference" FC backend (plain
PyTorch under autograd: no FC kernel has a backward, in either package),
then the same weights are evaluated under each execution mode, the
paper's setting (the accelerator changes inference, not training).
Evaluation runs under ``torch.no_grad()`` with the "cuda" FC backend by
default: ``gather_mlp`` for the dense dataflow, ``hub_reuse`` for the
reuse one (their plain versions on CPU tensors).  Mesorasi is plain
torch in both packages.

    PYTHONPATH=src python -m repro_torch.examples.accuracy [--quick]
    PYTHONPATH=src python -m repro_torch.examples.accuracy --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import random
from ..core.hub_schedule import build_schedule
from ..core.islandize import _take, islandize
from ..core.mlp import MLP, apply_mlp, init_mlp
from ..core.pipeline import (LPCNConfig, data_structuring, fc_lpcn_batched,
                             fc_traditional_batched)
from ..core.registry import get_fc_backend
from ..data.synthetic import _box, _cylinder, _sphere
from ..device import resolve_device
from ..engine.params import _mlp_from_numpy
from ..models.baselines import mesorasi_fc

# (mode, compensation) of each evaluation, and its column in the table
EVALS = (("traditional", "linear"), ("lpcn", "linear"), ("lpcn", "mlp"),
         ("mesorasi", "linear"))
ACTIVATIONS = ("block_end", "per_layer")


def tag(mode: str, comp: str) -> str:
    """The table's column of an evaluation."""
    return mode if mode != "lpcn" else f"lpcn_{comp}"


def gen_task(n_clouds: int, n_points: int, seed: int, device=None):
    """8-class shape task, separable by construction: class k is a fixed
    primitive composition (sphere / box / cylinder × scale), jittered.
    numpy draws in the JAX package's order.  -> (xs (B, N, 3) float32,
    ys (B,) int64) on ``device``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for i in range(n_clouds):
        cls = i % 8
        kind, big = cls % 4, cls // 4
        scale = 0.9 if big else 0.45
        n1 = n_points // 2
        c = rng.normal(0, 0.05, 3)
        if kind == 0:
            a = _sphere(rng, n1, c, 0.5 * scale)
            b = _sphere(rng, n_points - n1, -c, 0.25 * scale)
        elif kind == 1:
            a = _box(rng, n1, c, np.full(3, scale))
            b = _sphere(rng, n_points - n1, -c, 0.3 * scale)
        elif kind == 2:
            a = _cylinder(rng, n1, c, 0.3 * scale, 1.2 * scale)
            b = _box(rng, n_points - n1, -c, np.full(3, 0.4 * scale))
        else:
            a = _cylinder(rng, n1, c, 0.5 * scale, 0.4 * scale)
            b = _cylinder(rng, n_points - n1, -c, 0.15 * scale,
                          1.5 * scale)
        pts = np.concatenate([a, b])[:n_points]
        pts += 0.01 * rng.normal(size=pts.shape)
        pts -= pts.mean(0)
        pts /= np.abs(pts).max() + 1e-9
        xs.append(pts.astype(np.float32))
        ys.append(cls)
    return (torch.from_numpy(np.stack(xs)).to(device),
            torch.tensor(ys, dtype=torch.int64, device=device))


def model_init(generator: torch.Generator, activation: str, device=None):
    """He-normal weights from ``generator`` (not the JAX package's
    numbers: carry those across with :func:`params_from_numpy`)."""
    device = resolve_device(device)
    return {
        "mlp1": init_mlp([6, 32, 64], activation, generator=generator,
                         device=device),
        "mlp2": init_mlp([64 + 3, 64, 128], activation, generator=generator,
                         device=device),
        "head": init_mlp([128, 64, 8], "per_layer", generator=generator,
                         device=device),
    }


def params_from_numpy(tree, device=None) -> dict:
    """The JAX package's ``_model_init`` dict of MLPs (numpy leaves) as the
    port's MLPs on ``device``."""
    device = resolve_device(device)
    return {name: _mlp_from_numpy(m, device) for name, m in tree.items()}


def leaves(params: dict) -> list:
    """Every weight and bias in ``jax.tree_util``'s order (keys sorted,
    then each layer's w, b)."""
    return [t for name in sorted(params) for layer in params[name].layers
            for t in (layer.w, layer.b)]


def with_leaves(params: dict, flat) -> dict:
    """``params``' structure over the tensors ``flat`` (in :func:`leaves`
    order)."""
    it = iter(flat)
    out = {}
    for name in sorted(params):
        m = params[name]
        layers = [type(layer)(w=next(it), b=next(it)) for layer in m.layers]
        out[name] = MLP(layers=layers, activation=m.activation)
    return out


def forward(params: dict, xyz, mode: str, key, comp: str = "linear",
            activation: str = "block_end", backend: str = "reference"):
    """Logits (B, 8) of clouds ``xyz`` (B, N, 3): two SA blocks (128
    centers, then 32 on block 1's centers and features), a max over the
    centers, the head.  The counterpart of ``jax.vmap(_forward, in_axes=(None,
    0))``: the one ``key`` (2,) serves every cloud, split once into the
    blocks' keys, each used for both the sampler and the islands.
    ``activation`` is the MLPs' own (``params`` carry it); it is taken for
    the JAX package's signature.  ``backend`` names the FC backend."""
    del activation
    be = get_fc_backend(backend)
    cfg1 = LPCNConfig(n_centers=128, k=16, mode=mode, compensation=comp)
    cfg2 = LPCNConfig(n_centers=32, k=16, mode=mode, compensation=comp,
                      island_size=16, cache_capacity_x=2.0)
    b = xyz.shape[0]
    k1, k2 = random.split(key.to(xyz.device)).expand(b, 2, 2).unbind(1)

    def block(cfg, mlp, xyz_in, feats, kk):
        cidx, nbr = data_structuring(cfg, xyz_in, kk)
        centers = _take(xyz_in, cidx)
        cf = _take(feats, cidx)
        if mode == "traditional":
            f = fc_traditional_batched(mlp, xyz_in, feats, nbr, centers, cf,
                                       "sa", backend=be)
        elif mode == "mesorasi":
            f = mesorasi_fc(mlp, xyz_in, feats, nbr, centers, cf, "sa")
        else:
            n_hubs = max(cidx.shape[1] // cfg.island_size, 1)
            isl = islandize(centers, n_hubs, capacity=cfg.island_capacity,
                            key=kk)
            sched = build_schedule(isl, nbr, cfg.cache_capacity)
            f = fc_lpcn_batched(mlp, xyz_in, feats, nbr, centers, isl,
                                sched, cfg, cf, backend=be)
        return centers, f

    c1, f1 = block(cfg1, params["mlp1"], xyz, xyz, k1)
    _, f2 = block(cfg2, params["mlp2"], c1, f1, k2)
    # amax splits the gradient evenly over ties, as jnp.max's does
    return apply_mlp(params["head"], f2.amax(1))


def loss_fn(params: dict, xs, ys, key, backend: str = "reference"):
    """Mean cross-entropy of the traditional path's logits."""
    logits = forward(params, xs, "traditional", key, backend=backend)
    lp = torch.log_softmax(logits, dim=-1)
    return -lp[torch.arange(ys.shape[0], device=ys.device), ys].mean()


def grads(params: dict, xs, ys, key, backend: str = "reference"):
    """-> (loss, grads in :func:`leaves` order) of :func:`loss_fn`; the
    params' own tensors are not marked as requiring grad."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(with_leaves(params, flat), xs, ys, key, backend)
        return loss.detach(), torch.autograd.grad(loss, flat)


def sgd_step(params: dict, xs, ys, key, lr: float = 3e-3) -> float:
    """One plain SGD step, ``p - lr·g`` in place, through the "reference"
    backend.  -> the step's loss (read on the host, which waits for the
    device)."""
    loss, g = grads(params, xs, ys, key)
    with torch.no_grad():
        for p, gg in zip(leaves(params), g):
            p.sub_(lr * gg)
    return float(loss)


def train(params: dict, xs, ys, epochs: int, batch: int = 16,
          lr: float = 3e-3, step_s: list | None = None) -> list:
    """:func:`sgd_step` over ``epochs`` passes of ``batch``-cloud slices in
    order, every forward with ``PRNGKey(0)``.  ``step_s``, where given,
    gets each step's host seconds.  -> the per-step losses."""
    key = random.PRNGKey(0, xs.device)
    losses = []
    for _ in range(epochs):
        for i in range(0, xs.shape[0], batch):
            t = time.perf_counter()
            losses.append(sgd_step(params, xs[i:i + batch], ys[i:i + batch],
                                   key, lr))
            if step_s is not None:
                step_s.append(time.perf_counter() - t)
    return losses


@torch.no_grad()
def predict(params: dict, xs, mode: str, comp: str, key,
            backend: str = "cuda"):
    """Evaluation logits (B, 8) under ``mode`` / ``comp``, through the
    kernels by default (their plain versions on CPU tensors)."""
    return forward(params, xs, mode, key, comp, backend=backend)


def evaluate(params: dict, xs, ys, mode: str, comp: str = "linear",
             key=None, backend: str = "cuda") -> float:
    """Test accuracy of ``params`` under ``mode`` / ``comp``."""
    key = random.PRNGKey(0, xs.device) if key is None else key
    pred = predict(params, xs, mode, comp, key, backend).argmax(-1)
    return float((pred == ys).float().mean())


@dataclass
class AccuracyRun:
    """One :func:`run_accuracy`: ``table`` is the JAX package's result
    ({activation: {tag: accuracy}}); per activation the trained params,
    the per-step losses and host seconds, and each evaluation's logits."""
    table: dict = field(default_factory=dict)
    params: dict = field(default_factory=dict)
    losses: dict = field(default_factory=dict)
    step_s: dict = field(default_factory=dict)
    logits: dict = field(default_factory=dict)


def sizes(quick: bool) -> tuple:
    """(train clouds, test clouds, points, epochs)."""
    return (64, 32, 256, 4) if quick else (160, 64, 256, 10)


def run_accuracy(quick: bool = False, device=None,
                 init=None) -> AccuracyRun:
    """Train at each activation placement, then evaluate under the four
    modes.  Full: 160 train / 64 test clouds of 256 points, 10 epochs;
    quick: 64 / 32, 4 epochs.  ``init`` maps an activation to its
    starting params (default: :func:`model_init` from a generator seeded
    0); every forward uses ``PRNGKey(0)``."""
    device = resolve_device(device)
    n_train, n_test, n_points, epochs = sizes(quick)
    xtr, ytr = gen_task(n_train, n_points, seed=1, device=device)
    xte, yte = gen_task(n_test, n_points, seed=2, device=device)
    key = random.PRNGKey(0, device)
    run = AccuracyRun()
    for act in ACTIVATIONS:
        p0 = (init[act] if init is not None else model_init(
            torch.Generator().manual_seed(0), act, device))
        # train updates in place: leave the caller's init as it was
        params = with_leaves(p0, [t.clone() for t in leaves(p0)])
        run.step_s[act] = []
        run.losses[act] = train(params, xtr, ytr, epochs,
                                step_s=run.step_s[act])
        run.params[act] = params
        run.logits[act], run.table[act] = {}, {}
        for mode, comp in EVALS:
            logits = predict(params, xte, mode, comp, key)
            run.logits[act][tag(mode, comp)] = logits
            run.table[act][tag(mode, comp)] = float(
                (logits.argmax(-1) == yte).float().mean())
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="64 / 32 clouds, 4 epochs (full: 160 / 64, 10)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    t = time.perf_counter()
    run = run_accuracy(args.quick, args.device)
    for act in ACTIVATIONS:
        ms = run.step_s[act][2:] or run.step_s[act]
        print(f"{act}: {len(run.losses[act])} steps, loss "
              f"{run.losses[act][0]:.4f} -> {run.losses[act][-1]:.4f}, "
              f"{1e3 * sum(ms) / len(ms):.1f} ms a step (steps 3 on)")
    print(json.dumps({"accuracy": run.table,
                      "seconds": time.perf_counter() - t}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
