"""End-to-end driver: train a small PointNet++ classifier on synthetic
clouds for a few hundred steps, then evaluate under the islandized
execution mode (the paper's deployment scenario: train exact, serve with
the Islandization Unit).  The port of the JAX package's
``examples/train_pointnet2.py``; training runs the "reference" FC backend
under autograd, evaluation the kernels (:mod:`.accuracy`).

    PYTHONPATH=src python -m repro_torch.examples.train_pointnet2 [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_pointnet2 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import random
from ..device import resolve_device
from .accuracy import evaluate, gen_task, model_init, sgd_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    xtr, ytr = gen_task(128, 256, seed=1, device=dev)
    xte, yte = gen_task(64, 256, seed=2, device=dev)
    key = random.PRNGKey(0, dev)
    params = model_init(torch.Generator().manual_seed(0), "block_end", dev)

    t0 = time.time()
    n = xtr.shape[0]
    for step in range(args.steps):
        i = (step * args.batch) % n
        loss = sgd_step(params, xtr[i:i + args.batch], ytr[i:i + args.batch],
                        key)
        if step % 25 == 0:
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"({time.time()-t0:.0f}s)", flush=True)

    for mode in ("traditional", "lpcn"):
        acc = evaluate(params, xte, yte, mode, key=key)
        print(f"test accuracy [{mode:12s}]: {acc:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
