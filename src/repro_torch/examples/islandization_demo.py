"""Visual / inspectable demo of Octree-based Islandization (paper Fig. 9):
prints island composition, BFS rounds and the Hub-Cache schedule for a
small cloud, and renders islands as ASCII (xy projection).  The port of
the JAX package's ``examples/islandization_demo.py``.

    PYTHONPATH=src python -m repro_torch.examples.islandization_demo
    PYTHONPATH=src python -m repro_torch.examples.islandization_demo --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import random
from ..core.hub_schedule import build_schedule
from ..core.islandize import _take, islandize
from ..core.pipeline import LPCNConfig, data_structuring
from ..core.registry import SAMPLERS
from ..data.synthetic import make_cloud
from ..device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(3)
    # one cloud, as a batch of one
    xyz = torch.from_numpy(make_cloud(rng, 512)).to(dev)[None]
    key = random.PRNGKey(0, dev)[None]
    # samplers / neighbor methods are registry-resolved by name: swap any
    # of them (or register your own via repro_torch.engine.register_sampler)
    print(f"registered samplers: {SAMPLERS.names()}")
    cfg = LPCNConfig(n_centers=128, k=16, island_size=16,
                     sampler="fps", neighbor="pointacc")
    cidx, nbr = data_structuring(cfg, xyz, key)
    centers = _take(xyz, cidx)

    isl = islandize(centers, 8, capacity=32, key=key)
    sched = build_schedule(isl, nbr, cfg.cache_capacity)

    members = isl.members[0].cpu().numpy()
    rounds = isl.round_of[0].cpu().numpy()
    c = centers[0].cpu().numpy()
    print("island | size | hub idx | BFS rounds (inside->outside)")
    for h in range(members.shape[0]):
        row = members[h][members[h] >= 0]
        if len(row) == 0:
            continue
        print(f"  {h:4d} | {len(row):4d} | {row[0]:7d} | "
              f"{rounds[row].tolist()}")

    # ASCII map: island id per center, xy projection
    grid = [[" "] * 64 for _ in range(24)]
    assign = np.full(c.shape[0], -1)
    for h in range(members.shape[0]):
        for m in members[h][members[h] >= 0]:
            assign[m] = h
    for i, (x, y, _z) in enumerate(c):
        gx = int((x + 1) / 2 * 63)
        gy = int((y + 1) / 2 * 23)
        grid[gy][gx] = chr(ord("A") + assign[i] % 26) \
            if assign[i] >= 0 else "."
    print("\nxy projection (letter = island):")
    for row in reversed(grid):
        print("".join(row))

    live = float((sched.reuse_slot >= 0).float().mean())
    print(f"\ncached positions: {live:.1%} of all (subset, k) slots")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
