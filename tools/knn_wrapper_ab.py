#!/usr/bin/env python3
"""Time the knn wrapper of two trees on the same calls, in turns.

    python3 tools/knn_wrapper_ab.py --against DIR [--seed N] [--iters N]

``DIR`` is another checkout's root (e.g. a parent commit unpacked with
``git archive``).  Saves chip_smoke.py's knn calls of the main path
(``knn_call_sets``: block 1 and block 2, 8 calls each, one per cloud) to
``build/repro_torch/knn_wrapper_ab.pt``, then runs one child process per
turn (against, this tree, this tree, against), each importing its tree's
``repro_torch`` (so each builds its own library and uses its own Python
wrapper) and timing the 8 calls of each block through
``repro_torch.kernels.knn.knn`` with CUDA events: wall time, host work
between launches included.  Prints one JSON line per (tree, turn, block)
with ms for the 8 calls, best of 5 runs of ``--iters``, and the card's
name and power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILD = r"""
import json, sys, torch
from repro_torch.kernels.knn import knn
sets = torch.load(sys.argv[1])
iters = int(sys.argv[2])
for name, calls in sets.items():
    calls = [(c.cuda(), p.cuda(), k) for c, p, k in calls]
    for c, p, k in calls:
        knn(c, p, k)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            for c, p, k in calls:
                knn(c, p, k)
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / iters)
    print(json.dumps({"block": name, "calls": len(calls), "ms": best}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="another checkout's root, with src/repro_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("knn_wrapper_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.models.pointnet2 import POINTNET2_C

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda")
    batch = chip_smoke.main_batch(args.seed, dev)
    sets, _ = chip_smoke.knn_call_sets(POINTNET2_C, batch, args.seed, dev)
    saved = {name: [(c.cpu(), p.cpu(), k) for c, p, k in sets[name]]
             for name in ("blk1", "blk2")}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "knn_wrapper_ab.pt"
    torch.save(saved, path)
    trees = {"against": Path(args.against).resolve(), "this": ROOT}
    for turn, tree in enumerate(("against", "this", "this", "against")):
        env = {**os.environ, "PYTHONPATH": str(trees[tree] / "src")}
        out = subprocess.run([sys.executable, "-c", CHILD, str(path),
                              str(args.iters)], env=env, check=True,
                             capture_output=True, text=True,
                             cwd=trees[tree]).stdout
        for line in out.splitlines():
            print(json.dumps({"tree": tree, "turn": turn,
                              **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
