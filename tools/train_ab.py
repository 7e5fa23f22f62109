#!/usr/bin/env python3
"""Time the trainer of two trees on the same runs, in turns (GPU only).

    python3 tools/train_ab.py --against DIR [--arch olmo-1b ...]
                              [--steps 8] [--rounds 1] [--seed 0]

``DIR`` is another checkout's root (e.g. a parent commit unpacked with
``git archive``).  For each ``--arch`` (as published, the
``chip_smoke.TRAIN_MAIN`` run: bf16 params, f32 AdamW state, remat, 4 x
2048 tokens in 2 microbatches) runs ``repro_torch.launch.train.main`` in
one child process per turn (``--rounds`` times: against, this tree, this
tree, against), each importing its tree's ``repro_torch``, with no
launcher (a world of one).  The kernels are built once from this tree and
copied beside the other's where its sources are the same (the libraries
are named by a hash of source and flags).  Prints the card's name and
power limit first, then one JSON line per (arch, tree, turn): each step's
seconds (the trainer's ``dt``: the batch's copy to the loss on the host),
the mean over the steps after the first two in ms, the losses; then per
arch whether every turn's losses were bit-equal.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILD = r"""
import contextlib, io, json, sys
import torch
from repro_torch.launch import train
out = io.StringIO()
with contextlib.redirect_stdout(out):
    losses = train.main(sys.argv[1:])
print(out.getvalue(), end="")
print(json.dumps({"losses": losses}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="another checkout's root, with src/repro_torch")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("train_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch import kernels
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    trees = {"against": Path(args.against).resolve(), "this": ROOT}
    kernels.build_all()
    other = trees["against"] / "build" / "repro_torch"
    other.mkdir(parents=True, exist_ok=True)
    for lib in _build.BUILD_DIR.glob("lib*"):
        if not (other / lib.name).exists():
            shutil.copy2(lib, other / lib.name)
    runs = {r["arch"]: r for r in chip_smoke.TRAIN_MAIN}
    order = ("against", "this", "this", "against") * args.rounds
    for arch in args.arch or ["olmo-1b"]:
        r = runs[arch]
        argv = ["--arch", arch, "--steps", str(args.steps), "--batch",
                str(r["b"]), "--seq", str(r["s"]), "--microbatches",
                str(r["microbatches"]), "--seed", str(args.seed)]
        seen = []
        for turn, tree in enumerate(order):
            env = {**os.environ, "PYTHONPATH": str(trees[tree] / "src"),
                   **chip_smoke.TRAIN_ENV}
            out = subprocess.run([sys.executable, "-c", CHILD, *argv],
                                 env=env, check=True, capture_output=True,
                                 text=True, cwd=trees[tree]).stdout
            lines = out.splitlines()
            dts = [float(m.group(1)) for m in
                   (re.search(r"dt=([0-9.]+)s", x) for x in lines) if m]
            losses = json.loads(lines[-1])["losses"]
            seen.append(losses)
            window = dts[2:]
            print(json.dumps({"arch": arch, "tree": tree, "turn": turn,
                              "step_s": dts,
                              "step_ms": 1e3 * sum(window) / len(window),
                              "losses": losses, "card": smi.splitlines()[0]}),
                  flush=True)
        print(json.dumps({"arch": arch, "losses_bit_equal": all(
            x == seen[0] for x in seen)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
