"""Hillclimb harness (the port of ``repro.launch.hillclimb``): trace ONE
cell again with config overrides and report its three roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch qwen2-72b --shape train_4k \\
        --set seq_shard_blocks=False --tag no_sp

The overridden config goes to ``dryrun.run_cell`` as an argument.  The
record, with its tag and overrides, is appended to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from ..configs import get_config
from . import dryrun


def parse_override(s: str):
    k, v = s.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg overrides key=value")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", default="results/hillclimb.json")
    args = ap.parse_args(argv)

    overrides = dict(parse_override(s) for s in args.set)
    cfg = dataclasses.replace(get_config(args.arch), **overrides)
    t0 = time.time()
    with dryrun.World(args.multi_pod) as world:
        rec = dryrun.run_cell(args.arch, args.shape, args.multi_pod,
                              world.mesh, cfg=cfg)
    rec["tag"] = args.tag
    rec["overrides"] = overrides
    rec["wall_s"] = round(time.time() - t0, 1)

    hist = []
    if os.path.exists(args.out):
        with open(args.out) as fh:
            hist = json.load(fh)
    hist.append(rec)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(hist, fh, indent=1)

    if rec["status"] == "ok":
        print(f"[{args.tag}] {args.arch} × {args.shape}"
              f"{' (2pod)' if args.multi_pod else ''}")
        for k in ("compute_s", "memory_s", "collective_s", "dominant"):
            print(f"  {k:14s} {rec[k]}")
        cb = rec["collective_bytes_per_chip"]
        print("  collectives  ",
              {k: f"{v/1e9:.2f}GB" for k, v in cb.items()})
    else:
        print(rec.get("error"), "\n", rec.get("trace", "")[-1500:])
    return rec


if __name__ == "__main__":
    main()
