#!/usr/bin/env python3
"""pointnet2_c's lpcn forward under each data structuring of
``chip_smoke.DS_VARIANTS``, timed in turns (GPU only).

    python3 tools/ds_variants_timing.py [--rounds 5] [--seed 0]

On the smoke's main batch ((8, 1024) seeded clouds) with the smoke's
seeded weights and biases, ``--rounds`` rounds each time every variant's
stages once (``chip_smoke.breakdown``: host clock, a device sync after
each stage), the order reversed every other round; then one forward of
each variant under torch.profiler (``chip_smoke.device_profile``): the
kernel launches, the summed kernel time and the device's idle share of
the profiled wall time.  Prints one JSON line per variant with the
median, min and max of each stage over the rounds, beside the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ds_variants_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.engine import PCNEngine
    from repro_torch.models.pointnet2 import POINTNET2_C

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device()
    params = cs.seed_biases(PCNEngine(POINTNET2_C).init(seed=args.seed),
                            torch.Generator().manual_seed(args.seed + 1))
    batch = cs.main_batch(args.seed, dev)
    specs = {name: (replace(POINTNET2_C, blocks=tuple(
        replace(b, sampler=s, neighbor=n) for b in POINTNET2_C.blocks)), kw)
        for name, (s, n, kw) in cs.DS_VARIANTS.items()}
    for spec, kw in specs.values():             # warm-up: builds, caches
        cs.breakdown(params, spec, batch, repeats=1, isl_kw=kw)
    times = {name: [] for name in specs}
    for r in range(args.rounds):
        order = list(specs) if r % 2 == 0 else list(reversed(specs))
        for name in order:
            spec, kw = specs[name]
            times[name].append(cs.breakdown(params, spec, batch, repeats=1,
                                            isl_kw=kw))
    for name, (spec, kw) in specs.items():
        eng = PCNEngine(spec, mode="lpcn", fc_backend="cuda", isl_kw=kw)
        prof = cs.device_profile(lambda b: eng.apply(params, b), batch)
        row = {"name": name, "device": smi, "rounds": args.rounds}
        for stage in ("structure_ms", "fc_ms", "tail_ms"):
            xs = [t[stage] for t in times[name]]
            row[stage] = {"median": statistics.median(xs), "min": min(xs),
                          "max": max(xs)}
        fwd = [sum(t.values()) for t in times[name]]
        row["forward_ms"] = {"median": statistics.median(fwd),
                             "min": min(fwd), "max": max(fwd)}
        row["profile"] = {
            "wall_ms": prof["profiled_wall_ms"],
            "kernel_launches": prof["kernel_launches"],
            "device_busy_ms": prof["device_busy_ms"],
            "idle_share": 1 - prof["device_busy_ms"]
            / prof["profiled_wall_ms"],
            "top": prof["top"][:4]}
        print(json.dumps({"ds_timing": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
