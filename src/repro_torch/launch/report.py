"""Report generator (the port of ``repro.launch.report``): merge the dry
run's JSONs -> markdown (coverage, the roofline tables, the memory
table) for the H100 meshes.

    PYTHONPATH=src python -m repro_torch.launch.report [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os

from .. import HW
from ..configs import ARCH_IDS, SHAPES
from .roofline import build_rows, to_markdown

HBM_GB = f"{HW['hbm_bytes'] / 1e9:g} GB"


def merge(paths):
    recs = {}
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p) as fh:
            for r in json.load(fh):
                recs[(r["arch"], r["shape"], r.get("multi_pod", False))] = r
    return list(recs.values())


def coverage(records, multi_pod):
    total = ok = skipped = err = missing = 0
    missing_cells = []
    for a in ARCH_IDS:
        for s in SHAPES:
            total += 1
            r = next((x for x in records
                      if x["arch"] == a and x["shape"] == s
                      and x.get("multi_pod", False) == multi_pod), None)
            if r is None:
                missing += 1
                missing_cells.append(f"{a}×{s}")
            elif r["status"] == "ok":
                ok += 1
            elif r["status"] == "skipped":
                skipped += 1
            else:
                err += 1
                missing_cells.append(f"{a}×{s}(ERR)")
    return dict(total=total, ok=ok, skipped=skipped, error=err,
                missing=missing, missing_cells=missing_cells)


def memory_table(path="results/memmodel.json"):
    if not os.path.exists(path):
        return "(memmodel.json missing)"
    with open(path) as fh:
        rows = json.load(fh)
    out = [f"| arch | shape | GiB/device (analytic) | fits {HBM_GB} |",
           "|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r['arch']} | {r['shape']} | "
                   f"{r.get('gib','?')} | {r['fits_hbm']} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    records = merge(["results/dryrun.json", "results/dryrun_2pod.json"])
    parts = []
    for mp in (False, True):
        cov = coverage(records, mp)
        mesh = ("2×16×16 (512 H100s, fake world)" if mp
                else "16×16 (256 H100s, fake world)")
        parts.append(f"\n### Dry-run coverage — {mesh}\n")
        parts.append(
            f"{cov['ok']} ok / {cov['skipped']} skipped (documented "
            f"long_500k full-attention skips) / {cov['error']} error / "
            f"{cov['missing']} not yet traced of {cov['total']} cells.")
        if cov["missing_cells"]:
            parts.append("Outstanding: " + ", ".join(cov["missing_cells"]))
    parts.append("\n### Roofline table — single-pod (per-device terms)\n")
    parts.append(to_markdown(build_rows(records, False)))
    parts.append("\n### Roofline table — multi-pod\n")
    parts.append(to_markdown(build_rows(records, True)))
    parts.append(f"\n### Analytic per-device memory against one H100's "
                 f"{HBM_GB} (launch/memmodel.py)\n")
    parts.append(memory_table())
    text = "\n".join(parts)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(text)
    print(text)
    return text


if __name__ == "__main__":
    main()
