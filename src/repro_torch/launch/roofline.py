"""Roofline report (the port of ``repro.launch.roofline``): read the dry
run's records -> a three-term roofline table a cell (markdown), its
dominant term, the MODEL / traced flops ratio and a one-line lever, over
the H100's data-sheet peaks (``repro_torch.HW``).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--json PATH]
"""
from __future__ import annotations

import argparse
import json

from .. import HW
from ..configs import SHAPES, get_config

CHIP_PEAK = HW["peak_bf16_flops"]
HBM_BW = HW["hbm_bw"]
LINK_BW = HW["nvlink_bw"]


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs: train = 6·N_active·tokens (fwd+bwd);
    prefill = 2·N_active·tokens; decode = 2·N_active·batch (one token).
    (Attention score FLOPs intentionally excluded — the ratio then shows
    attention+remat+padding overhead explicitly.)"""
    cfg = get_config(arch)
    sp = SHAPES[shape_name]
    n_act = cfg.param_counts()["active"]
    if sp.kind == "train":
        return 6.0 * n_act * sp.global_batch * sp.seq_len
    if sp.kind == "prefill":
        return 2.0 * n_act * sp.global_batch * sp.seq_len
    return 2.0 * n_act * sp.global_batch


def lever(rec: dict) -> str:
    """What to change in a cell, by its dominant term (the H100's
    levers)."""
    d = rec["dominant"]
    kind = SHAPES[rec["shape"]].kind
    if d == "collective_s":
        cb = rec["collective_bytes_per_chip"]
        top = max((k for k in cb if k != "total"), key=lambda k: cb[k])
        return (f"cut {top} bytes over NVLink (weight-gather caching / "
                f"larger per-device batch / TP->DP rebalance)")
    if d == "memory_s":
        if kind == "decode":
            return "decode is HBM-bound by design: KV/state streaming; " \
                   "quantize cache or batch more requests"
        return "raise arithmetic intensity: fuse elementwise ops into " \
               "kernels, flash attention, bigger microbatch"
    return "compute-bound: good; next is tensor-core use (wgmma tiles, " \
           "fusion)"


def build_rows(records: list, multi_pod: bool = False) -> list:
    rows = []
    for r in records:
        if r.get("multi_pod") != multi_pod:
            continue
        if r["status"] == "skipped":
            rows.append({"arch": r["arch"], "shape": r["shape"],
                         "skipped": r["reason"]})
            continue
        if r["status"] != "ok":
            rows.append({"arch": r["arch"], "shape": r["shape"],
                         "error": r.get("error", "?")[:80]})
            continue
        chips = r["chips"]
        mf = model_flops(r["arch"], r["shape"])
        hlo_total = r["hlo_flops_per_chip"] * chips
        terms = dict(compute_s=r["compute_s"], memory_s=r["memory_s"],
                     collective_s=r["collective_s"])
        dom = max(terms, key=terms.get)
        bound = max(terms.values())
        # roofline fraction: useful-FLOPs time at peak / bound term
        ideal_s = mf / (chips * CHIP_PEAK)
        rows.append({
            "arch": r["arch"], "shape": r["shape"],
            "compute_s": terms["compute_s"],
            "memory_s": terms["memory_s"],
            "collective_s": terms["collective_s"],
            "dominant": dom,
            "model_flops": mf,
            "hlo_flops": hlo_total,
            "useful_ratio": mf / max(hlo_total, 1),
            "roofline_frac": ideal_s / max(bound, 1e-30),
            "lever": lever(r),
        })
    return rows


def to_markdown(rows: list) -> str:
    out = ["| arch | shape | compute_s | memory_s | collective_s | "
           "dominant | MODEL/HLO | roofline-frac | lever |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"skipped | — | — | {r['skipped'][:60]} |")
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"ERROR | — | — | {r['error']} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"{r['dominant'].replace('_s','')} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_frac']:.3f} | "
            f"{r['lever'][:70]} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="results/dryrun.json")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    with open(args.json) as fh:
        records = json.load(fh)
    text = to_markdown(build_rows(records, args.multi_pod))
    print(text)
    return text


if __name__ == "__main__":
    main()
