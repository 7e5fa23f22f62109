#!/usr/bin/env python3
"""Show that chip_smoke.py's knn checks fail planted faults.

    python3 tools/knn_planted_faults.py [--seed N]

Builds copies of ``src/repro_torch/csrc/knn.cu`` with one fault each
(under ``build/repro_torch/faults/knn/``; the sources are not touched),
runs each through ``repro_torch.kernels.knn`` on chip_smoke.py's knn
calls (``knn_call_sets``: the main path's blocks, block 1 at k = 96 and
300, dgcnn_s's cloud) and its integer-grid cases (``KNN_TIES``), and
prints one JSON line per (fault, shape): the index mismatches against
``knn_ref`` where the distance order is decided (the smoke's limit: 0),
all index mismatches on the grid cases (limit: 0, ties included) and max
|Δd| beside the smoke's 1e-5 · max(1, max|d|).  The unchanged source runs
at every shape.  Exits 1 if it breaks a limit or a fault passes every
shape.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

# name -> (text, its replacement); each text occurs once in knn.cu
FAULTS = {
    # equal distances ordered by the higher index first
    "ties_to_higher_index": ("(ad == bd && ai < bi)", "(ad == bd && ai > bi)"),
    # the merge across warps drops each list's last entry
    "merge_drops_last_entry": ("if (i >= n2) continue;",
                               "if (i >= n2 - 1) continue;"),
    # the key's distance threshold <= instead of <: a key is below an
    # equal-distance key whatever their indices.  (The scan's candidate
    # test d < k-th is not the place: a candidate tied with the k-th has
    # a higher index and its merge ranks it after, so <= there is exact;
    # tools/knn_variants.py times it as filter_le.)
    "kth_threshold_le": ("return ad < bd ||", "return ad <= bd ||"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("knn_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.knn import knn, knn_ref
    from repro_torch.kernels.knn.ops import _declare
    from repro_torch.models.pointnet2 import POINTNET2_C

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    files = ("knn.cu", "tf32x3.cuh")
    sound = {f: (_build.CSRC / f).read_text() for f in files}
    sources = {"none": sound}
    for name, (old, new) in FAULTS.items():
        if sound["knn.cu"].count(old) != 1:
            raise RuntimeError(f"fault {name}: {old!r} occurs "
                               f"{sound['knn.cu'].count(old)} times")
        sources[name] = {**sound, "knn.cu": sound["knn.cu"].replace(old,
                                                                    new)}
    libs = build(sources, _build.BUILD_DIR / "faults" / "knn")

    dev = torch.device("cuda")
    batch = chip_smoke.main_batch(args.seed, dev)
    sets, _ = chip_smoke.knn_call_sets(POINTNET2_C, batch, args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    for s, n, k in chip_smoke.KNN_TIES:
        c, p = (torch.randint(0, 8, (m, 3), generator=gen,
                              device=dev).float() for m in (s, n))
        sets[f"ties S={s} N={n} k={k}"] = [(c, p, k)]
    broken = {name: False for name in libs}
    ok = True
    for shape, calls in sets.items():
        refs = []
        for c, p, k in calls:
            d_ext, i_ext = knn_ref(c, p, min(k + 1, p.shape[0]))
            d_next = (d_ext[:, k:] if k < p.shape[0] else
                      torch.full_like(d_ext[:, :1], float("inf")))
            refs.append((d_ext[:, :k], i_ext[:, :k], d_next))
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            _build._LIBS["knn"] = lib
            before = _build.LAUNCHES["knn"]
            outs = []
            for c, p, k in calls:
                # the wrapper's output block, freed full of -1 just before:
                # a slot the kernel leaves unwritten reads -1, not the
                # last run's answer
                del_me = torch.full((2, c.shape[0], k), -1, dtype=torch.int32,
                                    device=dev)
                del del_me
                outs.append(knn(c, p, k))
            torch.cuda.synchronize()
            if _build.LAUNCHES["knn"] != before + len(calls):
                raise RuntimeError(f"{shape}: the kernel did not launch")
            err, tol, wrong, decided = 0.0, 0.0, 0, 0
            for (d, i), (d_ref, i_ref, d_next) in zip(outs, refs):
                e, t, w, dw = chip_smoke.knn_mismatch(d, i, d_ref, i_ref,
                                                      d_next)
                err, tol = max(err, e), max(tol, t)
                wrong, decided = wrong + w, decided + dw
            ties = shape.startswith("ties")
            breaks = not (err <= tol and decided == 0
                          and (not ties or wrong == 0))
            print(json.dumps(dict(fault=name, shape=shape, max_abs_err=err,
                                  tol=tol, idx_mismatch=wrong,
                                  idx_mismatch_decided=decided,
                                  breaks=breaks)), flush=True)
            if name == "none":
                ok &= not breaks
            broken[name] |= breaks
    _build._LIBS.pop("knn", None)
    ok &= all(broken[name] for name in FAULTS)
    print(json.dumps({"ok": ok, "broken": broken,
                      "limits": "decided order exact, grid ties exact, "
                                "|Δd| <= 1e-5 · max(1, max|d|)"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
