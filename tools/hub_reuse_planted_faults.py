#!/usr/bin/env python3
"""Show that chip_smoke.py's hub_reuse limit fails planted faults.

    python3 tools/hub_reuse_planted_faults.py [--seed N]

Builds copies of ``src/repro_torch/csrc/hub_reuse.cu`` and its header
``tf32x3.cuh`` with one fault each (written under
``build/repro_torch/faults/hub_reuse/``; the sources are not touched),
runs each through ``repro_torch.kernels.hub_reuse`` at both PointNet++(c)
block shapes of chip_smoke.py (B = 8, live masked, subsets with no live
slot) and at block 2's widths with C = 256 cache rows (``REUSE_C256``,
two launches a call; the dropped-chunk fault runs there only), and
prints one JSON line per (fault, block): max |Δ| against
``hub_reuse_ref`` beside chip_smoke.py's limit 1e-4 · max(1, max|plain|),
and whether the -BIG identity came out exactly.  Exits 1 if the unchanged
sources break the limit or a fault passes it.  Needs one CUDA device.
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

# the two small products of tf32x3::mma3
SMALL_PASSES = "  mma(c, a.small, b.big);\n  mma(c, a.big, b.small);\n"
# name -> (file, text, its replacement); each text occurs once in its file
FAULTS = {
    # 1xTF32: the two small products dropped
    "one_tf32_pass": ("tf32x3.cuh", SMALL_PASSES, ""),
    # y without the last 64-column chunk of h
    "last_hd_chunk_skipped": ("hub_reuse.cu",
                              "p.nchunk = (Hd + kNC - 1) / kNC;",
                              "p.nchunk = (Hd - 1) / kNC;"),
    # every cached slot live: live is not read
    "live_ignored": ("hub_reuse.cu", "(p.live == nullptr || lv[",
                     "(true || lv["),
    # the compensation not added
    "comp_dropped": ("hub_reuse.cu", "-kBig : m + c;", "-kBig : m;"),
    # a subset with no live slot written as 0, not the merge identity
    "big_identity_as_zero": ("hub_reuse.cu", "-kBig : m + c;",
                             "0.f : m + c;"),
    # past 128 cache rows: the second chunk's launch does nothing
    "chunk_dropped": ("hub_reuse.cu",
                      "  const int Cc = min(kMaxC, C - c0);",
                      "  if (c0 > 0) return 0;\n"
                      "  const int Cc = min(kMaxC, C - c0);"),
}
# faults that only a C past one launch's 128 rows shows: run there only
LARGE_C = ("chunk_dropped",)
FILES = ("hub_reuse.cu", "tf32x3.cuh")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("hub_reuse_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
    from repro_torch.kernels.hub_reuse.ops import _declare

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sound = {f: (_build.CSRC / f).read_text() for f in FILES}
    sources = {"none": sound}
    for name, (fname, old, new) in FAULTS.items():
        if sound[fname].count(old) != 1:
            raise RuntimeError(f"fault {name}: {old!r} occurs "
                               f"{sound[fname].count(old)} times in {fname}")
        sources[name] = {**sound, fname: sound[fname].replace(old, new)}
    libs = build(sources, _build.BUILD_DIR / "faults" / "hub_reuse")

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    ok = True
    for blk, shp in {**chip_smoke.REUSE, **chip_smoke.REUSE_C256}.items():
        pool, slot, comp, w1, b1, w2, b2, live = chip_smoke.reuse_inputs(
            gen, dev, chip_smoke.B, **shp)
        ops = (pool, slot, comp, w1, b1, w2, b2)
        ref = hub_reuse_ref(*ops, live=live)
        empty = ref <= -chip_smoke.BIG / 2
        tol = chip_smoke.TOL * max(1.0, ref[~empty].abs().max().item())
        for name, so in libs.items():
            if name in LARGE_C and shp["c"] <= 128:
                continue
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            _build._LIBS["hub_reuse"] = lib
            before = _build.LAUNCHES["hub_reuse"]
            out = hub_reuse(*ops, live=live)
            torch.cuda.synchronize()
            if _build.LAUNCHES["hub_reuse"] != before + -(-shp["c"] // 128):
                raise RuntimeError(f"{blk}: the kernel did not launch")
            identity = bool(torch.equal(out[empty], ref[empty]))
            err = (out[~empty] - ref[~empty]).abs().max().item()
            breaks = not (identity and err <= tol)
            print(json.dumps(dict(fault=name, block=blk, max_abs_err=err,
                                  tol=tol, big_identity_exact=identity,
                                  breaks=breaks)), flush=True)
            ok &= breaks if name != "none" else not breaks
    _build._LIBS.pop("hub_reuse", None)
    print(json.dumps({"ok": ok, "limit": "1e-4 * max(1, max|plain|), "
                      "-BIG exact"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
