#!/usr/bin/env python3
"""Show that chip_smoke.py's ssd_chunk limit fails planted faults.

    python3 tools/ssd_chunk_planted_faults.py [--seed N]

Builds copies of ``src/repro_torch/csrc/ssd_chunk.cu`` and its headers
``ssd_tiles.cuh`` and ``tf32x3.cuh`` with one fault each (under
``build/repro_torch/faults/ssd_chunk/``; the sources are not touched),
runs each through ``repro_torch.kernels.ssd_chunk`` at chip_smoke.py's
``SSD_LAYERS`` (a Mamba2-2.7B layer at chunks of 64 and 128) and
``SSD_PARITY`` shapes (two P and two S tiles, ragged tiles), and prints
one JSON line per (fault, shape): max |Δ| of y_in and of the states
against ``ssd_chunk_ref`` beside the smoke's limit 2e-4 · max(1,
max|plain|).  The output block is freed full of NaN just before each
call, so what a fault leaves unwritten cannot read as the last run's
answer.  The unchanged sources run at every shape.  Exits 1 if they
break the limit or a fault passes it everywhere.  Needs one CUDA device.
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

# name -> (file, text, its replacement); each text occurs once in its file
FAULTS = {
    # 1xTF32: the two small products dropped
    "one_tf32_pass": ("tf32x3.cuh",
                      "  mma(c, a.small, b.big);\n  mma(c, a.big, b.small);\n",
                      ""),
    # M's decay taken above the diagonal too (not masked to 0)
    "exp_above_diagonal_unmasked": (
        "ssd_tiles.cuh", "return on ? cb * __expf(ci - cj) * dj : 0.f;",
        "return cb * __expf(ci - cj) * dj;"),
    # the last 64-column tile of P never computed
    "last_p_tile_dropped": ("ssd_chunk.cu", "p.nP = (P + kPT - 1) / kPT;",
                            "p.nP = (P - 1) / kPT;"),
    # the last 128-column tile of S never loaded or computed
    "last_s_tile_dropped": ("ssd_chunk.cu", "p.nS = (S + kST - 1) / kST;",
                            "p.nS = (S - 1) / kST;"),
    # the states' decay taken to cum[q - 2], not to the chunk's end
    "decay_to_cum_q_minus_2": ("ssd_chunk.cu",
                               "const float cend = cum[p.Q - 1];",
                               "const float cend = cum[p.Q - 2];"),
}
FILES = ("ssd_chunk.cu", "ssd_tiles.cuh", "tf32x3.cuh")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ssd_chunk_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref
    from repro_torch.kernels.ssd_chunk.ops import _declare

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
    libs = build(sources, _build.BUILD_DIR / "faults" / "ssd_chunk")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    shapes = {name: tuple(m.values())
              for name, m in chip_smoke.SSD_LAYERS.items()}
    shapes.update({"bs={} nc={} q={} H={} P={} S={}".format(*shp): shp
                   for shp in chip_smoke.SSD_PARITY})
    broken = {name: False for name in libs}
    ok = True
    for shape, (bs, nc, q, h, p, s) in shapes.items():
        ops = chip_smoke.ssd_inputs(gen, dev, bs, nc, q, h, p, s)
        refs = ssd_chunk_ref(*ops)
        tols = [2e-4 * max(1.0, r.abs().max().item()) for r in refs]
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            _build._LIBS["ssd_chunk"] = lib
            poison = torch.full((sum(r.numel() for r in refs),),
                                float("nan"), device=dev)
            del poison
            before = _build.LAUNCHES["ssd_chunk"]
            out = ssd_chunk(*ops)
            torch.cuda.synchronize()
            if _build.LAUNCHES["ssd_chunk"] != before + 1:
                raise RuntimeError(f"{shape}: the kernel did not launch")
            errs = [(o - r).abs().max().item() for o, r in zip(out, refs)]
            breaks = not all(e <= t for e, t in zip(errs, tols))
            print(json.dumps(dict(fault=name, shape=shape,
                                  y_in_err=errs[0], y_in_tol=tols[0],
                                  states_err=errs[1], states_tol=tols[1],
                                  breaks=breaks)), flush=True)
            if name == "none":
                ok &= not breaks
            broken[name] |= breaks
    _build._LIBS.pop("ssd_chunk", None)
    ok &= all(broken[name] for name in FAULTS)
    print(json.dumps({"ok": ok, "broken": broken,
                      "limit": "2e-4 * max(1, max|plain|)"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
