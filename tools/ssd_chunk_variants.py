#!/usr/bin/env python3
"""Time text variants of the ssd_chunk kernel side by side.

    python3 tools/ssd_chunk_variants.py [--seed N] [--iters N]
        [--only committed,one_pass] [--shapes a,b] [--against DIR]

Builds copies of ``src/repro_torch/csrc/ssd_chunk.cu``, ``ssd_tiles.cuh``
and ``tf32x3.cuh`` with one edit each (under
``build/repro_torch/variants/ssd_chunk/``; the
sources are not touched), calls each library's ``ssd_chunk_forward``
directly (no Python wrapper) at chip_smoke.py's ``SSD_LAYERS`` (a
Mamba2-2.7B layer at chunks of 64 and 128), and times every variant and
the plain version in turns with CUDA events.  ``one_pass`` computes a
wrong result on purpose (1xTF32: the two small products dropped), to
show what they cost; the others are alternatives the kernel does not
take (``VARIANTS``).  Prints ptxas's registers and spills per kernel of
each variant and one JSON line per (shape, variant): ms and max |Δ| of
y_in and the states against the plain version beside the limit 2e-4 ·
max(1, max|plain|).  ``--against DIR`` adds another tree's
``ssd_chunk.cu`` (and its headers where DIR has them; e.g. a
parent commit's ``src/repro_torch/csrc``) as the variant ``against``,
timed in the same turns; a library that refuses a shape (a parent at
q > 64) says so.  Needs one CUDA device.
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

FILES = ("ssd_chunk.cu", "ssd_tiles.cuh", "tf32x3.cuh")
NO_Y = ("ssd_chunk.cu", "    if (pr < npairs) {", "    if (false) {")
NO_STATES = ("ssd_chunk.cu",
             "for (int wi = warp; wi < npp * nsq; wi += kWarps) {",
             "for (int wi = warp; wi < 0; wi += kWarps) {")
NO_PREFETCH = ("ssd_chunk.cu", "if (it + 1 < items) {", "if (false) {")
# name -> [(file, text, replacement), ...]; each text occurs once
VARIANTS = {
    "committed": [],
    # 1xTF32: what the two small products cost (wrong on purpose)
    "one_pass": [("tf32x3.cuh",
                  "  mma(c, a.small, b.big);\n  mma(c, a.big, b.small);\n",
                  "")],
    # the exponentials in full precision (expf, not __expf)
    "exact_exp": [("ssd_tiles.cuh", "return on ? cb * __expf(ci - cj) * dj",
                   "return on ? cb * expf(ci - cj) * dj"),
                  ("ssd_chunk.cu", "ws[j] = j < p.Q ? __expf(cend - cum[j])",
                   "ws[j] = j < p.Q ? expf(cend - cum[j])")],
    # no y = M x, no states product (wrong on purpose)
    "no_y": [NO_Y],
    "no_states": [NO_STATES],
    # y and the states computed but not written (wrong on purpose)
    "y_no_store": [("ssd_chunk.cu", "if (i0 < p.Q)\n            store2(p.y",
                    "if (i0 < p.Q && acc[nt][0] != acc[nt][0])\n"
                    "            store2(p.y"),
                   ("ssd_chunk.cu", "if (i1 < p.Q)\n            store2(p.y",
                    "if (i1 < p.Q && acc[nt][2] != acc[nt][2])\n"
                    "            store2(p.y")],
    "states_no_store": [("ssd_chunk.cu",
                         "if (pa < p.P)\n              store2(sp",
                         "if (pa < p.P && acc[m][nt][0] != acc[m][nt][0])\n"
                         "              store2(sp"),
                        ("ssd_chunk.cu",
                         "if (pb < p.P)\n              store2(sp",
                         "if (pb < p.P && acc[m][nt][2] != acc[m][nt][2])\n"
                         "              store2(sp")],
    # diagnostics, all wrong on purpose: no prefetch of the next head's x
    # (every head reuses the first's), and with no y (the states product
    # alone), and with no states either (the skeleton)
    "no_prefetch": [NO_PREFETCH],
    "bare_states": [NO_PREFETCH, NO_Y],
    "bare": [NO_PREFETCH, NO_Y, NO_STATES],
    # a fixed number of heads a block
    "hg4": [("ssd_chunk.cu", "  return best;\n}", "  return 4;\n}")],
    "hg8": [("ssd_chunk.cu", "  return best;\n}", "  return 8;\n}")],
    "hg16": [("ssd_chunk.cu", "  return best;\n}", "  return 16;\n}")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma-separated variants to build (default all)")
    ap.add_argument("--shapes", default="",
                    help="comma-separated shapes to run (default all)")
    ap.add_argument("--against", default="",
                    help="a directory with another ssd_chunk.cu, timed as "
                         "the variant 'against'")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ssd_chunk_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import ssd_chunk_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sound = {f: (_build.CSRC / f).read_text() for f in FILES}
    only = set(filter(None, args.only.split(",")))
    sources = {}
    for name, edits in VARIANTS.items():
        if only and name not in only:
            continue
        texts = dict(sound)
        for fname, old, new in edits:
            if texts[fname].count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} occurs "
                                   f"{texts[fname].count(old)} times")
            texts[fname] = texts[fname].replace(old, new)
        sources[name] = texts
    if args.against:
        d = Path(args.against)
        sources["against"] = {f: (d / f).read_text() for f in FILES
                              if (d / f).exists()}
    libs, logs = build(sources, _build.BUILD_DIR / "variants" / "ssd_chunk",
                       with_logs=True)
    for name, log in logs.items():
        print(json.dumps({"variant": name,
                          "ptxas": chip_smoke.ptxas_kernels(log)}),
              flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fwd = {}
    for name, so in libs.items():
        f = ctypes.CDLL(str(so)).ssd_chunk_forward
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fwd[name] = f
    keep = set(filter(None, args.shapes.split(",")))
    for shape, m in chip_smoke.SSD_LAYERS.items():
        if keep and shape not in keep:
            continue
        ops = chip_smoke.ssd_inputs(gen, dev, **m)
        refs = ssd_chunk_ref(*ops)
        fns, rows = {"plain": lambda ops=ops: ssd_chunk_ref(*ops)}, {}
        for name, f in fwd.items():
            out = tuple(torch.empty(r.shape, device=dev) for r in refs)
            call = (lambda f=f, out=out, ops=ops: f(
                *[t.data_ptr() for t in (*ops, *out)], m["bs"] * m["nc"],
                m["h"], m["q"], m["p"], m["s"], stream))
            code = call()
            torch.cuda.synchronize()
            if code != 0:
                rows[name] = dict(refused=f"CUDA error {code}")
                continue
            for part, o, r in zip(("y_in", "states"), out, refs):
                rows.setdefault(name, {})[part] = dict(
                    max_abs_err=(o - r).abs().max().item(),
                    tol=2e-4 * max(1.0, r.abs().max().item()))
            fns[name] = call
        ms = chip_smoke.time_turns(fns, iters=args.iters)
        for name in (*fwd, "plain"):
            row = rows.get(name, {})
            if name in ms:
                row["ms"] = ms[name]
            print(json.dumps(dict(shape=shape, variant=name, **row)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
