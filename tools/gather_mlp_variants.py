#!/usr/bin/env python3
"""Time text variants of the gather_mlp kernel side by side.

    python3 tools/gather_mlp_variants.py [--seed N] [--iters N]
        [--only committed,one_pass,...] [--against DIR]

Builds copies of ``src/repro_torch/csrc/gather_mlp.cu`` and
``tf32x3.cuh`` with one edit each (under ``build/repro_torch/variants/``;
the sources are not touched), calls each library's ``gather_mlp_forward``
directly (no Python wrapper) at chip_smoke.py's block shapes, batched
(B = 8) and per cloud (B = 1), and times all variants in turns with
CUDA events.  Prints ptxas's registers and spills per variant and one
JSON line per (variant, block, B): ms and max |Δ| against the plain
version.  Most variants compute a wrong result on purpose: each removes
one part of the kernel (the small TF32 products, the raw loads, the W
stages, the epilogue's shuffles) so that its time shows that part's
cost; the others are alternatives the kernel does not take.  ``--only``
keeps the named variants; ``--against DIR`` adds the sources of another
tree (``gather_mlp.cu`` and ``tf32x3.cuh`` in DIR, e.g. a parent
commit's ``src/repro_torch/csrc``) as the variant ``against``, timed in
the same turns.  Needs one CUDA device.
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

# name -> [(file, text, replacement), ...]; each text occurs once
VARIANTS = {
    "committed": [],
    # 1xTF32: what the two small products cost
    "one_pass": [("tf32x3.cuh",
                  "  mma(c, a.small, b.big);\n  mma(c, a.big, b.small);\n",
                  "")],
    # no tensor-core work at all: everything else the kernel does
    "no_products": [("tf32x3.cuh",
                     "  mma(c, a.small, b.big);\n  mma(c, a.big, b.small);\n"
                     "  mma(c, a.big, b.big);\n",
                     "  c[0] += __uint_as_float(a.big[0] ^ b.small[1]);\n")],
    # x left as it was: what staging the raw rows costs
    "no_raw": [("gather_mlp.cu",
                "    for (int r = warp; r < R; r += kThreads / 32) {",
                "    for (int r = warp; r < 0; r += kThreads / 32) {")],
    # W stages left as they were: what streaming W1 and W2 costs
    "no_w_stages": [("gather_mlp.cu",
                     "  for (int e = threadIdx.x; e < kKC * (kNC / 4); "
                     "e += kThreads) {",
                     "  for (int e = threadIdx.x; e < 0; e += kThreads) {")],
    # rows of an m16 tile not met by shuffles: what the epilogue's cost
    "no_shuffles": [("gather_mlp.cu",
                     "          for (int off = 4; off < 32; off <<= 1) {",
                     "          for (int off = 4; off < 0; off <<= 1) {")],
    # the split by the cvt.rna.tf32.f32 instruction instead of integers
    "cvt_split": [("tf32x3.cuh",
                   "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                   "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : "
                   "\"=r\"(r) : \"f\"(x));\n  return r;")],
    # the k-step loop unrolled by 4 over a runtime bound
    "unroll_4": [("gather_mlp.cu",
                  "#pragma unroll\n    for (int s = 0; s < kKC / 8; ++s) {",
                  "#pragma unroll 4\n    for (int s = 0; s < kKC / 8; ++s) {")],
    # 64-row tiles at every size
    "rows_64": [("gather_mlp.cu",
                 "  return rows / big < (long long)kBlocksPerSM * "
                 "sm_count() ? small : big;",
                 "  return small;")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", default="",
                    help="comma-separated variants to build (default all)")
    ap.add_argument("--against", default="",
                    help="a directory with another gather_mlp.cu and "
                         "tf32x3.cuh, timed as the variant 'against'")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("gather_mlp_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gather_mlp_planted_faults import FILES, build
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_mlp import gather_mlp_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sound = {f: (_build.CSRC / f).read_text() for f in FILES}
    sources = {}
    only = set(filter(None, args.only.split(",")))
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
        sources["against"] = {f: (Path(args.against) / f).read_text()
                              for f in FILES}
    libs, logs = build(sources, _build.BUILD_DIR / "variants" / "gather_mlp",
                       with_logs=True)
    for name, log in logs.items():
        print(json.dumps({"variant": name, "ptxas": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for blk, shp in chip_smoke.DENSE.items():
        for bb in (chip_smoke.B, 1):
            raw, ctr, w1, b1, w2, b2, mask = chip_smoke.dense_inputs(
                gen, dev, bb, **shp)
            ref = gather_mlp_ref(raw, ctr, w1, b1, w2, b2, mask=mask)
            fns, errs = {}, {}
            for name, so in libs.items():
                lib = ctypes.CDLL(str(so))
                fwd = lib.gather_mlp_forward
                fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                + [ctypes.c_void_p])
                out = torch.empty_like(ref)
                call = (lambda fwd=fwd, out=out: fwd(
                    raw.data_ptr(), ctr.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), out.data_ptr(), bb, shp["s"], shp["k"],
                    shp["d"], shp["dc"], shp["h"], shp["f"], stream))
                if call() != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                errs[name] = (out - ref).abs().max().item()
                fns[name] = call
            ms = chip_smoke.time_turns(fns, iters=args.iters)
            for name in fns:
                print(json.dumps(dict(variant=name, block=blk, b=bb,
                                      ms=ms[name], max_abs_err=errs[name])),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
