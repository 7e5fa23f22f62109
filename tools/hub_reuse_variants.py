#!/usr/bin/env python3
"""Time text variants of the hub_reuse kernel side by side.

    python3 tools/hub_reuse_variants.py [--seed N] [--iters N]

Builds copies of ``src/repro_torch/csrc/hub_reuse.cu`` and
``tf32x3.cuh`` with one edit each (under
``build/repro_torch/variants/hub_reuse/``; the sources are not touched),
calls each library's ``hub_reuse_forward`` directly (no Python wrapper)
at chip_smoke.py's block shapes, batched (B = 8) and per cloud (B = 1),
and times all variants in turns with CUDA events, beside the committed
kernel called through the wrapper (``wrapper``).  Prints ptxas's
registers and spills per variant and one JSON line per (variant, block,
B): ms and max |Δ| against the plain version.  Some variants compute a
wrong result on purpose: each removes one part of the kernel (the small
TF32 products, all products, the gather) so that its time shows that
part's cost; the others are alternatives the kernel does not take.
Needs one CUDA device.
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

from hub_reuse_planted_faults import SMALL_PASSES  # noqa: E402

# name -> [(file, text, replacement), ...]; each text occurs once
VARIANTS = {
    "committed": [],
    # 1xTF32: what the two small products cost
    "one_pass": [("tf32x3.cuh", SMALL_PASSES, "")],
    # no tensor-core work at all: everything else the kernel does
    "no_products": [("tf32x3.cuh",
                     SMALL_PASSES + "  mma(c, a.big, b.big);\n",
                     "  c[0] += __uint_as_float(a.big[0] ^ b.small[1]);\n")],
    # each pass over all of a warp's tiles before the next, so that no
    # mma waits on the one issued just before it
    "interleaved_passes": [("hub_reuse.cu",
                            "#pragma unroll\n    for (int j = 0; j < L::kNT; ++j) {\n"
                            "      const Frag<2> bf =\n"
                            "          tf32x3::load_b(st, kWS, s * 8, "
                            "(wn + L::kWN * j) * 8, lane);\n"
                            "#pragma unroll\n      for (int mt = 0; mt < kMT; ++mt) "
                            "tf32x3::mma3(acc[mt][j], af[mt], bf);\n    }\n",
                            "    Frag<2> bf[L::kNT];\n"
                            "#pragma unroll\n    for (int j = 0; j < L::kNT; ++j)\n"
                            "      bf[j] = tf32x3::load_b(st, kWS, s * 8, "
                            "(wn + L::kWN * j) * 8, lane);\n"
                            + "".join(
                                "#pragma unroll\n    for (int mt = 0; mt < kMT; ++mt)\n"
                                "#pragma unroll\n      for (int j = 0; j < L::kNT; ++j)\n"
                                f"        tf32x3::mma(acc[mt][j], af[mt].{a}, bf[j].{b});\n"
                                for a, b in (("small", "big"), ("big", "small"),
                                             ("big", "big"))))],
    # ring stages of 32 rows: twice the barriers
    "stage_rows_32": [("hub_reuse.cu", "constexpr int kKC = 64;",
                       "constexpr int kKC = 32;")],
    # no gather: what reading y[slot] and writing out costs
    "no_gather": [("hub_reuse.cu",
                   "  for (int m = warp; m < p.M; m += L::kWarps) {",
                   "  for (int m = warp; m < 0; m += L::kWarps) {")],
    # an empty kernel: the launch and the call
    "empty": [("hub_reuse.cu", "  // ---- prologue: x by cp.async",
               "  if (p.M >= 0) return;\n  // ---- prologue: x by cp.async")],
    # block (0, 0)'s clock64 at the phase ends, written over its first
    # outputs: x issued, ring and slots issued, first stage landed,
    # products done, y stored, gather done (cycles from the kernel's start)
    "timeline": [
        ("hub_reuse.cu", "  // ---- prologue: x by cp.async",
         "  long long tt[7];\n  tt[0] = clock64();\n"
         "  // ---- prologue: x by cp.async"),
        ("hub_reuse.cu", "  for (int q = 0; q < kStages - 1; ++q) {",
         "  tt[1] = clock64();\n"
         "  for (int q = 0; q < kStages - 1; ++q) {"),
        ("hub_reuse.cu", "  // ---- h a chunk at a time,",
         "  tt[2] = clock64();\n  // ---- h a chunk at a time,"),
        ("hub_reuse.cu", "// for all; slot q - 1 free\n",
         "// for all; slot q - 1 free\n    if (q == 0) tt[3] = clock64();\n"),
        ("hub_reuse.cu", "  // ---- y + b2 over x, then the gather",
         "  tt[4] = clock64();\n  // ---- y + b2 over x, then the gather"),
        ("hub_reuse.cu", "  const float2* y2 = reinterpret_cast",
         "  tt[5] = clock64();\n  const float2* y2 = reinterpret_cast"),
        ("hub_reuse.cu",
         "      p.out[row + c + 1] = p.merge ? fmaxf(p.out[row + c + 1], v) "
         ": v;\n    }\n  }\n",
         "      p.out[row + c + 1] = p.merge ? fmaxf(p.out[row + c + 1], v) "
         ": v;\n    }\n  }\n"
         "  tt[6] = clock64();\n"
         "  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0)\n"
         "    for (int i = 1; i < 7; ++i) p.out[i - 1] = "
         "(float)(tt[i] - tt[0]);\n")],
    # 8 warps a block at 128 rows (4 x 2, each 2 x 4 tiles of m16 x n8)
    "rows128_8_warps": [("hub_reuse.cu", "using Rows128 = Layout<4, 4>;",
                         "using Rows128 = Layout<4, 2>;")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("hub_reuse_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gather_mlp_planted_faults import build
    from hub_reuse_planted_faults import FILES
    from repro_torch.kernels import _build
    from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sound = {f: (_build.CSRC / f).read_text() for f in FILES}
    sources = {}
    for name, edits in VARIANTS.items():
        texts = dict(sound)
        for fname, old, new in edits:
            if texts[fname].count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} occurs "
                                   f"{texts[fname].count(old)} times")
            texts[fname] = texts[fname].replace(old, new)
        sources[name] = texts
    libs, logs = build(sources, _build.BUILD_DIR / "variants" / "hub_reuse",
                       with_logs=True)
    for name, log in logs.items():
        print(json.dumps({"variant": name, "ptxas": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for blk, shp in chip_smoke.REUSE.items():
        for bb in (chip_smoke.B, 1):
            pool, slot, comp, w1, b1, w2, b2, live = chip_smoke.reuse_inputs(
                gen, dev, bb, **shp)
            ops = (pool, slot, comp, w1, b1, w2, b2)
            ref = hub_reuse_ref(*ops, live=live)
            fns = {"wrapper": lambda: hub_reuse(*ops, live=live)}
            errs = {"wrapper": (fns["wrapper"]() - ref).abs().max().item()}
            for name, so in libs.items():
                lib = ctypes.CDLL(str(so))
                fwd = lib.hub_reuse_forward
                # the chunk knob (128 cache rows a launch) where it is taken
                chunk = ((128,) if hasattr(lib, "hub_reuse_smem_bytes")
                         else ())
                fwd.argtypes = ([ctypes.c_void_p] * 9
                                + [ctypes.c_int] * (10 + len(chunk))
                                + [ctypes.c_void_p])
                out = torch.empty_like(ref)
                call = (lambda fwd=fwd, out=out, chunk=chunk: fwd(
                    *(t.data_ptr() for t in (pool, slot, comp, live, w1, b1,
                                             w2, b2, out)),
                    bb, shp["hn"], shp["c"], shp["m"], shp["k"], shp["d"],
                    shp["h"], shp["f"], 0, 0, *chunk, stream))
                if call() != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                errs[name] = (out - ref).abs().max().item()
                if name == "timeline":
                    print(json.dumps(dict(
                        variant=name, block=blk, b=bb,
                        cycles=out.flatten()[:6].tolist())), flush=True)
                fns[name] = call
            ms = chip_smoke.time_turns(fns, iters=args.iters)
            for name in fns:
                print(json.dumps(dict(variant=name, block=blk, b=bb,
                                      ms=ms[name], max_abs_err=errs[name])),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
