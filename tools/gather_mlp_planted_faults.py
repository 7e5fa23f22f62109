#!/usr/bin/env python3
"""Show that chip_smoke.py's gather_mlp limit fails planted faults.

    python3 tools/gather_mlp_planted_faults.py [--seed N]

Builds copies of ``src/repro_torch/csrc/gather_mlp.cu`` and its header
``tf32x3.cuh`` with one fault each (written under
``build/repro_torch/faults/gather_mlp/``; the sources are not touched),
runs each through ``repro_torch.kernels.gather_mlp`` at the shapes of the
route it breaks: the narrow route at both PointNet++(c) block shapes of
chip_smoke.py (B = 8, masked, with all-dead subsets), the wide route at
chip_smoke.py's ``DENSE_WIDE`` (the six blocks that take it) and
``WIDE_D`` (D = 700, x streamed), the linear route at chip_smoke.py's
``DENSE_LINEAR`` and at ``LINEAR_EDGE`` (F = 100: an F tile that ends
off a multiple of 8), each fault where it applies (an ignored mask on
the masked shapes only), and prints
one JSON line per (fault, block): max |Δ| against ``gather_mlp_ref``
beside chip_smoke.py's limit 1e-4 · max(1, max|plain|).  The unchanged
sources run at every shape.  Exits 1 if they break the limit or a fault
passes it.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# name -> ([(file, text, its replacement), ...], the routes it is run
# on: "wide_unsplit" the wide route's shapes where H is not split,
# "linear_masked" the linear route's masked shapes, "linear_edge"
# LINEAR_EDGE); each text occurs once in its file
FAULTS = {
    # 1xTF32: the two small products dropped
    "one_tf32_pass": ([("tf32x3.cuh",
                        "  mma(c, a.small, b.big);\n  mma(c, a.big, b.small);\n",
                        "")], ("narrow", "wide")),
    # y = h W2 without W2's last 32-row stage
    "w2_last_stage_skipped": ([("gather_mlp.cu",
                                "gemm<L>(acc, hs, p.XH, p.Hp,",
                                "gemm<L>(acc, hs, p.XH, p.Hp - kKC,")],
                              ("narrow",)),
    # every row live: the mask is not read
    "mask_ignored": ([("gather_mlp.cu",
                       "(p.mask == nullptr ||\n                      "
                       "p.mask[(size_t)",
                       "(true ||\n                      p.mask[(size_t)")],
                     ("narrow",)),
    # the last subset of each row tile keeps the -3.4e38 identity
    "last_subset_unpooled": ([("gather_mlp.cu", "e < spt * nc;",
                               "e < (spt - 1) * nc;")], ("narrow",)),
    # wide route: y without the last H chunk of each block (of each split)
    "wide_last_chunk_skipped": ([("gather_mlp.cu",
                                  "nq = (j1 - j0) * per;",
                                  "nq = (j1 - j0 - 1) * per;")], ("wide",)),
    # wide route: b1 added twice to the h chunk (rows g of each m16 tile)
    "wide_b1_twice": ([("gather_mlp.cu",
                        "        lo = make_float2(fmaxf(lo.x, 0.f), "
                        "fmaxf(lo.y, 0.f));",
                        "        lo = make_float2(fmaxf(lo.x + bias0, 0.f), "
                        "fmaxf(lo.y + bias1, 0.f));")], ("wide",)),
    # wide route: each subset but a tile's last also takes the row after
    # its last, the first row of the next subset packed into the tile (the
    # pool of an unsplit H, so run where H is not split)
    "wide_pool_across_subsets": ([
        ("gather_mlp.cu",
         "        for (int k = 0; k < p.K; ++k) {\n"
         "          const int r = sl * p.Kp + k;",
         "        for (int k = 0; k < p.K + (sl + 1 < p.spt); ++k) {\n"
         "          const int r = sl * p.Kp + k;")], ("wide_unsplit",)),
    # wide route: layer 1 without x's last D slice (W1's last rows)
    "wide_last_d_slice_dropped": ([("gather_mlp.cu",
                                    "  p.n1 = (p.Dp + p.dc - 1) / p.dc;",
                                    "  p.n1 = (p.Dp - 1) / p.dc;")],
                                  ("wide",)),
    # linear route: the last center lane not staged, so not subtracted
    "linear_center_lane_dropped": ([("gather_mlp.cu",
                                     "const bool ok = in && d < p.Dc;",
                                     "const bool ok = in && d + 4 < p.Dc;"),
                                    ("gather_mlp.cu",
                                     "const bool ok = in && d + i < p.Dc;",
                                     "const bool ok = in && d + i < p.Dc - 1;")],
                                   ("linear",)),
    # linear route: every valid row live, the mask not read
    "linear_mask_ignored": ([("gather_mlp.cu",
                              "live = valid & m;",
                              "live = valid;")],
                            ("linear_masked",)),
    # linear route: b not added to the pooled max
    "linear_bias_missing": ([("gather_mlp.cu",
                              "any ? m + bsm[c0 + c] : 0.f;",
                              "any ? m : 0.f;")], ("linear",)),
    # linear route: an F tile's columns past its last multiple of 8 not
    # pooled (its edge rounded down, not kept)
    "linear_f_tile_edge": ([("gather_mlp.cu",
                             "ft = min(N, p.F - f0);",
                             "ft = min(N, p.F - f0) & ~7;")],
                           ("linear_edge",)),
    # linear route: W's small TF32 half written as 0 (W in 1xTF32)
    "linear_w_small_half_dropped": ([("tf32_split.cuh",
                                      "out[((size_t)Fp + n) * Dp + pos] = "
                                      "__uint_as_float(small);",
                                      "out[((size_t)Fp + n) * Dp + pos] = "
                                      "0.f;")], ("linear",)),
    # linear route: W's k in natural order within each 8-group, not the
    # order the A fragment's 8-byte loads read x in
    "linear_k_order_unpermuted": ([("tf32_split.cuh",
                                    "tile[(tx & ~7) | ((j & 3) * 2 + "
                                    "(j >> 2))][i]",
                                    "tile[tx][i]")], ("linear",)),
}
FILES = ("gather_mlp.cu", "tf32x3.cuh", "sm90.cuh", "sm90_tf32.cuh",
         "tf32_split.cuh")
# an F tile that ends off a multiple of 8 (F = 100), masked, K = 20 packed
LINEAR_EDGE = {"linear_edge": dict(b=2, s=64, k=20, d=35, dc=3, h=0, f=100,
                                   masked=True)}


def build(sources: dict, out_dir: Path, with_logs: bool = False):
    """One nvcc per variant, all at once, with the port's flags; each
    variant's directory holds its own copy of its files, one ``.cu`` and
    the headers it includes.  -> {name: library} (and {name: nvcc's
    output} with ``with_logs``)."""
    from repro_torch.kernels import _build
    procs = {}
    for name, texts in sources.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        cu = next(f for f in texts if f.endswith(".cu"))
        so = d / f"lib{cu[:-3]}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(d / cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{logs[name]}")
        libs[name] = so
    return (libs, logs) if with_logs else libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("gather_mlp_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_mlp import gather_mlp, gather_mlp_ref
    from repro_torch.kernels.gather_mlp.ops import _declare, wide_plan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sound = {f: (_build.CSRC / f).read_text() for f in FILES}
    sources = {"none": sound}
    for name, (edits, _) in FAULTS.items():
        texts = dict(sound)
        for fname, old, new in edits:
            if texts[fname].count(old) != 1:
                raise RuntimeError(f"fault {name}: {old!r} occurs "
                                   f"{texts[fname].count(old)} times in "
                                   f"{fname}")
            texts[fname] = texts[fname].replace(old, new)
        sources[name] = texts
    libs = build(sources, _build.BUILD_DIR / "faults" / "gather_mlp")

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    shapes = [("narrow", blk, {"b": chip_smoke.B, **shp, "masked": True})
              for blk, shp in chip_smoke.DENSE.items()]
    shapes += [("wide", blk, shp) for blk, shp in
               {**chip_smoke.DENSE_WIDE, **chip_smoke.WIDE_D}.items()]
    shapes += [("linear", blk, shp) for blk, shp in
               {**chip_smoke.DENSE_LINEAR, **LINEAR_EDGE}.items()]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    unsplit = {blk: wide_plan(shp["b"], shp["s"], shp["k"], shp["d"],
                              shp["dc"], shp["h"], shp["f"],
                              sms=sms)["nsplit"] == 1
               for way, blk, shp in shapes if way == "wide"}
    ok = True
    for way, blk, shp in shapes:
        raw, ctr, w1, b1, w2, b2, mask = chip_smoke.dense_inputs(
            gen, dev, **shp)
        ops = (raw, ctr, w1, b1, w2, b2)
        ref = gather_mlp_ref(*ops, mask=mask)
        for name, so in libs.items():
            routes = FAULTS[name][1] if name != "none" else ()
            tags = {way, *(("wide_unsplit",) if way == "wide"
                           and unsplit[blk] else ()),
                    *(("linear_masked",) if way == "linear"
                      and shp["masked"] else ()),
                    *(("linear_edge",) if blk in LINEAR_EDGE else ())}
            if name != "none" and not tags & set(routes):
                continue
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            _build._LIBS["gather_mlp"] = lib
            before = _build.LAUNCHES["gather_mlp"]
            out = gather_mlp(*ops, mask=mask)
            torch.cuda.synchronize()
            if _build.LAUNCHES["gather_mlp"] != before + 1:
                raise RuntimeError(f"{blk}: the kernel did not launch")
            err = (out - ref).abs().max().item()
            tol = chip_smoke.TOL * max(1.0, ref.abs().max().item())
            breaks = not err <= tol
            print(json.dumps(dict(fault=name, route=way, block=blk,
                                  max_abs_err=err, tol=tol,
                                  breaks=breaks)), flush=True)
            ok &= breaks if name != "none" else not breaks
    _build._LIBS.pop("gather_mlp", None)
    print(json.dumps({"ok": ok, "limit": "1e-4 * max(1, max|plain|)"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
