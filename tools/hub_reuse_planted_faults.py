#!/usr/bin/env python3
"""Show that chip_smoke.py's hub_reuse limit fails planted faults.

    python3 tools/hub_reuse_planted_faults.py [--seed N]

Builds copies of ``src/repro_torch/csrc/hub_reuse.cu`` and its header
``tf32x3.cuh`` with one fault each (written under
``build/repro_torch/faults/hub_reuse/``; the sources are not touched),
runs each through ``repro_torch.kernels.hub_reuse`` on the shapes of the
route it breaks: the resident route at both PointNet++(c) block shapes
of chip_smoke.py (B = 8, live masked, subsets with no live slot; block 2
also forced to two 64-row chunks, for the fault in their merge) and at
block 2's widths with C = 256 cache rows (``REUSE_C256``, two 128-row
launches), the layered route at ``REUSE_DOMAIN`` (PointVector-L's block
4 under the paper's cache size, whose second layer splits H three ways,
and D = 700), at B = 2 there, and the one-layer form at three of
``REUSE_LINEAR``'s calls (DGCNN(c)'s block 4 at its batch, resident on
the wgmma kernel; PointVector-L's block 4 at its batch, resident on the
mma.sync kernel; PointVector-L's block 4 under the paper's cache size,
layered, D split three ways) and at ``LINEAR_EXTRA`` (on the wgmma
kernel three islands of 20 rows packed a tile and an F tile ending off
a multiple of 8; the latter on the mma.sync kernel too; 256 cache rows
on a small grid, layered, D split);
and prints one JSON line per (fault, shape): max
|Δ| against ``hub_reuse_ref`` beside chip_smoke.py's limit 1e-4 · max(1,
max|plain|), and whether the -BIG identity came out exactly.  Exits 1 if
the unchanged sources break the limit or a fault passes it on a shape of
its route.  Needs one CUDA device.
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

# the two small products of tf32x3::mma3 (the resident route's) and of
# tf32x3::mma3_row (the layered route's)
SMALL_PASSES = "  mma(c, a.small, b.big);\n  mma(c, a.big, b.small);\n"
SMALL_WAVES = ("#pragma unroll\n"
               "  for (int i = 0; i < N; ++i) mma(c[i], a.small, b[i].big);\n"
               "#pragma unroll\n"
               "  for (int i = 0; i < N; ++i) mma(c[i], a.big, b[i].small);\n")
# name -> (file, text, its replacement, the route it breaks: "resident",
# "layered" or None for both, the form: "two" (layers), "one" (one layer
# off the wgmma kernel), "wgmma" (one layer on it: rl::, its own code) or
# None for "two" and "one", and optionally the cases it runs on where it
# shows only there); each text occurs once in its file.
FAULTS = {
    # 1xTF32: the two small products dropped
    "one_tf32_pass": ("tf32x3.cuh", SMALL_PASSES, "", "resident", None),
    "layered_one_tf32_pass": ("tf32x3.cuh", SMALL_WAVES, "", "layered",
                              None),
    # the compensation not added
    "comp_dropped": ("hub_reuse.cu", "-kBig : m + c;", "-kBig : m;", None,
                     None),
    # a subset with no live slot written as 0, not the merge identity
    "big_identity_as_zero": ("hub_reuse.cu", "-kBig : m + c;",
                             "0.f : m + c;", None, None),
    # resident: y without the last 64-column chunk of h
    "last_hd_chunk_skipped": ("hub_reuse.cu",
                              "p.nchunk = (p.Hd + kNC - 1) / kNC;",
                              "p.nchunk = (p.Hd - 1) / kNC;", "resident",
                              "two"),
    # resident: every cached slot live, live is not read
    "live_ignored": ("hub_reuse.cu", "(p.live == nullptr || lv[",
                     "(true || lv[", "resident", None),
    # resident, past one chunk: each chunk's launch overwrites the last's
    "merge_ignored": ("hub_reuse.cu",
                      "p.out[row + c] = p.merge ? fmaxf(p.out[row + c], v) "
                      ": v;", "p.out[row + c] = v;", "resident", None),
    # layered: layer 1 without its bias, or without its relu
    "layered_b1_dropped": ("hub_reuse.cu",
                           "const ly::Gemm g1{pool, w1, b1, h,",
                           "const ly::Gemm g1{pool, w1, nullptr, h,",
                           "layered", "two"),
    "layered_relu_dropped": ("hub_reuse.cu",
                             "ly::run_gemm<true>(g1, 1, st);",
                             "ly::run_gemm<false>(g1, 1, st);", "layered",
                             "two"),
    # layered: each GEMM without its last, partial K stage
    "layered_last_k_stage": ("hub_reuse.cu",
                             "const int nst = (ke - kb + kKC - 1) / kKC;",
                             "const int nst = (ke - kb - 1) / kKC;",
                             "layered", None),
    # layered: the gather without layer 2's last H split
    "layered_last_split_dropped": ("hub_reuse.cu",
                                   "for (int s = 0; s < nsplit; ++s)",
                                   "for (int s = 0; s < nsplit - 1; ++s)",
                                   "layered", None),
    # layered: every cached slot live
    "layered_live_ignored": ("hub_reuse.cu",
                             "(lvp == nullptr || lvp[k0 + lane] != 0)",
                             "(true || lvp[k0 + lane] != 0)", "layered", None),
    # one layer, resident: y without W's last 64-row stage of D
    "linear_last_d_stage": ("hub_reuse.cu",
                            "const int nq = kLin ? p.n1 : p.nchunk * per;",
                            "const int nq = kLin ? p.n1 - 1 : p.nchunk * "
                            "per;", "resident", "one"),
    # one layer, resident: every feature tile reads W's first 64 columns
    "linear_first_w_tile": ("hub_reuse.cu",
                            "load_stage<kThreads>(st, p.w1, p.D, p.F, "
                            "q * kKC, f0, ft,",
                            "load_stage<kThreads>(st, p.w1, p.D, p.F, "
                            "q * kKC, 0, ft,", "resident", "one"),
    # one layer, resident: y without b1
    "linear_bias_dropped": ("hub_reuse.cu",
                            "(kLin ? p.b1 : p.b2) + f0, ft, wm, wn,",
                            "(kLin ? p.b1 : p.b2) + f0, kLin ? 0 : ft, wm, "
                            "wn,", "resident", "one"),
    # the wgmma kernel: a slot's tile row without its island's packing
    # offset (every packed island reads the first's rows)
    "wgmma_island_offset": ("hub_reuse.cu",
                            "? (j * p.Cc + r) * kYS : dead;",
                            "? r * kYS : dead;", "resident", "wgmma",
                            ("packed",)),
    # the wgmma kernel: the small·big product dropped (2 of 3 TF32 passes)
    "wgmma_small_big_dropped": ("hub_reuse.cu",
                                "          sm90_tf32::wgmma_tf32(acc, "
                                "af[k8].small,\n"
                                "                                "
                                "sm90_tf32::desc_sw64(wb + 32 * k8), 1);\n",
                                "", "resident", "wgmma"),
    # the wgmma kernel: an F tile's columns past its last multiple of 8
    # not gathered (its edge rounded down)
    "wgmma_f_tile_edge": ("hub_reuse.cu",
                          "const int f0 = (item % p.nft) * N, ft = "
                          "min(N, p.F - f0);",
                          "const int f0 = (item % p.nft) * N, ft = "
                          "min(N, p.F - f0) & ~7;", "resident", "wgmma",
                          ("wgmma_edge77",)),
    # the wgmma kernel: y without W's last 16-deep stage of D
    "wgmma_last_d_stage": ("hub_reuse.cu",
                           "pl.items, (D + kBK - 1) / kBK,",
                           "pl.items, (D - 1) / kBK,", "resident", "wgmma"),
    # the wgmma kernel: every F tile reads W's first N columns (its big
    # half)
    "wgmma_first_w_tile": ("hub_reuse.cu",
                           "sm90::tma_load(st, &wmap, full + s, d0, f0, 0);",
                           "sm90::tma_load(st, &wmap, full + s, d0, 0, 0);",
                           "resident", "wgmma", ("dgcnn_c_blk4",)),
    # the wgmma kernel: y without b; comp not added; a subset with no live
    # slot written as 0; every cached slot live
    "wgmma_bias_dropped": ("hub_reuse.cu", "? -kBig : (m + b) + c;",
                           "? -kBig : m + c;", "resident", "wgmma"),
    "wgmma_comp_dropped": ("hub_reuse.cu", "? -kBig : (m + b) + c;",
                           "? -kBig : m + b;", "resident", "wgmma"),
    "wgmma_identity_as_zero": ("hub_reuse.cu", "? -kBig : (m + b) + c;",
                               "? 0.f : (m + b) + c;", "resident", "wgmma"),
    "wgmma_live_ignored": ("hub_reuse.cu",
                           "const int lv = t.live == nullptr ? 1 : "
                           "t.live[at];", "const int lv = 1;", "resident",
                           "wgmma"),
    # one layer, layered: x·W's first D split only
    "linear_first_split_only": ("hub_reuse.cu",
                                "err = ly::run_gemm<false>(g, pl.nsplit, "
                                "st);",
                                "err = ly::run_gemm<false>(g, 1, st);",
                                "layered", "one"),
}
FILES = ("hub_reuse.cu", "tf32x3.cuh", "sm90.cuh", "sm90_tf32.cuh",
         "tf32_split.cuh")
# the one-layer calls of REUSE_LINEAR the faults run on, and four more:
# 2048 islands of C = 20 (three a 64-row tile, wgmma), F = 77 (an F tile
# ending off a multiple of 8) on the wgmma kernel (1024 islands) and off
# it (6), C = 256 on a small grid (layered, D split)
LINEAR_CASES = ("dgcnn_c_blk4", "pointvector_l_blk4",
                "pointvector_l_blk4_c128")
LINEAR_EXTRA = {
    "packed": dict(b=8, hn=256, c=20, m=16, k=20, d=128, f=64),
    "wgmma_edge77": dict(b=2, hn=512, c=100, m=9, k=13, d=131, f=77),
    "edge77": dict(b=2, hn=3, c=100, m=9, k=13, d=131, f=77),
    "layered_c256": dict(b=2, hn=1, c=256, m=64, k=32, d=387, f=768)}


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
    from repro_torch.kernels import _build, tiling
    from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
    from repro_torch.kernels.hub_reuse import ops as hub_ops
    from repro_torch.kernels.hub_reuse.ops import _declare

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sound = {f: (_build.CSRC / f).read_text() for f in FILES}
    sources = {"none": sound}
    for name, (fname, old, new, *_) in FAULTS.items():
        if sound[fname].count(old) != 1:
            raise RuntimeError(f"fault {name}: {old!r} occurs "
                               f"{sound[fname].count(old)} times in {fname}")
        sources[name] = {**sound, fname: sound[fname].replace(old, new)}
    libs = build(sources, _build.BUILD_DIR / "faults" / "hub_reuse")

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    ok = True
    # (block, shape, B, forced chunk, form)
    cases = [(blk, shp, chip_smoke.B, None) for blk, shp in
             chip_smoke.REUSE.items()]
    cases.append(("blk2_chunk64", chip_smoke.REUSE["blk2"], chip_smoke.B,
                  64))
    cases += [(blk, shp, chip_smoke.B, None) for blk, shp in
              chip_smoke.REUSE_C256.items()]
    cases += [(blk, shp, 2, None) for blk, shp in
              chip_smoke.REUSE_DOMAIN.items()]
    cases = [(*case, "two") for case in cases]
    cases += [(blk, dict(shp, h=0), shp["b"], None, "one")
              for blk, shp in {**{blk: chip_smoke.REUSE_LINEAR[blk]
                                  for blk in LINEAR_CASES},
                               **LINEAR_EXTRA}.items()]
    for blk, shp, b, chunk, form in cases:
        shp = {n: v for n, v in shp.items() if n != "b"}
        pool, slot, comp, w1, b1, w2, b2, live = chip_smoke.reuse_inputs(
            gen, dev, b, **shp)
        ops = (pool, slot, comp, w1, b1, w2, b2)
        ref = hub_reuse_ref(*ops, live=live)
        empty = ref <= -chip_smoke.BIG / 2
        tol = chip_smoke.TOL * max(1.0, ref[~empty].abs().max().item())
        pl = hub_ops.plan(b, shp["hn"], shp["c"], shp["m"], shp["k"],
                          shp["d"], shp["h"], shp["f"], dev, chunk=chunk)
        route = pl["route"]
        if form == "one" and route == "resident" and \
                tiling.reuse_linear_wgmma(b, shp["hn"], shp["c"], shp["d"],
                                          shp["f"]):
            form = "wgmma"
        calls = (1 if route == "layered" else
                 len(tiling.hub_reuse_launches(shp["c"], pl["chunk"])))
        for name, so in libs.items():
            # a fault of another route or form (the wgmma kernel takes
            # its own faults only) or of other cases, a merge where one
            # launch takes the call, or on the forced chunks any fault but
            # the merge's
            fault = FAULTS.get(name, (None,) * 5)
            if name != "none" and (
                    fault[3] not in (None, route)
                    or fault[4] != form and not (fault[4] is None
                                                 and form != "wgmma")
                    or (len(fault) > 5 and blk not in fault[5])
                    or (name == "merge_ignored" and calls < 2)
                    or (chunk is not None and name != "merge_ignored")):
                continue
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            _build._LIBS["hub_reuse"] = lib
            before = _build.LAUNCHES["hub_reuse"]
            out = hub_reuse(*ops, live=live, chunk=chunk)
            torch.cuda.synchronize()
            if _build.LAUNCHES["hub_reuse"] != before + calls:
                raise RuntimeError(f"{blk}: the kernel did not launch")
            identity = bool(torch.equal(out[empty], ref[empty]))
            err = (out[~empty] - ref[~empty]).abs().max().item()
            breaks = not (identity and err <= tol)
            print(json.dumps(dict(fault=name, block=blk, route=route,
                                  form=form,
                                  max_abs_err=err, tol=tol,
                                  big_identity_exact=identity,
                                  breaks=breaks)), flush=True)
            ok &= breaks if name != "none" else not breaks
    _build._LIBS.pop("hub_reuse", None)
    print(json.dumps({"ok": ok, "limit": "1e-4 * max(1, max|plain|), "
                      "-BIG exact"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
