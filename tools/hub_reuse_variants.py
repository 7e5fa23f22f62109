#!/usr/bin/env python3
"""Time text variants of the hub_reuse kernel side by side.

    python3 tools/hub_reuse_variants.py [--seed N] [--iters N]
        [--only a,b] [--against DIR] [--layered | --linear]

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
``--layered`` runs the layered route's shapes instead (chip_smoke.py's
``REUSE_C256`` at B = 8, 1, 2 and 4 and ``REUSE_DOMAIN`` at B = 2), each library
through ``hub_reuse_layered`` (``LAYERED_VARIANTS``), beside the plain
version (``plain``).  ``--linear`` runs the one-layer form instead
(chip_smoke.py's ``REUSE_LINEAR``: the families' one-layer calls at their
batches and pointvector_l's block 4 under ``CACHE_X4``), each library
called with (W, b) and Hd = 0 by its own plan (``LINEAR_VARIANTS``: the
rule between the wgmma and the mma.sync kernel forced either way, the
wgmma kernel's row and N rules forced, its parts taken out one at a
time), beside the plain version (``plain``) and this tree's wrapper on
the split-sign two-layer weights of the same block (``split_sign``: x·[W,
−W] + [b, −b], relu, [I; −I], 0, Hd = 2F).  ``--against DIR`` adds
another tree's ``hub_reuse.cu`` and the headers it has (e.g. a parent
commit's ``src/repro_torch/csrc``) as the variant ``against``, called as
that tree's wrapper calls it, by its own plan (``hub_reuse_plan``): the
layered route with its scratch, or one resident launch a chunk of 128
cache rows (64 where the 128-row launch is refused), each merged into
the last; in ``--linear`` mode with (W, b) in one layer too.  Each row
also says whether its output equals ``against``'s bit for bit
(``bit_equal_against``: the two-layer form's, the layered route's and
the mma.sync one-layer kernel's code is the parent's).  Needs one CUDA
device.
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
# the layered route's: every C past 128 on it (not the resident route's
# 128-row chunks where their grid covers 3/4 of the card: the rule's
# other side); layer 2 without its H split (one range, however few its
# tiles); the gather reading every slot's row of the partials
# through L2 (no y tile in shared memory); the gather's subsets left out
# (wrong on purpose: the cost of everything but them)
LAYERED_VARIANTS = {
    "committed": [],
    "layered_nsplit1": [("hub_reuse.cu",
                         "  long long want = tiles >= sms ? 1 : "
                         "(sms + tiles - 1) / tiles;",
                         "  long long want = 1;")],
    "layered_always": [("hub_reuse.cu",
                        "  return !(fits && 4 * grid >= 3LL * sms);",
                        "  return true;")],
    "layered_unstaged": [("hub_reuse.cu",
                          "  const int staged = C <= ly::kStagedC;",
                          "  const int staged = 0;")],
    "layered_no_gather": [("hub_reuse.cu",
                           "  for (int m = m0 + warp; m < min(m0 + "
                           "kGatherSubsets, g.M);",
                           "  for (int m = m0 + warp; m < 0;")],
}


# the one-layer form's: the kernel rule forced either way (every
# resident call on the wgmma kernel, rl:: in hub_reuse.cu, or none: the
# mma.sync kernel everywhere); the wgmma kernel's row rule forced to 128
# rows (floor(128 / Cc) islands a tile); one block an SM at 64 rows (N >
# 64), not two; its N rule off (the widest N, F up to 128) or N forced to
# 64; 1xTF32 (wrong on purpose: what the small products cost); no
# products, or the gather left out (wrong on purpose: the cost of the
# rest); the gather's slot loop not unrolled; subsets gathered one or
# eight at a time a warp, not four; x by cp.async everywhere; every call
# on the layered route (the route rule's other side); x·W without its D
# split on the layered route
LINEAR_VARIANTS = {
    "committed": [],
    "wgmma_always": [("hub_reuse.cu",
                      "  return islands * min(C, kMaxC) * D * F >= "
                      "kWgmmaMacs;", "  return true;")],
    "wgmma_never": [("hub_reuse.cu",
                     "  return islands * min(C, kMaxC) * D * F >= "
                     "kWgmmaMacs;", "  return false;")],
    "rows128": [("hub_reuse.cu",
                 "int row_rule(int Cc) { return Cc > 64 ? 128 : 64; }",
                 "int row_rule(int) { return 128; }")],
    "one_block_rows64": [("hub_reuse.cu",
                          "  return R <= 64 || N <= kTileN ? 2 : 1;",
                          "  return N <= kTileN ? 2 : 1;")],
    "cols_widest": [("hub_reuse.cu", "  return N > kTileN &&",
                     "  return false &&")],
    "cols64": [("hub_reuse.cu", "  const int N = widest(F);",
                "  const int N = kTileN;")],
    "one_pass": [("hub_reuse.cu",
                  "          sm90_tf32::wgmma_tf32(acc, af[k8].small,\n"
                  "                                sm90_tf32::desc_sw64(wb + "
                  "32 * k8), 1);\n"
                  "          sm90_tf32::wgmma_tf32(acc, af[k8].big,\n"
                  "                                sm90_tf32::desc_sw64(wsm + "
                  "32 * k8), 1);\n", "")],
    "no_products": [("hub_reuse.cu",
                     "          sm90_tf32::wgmma_tf32(acc, af[k8].small,\n"
                     "                                sm90_tf32::desc_sw64(wb + "
                     "32 * k8), 1);\n"
                     "          sm90_tf32::wgmma_tf32(acc, af[k8].big,\n"
                     "                                sm90_tf32::desc_sw64(wsm + "
                     "32 * k8), 1);\n"
                     "          sm90_tf32::wgmma_tf32(acc, af[k8].big,\n"
                     "                                sm90_tf32::desc_sw64(wb + "
                     "32 * k8), 1);\n", "")],
    "no_gather": [("hub_reuse.cu",
                   "  for (int e0 = warp * kGroup; e0 < nsub;",
                   "  for (int e0 = warp * kGroup; e0 < 0;")],
    "gather_unroll1": [("hub_reuse.cu",
                        "#pragma unroll 4\n    for (int i = 0; i < k32; ++i) {",
                        "#pragma unroll 1\n    for (int i = 0; i < k32; ++i) {")],
    "group1": [("hub_reuse.cu", "constexpr int kGroup = 4;",
                "constexpr int kGroup = 1;")],
    "group8": [("hub_reuse.cu", "constexpr int kGroup = 4;",
                "constexpr int kGroup = 8;")],
    "x_cp_async": [("hub_reuse.cu", "constexpr bool kXByTma = true;",
                    "constexpr bool kXByTma = false;")],
    "linear_layered_always": [("hub_reuse.cu",
                               "  if (C <= kMaxC) return !fits;",
                               "  if (C <= kMaxC) return true;")],
    "linear_nsplit1": LAYERED_VARIANTS["layered_nsplit1"],
}


def library_call(lib, ops, out, dims, stream):
    """A call of a built hub_reuse library as its tree's wrapper makes it,
    by the library's own plan (``hub_reuse_plan``): the layered route
    with the scratch it reports, or one resident launch a chunk of 128
    cache rows (64 where 128 is refused), each merged into the last,
    after W's split into that scratch where the plan reports one on the
    resident route (the wgmma kernel: once a call).  ops: (pool, slot,
    comp, live, w1, b1, w2, b2), w2 and b2 None in one layer (h = 0).  ->
    a zero-argument call returning the launch's code."""
    import torch
    b, hn, c, m, k, d, h, f = dims
    ptrs = [None if t is None else t.data_ptr() for t in (*ops, out)]
    plan = (ctypes.c_longlong * 4)()
    lib.hub_reuse_plan.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    if lib.hub_reuse_plan(*dims, plan) != 0:
        raise RuntimeError(f"no plan for {dims}")
    scratch = torch.empty(max(plan[2], 1), device=out.device)
    if plan[0] == 1:
        fn = lib.hub_reuse_layered
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        return lambda: fn(*ptrs, scratch.data_ptr(), *dims, stream)
    fwd = lib.hub_reuse_forward
    # a tree with the wgmma kernel passes scratch (W's halves, split
    # where its plan reports them)
    extra = ((scratch.data_ptr(),) if hasattr(lib, "hub_reuse_linear_plan")
             else ())
    fwd.argtypes = [ctypes.c_void_p] * (9 + len(extra)) + [
        ctypes.c_int] * 11 + [ctypes.c_void_p]
    split = None
    if extra and plan[2] > 0:
        split = lib.hub_reuse_split_weights
        split.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]

    def run(chunk):
        if split is not None:
            code = split(ptrs[4], scratch.data_ptr(), d, f, stream)
            if code:
                return code
        for c0 in range(0, c, chunk):
            code = fwd(*ptrs, *extra, b, hn, c, m, k, d, h, f, c0,
                       int(c0 > 0), chunk, stream)
            if code:
                return code
        return 0
    chunk = 128 if run(128) == 0 else 64
    if chunk == 64 and run(64):
        raise RuntimeError(f"{dims}: its launches were refused")
    return lambda: run(chunk)


def against_bits(outs: dict, name: str) -> dict:
    """``bit_equal_against``: whether variant ``name``'s output equals the
    ``against`` tree's bit for bit (where both ran)."""
    import torch
    if "against" not in outs or name not in outs:
        return {}
    return {"bit_equal_against": bool(torch.equal(outs[name],
                                                  outs["against"]))}


def linear(args, libs, dev) -> int:
    """The one-layer form's shapes (see the module's doc)."""
    import torch

    import chip_smoke
    from repro_torch.engine.fc import _split_sign
    from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
    gen = torch.Generator().manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for blk, shp in chip_smoke.REUSE_LINEAR.items():
        pool, slot, comp, w, bias, _, _, live = chip_smoke.reuse_inputs(
            gen, dev, h=0, **shp)
        two = _split_sign(w, bias)
        ref = hub_reuse_ref(pool, slot, comp, w, bias, live=live)
        b, hn, c, m, k, d, f = (shp[n] for n in ("b", "hn", "c", "m", "k",
                                                 "d", "f"))
        fns = {"wrapper": lambda: hub_reuse(pool, slot, comp, w, bias,
                                            live=live),
               "plain": lambda: hub_reuse_ref(pool, slot, comp, w, bias,
                                              live=live),
               "split_sign": lambda: hub_reuse(pool, slot, comp, *two,
                                               live=live)}
        outs = {name: fns[name]() for name in ("wrapper", "split_sign")}
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            out = torch.empty_like(ref)
            ops = (pool, slot, comp, live, w, bias, None, None)
            dims = (b, hn, c, m, k, d, 0, f)
            fns[name] = library_call(lib, ops, out, dims, stream)
            if fns[name]() != 0:
                raise RuntimeError(f"{name} {blk}: launch failed")
            torch.cuda.synchronize()
            outs[name] = out
        ms = chip_smoke.time_turns(fns, iters=args.iters)
        for name in fns:
            row = dict(variant=name, block=blk, b=b, ms=ms[name],
                       **against_bits(outs, name))
            if name in outs:
                try:
                    row["max_abs_err"], row["tol"] = chip_smoke.max_err(
                        outs[name], ref)
                except AssertionError:      # a variant wrong on purpose
                    row["big_identity_exact"] = False
            print(json.dumps(row), flush=True)
    return 0


def layered(args, libs, dev) -> int:
    """The layered route's shapes (see the module's doc)."""
    import torch

    import chip_smoke
    from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
    gen = torch.Generator().manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shapes = [(blk, chip_smoke.B, shp) for blk, shp in
              chip_smoke.REUSE_C256.items()]
    # the same widths at smaller batches, where the chunked resident
    # route's grid (B H ceil(F / 64) blocks) covers less of the card
    shapes += [(f"{blk}_b{bb}", bb, shp) for blk, shp in
               chip_smoke.REUSE_C256.items() for bb in (1, 2, 4)]
    shapes += [(blk, 2, shp) for blk, shp in chip_smoke.REUSE_DOMAIN.items()]
    for blk, bb, shp in shapes:
        pool, slot, comp, w1, b1, w2, b2, live = chip_smoke.reuse_inputs(
            gen, dev, bb, **shp)
        ops = (pool, slot, comp, live, w1, b1, w2, b2)
        plain = (pool, slot, comp, w1, b1, w2, b2)
        ref = hub_reuse_ref(*plain, live=live)
        dims = (bb, shp["hn"], shp["c"], shp["m"], shp["k"], shp["d"],
                shp["h"], shp["f"])
        fns = {"wrapper": lambda: hub_reuse(*plain, live=live),
               "plain": lambda: hub_reuse_ref(*plain, live=live)}
        outs = {"wrapper": fns["wrapper"]()}
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            out = torch.empty_like(ref)
            fns[name] = library_call(lib, ops, out, dims, stream)
            if fns[name]() != 0:
                raise RuntimeError(f"{name} {blk}: launch failed")
            torch.cuda.synchronize()
            outs[name] = out
        ms = chip_smoke.time_turns(fns, iters=args.iters)
        for name in fns:
            row = dict(variant=name, block=blk, b=bb, ms=ms[name],
                       **against_bits(outs, name))
            if name in outs:
                try:
                    row["max_abs_err"], row["tol"] = chip_smoke.max_err(
                        outs[name], ref)
                except AssertionError:      # a variant wrong on purpose
                    row["big_identity_exact"] = False
            print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", default="",
                    help="comma-separated variants to build (default all)")
    ap.add_argument("--against", default="",
                    help="a directory with another hub_reuse.cu, timed as "
                         "the variant 'against'")
    ap.add_argument("--layered", action="store_true",
                    help="the layered route's shapes and variants")
    ap.add_argument("--linear", action="store_true",
                    help="the one-layer form's shapes and variants")
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
    only = set(filter(None, args.only.split(",")))
    for name, edits in (LAYERED_VARIANTS if args.layered else
                        LINEAR_VARIANTS if args.linear
                        else VARIANTS).items():
        if only and name not in only:
            continue
        texts = dict(sound)
        for fname, old, new in edits:
            if texts[fname].count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} occurs "
                                   f"{texts[fname].count(old)} times")
            texts[fname] = texts[fname].replace(old, new)
        sources[name] = texts
    if args.against:                  # the files that tree has
        sources["against"] = {f: (Path(args.against) / f).read_text()
                              for f in FILES
                              if (Path(args.against) / f).exists()}
    libs, logs = build(sources, _build.BUILD_DIR / "variants" / "hub_reuse",
                       with_logs=True)
    for name, log in logs.items():
        print(json.dumps({"variant": name, "ptxas": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]}), flush=True)

    dev = torch.device("cuda")
    if args.layered:
        return layered(args, libs, dev)
    if args.linear:
        return linear(args, libs, dev)
    gen = torch.Generator().manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for blk, shp in chip_smoke.REUSE.items():
        for bb in (chip_smoke.B, 1):
            pool, slot, comp, w1, b1, w2, b2, live = chip_smoke.reuse_inputs(
                gen, dev, bb, **shp)
            ops = (pool, slot, comp, w1, b1, w2, b2)
            ref = hub_reuse_ref(*ops, live=live)
            fns = {"wrapper": lambda: hub_reuse(*ops, live=live)}
            outs = {"wrapper": fns["wrapper"]()}
            for name, so in libs.items():
                lib = ctypes.CDLL(str(so))
                fwd = lib.hub_reuse_forward
                # the chunk knob (128 cache rows a launch) where it is taken
                chunk = ((128,) if hasattr(lib, "hub_reuse_smem_bytes")
                         else ())
                # no scratch in two layers, where the tree takes one
                extra = ((None,) if hasattr(lib, "hub_reuse_linear_plan")
                         else ())
                fwd.argtypes = ([ctypes.c_void_p] * (9 + len(extra))
                                + [ctypes.c_int] * (10 + len(chunk))
                                + [ctypes.c_void_p])
                out = torch.empty_like(ref)
                call = (lambda fwd=fwd, out=out, chunk=chunk, extra=extra: fwd(
                    *(t.data_ptr() for t in (pool, slot, comp, live, w1, b1,
                                             w2, b2, out)), *extra,
                    bb, shp["hn"], shp["c"], shp["m"], shp["k"], shp["d"],
                    shp["h"], shp["f"], 0, 0, *chunk, stream))
                if call() != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                outs[name] = out
                if name == "timeline":
                    print(json.dumps(dict(
                        variant=name, block=blk, b=bb,
                        cycles=out.flatten()[:6].tolist())), flush=True)
                fns[name] = call
            ms = chip_smoke.time_turns(fns, iters=args.iters)
            for name in fns:
                print(json.dumps(dict(
                    variant=name, block=blk, b=bb, ms=ms[name],
                    max_abs_err=(outs[name] - ref).abs().max().item(),
                    **against_bits(outs, name))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
