#!/usr/bin/env python3
"""Time text variants of the gather_mlp kernel side by side.

    python3 tools/gather_mlp_variants.py [--seed N] [--iters N]
        [--narrow | --linear] [--only committed,one_pass,...]
        [--against DIR]

Builds copies of ``src/repro_torch/csrc/gather_mlp.cu`` and
``tf32x3.cuh`` with one edit each (under ``build/repro_torch/variants/``;
the sources are not touched), calls each library's ``gather_mlp_forward``
directly (no Python wrapper) and times all variants in turns with CUDA
events, beside the committed kernel called through the wrapper
(``wrapper``: the host's share).  By default at the wide route's shapes
(chip_smoke.py's ``DENSE_WIDE`` and ``WIDE_D``), with ``--narrow`` at
the narrow route's block shapes, batched (B = 8) and per cloud (B = 1),
with ``--linear`` at every one-layer block of the zoo at chip_smoke.py's
``FAMILIES`` batches (the engine's lowering gives each one linear map)
and at ``DENSE_LINEAR``'s D = 700: the committed sources are called with
(W, b) and H = 0, and so are ``--against``'s where that library has the
linear route, else with the split-sign two-layer weights (x·[W, −W] +
[b, −b], relu, [I; −I], 0) the lowering made before it.
Prints ptxas's registers and spills per variant, one JSON line per
(variant, shape): ms and max |Δ| against the plain version, and with
``--against`` one per shape: whether the committed output is bit-equal to
the other tree's.  Most
variants compute a wrong result or take a worse path on purpose: each
removes one part of the design (the small TF32 products, layer 1 once a
block, subsets packed K rows apart, two blocks an SM, ...) so that its
time shows that part's worth; the others are alternatives the kernel
does not take.  ``--only`` keeps the named variants; ``--against DIR``
adds the sources of another tree (``gather_mlp.cu`` and the headers
in DIR, e.g. a parent commit's ``src/repro_torch/csrc``) as the variant
``against``, timed in the same turns (called with its own signature).
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

SMALL = "  mma(c, a.small, b.big);\n  mma(c, a.big, b.small);\n"
# name -> (the route whose shapes it runs on, "all" for every route,
# [(file, text, replacement), ...]); each text occurs once
VARIANTS = {
    "committed": ("all", []),
    # 1xTF32: what the two small products cost (mma3's; the linear route's
    # waves keep their three products)
    "one_pass": ("all", [("tf32x3.cuh", SMALL, "")]),
    # ---- the linear route ------------------------------------------------
    # 1xTF32 on wgmma: the two small products dropped
    "lin_one_pass": ("linear", [("gather_mlp.cu",
                                 "          sm90_tf32::wgmma_tf32(acc, af[k8].small,\n"
                                 "                                sm90_tf32::desc_sw64(wb + 32 * k8), 1);\n"
                                 "          sm90_tf32::wgmma_tf32(acc, af[k8].big,\n"
                                 "                                sm90_tf32::desc_sw64(wsm + 32 * k8), 1);\n",
                                 "")]),
    # F tiles of at most 128 columns: x crosses DRAM twice at F = 256
    "lin_n128": ("linear", [("gather_mlp.cu",
                             "constexpr int kMaxN = 256;",
                             "constexpr int kMaxN = 128;")]),
    # x by cp.async everywhere, not by TMA where D % 4 == 0
    "lin_x_cp_async": ("linear", [("gather_mlp.cu",
                                   "constexpr bool kXByTma = true;",
                                   "constexpr bool kXByTma = false;")]),
    # a block an item, not one an SM walking the items
    "lin_no_persist": ("linear", [("gather_mlp.cu",
                                   "const int grid = min(p.items, "
                                   "blocks_per_sm(N) * sm_count());",
                                   "const int grid = p.items;")]),
    # a ring of at most 3 stages
    "lin_stages3": ("linear", [("gather_mlp.cu",
                                "constexpr int kMaxStages = 8;",
                                "constexpr int kMaxStages = 3;")]),
    # 128-row tiles (two consumer warpgroups) at every size
    "lin_rows128": ("linear", [("gather_mlp.cu",
                                "  return 4 * items < 3LL * blocks_per_sm(cols(F)) "
                                "* sms ? 64 : 128;",
                                "  return 128;")]),
    # 64-row tiles (one consumer warpgroup) at every size
    "lin_rows64": ("linear", [("gather_mlp.cu",
                               "  return 4 * items < 3LL * blocks_per_sm(cols(F)) "
                               "* sms ? 64 : 128;",
                               "  return 64;")]),
    # W's halves never copied (stale): what streaming W through L2 costs
    "lin_no_w": ("linear", [("gather_mlp.cu",
                             "            sm90::tma_load(st, &wmap, full + s, d0, f0, 0);\n"
                             "            sm90::tma_load(st + N * kBK * 4, &wmap, full + s, d0, f0, 1);\n",
                             ""),
                            ("gather_mlp.cu",
                             "    const int tx = 2 * N * kBK * 4 + (p.x_tma ? R * kXS * 4 : 0);",
                             "    const int tx = p.x_tma ? R * kXS * 4 : 0;")]),
    # the centers neither staged nor subtracted: what centering costs
    "lin_no_center": ("linear", [("gather_mlp.cu",
                                  "          if (d0 < p.Dc) {\n            for (int e = pt;",
                                  "          if (false) {\n            for (int e = pt;"),
                                 ("gather_mlp.cu",
                                  "const bool centered = q * kBK < p.Dc;",
                                  "const bool centered = false;")]),
    # y not pooled: what the epilogue's max costs
    "lin_no_pool": ("linear", [("gather_mlp.cu",
                                "for (int e = ct; e < p.spt * nc; "
                                "e += kCons) {",
                                "for (int e = ct; e < 0; "
                                "e += kCons) {")]),
    # ---- the wide route --------------------------------------------------
    # layer 1 once per 64-column F tile, as the PR 18 route did
    "recompute": ("wide", [("gather_mlp.cu",
                            "constexpr int kMaxFT = 256;",
                            "constexpr int kMaxFT = 64;")]),
    # subsets at multiples of 16 rows (K = 20: 2 a tile, not 3)
    "k_pad16": ("wide", [("gather_mlp.cu",
                          "p.Kp = q.K > 0 ? q.K : 1;", "p.Kp = q.Kp;")]),
    # one block an SM: x resident wherever it fits an SM, H split only to
    # one block an SM, 255 registers
    "one_block": ("wide", [("gather_mlp.cu", "constexpr int kBlocks = 2;",
                            "constexpr int kBlocks = 1;")]),
    # H never split: small grids leave SMs idle
    "no_split": ("wide", [("gather_mlp.cu", "} else if (blocks < sms) {",
                           "} else if (false) {")]),
    # H split only where the blocks would fill at most half the SMs
    "split_half": ("wide", [("gather_mlp.cu", "} else if (blocks < sms) {",
                             "} else if (2 * blocks <= sms) {")]),
    # x always streamed in slices beside W1, never resident
    "stream_x": ("wide", [("gather_mlp.cu",
                           "  if (smem_bytes(p) > (size_t)kBudget) {",
                           "  if (true) {")]),
    # the small parts rounded to TF32 (split), not truncated (split_fast)
    "exact_split": ("wide", [("gather_mlp.cu",
                              "constexpr bool kFast = true;",
                              "constexpr bool kFast = false;")]),
    # W2's k8 steps unrolled within a stage (ptxas spills at 128 registers)
    "l2_unrolled": ("wide", [("gather_mlp.cu",
                              "#pragma unroll 1                          "
                              "// one k8 step at a time: no spills",
                              "#pragma unroll")]),
    # layer 1's k8 steps one at a time, as layer 2's
    "l1_rolled": ("wide", [("gather_mlp.cu",
                            "        mma_stage<1, kNH, kWNH, kDCR / 8>(\n"
                            "            acc_h, a, resident ? p.XD : kXS, st, "
                            "kW1S,\n            min(p.dc, p.Dp - r * p.dc) / 8, "
                            "warp / kWNH, warp % kWNH, lane);",
                            "        const int steps = min(p.dc, p.Dp - r * "
                            "p.dc) / 8;\n#pragma unroll 1\n"
                            "        for (int s = 0; s < steps; ++s)\n"
                            "          mma_stage<1, kNH, kWNH, 1>(acc_h, a + s "
                            "* 8, resident ? p.XD : kXS, st + s * 8 * kW1S, "
                            "kW1S, 1, warp / kWNH, warp % kWNH, lane);")]),
    # W1's and W2's stages never copied (stale): what streaming W costs
    "no_w_loads": ("wide", [("gather_mlp.cu",
                             "  for (int e = threadIdx.x; e < rows * (COLS / 4);"
                             " e += kThreads) {",
                             "  for (int e = threadIdx.x; e < 0; "
                             "e += kThreads) {")]),
    # x never copied (stale): what loading x costs
    "no_x_loads": ("wide", [("gather_mlp.cu",
                             "  auto load_x = [&](float* dst, int ld, int d0, "
                             "int width) {\n    for (int e = tid; e < kR * "
                             "(width / 4); e += kThreads) {",
                             "  auto load_x = [&](float* dst, int ld, int d0, "
                             "int width) {\n    for (int e = tid; e < 0; "
                             "e += kThreads) {")]),
    # the centers' loop not unrolled: its loads one quad at a time
    "center_rolled": ("wide", [("gather_mlp.cu",
                                "#pragma unroll 4              // 4 quads' "
                                "loads in flight (rolled: spills)\n", "")]),
    # the centers not subtracted: what the per-thread fix-up costs
    "no_center": ("wide", [("gather_mlp.cu",
                            "    if (d0 >= p.Dc) return;\n#pragma unroll 4",
                            "    return;\n#pragma unroll 4")]),
    # ---- the narrow route ------------------------------------------------
    # x left as it was: what staging the raw rows costs
    "no_raw": ("narrow", [("gather_mlp.cu",
                           "    for (int r = warp; r < R; r += kThreads / 32) {",
                           "    for (int r = warp; r < 0; r += kThreads / 32) {")]),
    # W stages left as they were: what streaming W1 and W2 costs
    "no_w_stages": ("narrow", [("gather_mlp.cu",
                                "  for (int e = threadIdx.x; e < kKC * (kNC / 4); "
                                "e += kThreads) {",
                                "  for (int e = threadIdx.x; e < 0; e += kThreads) {")]),
    # rows of an m16 tile not met by shuffles: what the epilogue's cost
    "no_shuffles": ("narrow", [("gather_mlp.cu",
                                "          for (int off = 4; off < 32; off <<= 1) {",
                                "          for (int off = 4; off < 0; off <<= 1) {")]),
    # 64-row tiles at every size
    "rows_64": ("narrow", [("gather_mlp.cu",
                            "  return rows / big < (long long)kBlocksPerSM * "
                            "sm_count() ? small : big;",
                            "  return small;")]),
}


def forward(lib, dev):
    """A caller of lib's gather_mlp_forward, with any of its signatures:
    the scratch pointer (and its size from gather_mlp_scratch_bytes) where
    the library has one, none where it predates the wide route's splits;
    the launch knobs rows and nsplit (0, 0: the heuristic's launch) where
    it takes them (it then has gather_mlp_smem_bytes)."""
    import torch
    P, I = ctypes.c_void_p, ctypes.c_int
    fwd = lib.gather_mlp_forward
    try:
        sizer = lib.gather_mlp_scratch_bytes
    except AttributeError:
        sizer = None
    knobs = (0, 0) if hasattr(lib, "gather_mlp_smem_bytes") else ()
    fwd.argtypes = ([P] * (9 if sizer else 8) + [I] * (7 + len(knobs))
                    + [P])
    fwd.restype = I
    if sizer:
        sizer.argtypes = [I] * (7 + len(knobs[:1]))
        sizer.restype = ctypes.c_longlong
    stream = torch.cuda.current_stream(dev).cuda_stream

    def bind(ptrs, out, dims):
        ptrs = [*ptrs, out]
        scratch = None
        if sizer:
            n = sizer(*dims, *knobs[:1])
            if n:
                scratch = torch.empty(n, dtype=torch.uint8, device=dev)
            ptrs.append(None if scratch is None else scratch.data_ptr())

        def call():
            return fwd(*ptrs, *dims, *knobs, stream)
        call.scratch = scratch            # held while the caller lives
        return call
    return bind


def split_sign(w, b):
    """(w1, b1, w2, b2) of x·w + b as the parent's lowering embedded it:
    relu(x·[w, −w] + [b, −b])·[I; −I] + 0."""
    import torch
    eye = torch.eye(w.shape[1], dtype=w.dtype, device=w.device)
    return (torch.cat([w, -w], 1), torch.cat([b, -b]),
            torch.cat([eye, -eye], 0), torch.zeros_like(b))


def one_layer_blocks() -> dict:
    """Every one-layer block of the zoo at chip_smoke.py's ``FAMILIES``
    batch, as the engine's lowering launches it (``dense_shape``, h = 0),
    masked as the path calls it (EdgeConv's every block and the SA
    stacks' first see n_valid)."""
    import chip_smoke
    from repro_torch.engine import init
    from repro_torch.engine.fc import dense_shape
    from repro_torch.models import MODEL_ZOO
    out = {}
    for name, (b, _) in chip_smoke.FAMILIES.items():
        spec = MODEL_ZOO[name][1]
        params = init(spec, device="cpu")
        for i, (blk, mlp) in enumerate(zip(spec.blocks, params.blocks), 1):
            k, d, dc, h, f = dense_shape(blk.kind, blk.k, mlp)
            if h == 0:
                out[f"{name}_blk{i}"] = dict(
                    b=b, s=blk.n_centers, k=k, d=d, dc=dc, h=0, f=f,
                    masked=blk.kind == "edge" or i == 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--narrow", action="store_true",
                    help="time the narrow route's shapes instead")
    ap.add_argument("--linear", action="store_true",
                    help="time the one-layer blocks on the linear route")
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
    from repro_torch.kernels.gather_mlp import gather_mlp, gather_mlp_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    way = "narrow" if args.narrow else "linear" if args.linear else "wide"
    sound = {f: (_build.CSRC / f).read_text() for f in FILES}
    sources = {}
    only = set(filter(None, args.only.split(",")))
    for name, (route, edits) in VARIANTS.items():
        if (only and name not in only) or route not in ("all", way):
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
                              for f in FILES
                              if (Path(args.against) / f).exists()}
    libs, logs = build(sources, _build.BUILD_DIR / "variants" / "gather_mlp",
                       with_logs=True)
    for name, log in logs.items():
        print(json.dumps({"variant": name, "ptxas": [
            row for row in chip_smoke.ptxas_kernels(log)]}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    if args.narrow:
        shapes = {f"{blk}_b{bb}": {"b": bb, **shp}
                  for blk, shp in chip_smoke.DENSE.items()
                  for bb in (chip_smoke.B, 1)}
    elif args.linear:
        shapes = {**one_layer_blocks(),
                  "d700": chip_smoke.DENSE_LINEAR["d700"]}
    else:
        shapes = {**chip_smoke.DENSE_WIDE, **chip_smoke.WIDE_D}
    callers = {name: forward(ctypes.CDLL(str(so)), dev)
               for name, so in libs.items()}
    against_linear = False           # the other tree has the linear route
    if "against" in libs:
        lib = ctypes.CDLL(str(libs["against"]))
        against_linear = (hasattr(lib, "gather_mlp_route")
                          and lib.gather_mlp_route(1, 8, 3, 0, 8) == 2)
    for blk, shp in shapes.items():
        raw, ctr, w1, b1, w2, b2, mask = chip_smoke.dense_inputs(
            gen, dev, **shp)
        args_ = (raw, ctr, w1, b1, w2, b2)
        ref = gather_mlp_ref(*args_, mask=mask)
        dims = (shp["b"], shp["s"], shp["k"], shp["d"], shp["dc"], shp["h"],
                shp["f"])
        ptrs = [t.data_ptr() if t is not None else None
                for t in (raw, ctr, mask, w1, b1, w2, b2)]
        two = None                   # the two-layer form of (W, b)
        if args.linear and not against_linear:
            two = [t.contiguous() for t in split_sign(w1, b1)]
            two_dims = (*dims[:5], 2 * shp["f"], shp["f"])
            two_ptrs = [raw.data_ptr(), ctr.data_ptr(),
                        None if mask is None else mask.data_ptr(),
                        *(t.data_ptr() for t in two)]
        fns = {"wrapper": lambda: gather_mlp(*args_, mask=mask)}
        outs = {"wrapper": None}
        for name, bind in callers.items():
            out = torch.empty_like(ref)
            if two is not None and name == "against":
                fns[name] = bind(two_ptrs, out.data_ptr(), two_dims)
            else:
                fns[name] = bind(ptrs, out.data_ptr(), dims)
            outs[name] = out
        errs = {}
        for name, fn in list(fns.items()):
            got = fn()
            if name != "wrapper":
                if got != 0 and name == "against":
                    print(json.dumps(dict(variant=name, shape=blk,
                                          refuses=got)), flush=True)
                    del fns[name]
                    continue
                if got != 0:
                    raise RuntimeError(f"{name} {blk}: launch failed ({got})")
                got = outs[name]
            torch.cuda.synchronize()
            errs[name] = (got - ref).abs().max().item()
        ms = chip_smoke.time_turns(fns, iters=args.iters)
        for name in fns:
            print(json.dumps(dict(variant=name, shape=blk, ms=ms[name],
                                  max_abs_err=errs[name], device=smi)),
                  flush=True)
        if "against" in fns and "committed" in fns:
            print(json.dumps(dict(shape=blk, bit_equal_against=bool(
                torch.equal(outs["committed"], outs["against"])))),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
