#!/usr/bin/env python3
"""Time text variants of the ssd_chunk kernel side by side.

    python3 tools/ssd_chunk_variants.py [--seed N] [--iters N]
        [--only committed,one_pass] [--shapes a,b] [--against DIR]
        [--backward]

Builds copies of ``src/repro_torch/csrc/ssd_chunk.cu``, ``ssd_tiles.cuh``
and ``tf32x3.cuh`` with one edit each (under
``build/repro_torch/variants/ssd_chunk/``; the sources are not touched),
calls each library's ``ssd_chunk_forward`` directly (no Python wrapper)
at chip_smoke.py's ``SSD_LAYERS`` (a Mamba2-2.7B layer at chunks of 64
and 128, the ``whole`` route) and ``SSD_TILED`` (the layer at Mamba-2's
published chunk, 256, bs 1 and 2: the ``tiled`` route), and times every
variant and the plain version in turns with CUDA events.  ``one_pass``
computes a wrong result on purpose (1xTF32: the two small products
dropped), to show what they cost; the others are alternatives the kernel
does not take (``VARIANTS``; the tiled route's are named ``tiled_*``).
Prints ptxas's registers and spills per kernel of each variant and one
JSON line per (shape, variant): ms and max |Δ| of y_in and the states
against the plain version beside the limit 2e-4 · max(1, max|plain|).
``--against DIR`` adds another tree's ``ssd_chunk.cu`` and the headers
beside it (e.g. a parent commit's ``src/repro_torch/csrc``) as the
variant ``against``, timed in the same turns, and ``speedup`` (against's
ms over each variant's); a library that refuses a shape says so.

``--backward`` does the same for ``ssd_chunk_bwd.cu`` at chip_smoke.py's
``SSD_BWD_LAYERS`` (the layer at chunks of 64 and 128, and the trainer's
microbatch) and ``SSD_TILED``, calling each library's
``ssd_chunk_backward`` with scratch sized by its own
``ssd_chunk_backward_scratch``: max |Δ| of each output against
``ssd_chunk_bwd_ref`` beside the smoke's ``SSD_BWD_TOL`` · max(1,
max|ref|), ms, the bound, and for ``committed`` each pass's device time
(torch.profiler) and the plan.  Its variants (``BWD_VARIANTS``) take
one design step out at a time (``sync_copies``: every copy waited for as
soon as it is issued; ``b_reload``: B's S tiles through the copy ring
for every unit; ``st_through_scratch``: dB's state term added into the
group's scratch slot at every (unit, S tile)), ``one_pass`` (1xTF32,
wrong on purpose) and ``hg10`` (10 heads a group); designs measured and
not taken (``l_regs``, ``unroll``, ``mma3_split``); ``timeline`` (block
(0, 0)'s cycles a step, by warp group); and diagnostics that drop a part,
wrong on purpose (``BWD_DIAGNOSTICS``); the tiled route's are named
``tiled_*``.  Needs one CUDA device.
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
# the tiled route (q > 128): diagnostics, all wrong on purpose (the y
# blocks' M x, the states blocks' product, C.B^T's products dropped; the
# exponential dropped), every stage waited for as soon as it is issued,
# and fixed heads a group
_TL_GRID = ("  l.grid = dim3((unsigned)BN,\n"
            "                (unsigned)((long long)((H + a.HG - 1) / a.HG) * "
            "a.roles));")
VARIANTS.update({
    "tiled_no_y": [("ssd_chunk.cu",
                    "        const int kend = max(kmax[0], kmax[1]);",
                    "        const int kend = 0;")],
    "tiled_no_states": [("ssd_chunk.cu",
                         "for (int ks = 0; ks < kR / 8; ++ks) {",
                         "for (int ks = 0; ks < 0; ++ks) {")],
    "tiled_no_cb": [("ssd_chunk.cu",
                     "          if (k >= nstr || jt > s || (jt == s && 32 * cg "
                     "> 16 * m + 15))\n            continue;",
                     "          if (true) continue;")],
    "tiled_no_exp": [("ssd_tiles.cuh",
                      "return on ? cb * __expf(ci - cj) * dj : 0.f;",
                      "return on ? cb * dj : 0.f;")],
    "tiled_bare": [],
    "tiled_sync_copies": [("ssd_chunk.cu",
                           "        column_factors(d + 1, jt0, nj);\n      }\n"
                           "      tf32x3::cp_async_commit();\n",
                           "        column_factors(d + 1, jt0, nj);\n      }\n"
                           "      tf32x3::cp_async_commit();\n"
                           "      tf32x3::cp_async_wait<0>();\n"
                           "      __syncthreads();\n")],
    **{f"tiled_hg{n}": [("ssd_chunk.cu", _TL_GRID,
                         f"  a.HG = H < {n} ? H : {n};\n" + _TL_GRID)]
       for n in (5, 10, 40)},
})
# block (0, 0)'s clock at each step of the tiled route: thread 0 past the
# step's barrier, y warp 0 and states warp 4 at the end of their products
_TL_CLK = ("blockIdx.x == 0 && blockIdx.y == 0 && lane == 0 && d < 4096")
VARIANTS["tiled_timeline"] = [
    ("ssd_chunk.cu", "constexpr int kQMax = 128;            // chunk length\n",
     "constexpr int kQMax = 128;            // chunk length\n"
     "__device__ long long g_tl[3][4096];\n"),
    ("ssd_chunk.cu",
     "      __syncthreads();   // stage d landed; stage d - 1 is read\n",
     "      __syncthreads();   // stage d landed; stage d - 1 is read\n"
     f"      if ({_TL_CLK} && warp == 0) g_tl[0][d] = clock64();\n"),
    ("ssd_chunk.cu",
     "        if (jt == jt1 - 1) {   // the unit's last tile in this window\n",
     f"        if ({_TL_CLK} && warp == 0) g_tl[1][d] = clock64();\n"
     "        if (jt == jt1 - 1) {   // the unit's last tile in this window\n"),
    ("ssd_chunk.cu",
     "        if (jt == jt1 - 1) {\n#pragma unroll\n          for (int m = 0;",
     f"        if ({_TL_CLK} && warp == 4) g_tl[2][d] = clock64();\n"
     "        if (jt == jt1 - 1) {\n#pragma unroll\n          for (int m = 0;"),
    ("ssd_chunk.cu", "extern \"C\" const char* ssd_chunk_error_string",
     "extern \"C\" int ssd_tl_timeline(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));\n}\n\n"
     "extern \"C\" const char* ssd_chunk_error_string")]
_TL_YLOOP = ("        for (int ks = 0; ks < kend; ++ks) {\n"
             "          const int jl = 8 * ks + 2 * t, j0 = jt * kR + jl, "
             "j1 = j0 + 1;\n")
for _n in (2, 4):
    VARIANTS[f"tiled_y_unroll{_n}"] = [("ssd_chunk.cu", _TL_YLOOP,
                                        f"#pragma unroll {_n}\n" + _TL_YLOOP)]
VARIANTS["tiled_bare"] = (VARIANTS["tiled_no_y"] + VARIANTS["tiled_no_states"]
                          + VARIANTS["tiled_no_cb"])


BWD_FILES = ("ssd_chunk_bwd.cu", "ssd_tiles.cuh", "tf32x3.cuh")
BWD_VARIANTS = {
    "committed": [],
    "sync_copies": [("ssd_chunk_bwd.cu", "    prefetch(d);\n",
                     "    prefetch(d);\n"
                     "    tf32x3::cp_async_wait<0>();\n"
                     "    __syncthreads();\n")],
    "b_reload": [("ssd_chunk_bwd.cu", "  pl.b_res = base + res <= max_f;",
                  "  pl.b_res = 0;")],
    "st_through_scratch": [("ssd_chunk_bwd.cu",
                            "  pl.st_res = total + res <= max_f;",
                            "  pl.st_res = 0;")],
    "one_pass": VARIANTS["one_pass"],
    "hg10": [("ssd_chunk_bwd.cu", "  pl.G = (H + pl.HG - 1) / pl.HG;",
              "  pl.HG = H < 10 ? H : 10;\n"
              "  pl.G = (H + pl.HG - 1) / pl.HG;")],
}
# diagnostics, all wrong on purpose: both warp groups' products dropped
# (the X warps' E and M^T dy, the D warps' state term and dM: "bare" keeps
# the copies, barriers and stores alone), the copies after the first
# unit's (every unit reuses stale tiles), a head's first step's w, L and
# the last head's ddt / dcum
_NO_X = [("ssd_chunk_bwd.cu",
          "      if (xr[0] >= 0) {\n        const int kss",
          "      if (false) {\n        const int kss"),
         ("ssd_chunk_bwd.cu", "for (int ks = 2 * r; ks < QP / 8; ++ks) {",
          "for (int ks = QP / 8; ks < QP / 8; ++ks) {")]
_NO_D = [("ssd_chunk_bwd.cu",
          "        for (int ks = 0; ks < kp; ++ks) {\n"
          "          const int pc = 8 * ks + 2 * t;",
          "        for (int ks = kp; ks < kp; ++ks) {\n"
          "          const int pc = 8 * ks + 2 * t;"),
         ("ssd_chunk_bwd.cu",
          "          for (int ks = 0; ks < kp; ++ks)\n"
          "            tf32x3::mma3(dm[s - s3],",
          "          for (int ks = kp; ks < kp; ++ks)\n"
          "            tf32x3::mma3(dm[s - s3],")]
BWD_DIAGNOSTICS = {
    "bare": _NO_X + _NO_D,
    "no_copies": [("ssd_chunk_bwd.cu",
                   "      if (it + 1 < units) issue_unit(it + 1);",
                   "      if (false) issue_unit(it + 1);"),
                  ("ssd_chunk_bwd.cu",
                   "    if (d + 1 < steps) issue_tile(d + 1);",
                   "    if (false) issue_tile(d + 1);")],
    "no_head_start": [("ssd_chunk_bwd.cu",
                       "    if (si == 0 && pi == 0) {\n      if (xw) {",
                       "    if (false) {\n      if (xw) {")],
}
BWD_VARIANTS.update(BWD_DIAGNOSTICS)
# L in registers at chunk 64 too, as at 128 (the exponentials taken per
# fragment, its shared memory freed)
BWD_VARIANTS["l_regs"] = [
    ("ssd_chunk_bwd.cu", "  constexpr bool kL = QM == 64;",
     "  constexpr bool kL = false;"),
    ("ssd_chunk_bwd.cu", "pl.cbf * (QP <= 64 ? 2 : 1);", "pl.cbf;")]
# block (0, 0)'s clock at each step: thread 0 (an X warp) and thread 256
# (a D warp) on reaching the step's wait, thread 0 past its barrier
_TL = ("    if (blockIdx.x == 0 && blockIdx.y == 0 && d < 4096) {\n"
       "      if (threadIdx.x == 0) g_tl[0][d] = clock64();\n"
       "      if (threadIdx.x == 256) g_tl[1][d] = clock64();\n"
       "    }\n")
BWD_VARIANTS["timeline"] = [
    ("ssd_chunk_bwd.cu", "constexpr int kQMax = 128;           // chunk length\n",
     "constexpr int kQMax = 128;           // chunk length\n"
     "__device__ long long g_tl[3][4096];\n"),
    ("ssd_chunk_bwd.cu", "    if (si == 1) tf32x3::cp_async_wait<1>();\n",
     _TL + "    if (si == 1) tf32x3::cp_async_wait<1>();\n"),
    ("ssd_chunk_bwd.cu", "    prefetch(d);\n",
     "    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&\n"
     "        d < 4096) g_tl[2][d] = clock64();\n    prefetch(d);\n"),
    ("ssd_chunk_bwd.cu", "extern \"C\" const char* ssd_chunk_bwd_error_string",
     "extern \"C\" int ssd_bwd_timeline(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));\n}\n\n"
     "extern \"C\" const char* ssd_chunk_bwd_error_string")]
# each 3xTF32 product's two small terms into a fresh accumulator, added to
# the sum after its big term: two dependent mma.sync a product, not three
BWD_VARIANTS["mma3_split"] = [
    ("tf32x3.cuh",
     "  mma(c, a.small, b.big);\n  mma(c, a.big, b.small);\n"
     "  mma(c, a.big, b.big);\n",
     "  float s[4] = {0.f, 0.f, 0.f, 0.f};\n  mma(s, a.small, b.big);\n"
     "  mma(s, a.big, b.small);\n  mma(c, a.big, b.big);\n"
     "#pragma unroll\n  for (int i = 0; i < 4; ++i) c[i] += s[i];\n")]
BWD_VARIANTS["unroll"] = [
    ("ssd_chunk_bwd.cu",
     "        for (int ks = 0; ks < kss; ++ks) {\n",
     "#pragma unroll\n        for (int ks = 0; ks < T / 8; ++ks) {\n"
     "          if (ks >= kss) break;\n"),
    ("ssd_chunk_bwd.cu",
     "        for (int ks = 0; ks < kp; ++ks) {\n",
     "#pragma unroll\n        for (int ks = 0; ks < T / 8; ++ks) {\n"
     "          if (ks >= kp) break;\n"),
    ("ssd_chunk_bwd.cu",
     "          for (int ks = 0; ks < kp; ++ks)\n"
     "            tf32x3::mma3(dm[s - s3],",
     "#pragma unroll\n          for (int ks = 0; ks < T / 8; ++ks)\n"
     "            if (ks < kp) tf32x3::mma3(dm[s - s3],"),
    ("ssd_chunk_bwd.cu",
     "        for (int ks = 2 * r; ks < QP / 8; ++ks) {\n",
     "#pragma unroll\n        for (int kk = 0; kk < QM / 8; ++kk) {\n"
     "          const int ks = 2 * r + kk;\n"
     "          if (ks >= QP / 8) break;\n")]


def texts_of(files, variants, only, against):
    """{variant: {file: text}}: each variant's edits applied to the
    committed sources, and ``against``'s files where it names a tree."""
    from repro_torch.kernels import _build
    sound = {f: (_build.CSRC / f).read_text() for f in files}
    sources = {}
    for name, edits in variants.items():
        if only and name not in only:
            continue
        texts = dict(sound)
        for fname, old, new in edits:
            if texts[fname].count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} occurs "
                                   f"{texts[fname].count(old)} times")
            texts[fname] = texts[fname].replace(old, new)
        sources[name] = texts
    if against:
        d = Path(against)
        sources["against"] = {f.name: f.read_text() for f in
                              (d / files[0], *sorted(d.glob("*.cuh")))}
    return sources


def timeline(lib, call, m) -> dict:
    """One more call of the ``timeline`` variant, then block (0, 0)'s
    steps: cycles of the X and the D warp's work before each barrier, the
    stall from the later of the two to the barrier's release (the copies'
    wait and the other warps), and the block's cycles from its first step
    to its last; means by the step's place in its unit (si)."""
    import torch
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (3 * 4096))()
    if lib.ssd_bwd_timeline(buf):
        return {}
    tx, td, tb = (list(buf[k * 4096:(k + 1) * 4096]) for k in range(3))
    steps = next((i for i in range(4096) if tb[i] == 0), 4096)
    n_s = -(-m["s"] // 64) if m["q"] <= 64 else -(-m["s"] // 32)  # S tiles
    out = {}
    for d in range(1, steps):   # step d - 1's work, d - 1's place
        key = f"si{(d - 1) % n_s}"
        row = out.setdefault(key, dict(n=0, x_work=0, d_work=0, stall=0))
        row["n"] += 1
        row["x_work"] += tx[d] - tb[d - 1]
        row["d_work"] += td[d] - tb[d - 1]
        row["stall"] += tb[d] - max(tx[d], td[d])
    for row in out.values():
        for k in ("x_work", "d_work", "stall"):
            row[k] = round(row[k] / row["n"])
    out["cycles"] = tb[steps - 1] - tb[0]
    return out


def fwd_timeline(so, call) -> dict:
    """One more call of the ``tiled_timeline`` variant, then block (0, 0)'s
    steps: cycles from a step's barrier to the end of the y warp's and the
    states warp's products, and from one step's barrier to the next."""
    import torch
    call()
    torch.cuda.synchronize()
    lib = ctypes.CDLL(str(so))
    buf = (ctypes.c_longlong * (3 * 4096))()
    if lib.ssd_tl_timeline(buf):
        return {}
    t0, ty, ts = (list(buf[k * 4096:(k + 1) * 4096]) for k in range(3))
    steps = next((i for i in range(1, 4096) if t0[i] == 0), 4096)
    y = [ty[d] - t0[d] for d in range(steps) if ty[d]]
    st = [ts[d] - t0[d] for d in range(steps) if ts[d]]
    gap = [t0[d + 1] - t0[d] for d in range(steps - 1)]
    mean = lambda v: round(sum(v) / len(v)) if v else None
    return dict(steps=steps, y=mean(y), states=mean(st), step=mean(gap),
                first=t0[0], total=t0[steps - 1] - t0[0],
                y_each=y[:8], states_each=st[:8], step_each=gap[:8])


def backward(args) -> int:
    """The backward's variants at SSD_BWD_LAYERS (see the module's doc)."""
    import torch

    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_ref
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    sources = texts_of(BWD_FILES, BWD_VARIANTS,
                       set(filter(None, args.only.split(","))), args.against)
    libs, logs = build(sources,
                       _build.BUILD_DIR / "variants" / "ssd_chunk_bwd",
                       with_logs=True)
    for name, log in logs.items():
        print(json.dumps({"variant": name,
                          "ptxas": chip_smoke.ptxas_kernels(log)}),
              flush=True)
    loaded = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        lib.ssd_chunk_backward.argtypes = ([ctypes.c_void_p] * 13
                                           + [ctypes.c_int] * 5
                                           + [ctypes.c_void_p])
        lib.ssd_chunk_backward_scratch.argtypes = [ctypes.c_int] * 5
        lib.ssd_chunk_backward_scratch.restype = ctypes.c_longlong
        loaded[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    keep = set(filter(None, args.shapes.split(",")))
    parts = ("dx", "dB", "dC", "ddt", "dcum")
    for shape, m in {**chip_smoke.SSD_BWD_LAYERS,
                     **chip_smoke.SSD_TILED}.items():
        if keep and shape not in keep:
            continue
        ops = chip_smoke.ssd_bwd_inputs(gen, dev, **m)
        refs = ssd_chunk_bwd_ref(*ops)
        dims = (m["bs"] * m["nc"], m["h"], m["q"], m["p"], m["s"])
        fns = {"plain": lambda ops=ops: ssd_chunk_bwd_ref(*ops)}
        rows = {}
        for name, lib in loaded.items():
            outs = [torch.empty(r.shape, device=dev) for r in refs]
            scratch = torch.empty(lib.ssd_chunk_backward_scratch(*dims),
                                  device=dev)
            argv = (*[t.data_ptr() for t in (*ops, *outs, scratch)], *dims,
                    stream)
            call = (lambda lib=lib, argv=argv: lib.ssd_chunk_backward(*argv))
            code = call()
            torch.cuda.synchronize()
            if code != 0:
                rows[name] = dict(refused=f"CUDA error {code}")
                continue
            row = {}
            for part, o, r in zip(parts, outs, refs):
                row[part] = dict(
                    max_abs_err=(o - r).abs().max().item(),
                    tol=chip_smoke.SSD_BWD_TOL * max(1.0,
                                                      r.abs().max().item()))
            row["within_tol"] = all(v["max_abs_err"] <= v["tol"]
                                    for v in row.values())
            rows[name] = row
            fns[name] = call
        ms = chip_smoke.time_turns(fns, iters=args.iters)
        if "timeline" in fns:
            rows["timeline"]["steps"] = timeline(loaded["timeline"],
                                                 fns["timeline"], m)
        if "committed" in fns:
            rows["committed"]["device_ms"] = {
                p: chip_smoke.pass_ms(fns["committed"], f"ssd_bwd_{p}")
                for p in ssd_ops.SSD_BWD_PASSES}
            rows["committed"]["plan"] = ssd_ops.backward_plan(
                m["bs"], m["nc"], m["q"], m["h"], m["p"], m["s"])
        flops = 2.0 * m["bs"] * m["nc"] * chip_smoke.ssd_bwd_macs(
            m["q"], m["h"], m["p"], m["s"])
        bms, by = chip_smoke.bound(3 * flops, chip_smoke.nbytes(*ops, *refs),
                                   chip_smoke.PEAK_TF32)
        for name in (*loaded, "plain"):
            row = rows.get(name, {})
            if name in ms:
                row["ms"] = ms[name]
                row["share"] = bms / ms[name]
                if "against" in ms:
                    row["speedup"] = ms["against"] / ms[name]
            print(json.dumps(dict(shape=shape, variant=name, **row,
                                  bound_ms=bms, bound_by=by)), flush=True)
        del ops, refs, fns, rows
        chip_smoke.free_card()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma-separated variants to build (default all)")
    ap.add_argument("--shapes", default="",
                    help="comma-separated shapes to run (default all)")
    ap.add_argument("--against", default="",
                    help="a directory with another ssd_chunk.cu (with "
                         "--backward: ssd_chunk_bwd.cu), timed as the "
                         "variant 'against'")
    ap.add_argument("--backward", action="store_true",
                    help="the backward's variants at SSD_BWD_LAYERS")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ssd_chunk_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    if args.backward:
        return backward(args)
    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import ssd_chunk_ref

    sources = texts_of(FILES, VARIANTS,
                       set(filter(None, args.only.split(","))), args.against)
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
    for shape, m in {**chip_smoke.SSD_LAYERS, **chip_smoke.SSD_TILED}.items():
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
        if "tiled_timeline" in fns:
            rows["tiled_timeline"]["steps"] = fwd_timeline(
                libs["tiled_timeline"], fns["tiled_timeline"])
        for name in (*fwd, "plain"):
            row = rows.get(name, {})
            if name in ms:
                row["ms"] = ms[name]
                if "against" in ms:
                    row["speedup"] = ms["against"] / ms[name]
            print(json.dumps(dict(shape=shape, variant=name, **row)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
