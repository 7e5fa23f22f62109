#!/usr/bin/env python3
"""Show that chip_smoke.py's ssd_chunk limit fails planted faults.

    python3 tools/ssd_chunk_planted_faults.py [--seed N] [--backward]

Builds copies of ``src/repro_torch/csrc/ssd_chunk.cu`` and its headers
``ssd_tiles.cuh`` and ``tf32x3.cuh`` with one fault each (under
``build/repro_torch/faults/ssd_chunk/``; the sources are not touched),
runs each through ``repro_torch.kernels.ssd_chunk`` at chip_smoke.py's
``SSD_LAYERS`` (a Mamba2-2.7B layer at chunks of 64 and 128),
``SSD_PARITY`` shapes (two P and two S tiles, ragged tiles) and
``SSD_TILED`` (the layer at chunk 256: the tiled route), and prints one
JSON line per (fault, shape): max |Δ| of y_in and of the states against
``ssd_chunk_ref`` beside the smoke's limit 2e-4 · max(1, max|plain|).
The output block is freed full of NaN just before each call, so what a
fault leaves unwritten cannot read as the last run's answer.  The
unchanged sources run at every shape.  Exits 1 if they break the limit,
a fault passes it everywhere, or a fault of the tiled route
(``tiled_*``) passes it at every ``SSD_TILED`` shape.

``--backward`` does the same for ``ssd_chunk_bwd.cu`` (``BWD_FAULTS``) at
chip_smoke.py's ``SSD_BWD_LAYERS``, ``SSD_PARITY``, ``SSD_BWD_STEEP`` and
``SSD_TILED`` shapes and ``BWD_STREAMED_B``, calling each library's
``ssd_chunk_backward`` directly with its outputs and scratch filled with
NaN: max |Δ| of dx, dB, dC, ddt and dcum
against ``ssd_chunk_bwd_ref`` beside the smoke's ``SSD_BWD_TOL`` ·
max(1, max|ref|) (a NaN breaks it).  Needs one CUDA device.
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
    # the tiled route: every head after a group's first reads C.B^T's
    # strips 8 rows down (a strip formed once a group, the wrong rows)
    "tiled_cb_wrong_rows_after_first_head": (
        "ssd_chunk.cu",
        "        const float* cbr[2] = {cba + (16 * mi + g) * lda",
        "        const float* cbr[2] = {cba + (16 * mi + g + (hh ? 8 : 0)) "
        "* lda"),
    # M's decay taken above the diagonal too (i >= j dropped)
    "tiled_exp_above_diagonal": (
        "ssd_chunk.cu",
        "                  decay(lo.x, ci[k][0], cj0, dj0, i0 >= j0 && j0 < Q),",
        "                  decay(lo.x, ci[k][0], cj0, dj0, j0 < Q),"),
    # the states blocks form w for a group's first head only
    "tiled_w_first_head_only": (
        "ssd_chunk.cu", "if (hs && jt == jt0 && pt == 0) {   // once a head",
        "if (hs && jt == jt0 && pt == 0 && hh == 0) {   // once a head"),
}
FILES = ("ssd_chunk.cu", "ssd_tiles.cuh", "tf32x3.cuh")
BWD_FILES = ("ssd_chunk_bwd.cu", "ssd_tiles.cuh", "tf32x3.cuh")
# (bs, nc, q, H, P, S) where B is too wide to stay in shared memory beside
# chunk 128's C.B^T and streams in S tiles, the last one ragged
BWD_STREAMED_B = (1, 2, 128, 4, 64, 250)
BWD_FAULTS = {
    # a D step reads the other half of the copy ring: the tile before, or
    # the one being copied
    "stage_read_before_it_lands": (
        "ssd_chunk_bwd.cu",
        "const float* ds = dbase + (d & 1) * p.d_stage;",
        "const float* ds = dbase + ((d + 1) & 1) * p.d_stage;"),
    # the group's second head never reaches dB's state term
    "head_left_out_of_state_term": (
        "ssd_chunk_bwd.cu",
        "        if (32 * ng >= sw) continue;\n",
        "        if (32 * ng >= sw || hh == 1) continue;\n"),
    # B's ragged S tile keeps the last tile's columns past S (only where B
    # streams through the copy ring: BWD_STREAMED_B)
    "b_ragged_tile_not_zeroed": (
        "ssd_chunk_bwd.cu",
        "  if (w < T) zero_cols<kThreadsH>(bt, ld, p.Q, w, T);\n", ""),
    # G_ii in dcum's row sums only, so it no longer cancels
    "g_ii_not_cancelled": (
        "ssd_chunk_bwd.cu",
        "            if (i != j) {   // G_ii enters both sums and cancels\n"
        "              rg[a] += gv;\n",
        "            rg[a] += gv;\n"
        "            if (i != j) {   // G_ii enters both sums and cancels\n"),
    # L's exponential taken everywhere and multiplied by 0 above the
    # diagonal: inf * 0 where the decay is steep
    "exp_times_zero_above_diagonal": (
        "ssd_chunk_bwd.cu",
        "i >= j && i < Q ? __expf(cum[i] - cum[j]) : 0.f;",
        "__expf(cum[i] - cum[j]) * (i >= j && i < Q ? 1.f : 0.f);"),
    # the tiled route: the chunk pass sums the groups' dCB out of order,
    # group 0 twice
    "tiled_group_dcb_doubled": (
        "ssd_chunk_bwd.cu",
        "for (int gi = 0; gi < p.G; ++gi) v += pc[gi * QQ",
        "for (int gi = p.G - 1; gi >= -1; --gi) v += pc[max(gi, 0) * QQ"),
    # a group's dCB partial dropped (group 0 never summed)
    "tiled_group_dcb_dropped": (
        "ssd_chunk_bwd.cu",
        "for (int gi = 0; gi < p.G; ++gi) v += pc[gi * QQ",
        "for (int gi = 1; gi < p.G; ++gi) v += pc[gi * QQ"),
    # every head after a group's first reads C.B^T's strip 8 rows down
    # in M^T dy
    "tiled_cb_wrong_rows_after_first_head": (
        "ssd_chunk_bwd.cu",
        "const float* cb = cbk[k] + (r0 - lo[k]) * kLdC + 16 * mi + g;",
        "const float* cb = cbk[k] + (r0 - lo[k] + (hh ? 8 : 0)) * kLdC + "
        "16 * mi + g;"),
    # L's exponential taken above the diagonal too (i >= j dropped)
    "tiled_exp_above_diagonal": (
        "ssd_chunk_bwd.cu",
        "const bool on = k < nstr && i >= j && i < Q && j < Q;",
        "const bool on = k < nstr && i < Q && j < Q;"),
    # G_ii in dcum's row sums, so it no longer cancels
    "tiled_g_ii_not_cancelled": (
        "ssd_chunk_bwd.cu",
        "              if (i != j) {\n                rg[a] += gv;\n",
        "              rg[a] += gv;\n              if (i != j) {\n"),
    # a group's state term dropped in the chunk pass
    "tiled_state_term_group_dropped": (
        "ssd_chunk_bwd.cu",
        "        for (int gi = 0; gi < p.G; ++gi) {\n          const float2 s2",
        "        for (int gi = 1; gi < p.G; ++gi) {\n          const float2 s2"),
}


def backward(args) -> int:
    """The backward's planted faults (see the module's doc)."""
    import torch

    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_ref
    sound = {f: (_build.CSRC / f).read_text() for f in BWD_FILES}
    sources = {"none": sound}
    for name, (fname, old, new) in BWD_FAULTS.items():
        if sound[fname].count(old) != 1:
            raise RuntimeError(f"fault {name}: {old!r} occurs "
                               f"{sound[fname].count(old)} times in {fname}")
        sources[name] = {**sound, fname: sound[fname].replace(old, new)}
    libs = build(sources, _build.BUILD_DIR / "faults" / "ssd_chunk_bwd")
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
    fmt = "bs={} nc={} q={} H={} P={} S={}"
    shapes = [(name, m, False)
              for name, m in chip_smoke.SSD_BWD_LAYERS.items()]
    shapes += [(fmt.format(*shp), dict(zip(("bs", "nc", "q", "h", "p",
                                            "s"), shp)), False)
               for shp in (*chip_smoke.SSD_PARITY, BWD_STREAMED_B)]
    shapes.append(("steep", chip_smoke.SSD_BWD_STEEP, True))
    shapes += [(name, m, False) for name, m in chip_smoke.SSD_TILED.items()]
    parts = ("dx", "dB", "dC", "ddt", "dcum")
    broken = {name: False for name in loaded}
    broken_tiled = dict(broken)   # at the SSD_TILED shapes
    ok = True
    for shape, m, steep in shapes:
        ops = chip_smoke.ssd_bwd_inputs(gen, dev, **m, steep=steep)
        refs = ssd_chunk_bwd_ref(*ops)
        tols = [chip_smoke.SSD_BWD_TOL * max(1.0, r.abs().max().item())
                for r in refs]
        dims = (m["bs"] * m["nc"], m["h"], m["q"], m["p"], m["s"])
        for name, lib in loaded.items():
            outs = [torch.full(r.shape, float("nan"), device=dev)
                    for r in refs]
            scratch = torch.full((lib.ssd_chunk_backward_scratch(*dims),),
                                 float("nan"), device=dev)
            code = lib.ssd_chunk_backward(
                *[t.data_ptr() for t in (*ops, *outs, scratch)], *dims,
                stream)
            torch.cuda.synchronize()
            if code != 0:
                raise RuntimeError(f"{name} {shape}: CUDA error {code}")
            errs = [(o - r).abs().max().item() for o, r in zip(outs, refs)]
            breaks = not all(e <= tol for e, tol in zip(errs, tols))
            print(json.dumps(dict(fault=name, shape=shape, breaks=breaks,
                                  **{f"{p}_err": e for p, e in
                                     zip(parts, errs)},
                                  **{f"{p}_tol": tol for p, tol in
                                     zip(parts, tols)})), flush=True)
            if name == "none":
                ok &= not breaks
            broken[name] |= breaks
            broken_tiled[name] |= breaks and shape in chip_smoke.SSD_TILED
        del ops, refs
        chip_smoke.free_card()
    ok &= all(broken_tiled[name] if name.startswith("tiled_") else
              broken[name] for name in BWD_FAULTS)
    print(json.dumps({"ok": ok, "broken": broken,
                      "broken_at_ssd_tiled": broken_tiled,
                      "limit": f"{chip_smoke.SSD_BWD_TOL} * max(1, "
                               f"max|ref|)"}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backward", action="store_true",
                    help="the backward's faults (BWD_FAULTS)")
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
    if args.backward:
        return backward(args)
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
    shapes.update({name: tuple(m.values())
                   for name, m in chip_smoke.SSD_TILED.items()})
    broken = {name: False for name in libs}
    broken_tiled = dict(broken)   # at the SSD_TILED shapes
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
            broken_tiled[name] |= breaks and shape in chip_smoke.SSD_TILED
    _build._LIBS.pop("ssd_chunk", None)
    ok &= all(broken_tiled[name] if name.startswith("tiled_") else
              broken[name] for name in FAULTS)
    print(json.dumps({"ok": ok, "broken": broken,
                      "broken_at_ssd_tiled": broken_tiled,
                      "limit": "2e-4 * max(1, max|plain|)"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
