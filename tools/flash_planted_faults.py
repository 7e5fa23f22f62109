#!/usr/bin/env python3
"""Show that chip_smoke.py's flash_attention limits fail planted faults.

    python3 tools/flash_planted_faults.py [--seed N]

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` and its
headers ``sm90.cuh`` and ``tf32x3.cuh`` with one fault each (under
``build/repro_torch/faults/flash_attention/``; the sources are not
touched), runs each through ``repro_torch.kernels.flash_attention`` at the
shapes of the route it breaks (``SHAPES``: chip_smoke.py's Qwen2-72B layer,
causal, and its ragged non-causal parity shape, in bf16 on the ``wgmma``
route and in f32 and bf16 off 16 bytes on the ``mma`` route, the
gemma_7b layer, head_dim 256, in f32, and on the ``split`` route
``FLASH_STREAM_LAYER`` at D = 1040 in f32 and at D = 2056, streamed in
sweeps, in bf16), and prints one JSON line per
(fault, shape): max |Δ| and ‖Δ‖/‖plain‖ against ``attention_ref`` and
which of chip_smoke.py's limits (``FLASH_TOL``) each breaks.  The
unchanged sources run at every shape.  Exits 1 if they break a limit or a
fault passes both at one of its shapes.  Needs one CUDA device.
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

FILES = ("flash_attention.cu", "sm90.cuh", "tf32x3.cuh", "flash_split.cuh")
WGMMA = ("qwen2_72b_bf16", "ragged_bf16")
SPLIT = ("split_d1040_f32", "split_d2056_bf16")
# name -> (file, text, its replacement, the shapes it runs on); each text
# occurs once in its file
FAULTS = {
    # wgmma: O keeps its old scale when the row max moves
    "no_o_rescale": ("flash_attention.cu", "acc[r] *= alpha[(r / 2) % 2];",
                     "acc[r] *= 1.f;", WGMMA),
    # wgmma: l keeps its old scale when the row max moves
    "no_l_rescale": ("flash_attention.cu",
                     "l[i] = alpha[i] * l[i] + rs[i];",
                     "l[i] = l[i] + rs[i];", WGMMA),
    # wgmma: every key of a block's last kv tile masked (the diagonal tile
    # when causal, the ragged one otherwise)
    "last_tile_masked": ("flash_attention.cu",
                         "if (col >= Skv || (causal && col > row))",
                         "if (col >= Skv || (causal && col > row) || "
                         "kt == n_kt - 1)", WGMMA),
    # wgmma: P·V skips the last 16 keys of every kv tile
    "pv_drops_16_keys": ("flash_attention.cu",
                         "for (int kk = 0; kk < kBK / 16; ++kk)",
                         "for (int kk = 0; kk < kBK / 16 - 1; ++kk)", WGMMA),
    # mma, f32: 1xTF32, the two small products dropped
    "mma_one_tf32_pass": ("tf32x3.cuh",
                          "  mma(c, a.small, b.big);\n"
                          "  mma(c, a.big, b.small);\n", "",
                          ("qwen2_72b_f32", "ragged_f32", "gemma_7b_f32")),
    # mma: O keeps its old scale when the row max moves
    "mma_no_o_rescale": ("flash_attention.cu",
                         "for (int e = 0; e < 4; ++e) acc[n][e] *= "
                         "corr[e >> 1];",
                         "for (int e = 0; e < 4; ++e) acc[n][e] *= 1.f;",
                         ("qwen2_72b_f32", "ragged_f32",
                          "qwen2_72b_bf16_unaligned", "gemma_7b_f32")),
    # mma: the causal mask one key late (row i sees key i + 1)
    "mma_diagonal_off_by_one": ("flash_attention.cu",
                                "(causal && col > row);",
                                "(causal && col > row + 1);",
                                ("qwen2_72b_f32", "qwen2_72b_bf16_unaligned",
                                 "gemma_7b_f32")),
    # split: the exchange leaves the cluster's last round of ranks' partial S
    # out (one rank in fp32, two in bf16)
    "split_rank_dropped": ("flash_split.cuh",
                           "for (int r = 0; r < c; r += RANKS) {",
                           "for (int r = 0; r < c - RANKS; r += RANKS) {", SPLIT),
    # split, streamed: every sweep's pieces in one order, so the last
    # loaded is not the sweep's own (its V is another piece's)
    "split_sweep_piece_order": ("flash_split.cuh",
                                "return (j + 1 + i) % np * kPiece;",
                                "return i * kPiece;", ("split_d2056_bf16",)),
    # split, streamed: the forward's first piece left out of S
    "split_first_piece_dropped": (
        "flash_split.cuh",
        "gemm_nt<T, kPiece, kTile, kLdP, false>(s, qs, 16 * warp, ks, lane);",
        "if (i > 0) gemm_nt<T, kPiece, kTile, kLdP, false>(s, qs, 16 * warp, "
        "ks, lane);", ("split_d2056_bf16",)),
}


def shapes() -> dict:
    """name -> (B, Hq, Hkv, Sq, Skv, D, causal, dtype, element offset,
    route)."""
    import chip_smoke
    f, g = chip_smoke.QWEN2_72B, chip_smoke.GEMMA_7B
    L = chip_smoke.FLASH_STREAM_LAYER
    qwen = (f["b"], f["hq"], f["hkv"], f["s"], f["s"], f["d"], True)
    ragged = chip_smoke.FLASH_PARITY[0][:7]
    return {
        "qwen2_72b_bf16": (*qwen, "bfloat16", 0, "wgmma"),
        "ragged_bf16": (*ragged, "bfloat16", 0, "wgmma"),
        "qwen2_72b_f32": (*qwen, "float32", 0, "mma"),
        "ragged_f32": (*ragged, "float32", 0, "mma"),
        "qwen2_72b_bf16_unaligned": (*qwen, "bfloat16", 1, "mma"),
        "gemma_7b_f32": (g["b"], g["hq"], g["hkv"], g["s"], g["s"], g["d"],
                         True, "float32", 0, "mma"),
        **{f"split_d{d}_{tag}": (
            L["b"], L["hq"], L["hkv"], L["s"], L["s"], d, True, dtype, 0,
            "split") for d, dtype, tag in ((1040, "float32", "f32"),
                                           (2056, "bfloat16", "bf16"))}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("flash_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ops import _declare

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sound = {f: (_build.CSRC / f).read_text() for f in FILES}
    sources = {"none": sound}
    for name, (fname, old, new, _) in FAULTS.items():
        if sound[fname].count(old) != 1:
            raise RuntimeError(f"fault {name}: {old!r} occurs "
                               f"{sound[fname].count(old)} times in {fname}")
        sources[name] = {**sound, fname: sound[fname].replace(old, new)}
    libs = build(sources, _build.BUILD_DIR / "faults" / "flash_attention")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ok = True
    for shape, (b, hq, hkv, sq, skv, d, causal, dtype, off,
                route) in shapes().items():
        dt = getattr(torch, dtype)
        q, k, v = (chip_smoke.at_offset(torch.randn(
                       s, generator=gen, device=dev).to(dt), off)
                   for s in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d)))
        ref = attention_ref(q, k, v, causal=causal)
        tol, rel_tol = chip_smoke.FLASH_TOL[dtype]
        for name, so in libs.items():
            if name != "none" and shape not in FAULTS[name][3]:
                continue
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            _build._LIBS["flash_attention"] = lib
            before = _build.LAUNCHES[f"flash_attention_{route}"]
            out = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if _build.LAUNCHES[f"flash_attention_{route}"] != before + 1:
                raise RuntimeError(f"{shape}: not on the {route} route")
            e = chip_smoke.flash_err(out, ref)
            row = dict(fault=name, shape=shape, route=route, **e,
                       finite=bool(torch.isfinite(out).all()),
                       breaks_max_abs=not e["max_abs_err"] <= tol,
                       breaks_rel=not e["rel_err"] <= rel_tol,
                       limits=[tol, rel_tol])
            print(json.dumps(row), flush=True)
            caught = row["breaks_max_abs"] or row["breaks_rel"]
            ok &= caught if name != "none" else not caught
    _build._LIBS.pop("flash_attention", None)
    print(json.dumps({"ok": ok, "limits": chip_smoke.FLASH_TOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
