#!/usr/bin/env python3
"""Show that chip_smoke.py's flash_attention backward limits fail planted
faults.

    python3 tools/flash_bwd_planted_faults.py [--seed N]

Builds copies of ``src/repro_torch/csrc/flash_attention_bwd.cu`` (and of
``flash_attention.cu``, which stores the log-sum-exp the backward reads)
with their headers, one fault each (under
``build/repro_torch/faults/flash_attention_bwd/``; the sources are not
touched), runs each through ``flash_attention_backward`` given the
forward's log-sum-exp at the shapes of the route it breaks (``SHAPES``:
chip_smoke.py's Qwen2-72B layer in bf16 on the ``wgmma`` route and off 16
bytes on the ``mma`` route, both a GQA group of 8 in clusters of 4,
olmo-1b's layer in f32 on the ``mma`` route, and on the ``split`` route
``FLASH_STREAM_LAYER`` at D = 1040 in f32 (its dK/dV pass a cluster of 9)
and at D = 2056 in bf16, streamed in sweeps), and prints one JSON line
per (fault, shape): each output's max |Δ| and ‖Δ‖/‖plain‖ against
``attention_bwd_ref`` and whether it breaks chip_smoke.py's limit
(``BWD_TOL``: f32 max |Δ| <= 1e-4 · max(1, max|ref|), bf16 ‖Δ‖/‖ref‖ <=
2e-2).  The unchanged sources run at every shape.  Exits 1 if they break
the limit at a shape or a fault passes it at every one of its shapes.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

HEADERS = ("sm90.cuh", "tf32x3.cuh", "flash_split.cuh")
SPLIT_H = "flash_split.cuh"
SPLIT = ("split_d1040_f32", "split_d2056_bf16")
FWD, BWD = "flash_attention.cu", "flash_attention_bwd.cu"
WGMMA = ("qwen2_72b_bf16",)
MMA = ("olmo_1b_f32", "qwen2_72b_bf16_unaligned")
# name -> (file, text, its replacement, the shapes it runs on); each text
# occurs once in its file
FAULTS = {
    # wgmma: the dK/dV pass reads each row's LSE from its neighbour
    "lse_neighbour_row": (BWD, "ls[r] = in ? lse[at] : 0.f;",
                          "ls[r] = in ? lse[at ^ 1] : 0.f;", WGMMA),
    # mma: the dQ pass reads each row's LSE from its neighbour
    "mma_lse_neighbour_row": (
        BWD, "lse2[i] = row < Sq ? lse[base + 16 * warp + g + 8 * i] : 0.f;",
        "lse2[i] = row < Sq ? lse[(base + 16 * warp + g + 8 * i) ^ 1] : 0.f;",
        MMA),
    # both routes: the forward stores the LSE in the natural log's base
    "lse_natural_log": (FWD, "return m == -INFINITY ? 0.f : m + log2f(l);",
                        "return m == -INFINITY ? 0.f : "
                        "(m + log2f(l)) * 0.6931472f;", WGMMA + MMA),
    # wgmma: the group's last query head left out of the dK/dV sum (its
    # cluster's last block skips it)
    "head_left_out": (BWD, "  const int n_it = hpb * nq;\n"
                           "  const int wgi = threadIdx.x / 128;",
                      "  const int n_it = hpb * nq - (rank == c - 1 ? nq : 0);"
                      "\n  const int wgi = threadIdx.x / 128;", WGMMA),
    # mma: the same
    "mma_head_left_out": (BWD, "  const int n_it = hpb * nq;\n"
                               "  // stage buf of iteration it",
                          "  const int n_it = hpb * nq - (rank == c - 1 ? nq "
                          ": 0);\n  // stage buf of iteration it",
                          ("qwen2_72b_bf16_unaligned",)),
    # both routes: the cluster's sum leaves its last block's partial out
    "block_left_out": (BWD, "for (int j = 0; j < c; ++j) {",
                       "for (int j = 0; j < c - 1; ++j) {",
                       ("qwen2_72b_bf16", "qwen2_72b_bf16_unaligned")),
    # wgmma: the dK/dV pass's causal mask one key late on the diagonal tile
    "diagonal_off_by_one": (
        BWD, "if (key >= Skv || row >= Sq || (causal && key > row))",
        "if (key >= Skv || row >= Sq || (causal && key > row + 1))", WGMMA),
    # mma: the same
    "mma_diagonal_off_by_one": (
        BWD, "const bool hidden = key >= Skv || row >= Sq || (causal && "
             "key > row);",
        "const bool hidden = key >= Skv || row >= Sq || (causal && "
        "key > row + 1);", MMA),
    # wgmma: q read from the other stage, whose copy is still in flight
    "stage_read_early": (
        BWD, "sm90::smem_u32(smem + L::kQ + s * L::kHalves * L::kQHalf);",
        "sm90::smem_u32(smem + L::kQ + (s ^ 1) * L::kHalves * L::kQHalf);",
        WGMMA),
    # mma: the dK/dV pass reads q from the stage the next tile is being
    # copied into
    "mma_stage_read_early": (BWD, "    const T* qs = stage_q(buf);",
                             "    const T* qs = stage_q(buf ^ 1);",
                             ("qwen2_72b_bf16_unaligned",)),
    # split: the exchange leaves the cluster's last round of ranks' partials
    # out (one rank in fp32, two in bf16)
    "split_rank_dropped": (SPLIT_H, "for (int r = 0; r < c; r += RANKS) {",
                           "for (int r = 0; r < c - RANKS; r += RANKS) {", SPLIT),
    # split: D_i = dO . O summed without the cluster's last block's slice
    "split_di_rank_dropped": (SPLIT_H, "    for (int r = 0; r < c; ++r) {",
                              "    for (int r = 0; r < c - 1; ++r) {", SPLIT),
    # split, streamed: the dQ pass's dS times V's piece, not K's
    "split_dq_stream_wrong_piece": (
        SPLIT_H, "gemm_pv<T, kBK, kPiece, kLdP>(acc, s, ks, lane);",
        "gemm_pv<T, kBK, kPiece, kLdP>(acc, s, vs, lane);",
        ("split_d2056_bf16",)),
    # split, streamed: dV from q's piece, not dO's
    "split_dkv_stream_wrong_piece": (
        SPLIT_H, "gemm_pv<T, kBQ, kPiece, kLdP>(adv, s, dos, lane);",
        "gemm_pv<T, kBQ, kPiece, kLdP>(adv, s, qs, lane);",
        ("split_d2056_bf16",)),
}


def shapes() -> dict:
    """name -> (BWD_LAYERS entry, dtype, element offset, route)."""
    import chip_smoke
    layers = {(name, dtype): f for name, f, dtype in chip_smoke.BWD_LAYERS}
    qwen = layers[("qwen2_72b", "bfloat16")]
    short = chip_smoke.FLASH_STREAM_LAYER
    return {"qwen2_72b_bf16": (qwen, "bfloat16", 0, "wgmma"),
            "qwen2_72b_bf16_unaligned": (qwen, "bfloat16", 1, "mma"),
            "olmo_1b_f32": (layers[("olmo_1b", "float32")], "float32", 0,
                            "mma"),
            "split_d1040_f32": ({**short, "d": 1040}, "float32", 0, "split"),
            "split_d2056_bf16": ({**short, "d": 2056}, "bfloat16", 0,
                                 "split")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    import ctypes

    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, flash_attention_backward)
    from repro_torch.kernels.flash_attention import ops as flash_ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sound = {f: (_build.CSRC / f).read_text()
             for f in (FWD, BWD, *HEADERS)}
    fwd_src = {"none": {f: sound[f] for f in (FWD, *HEADERS)}}
    bwd_src = {"none": {f: sound[f] for f in (BWD, *HEADERS)}}
    for name, (fname, old, new, _) in FAULTS.items():
        if sound[fname].count(old) != 1:
            raise RuntimeError(f"fault {name}: {old!r} occurs "
                               f"{sound[fname].count(old)} times in {fname}")
        base = fwd_src if fname == FWD else bwd_src
        base[name] = {**base["none"], fname: sound[fname].replace(old, new)}
    out_dir = _build.BUILD_DIR / "faults" / "flash_attention_bwd"
    fwd_libs = build(fwd_src, out_dir / "forward")
    bwd_libs = build(bwd_src, out_dir / "backward")

    def use(name: str) -> None:
        fwd = ctypes.CDLL(str(fwd_libs.get(name, fwd_libs["none"])))
        flash_ops._declare(fwd)
        bwd = ctypes.CDLL(str(bwd_libs.get(name, bwd_libs["none"])))
        flash_ops._declare_bwd(bwd)
        _build._LIBS["flash_attention"] = fwd
        _build._LIBS["flash_attention_bwd"] = bwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sound_ok, caught = True, dict.fromkeys(FAULTS, False)
    for shape, (f, dtype, off, route) in shapes().items():
        dt = getattr(torch, dtype)
        b, hq, hkv, s, d, causal = (f[x] for x in ("b", "hq", "hkv", "s",
                                                   "d", "causal"))
        q, k, v = (chip_smoke.at_offset(torch.randn(
                       (b, h, s, d), generator=gen, device=dev).to(dt), off)
                   for h in (hq, hkv, hkv))
        do = chip_smoke.at_offset(torch.randn(
            (b, hq, s, d), generator=gen, device=dev).to(dt), off)
        use("none")
        o = flash_ops._forward(q, k, v, causal)
        ref = attention_bwd_ref(q, k, v, o, do, causal)
        tol = chip_smoke.BWD_TOL[dtype]
        for name in ("none", *FAULTS):
            if name != "none" and shape not in FAULTS[name][3]:
                continue
            use(name)
            _, lse = flash_ops._forward(q, k, v, causal, lse=True)
            counted = f"flash_attention_bwd_dq_{route}"
            before = _build.LAUNCHES[counted]
            got = flash_attention_backward(q, k, v, o, do, causal, lse=lse)
            torch.cuda.synchronize()
            if _build.LAUNCHES[counted] != before + 1:
                raise RuntimeError(f"{shape}: not on the {route} route")
            errs, broken = {}, False
            for part, x, y in zip(("dq", "dk", "dv"), got, ref):
                e = chip_smoke.flash_err(x, y)
                scale = max(1.0, y.float().abs().max().item())
                bad = (not e["max_abs_err"] <= tol * scale
                       if dtype == "float32" else not e["rel_err"] <= tol)
                errs[part] = dict(**e, breaks=bad,
                                  finite=bool(torch.isfinite(x).all()))
                broken |= bad
            print(json.dumps(dict(fault=name, shape=shape, route=route,
                                  breaks=broken, tol=tol, **errs)),
                  flush=True)
            if name == "none":
                sound_ok &= not broken
            else:
                caught[name] |= broken
            del got, lse
        del q, k, v, o, do, ref
        chip_smoke.free_card()
    for name in ("flash_attention", "flash_attention_bwd"):
        _build._LIBS.pop(name, None)
    ok = sound_ok and all(caught.values())
    print(json.dumps({"ok": ok, "sound_passes": sound_ok, "caught": caught,
                      "limits": chip_smoke.BWD_TOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
