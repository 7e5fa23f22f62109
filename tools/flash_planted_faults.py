#!/usr/bin/env python3
"""Show that chip_smoke.py's flash_attention limits fail planted faults.

    python3 tools/flash_planted_faults.py [--seed N]

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with one
fault each in the bf16 tensor-core kernel (written under
``build/repro_torch/faults/``; the source is not touched), runs each
through ``repro_torch.kernels.flash_attention`` at chip_smoke.py's
Qwen2-72B layer (causal) and at its ragged non-causal parity shape, both
bf16, and prints one JSON line per (fault, shape): max |Δ| and
‖Δ‖/‖plain‖ against ``attention_ref`` and which of chip_smoke.py's limits
(``FLASH_TOL``) each breaks.  Exits 1 if the unchanged source breaks a
limit or a fault passes both.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# name -> (text in the wgmma kernel, its replacement); each text occurs once
FAULTS = {
    # O keeps its old scale when the row max moves
    "no_o_rescale": ("acc[r] *= alpha[(r / 2) % 2];", "acc[r] *= 1.f;"),
    # l keeps its old scale when the row max moves
    "no_l_rescale": ("l[i] = alpha[i] * l[i] + rs[i];",
                     "l[i] = l[i] + rs[i];"),
    # every key of a block's last kv tile masked (the diagonal tile when
    # causal, the ragged one otherwise)
    "last_tile_masked": ("if (col >= Skv || (causal && col > row))",
                         "if (col >= Skv || (causal && col > row) || "
                         "kt == n_kt - 1)"),
    # P·V skips the last 16 keys of every kv tile
    "pv_drops_16_keys": ("for (int kk = 0; kk < kBK / 16; ++kk)",
                         "for (int kk = 0; kk < kBK / 16 - 1; ++kk)"),
}


def build(sources: dict, out_dir: Path) -> dict:
    """One nvcc per source, all at once, with the port's flags."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"flash_attention_{name}.cu"
        cu.write_text(text)
        so = out_dir / f"libflash_attention_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = so
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import ctypes

    import torch
    if not torch.cuda.is_available():
        print("flash_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    sources = {"none": src}
    for name, (old, new) in FAULTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"fault {name}: {old!r} occurs "
                               f"{src.count(old)} times in the source")
        sources[name] = src.replace(old, new)
    libs = build(sources, _build.BUILD_DIR / "faults")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    f = chip_smoke.QWEN2_72B
    ragged = chip_smoke.FLASH_PARITY[1]
    shapes = {"qwen2_72b": (f["b"], f["hq"], f["hkv"], f["s"], f["s"],
                            f["d"], True),
              "ragged_noncausal": ragged[:7]}
    tol, rel_tol = chip_smoke.FLASH_TOL["bfloat16"]
    ok = True
    for shape, (b, hq, hkv, sq, skv, d, causal) in shapes.items():
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(
                       torch.bfloat16)
                   for s in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d)))
        ref = attention_ref(q, k, v, causal=causal)
        for name, so in libs.items():
            _build._LIBS["flash_attention"] = ctypes.CDLL(str(so))
            before = _build.LAUNCHES["flash_attention_wgmma"]
            out = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if _build.LAUNCHES["flash_attention_wgmma"] != before + 1:
                raise RuntimeError(f"{shape}: not on the wgmma route")
            e = chip_smoke.flash_err(out, ref)
            row = dict(fault=name, shape=shape, **e,
                       finite=bool(torch.isfinite(out).all()),
                       breaks_max_abs=e["max_abs_err"] > tol,
                       breaks_rel=e["rel_err"] > rel_tol)
            print(json.dumps(row), flush=True)
            caught = row["breaks_max_abs"] or row["breaks_rel"]
            ok &= caught if name != "none" else not caught
    _build._LIBS.pop("flash_attention", None)
    print(json.dumps({"ok": ok, "limits": {"max_abs": tol,
                                           "rel": rel_tol}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
