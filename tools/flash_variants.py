#!/usr/bin/env python3
"""Time text variants of the flash_attention kernels side by side.

    python3 tools/flash_variants.py [--seed N] [--iters N]
        [--only committed,one_pass] [--shapes a,b] [--against DIR]

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` and
``tf32x3.cuh`` with one edit each (under
``build/repro_torch/variants/flash_attention/``; the sources are not
touched), calls each library's ``flash_attention_forward`` directly (no
Python wrapper) at full-width layers (``SHAPES``: a Qwen2-72B layer in
f32, in bf16 at an address off 16 bytes and in aligned bf16, a gemma_7b
layer at head_dim 256 in f32, bf16 and bf16 off 16 bytes), and times every variant, SDPA
(``torch.nn.functional.scaled_dot_product_attention``, timed only) and
the plain version in turns with CUDA events.  Variant 0 of the C entry is
the route every call but aligned bf16 at D <= 128 takes (``mma``; a
parent tree's ``simt``), variant 1 ``wgmma``; a library that refuses a
shape (a parent at D = 256) says so.  Two variants compute a wrong
result on purpose, to show what a part costs (``one_pass``: the two small
TF32 products; ``no_split``: the split of the operands); the others are
alternatives the kernel does not take (``VARIANTS``).  Prints ptxas's
registers and spills per kernel of each variant and one JSON line per
(shape, variant): ms, max |Δ| and ‖Δ‖/‖plain‖ against the plain version,
and the shape's bound.
``--against DIR`` adds the sources of another tree (``flash_attention.cu``
and, where DIR has it, ``tf32x3.cuh``; e.g. a parent commit's
``src/repro_torch/csrc``) as the variant ``against``, timed in the same
turns.  Needs one CUDA device.
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

FILES = ("flash_attention.cu", "tf32x3.cuh")
# name -> [(file, text, replacement), ...]; each text occurs once
VARIANTS = {
    "committed": [],
    # 1xTF32: what the two small products cost (f32 only; wrong on purpose)
    "one_pass": [("tf32x3.cuh",
                  "  mma(c, a.small, b.big);\n  mma(c, a.big, b.small);\n",
                  "")],
    # the three products on unsplit operands: what the split costs (f32
    # only; wrong on purpose)
    "no_split": [("tf32x3.cuh",
                  "    f.big[i] = to_tf32(v[i]);\n"
                  "    f.small[i] = __float_as_uint(v[i] - "
                  "__uint_as_float(f.big[i]));",
                  "    f.big[i] = __float_as_uint(v[i]);\n"
                  "    f.small[i] = f.big[i];")],
    # the remainders rounded to TF32 (split), not left to the tensor cores'
    # truncation (split_fast)
    "rounded_small": [("tf32x3.cuh", "  if constexpr (Fast) split_fast(f, v);",
                       "  if constexpr (Fast) split(f, v);"),
                      ("flash_attention.cu", "tf32x3::split_fast(a, pa);",
                       "tf32x3::split(a, pa);")],
    # 32 keys a kv tile at every width
    "bk32": [("flash_attention.cu",
              "kBK = DP == 256 ? 32 : 64;", "kBK = 32;")],
    # 4 warps (64 query rows) a block at every width
    "warps4": [("flash_attention.cu",
                "kWarps = DP == 256 ? 4 : 8;", "kWarps = 4;")],
    # f32 S: the small terms into a second accumulator, two independent
    # chains of products an n tile instead of one
    "two_acc": [("flash_attention.cu",
                 "  if constexpr (C::kF32) {\n#pragma unroll\n"
                 "    for (int ks = 0; ks < DP / 8; ++ks) {",
                 "  if constexpr (C::kF32) {\n"
                 "    float s2[C::kBK / 8][4] = {};\n#pragma unroll\n"
                 "    for (int ks = 0; ks < DP / 8; ++ks) {"),
                ("flash_attention.cu",
                 "        tf32x3::mma3(s[j], a, tf32x3::load_bt<true>(kb, "
                 "C::kLdQK, 8 * j,\n"
                 "                                                     "
                 "8 * ks, lane));\n    }\n  } else {",
                 "      {\n        const tf32x3::Frag<2> b = "
                 "tf32x3::load_bt<true>(kb, C::kLdQK, 8 * j, 8 * ks, lane);\n"
                 "        tf32x3::mma(s2[j], a.small, b.big);\n"
                 "        tf32x3::mma(s2[j], a.big, b.small);\n"
                 "        tf32x3::mma(s[j], a.big, b.big);\n      }\n    }\n"
                 "#pragma unroll\n    for (int j = 0; j < C::kBK / 8; ++j)\n"
                 "#pragma unroll\n      for (int e = 0; e < 4; ++e) "
                 "s[j][e] += s2[j][e];\n  } else {")],
    # plain loads held across the products at DP = 256 too
    "hold_256": [("flash_attention.cu", "constexpr bool kHold = DP < 256;",
                  "constexpr bool kHold = true;")],
    # one block an SM at every width (registers up to 255)
    "one_block": [("flash_attention.cu",
                   "2 * (kBytes + 1024) <= 233472 && (kF32 || DP != 128) ? 2 "
                   ": 1;",
                   "1;")],
}
# name -> (B, Hq, Hkv, S, D, dtype, element offset of q, k, v, variant)
SHAPES = {
    "qwen2_72b_f32": (1, 64, 8, 2048, 128, "float32", 0, 0),
    "qwen2_72b_bf16_unaligned": (1, 64, 8, 2048, 128, "bfloat16", 1, 0),
    "qwen2_72b_bf16_mma": (1, 64, 8, 2048, 128, "bfloat16", 0, 0),
    "qwen2_72b_bf16_wgmma": (1, 64, 8, 2048, 128, "bfloat16", 0, 1),
    "gemma_7b_f32": (1, 16, 16, 2048, 256, "float32", 0, 0),
    "gemma_7b_bf16": (1, 16, 16, 2048, 256, "bfloat16", 0, 0),
    "gemma_7b_bf16_unaligned": (1, 16, 16, 2048, 256, "bfloat16", 1, 0),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", default="",
                    help="comma-separated variants to build (default all)")
    ap.add_argument("--shapes", default="",
                    help="comma-separated shapes to run (default all)")
    ap.add_argument("--against", default="",
                    help="a directory with another flash_attention.cu, "
                         "timed as the variant 'against'")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sound = {f: (_build.CSRC / f).read_text() for f in FILES}
    only = set(filter(None, args.only.split(",")))
    sources = {}
    for name, edits in VARIANTS.items():
        if only and name not in only:
            continue
        texts = dict(sound)
        for fname, old, new in edits:
            if texts[fname].count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} occurs "
                                   f"{texts[fname].count(old)} times")
            texts[fname] = texts[fname].replace(old, new)
        sources[name] = texts
    if args.against:
        d = Path(args.against)
        sources["against"] = {f: (d / f).read_text() for f in FILES
                              if (d / f).exists()}
    libs, logs = build(sources,
                       _build.BUILD_DIR / "variants" / "flash_attention",
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
        f = ctypes.CDLL(str(so)).flash_attention_forward
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fwd[name] = f
    keep = set(filter(None, args.shapes.split(",")))
    for shape, (b, hq, hkv, s, d, dtype, off, variant) in SHAPES.items():
        if keep and shape not in keep:
            continue
        dt = getattr(torch, dtype)
        q, k, v = (chip_smoke.at_offset(torch.randn(
                       (b, h, s, d), generator=gen, device=dev).to(dt), off)
                   for h in (hq, hkv, hkv))
        ref = attention_ref(q, k, v, causal=True)
        fns, rows = {
            "plain": lambda: attention_ref(q, k, v, causal=True),
            "sdpa": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)}, {}
        try:
            fns["sdpa"]()
        except RuntimeError as err:           # no SDPA backend takes it
            rows["sdpa"] = dict(refused=str(err).splitlines()[0])
            del fns["sdpa"]
        for name, f in fwd.items():
            out = torch.empty_like(q)
            call = (lambda f=f, out=out: f(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                hq, hkv, s, s, d, 1, 1 if dt == torch.bfloat16 else 0,
                variant, stream))
            code = call()
            torch.cuda.synchronize()
            if code != 0:
                rows[name] = dict(refused=f"CUDA error {code}")
                continue
            rows[name] = chip_smoke.flash_err(out, ref)
            fns[name] = call
        ms = chip_smoke.time_turns(fns, iters=args.iters)
        flops = chip_smoke.flash_flops(b, hq, s, s, d, True)
        nbytes = chip_smoke.nbytes(q, k, v, ref)
        bf16 = chip_smoke.bound(flops, nbytes, chip_smoke.PEAK_BF16)[0]
        tf32x3 = chip_smoke.bound(3 * flops, nbytes, chip_smoke.PEAK_TF32)[0]
        fp32 = chip_smoke.bound(flops, nbytes)[0]
        bounds = (dict(bound_ms=bf16) if dt == torch.bfloat16 else
                  dict(bound_ms=tf32x3, bound_fp32_ms=fp32))
        for name in (*fwd, "sdpa", "plain"):
            row = rows.get(name, {})
            if name in ms:
                row["ms"] = ms[name]
            print(json.dumps(dict(shape=shape, variant=name, **row,
                                  **bounds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
