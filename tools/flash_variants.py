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
The split route (heads over 256 wide; ``--shapes
split_d512_f32,split_d512_bf16,split_d257_bf16``, chip_smoke.py's
``FLASH_SPLIT``, and ``split_d1040_*`` (``FLASH_SPLIT_WIDE``) and
``split_d2056_*`` (``FLASH_SPLIT_STREAM``, its short layer), forward or
``--backward``) has its own design choices as variants
(``SPLIT_VARIANTS``: the slice width ``split_wmax128``, the exchange
``split_one_buffer``, ``split_one_rank`` and ``split_two_ranks``, the
tiles and products ``split_dq192``, ``split_dq_tile16``,
``split_dkv_tile32`` and ``split_unfused``, and the diagnostics
``split_no_sum`` and ``split_no_barrier``).
``--against DIR`` adds the sources of another tree (``flash_attention.cu``
or ``flash_attention_bwd.cu`` and every header DIR has; e.g. a parent
commit's ``src/repro_torch/csrc``) as the variant ``against``, timed in
the same turns.

``--backward`` does the same for the backward,
``flash_attention_bwd.cu`` (``BWD_VARIANTS``: the steps of its design
taken out or changed one at a time, ``serial_heads`` (no clusters: a
block walks the whole group), ``cluster4`` / ``cluster8`` (clusters of at
most 4 or 8), ``one_stage`` (the mma route's streamed tiles in one
stage), ``two_stages`` (in two wherever they fit); and, wrong on purpose
to show what a part of the wgmma route's dK/dV pass costs,
``dkv_no_exp``, ``dkv_no_dk``, ``dkv_no_rows`` (no LSE or D copied),
``dkv_no_epilogue``), at chip_smoke.py's
``BWD_LAYERS``, the bf16 ones on both routes (``*_mma``: variant 0, the
route without wgmma), the forward's log-sum-exp passed in; ``--against`` there takes a
tree whose backward rebuilt the log-sum-exp itself (its own C signature).
Beside each shape's times: SDPA's backward (autograd of one call, its
graph kept), the plain version, each variant's errors against it, and the
committed library's device time per pass (torch.profiler).  Needs one
CUDA device.
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
BWD_FILES = ("flash_attention_bwd.cu", "sm90.cuh", "tf32x3.cuh",
             "flash_split.cuh")
_SPLIT = "flash_split.cuh"
# the split route's design choices, forward and backward alike: slices of
# at most 128 columns in the forward (c = 4 at D = 512, not 2), one buffer
# of partials everywhere (two cluster barriers a tile; committed: two
# buffers where they fit and cost no block an SM), one rank's partials in
# flight at a time in bf16 too (``split_one_rank``; committed: two in bf16,
# one in fp32; ``split_two_ranks``: two in fp32 too), the
# dQ pass's slices at most 192 wide (c = 3 at D = 512), the fp32 dQ
# pass's tiles of 16 rows (not 32) and the fp32 dK/dV pass's of 32 (not
# 16), the backward's two partial products one after the other (not in
# one k loop); and, wrong on purpose, to show what the exchange costs:
# each block's own partial alone (``split_no_sum``: no remote reads) and
# no barrier between the stores of the partials and their reads
# (``split_no_barrier``)
SPLIT_VARIANTS = {
    "split_wmax128": [(_SPLIT, "constexpr int kFwdWMax = 256;",
                       "constexpr int kFwdWMax = 128;"),
                      (_SPLIT, "  if (p.wp == 192)\n"
                               "    return launch_fwd_as<T, 192>",
                       "  if (p.wp == 128)\n"
                       "    return launch_fwd_as<T, 128>(q, k, v, o, lse, B, "
                       "Hq, Hkv, Sq, Skv, D,\n"
                       "                                 causal, stream);\n"
                       "  if (p.wp == 192)\n"
                       "    return launch_fwd_as<T, 192>"),
                      (_SPLIT, "         : p.wp == 192 ? Fwd<T, 192>::kBytes "
                               ": Fwd<T, 256>::kBytes;",
                       "         : p.wp == 128 ? Fwd<T, 128>::kBytes\n"
                       "         : p.wp == 192 ? Fwd<T, 192>::kBytes "
                       ": Fwd<T, 256>::kBytes;")],
    "split_one_buffer": [(_SPLIT, "  return one + part <= kSmemMax && "
                                  "sm_blocks(one + part) >= sm_blocks(one)\n"
                                  "             ? 2\n             : 1;",
                          "  return 1;")],
    "split_one_rank": [(_SPLIT, "constexpr int kRanksBf16 = 2, kRanksF32 = 1;",
                        "constexpr int kRanksBf16 = 1, kRanksF32 = 1;")],
    "split_two_ranks": [(_SPLIT, "constexpr int kRanksBf16 = 2, "
                                 "kRanksF32 = 1;",
                         "constexpr int kRanksBf16 = 2, kRanksF32 = 2;")],
    "split_dq192": [(_SPLIT, "constexpr int kDqWMax = 256;",
                     "constexpr int kDqWMax = 192;")],
    "split_dq_tile16": [(_SPLIT, "constexpr int kDqTileF32 = 32;",
                         "constexpr int kDqTileF32 = 16;")],
    "split_dkv_tile32": [(_SPLIT, "constexpr int kDkvTileF32 = 16;",
                          "constexpr int kDkvTileF32 = 32;")],
    "split_unfused": [(_SPLIT, "      gemm_nt2<T, kH, kBK, kLd>(s, dp, qs + ch * "
                               "kH, dos + ch * kH,\n"
                               "                                16 * rg, kb, "
                               "vb, lane);",
                       "    {\n      gemm_nt<T, kH, kBK, kLd>(s, qs + ch * kH, "
                       "16 * rg, kb, lane);\n"
                       "      gemm_nt<T, kH, kBK, kLd>(dp, dos + ch * kH, "
                       "16 * rg, vb, lane);\n    }"),
                      (_SPLIT, "      gemm_nt2<T, WP, kBQ, kLd>(s, dp, ks, vs, "
                               "16 * warp, qs, dos, lane);",
                       "      gemm_nt<T, WP, kBQ, kLd>(s, ks, 16 * warp, qs, "
                       "lane);\n"
                       "      gemm_nt<T, WP, kBQ, kLd>(dp, vs, 16 * warp, dos, "
                       "lane);")],
    "split_no_sum": [(_SPLIT, "  const int c = (int)cl.num_blocks(), "
                              "rank = (int)cl.block_rank();\n  const int at",
                      "  const int c = 1, rank = 0;\n  const int at")],
    "split_no_barrier": [(_SPLIT, "void xch_stored() {\n  cluster_arrive();\n"
                                  "  cluster_wait();\n}",
                          "void xch_stored() {}")],
}
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
    **SPLIT_VARIANTS,
}
_BWD = "flash_attention_bwd.cu"
BWD_VARIANTS = {
    "committed": [],
    # a block walks the whole group: no clusters, no reduction across blocks
    "serial_heads": [(_BWD, "constexpr int kMaxCluster = 2;",
                      "constexpr int kMaxCluster = 1;")],
    # clusters of at most 4 blocks, and of up to the portable 8
    "cluster4": [(_BWD, "constexpr int kMaxCluster = 2;",
                  "constexpr int kMaxCluster = 4;")],
    "cluster8": [(_BWD, "constexpr int kMaxCluster = 2;",
                  "constexpr int kMaxCluster = 8;")],
    # mma route: the streamed tiles in one stage, loaded between barriers
    "one_stage": [(_BWD, "  return two <= kSmemMax && sm_blocks(two, threads) "
                         ">= sm_blocks(one, threads)\n             ? 2\n"
                         "             : 1;",
                   "  return 1;")],
    # mma route: two stages wherever they fit, whatever they cost in blocks
    "two_stages": [(_BWD, "  return two <= kSmemMax && sm_blocks(two, "
                          "threads) >= sm_blocks(one, threads)\n"
                          "             ? 2\n             : 1;",
                    "  return two <= kSmemMax ? 2 : 1;")],
    # wgmma dK/dV pass, wrong on purpose, to show what a part costs:
    # P^T without exp2 or the LSE (the products unchanged)
    "dkv_no_exp": [(_BWD, "st[r] = ex2(fmaf(st[r], scale_log2, -lse_s[qi]));",
                    "st[r] = st[r];"),
                   (_BWD, "st[r + 1] = ex2(fmaf(st[r + 1], scale_log2, "
                          "-lse_s[qi + 1]));",
                    "st[r + 1] = st[r + 1];")],
    # the dk += dS^T q products left out
    "dkv_no_dk": [(_BWD, "      for (int kk = 0; kk < kBQ2 / 16; ++kk)\n"
                         "        sm90::wgmma_rs(adk,",
                   "      for (int kk = 0; kk < 0; ++kk)\n"
                   "        sm90::wgmma_rs(adk,")],
    # the producer copies no LSE or D into the stages
    "dkv_no_rows": [(_BWD, "          ls[r] = in ? lse[at] : 0.f;\n"
                           "          ls[kBQ2 + r] = in ? dsum[at] : 0.f;",
                     "          ls[r] = 0.f;\n          ls[kBQ2 + r] = 0.f;")],
    # the cluster's sum and the stores of dK and dV left out
    "dkv_no_epilogue": [(_BWD, "  cluster_sum<__nv_bfloat16, kBKV, DP, "
                               "L::kLdPart>(\n      part, dv + off,",
                         "  if (D < 0) cluster_sum<__nv_bfloat16, kBKV, DP, "
                         "L::kLdPart>(\n      part, dv + off,"),
                        (_BWD, "  cluster_sum<__nv_bfloat16, kBKV, DP, "
                               "L::kLdPart>(\n      part, dk + off,",
                         "  if (D < 0) cluster_sum<__nv_bfloat16, kBKV, DP, "
                         "L::kLdPart>(\n      part, dk + off,")],
    **SPLIT_VARIANTS,
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
    # chip_smoke.py's FLASH_SPLIT, on the split route (variant 2)
    "split_d512_f32": (1, 8, 8, 2048, 512, "float32", 0, 2),
    "split_d512_bf16": (1, 8, 8, 2048, 512, "bfloat16", 0, 2),
    "split_d257_bf16": (1, 8, 8, 2048, 257, "bfloat16", 0, 2),
    # FLASH_SPLIT_WIDE and FLASH_SPLIT_STREAM's widths at this layer
    "split_d1040_f32": (1, 8, 8, 2048, 1040, "float32", 0, 2),
    "split_d1040_bf16": (1, 8, 8, 2048, 1040, "bfloat16", 0, 2),
    "split_d2056_f32": (1, 8, 8, 2048, 2056, "float32", 0, 2),
    "split_d2056_bf16": (1, 8, 8, 2048, 2056, "bfloat16", 0, 2),
}


def against(directory: str, cu: str) -> dict:
    """Another tree's ``cu`` and every header beside it."""
    d = Path(directory)
    return {f.name: f.read_text() for f in sorted(d.glob("*.cuh"))} | {
        cu: (d / cu).read_text()}


def route_code(texts: dict, code: int, d: int) -> int:
    """The C entry's variant code for the split route (2) in a tree's
    sources: a tree from before split took every D past 1024 had its own
    variant 3 there."""
    old = any("variant == 3" in t for t in texts.values()) and d > 1024
    return 3 if code == 2 and old else code


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
    ap.add_argument("--backward", action="store_true",
                    help="the backward's variants at BWD_LAYERS")
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
    if args.backward:
        return backward(args)
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
        sources["against"] = against(args.against, FILES[0])
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
        # a tree from before the forward stored the log-sum-exp has no lse
        with_lse = "void* lse" in sources[name]["flash_attention.cu"]
        f.argtypes = [ctypes.c_void_p] * (4 + with_lse) + [
            ctypes.c_int] * 9 + [ctypes.c_void_p]
        fwd[name] = (f, with_lse)
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
        for name, (f, with_lse) in fwd.items():
            out = torch.empty_like(q)
            call = (lambda f=f, out=out, lse=(None,) * with_lse,
                    code=route_code(sources[name], variant, d): f(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *lse, b, hq, hkv, s, s, d, 1,
                1 if dt == torch.bfloat16 else 0, code, stream))
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


def bwd_shapes() -> dict:
    """name -> (BWD_LAYERS entry, dtype, route): every layer on its own
    route and the bf16 ones on the mma route too; FLASH_SPLIT's,
    FLASH_SPLIT_WIDE's and FLASH_SPLIT_STREAM's calls on the split route
    (``split_d512_f32``, ...)."""
    import chip_smoke
    out = {}
    for layer, calls in ((chip_smoke.FLASH_SPLIT_LAYER,
                          chip_smoke.FLASH_SPLIT + chip_smoke.FLASH_SPLIT_WIDE),
                         (chip_smoke.FLASH_STREAM_LAYER,
                          chip_smoke.FLASH_SPLIT_STREAM)):
        for name, d, dtype in calls:
            label = f"{name}_{'bf16' if dtype == 'bfloat16' else 'f32'}"
            out[label] = ({**layer, "d": d}, dtype, "split")
    for name, f, dtype in chip_smoke.BWD_LAYERS:
        label = f"{name}_{'bf16' if dtype == 'bfloat16' else 'f32'}"
        if dtype == "bfloat16":
            out[label] = (f, dtype, "wgmma")
            out[f"{label}_mma"] = (f, dtype, "mma")
        else:
            out[label] = (f, dtype, "mma")
    return out


def backward(args) -> int:
    """The backward's variants at BWD_LAYERS (see the module's doc)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    sound = {f: (_build.CSRC / f).read_text() for f in BWD_FILES}
    only = set(filter(None, args.only.split(",")))
    sources = {}
    for name, edits in BWD_VARIANTS.items():
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
        sources["against"] = against(args.against, BWD_FILES[0])
    libs, logs = build(sources,
                       _build.BUILD_DIR / "variants" / "flash_attention_bwd",
                       with_logs=True)
    for name, log in logs.items():
        print(json.dumps({"variant": name,
                          "ptxas": chip_smoke.ptxas_kernels(log)}),
              flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for name, so in libs.items():
        f = ctypes.CDLL(str(so)).flash_attention_backward
        # a tree whose backward rebuilt the log-sum-exp: no lse in, no
        # route, two scratch rows
        with_lse = "int variant" in sources[name][_BWD]
        f.argtypes = [P] * 10 + [I] * (8 + with_lse) + [P]
        f.restype = I
        entries[name] = (f, with_lse)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    keep = set(filter(None, args.shapes.split(",")))
    for shape, (f, dtype, route) in bwd_shapes().items():
        if keep and shape not in keep:
            continue
        dt = getattr(torch, dtype)
        b, hq, hkv, s, d, causal = (f[x] for x in ("b", "hq", "hkv", "s",
                                                   "d", "causal"))
        q, k, v = (torch.randn((b, h, s, d), generator=gen,
                               device=dev).to(dt) for h in (hq, hkv, hkv))
        o, lse = flash_ops._forward(q, k, v, causal, lse=True)
        do = torch.randn(o.shape, generator=gen, device=dev).to(dt)
        ref = attention_bwd_ref(q, k, v, o, do, causal)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                 enable_gqa=True)
        fns = {"plain": lambda: attention_bwd_ref(q, k, v, o, do, causal),
               "sdpa": lambda: torch.autograd.grad(lib_out, leaves, do,
                                                   retain_graph=True)}
        rows = {}
        scratch = torch.empty((2, b, hq, s), dtype=torch.float32,
                              device=dev)
        for name, (fn, with_lse) in entries.items():
            outs = [torch.empty_like(t) for t in (q, k, v)]
            ptrs = [t.data_ptr() for t in (q, k, v, o, do)]
            if with_lse:
                argv = (*ptrs, lse.data_ptr(), *[t.data_ptr() for t in outs],
                        scratch[1].data_ptr(), b, hq, hkv, s, s, d,
                        int(causal), 1 if dt == torch.bfloat16 else 0,
                        route_code(sources[name], flash_ops._VARIANTS[route],
                                   d), stream)
            elif route == "wgmma":
                continue                # that tree has no wgmma route
            else:
                argv = (*ptrs, *[t.data_ptr() for t in outs],
                        scratch[0].data_ptr(), scratch[1].data_ptr(), b, hq,
                        hkv, s, s, d, int(causal),
                        1 if dt == torch.bfloat16 else 0, stream)
            call = (lambda fn=fn, argv=argv: fn(*argv))
            code = call()
            torch.cuda.synchronize()
            if code != 0:
                rows[name] = dict(refused=f"CUDA error {code}")
                continue
            errs = [chip_smoke.flash_err(x, y) for x, y in zip(outs, ref)]
            rows[name] = dict(
                max_abs_err=max(e["max_abs_err"] for e in errs),
                rel_err=max(e["rel_err"] for e in errs))
            fns[name] = call
        ms = chip_smoke.time_turns(fns, iters=args.iters)
        if "committed" in fns:
            rows["committed"]["device_ms"] = {
                p: chip_smoke.device_ms(fns["committed"], (
                    f"split::{p}_" if route == "split" else
                    f"bwd_{p}_")) for p in ("dq", "dkv")}
        flops = chip_smoke.bwd_flops(b, hq, s, s, d, causal)
        moved = chip_smoke.nbytes(q, k, v, o, do, lse, *ref)
        bounds = (dict(bound_ms=chip_smoke.bound(
                       flops, moved, chip_smoke.PEAK_BF16)[0])
                  if dt == torch.bfloat16 else
                  dict(bound_ms=chip_smoke.bound(
                       3 * flops, moved, chip_smoke.PEAK_TF32)[0]))
        for name in (*entries, "sdpa", "plain"):
            row = rows.get(name, {})
            if name in ms:
                row["ms"] = ms[name]
            if name in ms or row:
                print(json.dumps(dict(shape=shape, route=route, variant=name,
                                      **row, **bounds)), flush=True)
        del q, k, v, o, do, lse, ref, leaves, lib_out, fns
        chip_smoke.free_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
