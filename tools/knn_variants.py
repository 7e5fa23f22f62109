#!/usr/bin/env python3
"""Time text variants of the knn kernel side by side.

    python3 tools/knn_variants.py [--seed N] [--iters N]
        [--only committed,w1] [--shapes a,b] [--against DIR]

Builds copies of ``src/repro_torch/csrc/knn.cu`` with one edit each
(under ``build/repro_torch/variants/knn/``; the sources are not touched),
calls each library's ``knn_forward`` directly (no Python wrapper) on
chip_smoke.py's knn calls (``knn_call_sets``: block 1 and block 2 of the
main path's first batch, 8 calls each, block 1 at k = 96 and 300, and
dgcnn_s's 8192-point cloud against itself), and times every variant and
the plain version in turns: wall time with CUDA events around the calls
(``ms``) and the kernels' own time from torch.profiler (``device_ms``).
``scan_only`` computes a wrong result on purpose, to show what the scan
costs without the selection; ``filter_le`` admits candidates tied with
the k-th distance, which the merge then ranks after it (the same
result, more merges); the others are alternatives the kernel does not
take (``VARIANTS``).  Prints ptxas's registers, stack and spills per
kernel of each variant and one JSON line per (shape, variant): ms,
device_ms, and the index mismatches against the plain version where the
distance order is decided.  ``--against DIR`` adds another tree's
``knn.cu`` (e.g. a parent commit's ``src/repro_torch/csrc``) as the
variant ``against``, timed in the same turns; a library that refuses a
shape (a parent at k > 64) says so.  Needs one CUDA device.
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

FILES = ("knn.cu", "tf32x3.cuh")
# name -> [(file, text, replacement), ...]; each text occurs once
VARIANTS = {
    "committed": [],
    # candidates only while the list is empty: the scan alone (wrong)
    "scan_only": [("knn.cu", "const bool a0 = d0 < kd, a1 = d1 < kd;",
                   "const bool a0 = d0 < kd && kd == INFINITY, "
                   "a1 = d1 < kd && kd == INFINITY;")],
    # a candidate may tie the k-th distance (exact: it ranks after it)
    "filter_le": [("knn.cu", "const bool a0 = d0 < kd, a1 = d1 < kd;",
                   "const bool a0 = d0 <= kd, a1 = d1 <= kd;")],
    # one warp a center
    "w1": [("knn.cu", "const int w_max = K > 128 ? kWarps : 2;",
            "const int w_max = 1;")],
    # up to 8 warps a center at every k
    "w8": [("knn.cu", "const int w_max = K > 128 ? kWarps : 2;",
            "const int w_max = kWarps;")],
    # the scan one step of 32 points at a time
    "one_step": [("knn.cu", "const float4 q0 = mypts[j0], q1 = mypts[j0 + 32];",
                  "const float4 q0 = mypts[j0], q1 = make_float4(0.f, 0.f, "
                  "0.f, INFINITY);"),
                 ("knn.cu", "j0 += 64) {", "j0 += 32) {")],
    # 16 warps a block: each staged tile serves twice the centers
    "warps16": [("knn.cu", "constexpr int kWarps = 8;",
                 "constexpr int kWarps = 16;"),
                ("knn.cu", "constexpr int kSmemLists = 1024;",
                 "constexpr int kSmemLists = 512;"),
                ("knn.cu", "__launch_bounds__(kThreads, R > 4 ? 2 : 4)",
                 "__launch_bounds__(kThreads, R > 4 ? 1 : 2)")],
    # 512 points a staged tile
    "tile512": [("knn.cu", "constexpr int kTile = 1024;",
                 "constexpr int kTile = 512;")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma-separated variants to build (default all)")
    ap.add_argument("--shapes", default="",
                    help="comma-separated call sets to run (default all)")
    ap.add_argument("--against", default="",
                    help="a directory with another knn.cu, timed as the "
                         "variant 'against'")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("knn_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build
    from repro_torch.kernels.knn import knn_ref
    from repro_torch.models.pointnet2 import POINTNET2_C

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
    libs, logs = build(sources, _build.BUILD_DIR / "variants" / "knn",
                       with_logs=True)
    for name, log in logs.items():
        print(json.dumps({"variant": name,
                          "ptxas": chip_smoke.ptxas_kernels(log)}),
              flush=True)

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    fwd = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        f = lib.knn_forward
        # the parent's entry takes no scratch: (c, p, d, i, S, N, K, stream)
        scratch = hasattr(lib, "knn_scratch_bytes")
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + (
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p] if scratch
            else [ctypes.c_void_p])
        fwd[name] = (f, scratch)
    batch = chip_smoke.main_batch(args.seed, dev)
    sets, _ = chip_smoke.knn_call_sets(POINTNET2_C, batch, args.seed, dev)
    keep = set(filter(None, args.shapes.split(",")))
    for shape, calls in sets.items():
        if keep and shape not in keep:
            continue
        fns, rows = {"plain": lambda calls=calls: [knn_ref(*a)
                                                   for a in calls]}, {}
        for name, (f, scratch) in fwd.items():
            outs = [(torch.empty((c.shape[0], k), device=dev),
                     torch.empty((c.shape[0], k), dtype=torch.int32,
                                 device=dev)) for c, _, k in calls]
            extra = (None, 0) if scratch else ()

            def call(f=f, outs=outs, extra=extra, calls=calls):
                return [f(c.data_ptr(), p.data_ptr(), d.data_ptr(),
                          i.data_ptr(), c.shape[0], p.shape[0], k, *extra,
                          stream)
                        for (c, p, k), (d, i) in zip(calls, outs)]
            codes = call()
            torch.cuda.synchronize()
            if any(codes):
                rows[name] = dict(refused=f"CUDA error {max(codes)}")
                continue
            decided = 0
            for (c, p, k), (d, i) in zip(calls, outs):
                d_ext, i_ext = knn_ref(c, p, min(k + 1, p.shape[0]))
                d_next = (d_ext[:, k:] if k < p.shape[0] else
                          torch.full_like(d_ext[:, :1], float("inf")))
                decided += chip_smoke.knn_mismatch(
                    d, i, d_ext[:, :k], i_ext[:, :k], d_next)[3]
            rows[name] = dict(idx_mismatch_decided=decided,
                              device_ms=chip_smoke.device_ms(call,
                                                             "knn_kernel"))
            fns[name] = call
        ms = chip_smoke.time_turns(fns, iters=args.iters)
        for name in (*fwd, "plain"):
            row = rows.get(name, {})
            if name in ms:
                row["ms"] = ms[name]
            print(json.dumps(dict(shape=shape, calls=len(calls),
                                  variant=name, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
