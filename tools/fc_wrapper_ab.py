#!/usr/bin/env python3
"""Time the FC kernels' wrappers of two trees on the main path's calls,
in turns.

    python3 tools/fc_wrapper_ab.py --against DIR [--seed N] [--iters N]
                                   [--rounds N] [--cache-x4 | --families]

``DIR`` is another checkout's root (e.g. a parent commit unpacked with
``git archive``).  Saves chip_smoke.py's gather_mlp and hub_reuse calls
of the pointnet2_c main path (``DENSE`` / ``REUSE``, both blocks, at B =
8, masked as the path calls them) to ``build/repro_torch/fc_wrapper_ab.pt``,
then runs one child process per turn (``--rounds`` times: against, this
tree, this tree, against), each importing its tree's ``repro_torch`` (its own library and
Python wrapper, with no tile-plan store: each call planned by the
heuristic) and timing each call through
``repro_torch.kernels.{gather_mlp,hub_reuse}`` with CUDA events: wall
time, the wrapper's host work included.  Prints one JSON line per (tree,
turn, call) with ms a call, best of 5 runs of ``--iters``, and the card's
name and power limit first.  ``--cache-x4`` times instead, in the same
turns, each tree's whole lpcn forward of chip_smoke.py's
``CACHE_X4_FAMILIES`` at the paper's Fig. 22 cache size (``CACHE_X4``,
the families phase's batch and seeded weights, from each tree's own
chip_smoke.py): its ``breakdown`` (host-clock ms of stage 1, the FC
stage and the tail, each ended by a device sync, best of 5) and the
device time of its hub_reuse kernels a forward, in all and by kernel
(torch.profiler, 3 forwards).  ``--families`` times likewise each tree's
lpcn forward of the four one-layer families and of pointnet2_s at the
families phase's batch (``FAMILIES``, default cache size): its
``breakdown`` and the device time and count of its gather_mlp and of its
hub_reuse kernels a forward, by kernel name (torch.profiler, 3
forwards; hub_reuse's resident kernel by row tile and form, ``true``
the one-layer one, and its layered kernels by name).  Needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILD = r"""
import json, sys, torch
from repro_torch.kernels.gather_mlp import gather_mlp
from repro_torch.kernels.hub_reuse import hub_reuse
calls = torch.load(sys.argv[1])
iters = int(sys.argv[2])
for name, (kernel, args, mask) in calls.items():
    args = [a.cuda() for a in args]
    fn = gather_mlp if kernel == "gather_mlp" else hub_reuse
    kw = {} if mask is None else {
        "mask" if kernel == "gather_mlp" else "live": mask.cuda()}
    fn(*args, **kw)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            fn(*args, **kw)
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / iters)
    print(json.dumps({"call": name, "ms": best}))
"""
# the short name of a profiled FC kernel: gather_mlp's by its name (the
# linear route's W split, split_weights_kernel, among them),
# hub_reuse's resident kernels with their template arguments (the row
# tile, and the form where the tree has two: true for one layer; the
# one-layer wgmma kernel, hub_reuse_linear_kernel<NC, N>), its W split
# (hub_reuse_split_weights_kernel) and its layered kernels by name; None
# for any other kernel
KIND = r"""
import re
def kind(name):
    name = name.replace("(anonymous namespace)::", "")
    m = re.search(r"gather_mlp\w*|hub_reuse_split_weights_kernel"
                  r"|split_weights_kernel|hub_reuse\w*kernel<[^(]*>"
                  r"|layered::\w+(<\w+>)?", name)
    return None if m is None else m.group(0)
GATHER = ("gather_mlp", "split_weights")   # gather_mlp's kernels
"""
# the child of --cache-x4: run in a tree's root, with that tree's
# chip_smoke.py and repro_torch
CHILD_X4 = KIND + r"""
import collections, json, torch
import chip_smoke as cs
from repro_torch.engine import PCNEngine
from repro_torch.models import MODEL_ZOO
dev = torch.device("cuda")
for name in cs.CACHE_X4_FAMILIES:
    spec = MODEL_ZOO[name][1]
    b, n = cs.FAMILIES[name]
    eng = PCNEngine(spec, mode="lpcn", fc_backend="cuda", isl_kw=cs.CACHE_X4)
    params = cs.seed_biases(eng.init(seed=0), torch.Generator().manual_seed(1))
    batch, _ = cs.family_batch(spec, b, n, 0, dev)
    eng.apply(params, batch)
    ms = cs.breakdown(params, spec, batch, repeats=5, isl_kw=cs.CACHE_X4)
    # hub_reuse's device time a forward (its resident and layered kernels)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.apply(params, batch)
        torch.cuda.synchronize()
    by = collections.defaultdict(float)
    count = collections.Counter()
    for e in prof.events():
        k = kind(e.name)
        if e.device_type == DeviceType.CUDA and k and not k.startswith(
                GATHER):
            by[k] += e.device_time / 3 / 1e3
            count[k] += 1
    print(json.dumps({"call": f"{name}_cache_x4", "b": b, "n": n, **ms,
                      "hub_reuse_device_ms": sum(by.values()),
                      "hub_reuse_kernels": sum(count.values()) / 3,
                      "hub_reuse_by_kernel_ms": dict(by)}))
"""
# the child of --families: gather_mlp's and hub_reuse's device time a
# forward, by kernel
CHILD_FAMILIES = KIND + r"""
import collections, json, torch
import chip_smoke as cs
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.engine import PCNEngine
from repro_torch.models import MODEL_ZOO
dev = torch.device("cuda")
for name in ("dgcnn_c", "dgcnn_s", "pointnext_s", "pointvector_l",
             "pointnet2_s"):
    spec = MODEL_ZOO[name][1]
    b, n = cs.FAMILIES[name]
    eng = PCNEngine(spec, mode="lpcn", fc_backend="cuda")
    params = cs.seed_biases(eng.init(seed=0), torch.Generator().manual_seed(1))
    batch, _ = cs.family_batch(spec, b, n, 0, dev)
    eng.apply(params, batch)
    ms = cs.breakdown(params, spec, batch, repeats=5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.apply(params, batch)
        torch.cuda.synchronize()
    by = collections.defaultdict(float)
    count = collections.Counter()
    for e in prof.events():
        k = kind(e.name)
        if e.device_type == DeviceType.CUDA and k:
            by[k] += e.device_time / 3 / 1e3
            count[k] += 1
    out = {"call": name, "b": b, "n": n, **ms}
    for fc in ("gather_mlp", "hub_reuse"):
        mine = [k for k in by if (k.startswith(GATHER)
                                  == (fc == "gather_mlp"))]
        out[f"{fc}_device_ms"] = sum(by[k] for k in mine)
        out[f"{fc}_by_kernel_ms"] = {k: by[k] for k in mine}
        out[f"{fc}_kernels"] = {k: count[k] / 3 for k in mine}
    print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="another checkout's root, with src/repro_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cache-x4", action="store_true",
                    help="the CACHE_X4_FAMILIES forwards, not the FC calls")
    ap.add_argument("--families", action="store_true",
                    help="the one-layer families' forwards: gather_mlp's "
                         "device time a forward")
    args = ap.parse_args()

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("fc_wrapper_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(args.seed)
    calls = {}
    for blk, shp in chip_smoke.DENSE.items():
        *ops, mask = chip_smoke.dense_inputs(gen, cpu, chip_smoke.B, **shp)
        calls[f"gather_mlp_{blk}"] = ("gather_mlp", ops, mask)
    for blk, shp in chip_smoke.REUSE.items():
        *ops, live = chip_smoke.reuse_inputs(gen, cpu, chip_smoke.B, **shp)
        calls[f"hub_reuse_{blk}"] = ("hub_reuse", ops, live)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "fc_wrapper_ab.pt"
    torch.save(calls, path)
    trees = {"against": Path(args.against).resolve(), "this": ROOT}
    order = ("against", "this", "this", "against") * args.rounds
    for turn, tree in enumerate(order):
        env = {**os.environ, "PYTHONPATH": str(trees[tree] / "src"),
               "REPRO_TORCH_TILE_PLANS": str(ROOT / "build" / "no_plans")}
        argv = (["-c", CHILD_X4] if args.cache_x4 else
                ["-c", CHILD_FAMILIES] if args.families else
                ["-c", CHILD, str(path), str(args.iters)])
        out = subprocess.run([sys.executable, *argv], env=env, check=True,
                             capture_output=True, text=True,
                             cwd=trees[tree]).stdout
        for line in out.splitlines():
            print(json.dumps({"tree": tree, "turn": turn,
                              **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
