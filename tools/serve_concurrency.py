#!/usr/bin/env python3
"""How the port's lpcn forward behaves when several threads run it at once,
as the server's async executor does (GPU only).

    python3 tools/serve_concurrency.py [--threads 1,2,4] [--forwards 8]

Runs ``--forwards`` (8, 1024) forwards of ``PCNEngine(POINTNET2_C,
mode="lpcn", fc_backend="cuda")``, each ended by its copy to the host, in
four ways, and prints one JSON line per way and thread count with the wall
time and the mean time per forward:

  serial    one thread, one forward after another;
  threads   T threads on the device's current stream (the server today);
  streams   T threads, each on a stream of its own;
  locked    T threads taking turns on the forward under one lock.

Then one forward under torch.profiler (CPU activity only): how many host
syncs and device-to-host copies one forward makes.  Each line carries the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", default="1,2,4")
    ap.add_argument("--forwards", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_concurrency: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import random
    from repro_torch.data.synthetic import make_cloud
    from repro_torch.engine import Batch, PCNEngine
    from repro_torch.models.pointnet2 import POINTNET2_C

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda")
    params = eng.init(seed=args.seed)
    rng = np.random.default_rng(args.seed)
    batches = []
    for i in range(args.forwards):
        clouds = [make_cloud(rng, int(rng.integers(512, 1025)))
                  for _ in range(8)]
        keys = random.fold_in(random.PRNGKey(args.seed), torch.arange(
            8 * i, 8 * i + 8))
        batches.append(Batch.from_clouds(clouds, key=keys, n_pad=1024,
                                         device=eng.device))
    eng.apply(params, batches[0]).cpu()              # warm

    def forward(b):
        t0 = time.perf_counter()
        eng.apply(params, b).cpu()
        return time.perf_counter() - t0

    def run(n_threads, how):
        lock = threading.Lock()
        per, jobs = [], list(batches)
        jobs_lock = threading.Lock()

        def worker():
            stream = torch.cuda.Stream() if how == "streams" else None
            while True:
                with jobs_lock:
                    if not jobs:
                        return
                    b = jobs.pop()
                if how == "streams":
                    with torch.cuda.stream(stream):
                        per.append(forward(b))
                elif how == "locked":
                    with lock:
                        per.append(forward(b))
                else:
                    per.append(forward(b))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        return {"way": how, "threads": n_threads, "forwards": len(per),
                "wall_s": wall, "forward_ms_mean": 1e3 * sum(per) / len(per),
                "forwards_per_s": len(per) / wall, "device": smi}

    print(json.dumps(run(1, "serial")), flush=True)
    for n in (int(x) for x in args.threads.split(",")):
        if n > 1:
            for how in ("threads", "streams", "locked"):
                print(json.dumps(run(n, how)), flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.apply(params, batches[0]).cpu()
    names = {}
    for e in prof.events():
        names[e.name] = names.get(e.name, 0) + 1
    want = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaMemcpyAsync", "aten::item", "aten::_local_scalar_dense",
            "aten::nonzero", "cudaLaunchKernel")
    print(json.dumps({"one_forward_host_events": {
        k: names.get(k, 0) for k in want}, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
