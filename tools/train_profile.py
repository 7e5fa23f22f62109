#!/usr/bin/env python3
"""Where one full-width train step spends its time (GPU only).

    python3 tools/train_profile.py [--arch olmo-1b] [--steps 2] [--seed 0]

The step of a ``chip_smoke.TRAIN_MAIN`` run (olmo-1b or mamba2-2.7b as
published, bf16 params, f32 AdamW state, remat, 4 x 2048 tokens in 2
microbatches) through ``repro_torch.lm.steps.make_train_step``: after two
warm-up steps, ``--steps`` steps under torch.profiler, their kernels'
device time summed by kind (the flash_attention and ssd_chunk forward and
backward kernels, cuBLAS's matrix products, everything else, whose
costliest kernels are named; the backward kernels also by pass) with the
device's idle share of the profiled wall time; then, timed alone with CUDA events, one microbatch's forward
and backward (``steps.loss_and_grads``) and one AdamW update
(``optim.adamw.apply_updates``).  Prints one JSON line beside the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# kernel name fragments of each kind, tried in this order
KINDS = (("flash_attention_bwd", ("bwd_dq_kernel", "bwd_dkv_kernel",
                                  "bwd_dq_wgmma_kernel",
                                  "bwd_dkv_wgmma_kernel")),
         ("flash_attention", ("flash_mma_kernel", "flash_wgmma_kernel")),
         ("ssd_chunk_bwd", ("ssd_bwd_heads", "ssd_bwd_chunk")),
         ("ssd_chunk", ("ssd_chunk_kernel",)),
         ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, frags in KINDS:
        if any(f.lower() in low for f in frags):
            return kind
    return "other"


def cuda_ms(fn, reps: int = 3) -> float:
    """Best of ``reps`` calls of ``fn``, CUDA events around each."""
    import torch
    best = float("inf")
    for _ in range(reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1))
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b",
                    choices=("olmo-1b", "mamba2-2.7b"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch import kernels, tree
    from repro_torch.configs import get_config
    from repro_torch.data.loader import TokenStream
    from repro_torch.lm import model_zoo as zoo
    from repro_torch.lm import steps
    from repro_torch.optim import adamw

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.splitlines()[0]
    print(smi, flush=True)
    kernels.build(("flash_attention", "flash_attention_bwd", "ssd_chunk",
                   "ssd_chunk_bwd"))
    torch.use_deterministic_algorithms(True, warn_only=True)
    r = next(run for run in cs.TRAIN_MAIN if run["arch"] == args.arch)
    cfg = get_config(r["arch"])
    dev = torch.device("cuda")
    params = zoo.init(torch.Generator(device=dev).manual_seed(args.seed), cfg,
                      dev)
    opt_cfg = adamw.AdamWConfig(state_dtype="float32")
    state = adamw.init_state(opt_cfg, params)
    step = steps.make_train_step(cfg, opt_cfg, microbatches=r["microbatches"])
    stream = TokenStream(vocab=cfg.vocab, batch=r["b"], seq_len=r["s"],
                         seed=args.seed)
    batches = [{"tokens": torch.from_numpy(stream.next()).to(dev)}
               for _ in range(2 + args.steps)]
    for i in range(2):
        params, state, _ = step(params, state, batches[i], i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, 2 + args.steps):
            params, state, _ = step(params, state, batches[i], i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_kind: dict = {}
    other: dict = {}
    by_pass: dict = {}   # the backward kernels' device time by pass
    for e in kern:
        ms, n = by_kind.get(kind_of(e.name), (0.0, 0))
        by_kind[kind_of(e.name)] = (ms + e.device_time / 1e3, n + 1)
        if kind_of(e.name) == "other":
            ms, n = other.get(e.name, (0.0, 0))
            other[e.name] = (ms + e.device_time / 1e3, n + 1)
        for kind, frags in KINDS[:3:2]:   # the two backward kinds
            for f in frags:
                if f in e.name:
                    ms, n = by_pass.get(f, (0.0, 0))
                    by_pass[f] = (ms + e.device_time / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_kind.values())

    mb = {k: v[: r["b"] // r["microbatches"]] for k, v in batches[0].items()}
    grads = tree.map(lambda p: torch.randn(p.shape, device=dev), params)

    row = dict(
        arch=r["arch"], batch=r["b"], seq=r["s"],
        microbatches=r["microbatches"], steps=args.steps, card=smi,
        step_wall_ms=wall_ms / args.steps,
        device_busy_ms_per_step=busy / args.steps,
        idle_share=1 - busy / wall_ms,
        kernels_per_step=len(kern) / args.steps,
        by_kind={k: {"ms_per_step": ms / args.steps,
                     "launches_per_step": n / args.steps,
                     "share_of_busy": ms / busy}
                 for k, (ms, n) in sorted(by_kind.items(),
                                          key=lambda kv: -kv[1][0])},
        backward_by_pass={f: {"ms_per_step": ms / args.steps,
                              "launches_per_step": n / args.steps}
                          for f, (ms, n) in by_pass.items()},
        costliest_other={name[:120]: {"ms_per_step": ms / args.steps,
                                      "launches_per_step": n / args.steps}
                         for name, (ms, n) in sorted(
                             other.items(), key=lambda kv: -kv[1][0])[:10]},
        microbatch_fwd_bwd_ms=cuda_ms(
            lambda: steps.loss_and_grads(cfg, params, mb)),
        adamw_ms=cuda_ms(lambda: adamw.apply_updates(opt_cfg, params, grads,
                                                     state)))
    print(json.dumps({"train_profile": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
