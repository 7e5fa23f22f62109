"""PCN serving entry point: the port's counterpart of ``repro.launch.serve``'s
PCN half, on the GPU unless ``--device cpu`` is given.

  * Batched inference — one padded (B, N, 3) batch shape through
    ``repro_torch.engine``, a throughput loop with per-step latency:

        PYTHONPATH=src python -m repro_torch.launch.serve \\
            --arch pointnet2_c --batch 8 --points 1024 --backend cuda

  * Trace serving (``--trace N``) — the continuous-batching layer
    (``repro_torch.serve``): replay a synthetic ragged arrival trace
    (Poisson arrivals at ``--rate`` req/s, log-normal cloud sizes with
    median ``--points``) through the admission queue, size buckets and
    timeout dispatcher, and report per-request p50/p95/p99 latency,
    throughput, padding waste and the fault counters as JSON.
    ``--faults`` injects a deterministic chaos plan into primary
    dispatches, ``--max-queue`` bounds each bucket lane (shed-on-full),
    ``--deadline-ms`` stamps per-request TTLs, ``--fallback`` picks the
    degraded backend ('' disables it).  Dispatch is async by default (up
    to ``--max-in-flight`` batches in flight); ``--sync`` restores the
    blocking dispatcher as the A/B baseline.

        PYTHONPATH=src python -m repro_torch.launch.serve \\
            --arch pointnet2_c --trace 64 --rate 30 --buckets 512,1024 \\
            --batch 8 --timeout-ms 100 --faults "fail@1,nan@3"

Every line that reports a time starts with the device's name.  Not
ported yet, each refused with the ROADMAP item that will bring it: the
mesh-sharded path (``--mesh-data``), tile knobs (``--kernel-kw``), the
families other than PointNet++ and the LM serving loop.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import replace

import numpy as np
import torch

from .. import random, serve
from ..data.synthetic import make_cloud
from ..engine import Batch, PCNEngine
from ..models.pointnet2 import POINTNET2_C, POINTNET2_PS, POINTNET2_S

PCN_ARCHS = {"pointnet2_c": POINTNET2_C, "pointnet2_ps": POINTNET2_PS,
             "pointnet2_s": POINTNET2_S}
# the JAX package's other PCN models, whose families are not ported yet
NOT_PORTED = ("dgcnn_c", "dgcnn_s", "pointnext_s", "pointvector_l")


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pcn_engine(args):
    """Shared PCN setup: spec (optionally reduced), engine, params."""
    spec = PCN_ARCHS[args.arch]
    if args.reduced:
        spec = replace(spec, blocks=tuple(
            replace(b, n_centers=min(b.n_centers, max(args.points // 4, 16)),
                    k=min(b.k, 16)) for b in spec.blocks))
    eng = PCNEngine(spec, mode=args.mode, fc_backend=args.backend,
                    device=args.device)
    return spec, eng, eng.init(seed=0)


def serve_pcn(args):
    """Batched PCN inference through the engine (one shape, many
    batches), each step ended by a device sync."""
    spec, eng, params = _pcn_engine(args)
    dev, name = eng.device, device_name(eng.device)
    rng = np.random.default_rng(0)
    f = spec.in_feats

    def make_batch(step: int):
        xyz = np.stack([make_cloud(rng, args.points)
                        for _ in range(args.batch)])
        feats = None
        if f > 3:
            feats = np.concatenate(
                [xyz, rng.uniform(0, 1, (args.batch, args.points, f - 3))
                 .astype(np.float32)], -1)
        return Batch.make(xyz, feats, key=random.PRNGKey(step), device=dev)

    # the first batch builds any kernel not built yet
    t0 = time.perf_counter()
    eng.apply(params, make_batch(0))
    _sync(dev)
    warmup_s = time.perf_counter() - t0

    # pre-built batches, so the loop times the engine, not cloud synthesis
    batches = [make_batch(step) for step in range(1, min(args.steps, 4) + 1)]
    step_ms = []
    for step in range(args.steps):
        t1 = time.perf_counter()
        logits = eng.apply(params, batches[step % len(batches)])
        _sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t1))
    dt = max(sum(step_ms) / 1e3, 1e-9)
    n = args.steps * args.batch
    lat = serve.percentile_summary(step_ms)
    print(f"{name}: {eng}: warmed in {warmup_s:.2f}s; served {n} clouds in "
          f"{dt:.2f}s ({n / dt:.1f} clouds/s, batch={args.batch}, "
          f"N={args.points})")
    print(f"{name}: per-step latency ms: p50={lat['p50']:.2f} "
          f"p95={lat['p95']:.2f} p99={lat['p99']:.2f} "
          f"mean={lat['mean']:.2f} max={lat['max']:.2f}")
    print("logits", tuple(logits.shape))
    return logits


def serve_trace(args):
    """Replay a synthetic ragged arrival trace through
    ``repro_torch.serve.PCNServer`` and write the latency / throughput /
    padding-waste / fault report as JSON.  Shed requests count in the
    report's ``faults`` section rather than aborting the replay."""
    spec, eng, params = _pcn_engine(args)
    name = device_name(eng.device)
    if args.buckets:
        sizes = sorted({int(s) for s in args.buckets.split(",")})
        buckets = serve.BucketSet.make(sizes, batch=args.batch)
    else:
        # no explicit sizes: plan quantile buckets from the trace itself
        probe = serve.synthetic_trace(
            n_requests=max(args.trace, 64), rate_hz=args.rate,
            n_median=args.points, sigma=args.size_sigma, seed=args.seed)
        buckets = serve.BucketSet.plan(
            [e.n_points for e in probe], n_buckets=2, batch=args.batch)
    events = serve.synthetic_trace(
        n_requests=args.trace, rate_hz=args.rate, n_median=args.points,
        sigma=args.size_sigma, n_max=buckets.max_points, seed=args.seed)

    faults = serve.FaultPlan.parse(args.faults) if args.faults else None
    t0 = time.perf_counter()
    server = serve.PCNServer(
        eng, params, buckets, timeout_s=args.timeout_ms / 1e3,
        faults=faults, seed=args.seed,
        max_lane_depth=args.max_queue or None,
        deadline_s=(args.deadline_ms / 1e3) if args.deadline_ms else None,
        fallback=args.fallback or None,
        max_in_flight=args.max_in_flight, sync=args.sync)
    warmup_s = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    f = spec.in_feats

    def make_request(n, i):
        xyz = make_cloud(rng, n)
        feats = None if f <= 3 else np.concatenate(
            [xyz, rng.uniform(0, 1, (n, f - 3)).astype(np.float32)], -1)
        return xyz, feats

    rids = serve.replay(server, events, make_request)
    server.close()                       # join + release the executor
    admitted = [r for r in rids if r is not None]
    answered = sum(server.ready(r) and not server.failed(r)
                   for r in admitted)
    failed = sum(server.failed(r) for r in admitted)
    report = server.report(arch=args.arch, mode=args.mode,
                           backend=args.backend, rate_hz=args.rate,
                           device=name, warmup_s=warmup_s,
                           answered=answered, failed=failed,
                           shed=len(rids) - len(admitted))
    lat = report["latency_ms"]["e2e"]
    fl = report["faults"]
    dmode = ("sync" if args.sync
             else f"async(max_in_flight={args.max_in_flight})")
    print(f"{name}: {eng}: {buckets}, timeout={args.timeout_ms:.1f}ms, "
          f"{dmode}; warmed {len(buckets)} buckets in {warmup_s:.2f}s; "
          f"answered {answered}/{len(rids)} requests")
    ov = report["overlap"]
    print(f"{name}: throughput {report['throughput_rps']:.1f} req/s "
          f"(offered {args.rate:.1f}), padding waste "
          f"{report['padding_waste_pct']:.1f}%, dispatches "
          f"{report['dispatches']} ({report['partial_batches']} partial), "
          f"overlap {ov['overlap_pct']:.1f}% "
          f"(depth<={ov['inflight_depth_max']}, "
          f"idle gap {ov['idle_gap_ms']:.1f}ms)")
    print(f"{name}: e2e latency ms: p50={lat['p50']:.2f} "
          f"p95={lat['p95']:.2f} p99={lat['p99']:.2f} max={lat['max']:.2f}")
    print(f"{name}: faults: degraded={fl['degraded_dispatches']} "
          f"failed={fl['failed_requests']} "
          f"shed_queue_full={fl['shed_queue_full']} "
          f"deadline_miss={fl['deadline_miss']} "
          f"breaker_opened={fl['breaker_opened']}")
    if args.serve_json:
        os.makedirs(os.path.dirname(args.serve_json) or ".", exist_ok=True)
        with open(args.serve_json, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"report written to {args.serve_json}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="PCN serving on the port (GPU unless --device cpu)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch path)")
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--mode", default="lpcn",
                    choices=["lpcn", "traditional"])
    ap.add_argument("--backend", default="cuda",
                    choices=["reference", "cuda"],
                    help="FC backend: the hand-written CUDA kernels "
                         "(default) or the plain PyTorch path")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="not ported yet (ROADMAP queue 1 item 8)")
    ap.add_argument("--kernel-kw", default=None,
                    help="not ported yet (ROADMAP queue 1 item 5)")
    # trace-serving options (--trace N turns the mode on)
    ap.add_argument("--trace", type=int, default=0,
                    help="replay a synthetic ragged trace of N requests "
                         "through the continuous-batching layer")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--size-sigma", type=float, default=0.35,
                    help="log-normal size spread (median = --points)")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated bucket pad sizes, e.g. "
                         "'512,1024' (default: quantile-planned from "
                         "the trace); per-bucket batch is --batch")
    ap.add_argument("--timeout-ms", type=float, default=10.0,
                    help="partial-batch dispatch timeout")
    ap.add_argument("--faults", default=None,
                    help="deterministic fault plan for the primary "
                         "engine path, e.g. 'fail@1,nan@3,slow@5:80' "
                         "(kind@dispatch-step[:arg_ms])")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="per-bucket lane depth bound; submits into a "
                         "full lane are shed (0 = unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline; expired queued requests "
                         "are shed at poll time (0 = none)")
    ap.add_argument("--fallback", default="reference",
                    help="FC backend for the one-shot degraded retry of "
                         "a failed batch ('' disables)")
    ap.add_argument("--max-in-flight", type=int, default=4,
                    help="how many fired batches may be in flight at "
                         "once (async dispatch)")
    ap.add_argument("--sync", action="store_true",
                    help="fully-blocking dispatch — the A/B baseline for "
                         "--max-in-flight")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve-json", default="results/serve_trace.json",
                    help="where the trace report JSON goes ('' = skip)")
    args = ap.parse_args(argv)

    if args.mesh_data:
        raise SystemExit("--mesh-data: the port's engine has no mesh yet; "
                         "batch data parallelism comes with ROADMAP queue 1 "
                         "item 8")
    if args.kernel_kw:
        raise SystemExit("--kernel-kw: the port's kernels take no tile "
                         "knobs yet; Hopper tile plans come with ROADMAP "
                         "queue 1 item 5")
    if args.arch in NOT_PORTED:
        raise NotImplementedError(
            f"architecture family {args.arch.split('_')[0]!r} is not ported "
            f"yet (ROADMAP queue 1 item 2); ported: "
            f"{', '.join(PCN_ARCHS)}")
    if args.arch not in PCN_ARCHS:
        raise SystemExit(
            f"--arch {args.arch!r} is not a PCN model "
            f"({', '.join(PCN_ARCHS)}); the LM serving loop is not ported "
            f"yet (ROADMAP queue 1 item 10)")
    return serve_trace(args) if args.trace else serve_pcn(args)


if __name__ == "__main__":
    main()
