"""Serving entry point: the port's counterpart of ``repro.launch.serve``,
on the GPU unless ``--device cpu`` is given.  Two families share one CLI,
dispatched on ``--arch``.

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

  * LM serving — ``--arch`` one of ``repro_torch.configs.ARCH_IDS``
    (``--reduced`` for its smoke config): a batch of random prompts
    teacher-forced through the decode cache one token a step, then
    ``--gen`` greedy tokens (``repro_torch.lm.steps.make_decode_step``).
    Launched on N ranks it decodes tensor-parallel under ``local_mesh()``
    ((1, N) over ("data", "model"); a world of one runs without a mesh):

        PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
            --batch 4 --prompt-len 32 --gen 16 --cache-len 64
        PYTHONPATH=src torchrun --nproc-per-node 4 -m \\
            repro_torch.launch.serve --arch olmo-1b --reduced --device cpu

For PCN serving, ``--arch`` takes every model of
``repro_torch.models.MODEL_ZOO``; a seg model answers each request with
its per-point logits.  ``--kernel-kw``
takes a JSON object of the FC kernels' launch knobs (``{"rows": 64,
"chunk": 64}``; ``rows``, ``nsplit``, ``chunk``), passed to
``PCNEngine(kernel_kw=...)``; without it each call's plan comes from the
tile-plan store (``python -m repro_torch.launch.autotune``) or the
heuristic.  Every line that reports a time starts with the device's
name.

``--mesh-data N`` serves a PCN model over an (N, 1) data mesh, one rank
a device (``torchrun --nproc-per-node N``; with N = 1 a world of one is
made in-process): each forward splits the batch's rows over the ranks
(``PCNEngine(mesh=)``).  The throughput loop runs on every rank; a trace
is served by rank 0, which forms the batches, while the other ranks
follow its forwards (``PCNEngine.follow``).  Rank 0 prints, with the rate
per device.  With an LM arch ``--mesh-data`` is refused, as the JAX CLI
refuses it.  Rehearsed on the CPU over gloo:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch pointnet2_c --reduced --device cpu --mesh-data 4 --batch 4 \
        --points 256 --trace 16 --serve-json ''
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
from ..configs import ARCH_IDS, get_config
from ..data.synthetic import make_cloud
from ..dist import sharding as shd
from ..device import resolve_device
from ..engine import Batch, PCNEngine
from ..lm import model_zoo as zoo
from ..lm import steps as lm_steps
from ..lm.transformer import dtype_of
from ..models import MODEL_ZOO
from .mesh import data_mesh, local_mesh, release_world, world_size


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pcn_engine(args):
    """Shared PCN setup: spec (optionally reduced), the data mesh (None
    without ``--mesh-data``), engine, params (the same on every rank)."""
    _, spec = MODEL_ZOO[args.arch]
    if args.reduced:
        spec = replace(spec, blocks=tuple(
            replace(b, n_centers=min(b.n_centers, max(args.points // 4, 16)),
                    k=min(b.k, 16)) for b in spec.blocks))
    mesh = None
    if args.mesh_data:
        if args.batch % args.mesh_data:
            raise SystemExit(
                f"--batch {args.batch} does not divide over a "
                f"{args.mesh_data}-way data mesh; pick a batch that is a "
                f"multiple of --mesh-data")
        try:
            mesh = data_mesh(args.mesh_data, device=args.device)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"--mesh-data {args.mesh_data}: {e}") from None
    kernel_kw = json.loads(args.kernel_kw) if args.kernel_kw else None
    eng = PCNEngine(spec, mode=args.mode, fc_backend=args.backend,
                    kernel_kw=kernel_kw, device=args.device, mesh=mesh)
    return spec, mesh, eng, eng.init(seed=0)


def _lead(mesh) -> bool:
    """Whether this rank prints (rank 0, or no mesh)."""
    if mesh is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def _per_device(mesh, rate: float, unit: str) -> str:
    if mesh is None:
        return ""
    n = mesh.shape["data"]
    return f", {rate / n:.1f} {unit}/device over {n} devices"


def serve_pcn(args):
    """Batched PCN inference through the engine (one shape, many
    batches), each step ended by a device sync."""
    spec, mesh, eng, params = _pcn_engine(args)
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
    if not _lead(mesh):
        return logits
    print(f"{name}: {eng}: warmed in {warmup_s:.2f}s; served {n} clouds in "
          f"{dt:.2f}s ({n / dt:.1f} clouds/s, batch={args.batch}, "
          f"N={args.points}{_per_device(mesh, n / dt, 'clouds/s')})")
    print(f"{name}: per-step latency ms: p50={lat['p50']:.2f} "
          f"p95={lat['p95']:.2f} p99={lat['p99']:.2f} "
          f"mean={lat['mean']:.2f} max={lat['max']:.2f}")
    print("logits", tuple(logits.shape))
    return logits


def serve_trace(args):
    """Replay a synthetic ragged arrival trace through
    ``repro_torch.serve.PCNServer`` and write the latency / throughput /
    padding-waste / fault report as JSON.  Shed requests count in the
    report's ``faults`` section rather than aborting the replay.  Under a
    mesh the ranks but 0 follow rank 0's forwards and return None."""
    spec, mesh, eng, params = _pcn_engine(args)
    if not _lead(mesh):
        eng.follow(params)
        return None
    try:
        return _serve_trace(args, spec, mesh, eng, params)
    finally:
        if mesh is not None:
            eng.release()


def _serve_trace(args, spec, mesh, eng, params):
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
                           mesh_data=args.mesh_data or None,
                           device=name, warmup_s=warmup_s,
                           answered=answered, failed=failed,
                           shed=len(rids) - len(admitted))
    lat = report["latency_ms"]["e2e"]
    fl = report["faults"]
    dmode = ("sync" if args.sync
             else f"async(max_in_flight={args.max_in_flight})")
    over = "" if mesh is None else f" over {mesh.shape['data']} devices"
    print(f"{name}: {eng}: {buckets}, timeout={args.timeout_ms:.1f}ms, "
          f"{dmode}; warmed {len(buckets)} buckets in {warmup_s:.2f}s; "
          f"answered {answered}/{len(rids)} requests{over}")
    ov = report["overlap"]
    print(f"{name}: throughput {report['throughput_rps']:.1f} req/s "
          f"(offered {args.rate:.1f}"
          f"{_per_device(mesh, report['throughput_rps'], 'req/s')}), "
          f"padding waste "
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


def serve_lm(args, params=None, mesh=None, logits=None):
    """Batched decode loop: a batch of random prompts teacher-forced
    through the decode cache token by token, then ``--gen`` greedy tokens,
    each step on the device.  It is the JAX CLI's loop to the position:
    the prompt's last token enters at position ``prompt_len``, so cache
    slot ``prompt_len - 1`` stays empty (ROADMAP queue 3).  ``params``
    (default: ``zoo.init`` from a generator seeded with 0) lets a caller
    serve weights carried across from JAX; ``logits``, if a list, gets
    each generated step's logits (the whole (batch, vocab) tensor).  ->
    (batch, gen) generated tokens.

    Launched on more than one rank (``torchrun --nproc-per-node N``) it
    serves under ``local_mesh()``, a (1, N) ("data", "model") mesh:
    tensor-parallel decode, params laid out by ``param_shardings`` and
    the caches by ``cache_shardings`` as DTensors, every rank drawing the
    same params and prompts; rank 0 prints.  A world of one serves
    without a mesh unless ``mesh`` (a ``launch.mesh.Mesh`` the caller
    made and releases) is handed in.  An op without a DTensor rule
    raises; nothing falls back to the mesh-free loop."""
    cfg = get_config(args.arch, reduced=args.reduced)
    dev = resolve_device(args.device)
    own = mesh is None and world_size() > 1
    if own:
        mesh = local_mesh(dev)
    if mesh is None:
        return _serve_lm(args, cfg, dev, params, None, logits)
    try:
        with shd.use_mesh(mesh, sp=cfg.seq_shard_blocks,
                          profile=cfg.shard_profile):
            return _serve_lm(args, cfg, dev, params, mesh, logits)
    finally:
        if own:
            release_world()


def _serve_lm(args, cfg, dev, params, mesh, logits):
    name = device_name(dev)
    lead = mesh is None or torch.distributed.get_rank() == 0
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    if params is None:
        params = zoo.init(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)

    def laid(tree, shardings):
        return tree if mesh is None else shd.distribute(tree,
                                                        shardings(tree))

    params = laid(params, lambda t: shd.param_shardings(t, mesh,
                                                        cfg.moe_shard))
    frames = None
    if cfg.family == "audio":           # the stubbed frontend's frames
        frames = laid(torch.full((args.batch, cfg.enc_seq, cfg.d_model),
                                 0.01, dtype=dtype_of(cfg), device=dev),
                      lambda t: shd.batch_shardings(t, mesh))
    with torch.no_grad():
        cache = laid(zoo.make_cache(cfg, params, args.batch, args.cache_len,
                                    frames=frames, device=dev),
                     lambda t: shd.cache_shardings(t, mesh))
    decode = lm_steps.make_decode_step(cfg)
    _sync(dev)
    setup_s = time.perf_counter() - t0

    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    prompts = torch.from_numpy(prompts).to(dev)

    def token(t):
        return laid(t, lambda x: shd.batch_shardings(x, mesh))

    tok = token(prompts[:, 0])
    t0 = time.perf_counter()
    for pos in range(args.prompt_len - 1):
        _, _, cache = decode(params, tok, cache, pos)
        tok = token(prompts[:, pos + 1])
    _sync(dev)
    prompt_s = time.perf_counter() - t0
    out = []
    t0 = time.perf_counter()
    for g in range(args.gen):
        tok, step_logits, cache = decode(params, tok, cache,
                                         args.prompt_len + g)
        out.append(shd.whole(tok))
        if logits is not None:
            logits.append(shd.whole(step_logits))
    gen = torch.stack(out, 1).cpu().numpy()
    gen_s = max(time.perf_counter() - t0, 1e-9)
    n = args.batch * args.gen
    if lead:
        over = ("" if mesh is None else
                f", mesh {dict(mesh.shape)} over {mesh.size} devices")
        print(f"{name}: {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}"
              f"{over}): set up in {setup_s:.2f}s; prompt of "
              f"{args.prompt_len} through decode in {prompt_s:.2f}s; "
              f"generated {gen.shape} tokens in {gen_s:.2f}s "
              f"({n / gen_s:.1f} tok/s, {1e3 * gen_s / args.gen:.2f} ms a "
              f"step, batch={args.batch})")
        print(gen)
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="PCN and LM serving on the port (GPU unless --device "
                    "cpu)")
    ap.add_argument("--arch", required=True,
                    help="a PCN model (repro_torch.models.MODEL_ZOO) or an "
                         "LM architecture (repro_torch.configs.ARCH_IDS)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch path)")
    # LM options
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=64)
    # PCN options
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--mode", default="lpcn",
                    choices=["lpcn", "traditional"])
    ap.add_argument("--backend", default="cuda",
                    choices=["reference", "cuda", "cuda_per_cloud"],
                    help="FC backend: the hand-written CUDA kernels "
                         "(default; cuda_per_cloud: one launch per cloud) "
                         "or the plain PyTorch path")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="serve a PCN model over an N-way data mesh, one "
                         "rank a device (torchrun --nproc-per-node N)")
    ap.add_argument("--kernel-kw", default=None,
                    help="JSON object of FC kernel launch knobs, e.g. "
                         "'{\"rows\": 64, \"chunk\": 64}' (rows, nsplit, "
                         "chunk; passed to PCNEngine(kernel_kw=...))")
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

    if args.arch in ARCH_IDS:
        if args.mesh_data:
            raise SystemExit(
                "--mesh-data is the PCN engine's sharded path; the LM "
                "serving loop runs on one device")
        return serve_lm(args)
    if args.arch not in MODEL_ZOO:
        raise SystemExit(
            f"--arch {args.arch!r} is neither a PCN model "
            f"({', '.join(MODEL_ZOO)}) nor an LM architecture "
            f"({', '.join(ARCH_IDS)})")
    try:
        return serve_trace(args) if args.trace else serve_pcn(args)
    finally:
        release_world()


if __name__ == "__main__":
    main()
