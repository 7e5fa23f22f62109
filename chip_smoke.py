#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each timed, any failure exits non-zero:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  2. hold each FC kernel against its plain PyTorch version on the card, at
     both PointNet++(c) block shapes, batched (B=8) and at B=1, masked and
     unmasked, and hub_reuse also at the other families' widest blocks
     (``REUSE_WIDE``): ``max|Δ| <= 1e-4 · max(1, max|plain|)``, the -BIG
     identity exactly;
  3. time each FC kernel and its plain version in turns at the main path's
     shapes;
  4. serve: ``repro_torch.serve.PCNServer`` over
     ``PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda")`` in (8, 512)
     and (8, 1024) buckets replays a 48-request ``synthetic_trace``
     (Poisson arrivals at 30 req/s, log-normal sizes, median 768, clipped
     to 512–1024) three times: async (4 batches in flight), sync, and under
     the chaos plan ``fail@1,nan@3`` with the "reference" fallback.  Each
     run checks every request answered exactly once, the launch counts of
     the run (2 per dispatch that reached the kernels, 0 for the entry
     kernels), no degraded dispatch when healthy and exactly 2 under chaos,
     every response against ``apply_single`` on its own cloud and key (the
     degraded ones against the "reference" backend's); then the CLI,
     ``python -m repro_torch.launch.serve --arch pointnet2_c --trace 16``,
     in a subprocess; and one (8, 1024) batch against the "reference"
     backend;
  5. one batch in ``mode="traditional"``;
  6. entry kernels: drive ``knn`` (stage 1 of the first batch, both
     blocks, every cloud), ``flash_attention`` (a Qwen2-72B layer, bf16 on
     the tensor-core route; the same bf16 at an address off 16 bytes and
     f32 on the CUDA-core one) and ``ssd_chunk`` (Mamba2-2.7B) once at
     full width with the launch counts reset, then hold each output and
     some ragged parity cases against the plain versions (flash: max |Δ|
     and ‖Δ‖/‖plain‖) and time all three.

Output lines: the card's name and power limit (nvidia-smi), phase times,
ptxas's registers and spills (gather_mlp and hub_reuse must not spill),
the counts of HGMMA (wgmma) instructions in the built flash_attention
library and of TF32 HMMA (mma.sync) instructions in the gather_mlp and
hub_reuse ones, ``parity``,
``per_cloud`` and ``entry_parity``
JSON lines, the serving reports (``serve_async``, ``serve_sync``,
``serve_chaos``, each beside the card's name and power limit) and the
CLI's lines, the lpcn forward's stage times (``--profile`` adds a
torch.profiler trace of one forward), stage 1 on the card against the
CPU, a ``kernels`` JSON line (every TPU kernel's counterpart: the FC
kernels batched and per cloud, and the entry kernels; ``launches`` counted
per wrapper, in the async serving run for the FC kernels and in the entry
phase for the others), and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-4
BIG = 3.4e38
# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 and TF32 on the tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
B, N_PAD = 8, 1024

# (name, shape) of each kernel call on the pointnet2_c main path, masked as
# the path calls it: block 1 sees the batch's n_valid, block 2 FPS centers
DENSE = {"blk1": dict(s=512, k=32, d=65, dc=1, h=64, f=128, masked=True),
         "blk2": dict(s=128, k=64, d=129, dc=1, h=128, f=256, masked=False)}
REUSE = {"blk1": dict(hn=16, c=64, m=64, k=32, d=64, h=64, f=128),
         "blk2": dict(hn=4, c=128, m=64, k=64, d=128, h=128, f=256)}
# parity only, at B = 2: hub_reuse at the other families' widest blocks
# (two_layer_form doubles Hd for one-layer MLPs; C = 2k cache rows)
REUSE_WIDE = {
    "pointnext_s_blk4": dict(hn=4, c=64, m=16, k=32, d=259, h=1024, f=512),
    "pointvector_l_blk3": dict(hn=4, c=64, m=16, k=32, d=195, h=768, f=384),
    "pointvector_l_blk4": dict(hn=4, c=64, m=16, k=32, d=387, h=1536,
                               f=768),
    "dgcnn_c_blk4": dict(hn=4, c=40, m=16, k=32, d=256, h=512, f=256)}
# a Qwen2-72B attention layer (src/repro/configs/qwen2_72b.py: 64 query
# heads, 8 kv heads, head_dim 128) over a 2048-token prefill
QWEN2_72B = dict(b=1, hq=64, hkv=8, s=2048, d=128)
# parity only: (B, Hq, Hkv, Sq, Skv, D, causal, dtype) — non-causal with a
# ragged Skv, causal with Sq != Skv (top-left mask), a D below 128, and
# bf16 widths with D % 8 != 0 (the CUDA-core route)
FLASH_PARITY = ((1, 64, 8, 320, 1000, 128, False, "float32"),
                (1, 64, 8, 320, 1000, 128, False, "bfloat16"),
                (1, 16, 4, 320, 1000, 128, True, "float32"),
                (2, 8, 2, 333, 333, 80, True, "bfloat16"),
                (1, 64, 8, 320, 1000, 100, False, "bfloat16"),
                (2, 8, 2, 333, 333, 36, True, "bfloat16"))
# flash_attention's limits per dtype: max |Δ| and ‖Δ‖ / ‖plain‖.  With
# randn inputs most causal rows average hundreds of keys and are ~0.03,
# so the max |Δ| limit alone passes a fault confined to those rows
FLASH_TOL = {"bfloat16": (3e-2, 1e-2), "float32": (2e-3, 1e-3)}
# the serving phase: a ragged trace of ModelNet-sized objects, Poisson
# arrivals at 30 req/s, about 65 % of the 46.5 clouds/s that full
# (8, 1024) batches sustained on the H100 before the server (PERF.md §4)
SERVE_TRACE = dict(n_requests=48, rate_hz=30.0, n_median=768, sigma=0.35,
                   n_min=512, n_max=N_PAD)
SERVE_BUCKETS = (512, N_PAD)
SERVE_TIMEOUT_S = 0.1
SERVE_CHAOS = "fail@1,nan@3"
CLI_TRACE = 16
# Mamba2-2.7B's SSD (src/repro/configs/mamba2_2p7b.py: d_inner 5120 = 80
# heads of 64, state 128, chunk 64) over a 2048-token sequence: 32 chunks
MAMBA2_2P7B = dict(bs=1, nc=32, q=64, h=80, p=64, s=128)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_err(out, ref) -> tuple[float, float]:
    """(max |out − ref|, tolerance) with the -BIG merge identity compared
    exactly and left out of the scale."""
    import torch
    sentinel = ref <= -BIG / 2
    check(bool(torch.equal(out[sentinel], ref[sentinel])),
          "kernel and plain version disagree on the -BIG identity")
    rest = ~sentinel
    if not bool(rest.any()):
        return 0.0, TOL
    err = (out[rest] - ref[rest]).abs().max().item()
    return err, TOL * max(1.0, ref[rest].abs().max().item())


def dense_inputs(gen, dev, b, s, k, d, dc, h, f, masked):
    import torch
    r = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen)
                                   * scale).to(dev)
    mask = None
    if masked:
        mask = torch.rand((b, s, k), generator=gen) < 0.8
        mask[:, ::7] = False                  # whole subsets dead
        mask = mask.to(dev)
    return (r(b, s, k, d), r(b, s, dc), r(d, h, scale=(2 / d) ** .5),
            r(h, scale=.1), r(h, f, scale=(2 / h) ** .5), r(f, scale=.1),
            mask)


def reuse_inputs(gen, dev, b, hn, c, m, k, d, h, f):
    import torch
    r = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen)
                                   * scale).to(dev)
    slot = torch.randint(-1, c, (b, hn, m, k), generator=gen,
                         dtype=torch.int32)
    slot[:, :, ::9] = -1                      # subsets with no cached slot
    live = (torch.rand((b, hn, m, k), generator=gen) < 0.9)
    return (r(b, hn, c, d), slot.to(dev), r(b, hn, m, f), r(d, h,
            scale=(2 / d) ** .5), r(h, scale=.1), r(h, f,
            scale=(2 / h) ** .5), r(f, scale=.1), live.to(dev))


def time_turns(fns: dict, iters=20) -> dict:
    """ms per call of each named function, timed with CUDA events after a
    warm-up, in turns that run the names forward then backward (plain,
    kernel, kernel, plain); each name's best turn."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for name in (*fns, *reversed(fns)):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            fns[name]()
        t1.record()
        torch.cuda.synchronize()
        times[name].append(t0.elapsed_time(t1) / iters)
    return {name: min(t) for name, t in times.items()}


def time_pair(fn_kernel, fn_plain, iters=20):
    """ms per call of kernel and plain version, timed in turns."""
    t = time_turns({"plain": fn_plain, "kernel": fn_kernel}, iters)
    return t["kernel"], t["plain"]


def sass_count(name: str, *words: str) -> int:
    """Instructions of the built ``name`` library whose SASS line holds
    every one of ``words`` (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    lib = _build.library_path(name)
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    return sum(all(w in line for w in words) for line in sass.splitlines())


def spilled_bytes(log: str) -> int:
    """Spill stores plus spill loads over every kernel in an nvcc log."""
    return sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FP32) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def kernel_phase(dev, seed):
    """Hold every kernel variant against its plain version and time the
    main-path shapes, batched (the serving path) and at B = 1 (the
    per-cloud entry).  -> (parity rows, batched rows without launches,
    per-cloud rows)."""
    import torch
    from repro_torch.kernels.gather_mlp import gather_mlp, gather_mlp_ref
    from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
    gen = torch.Generator().manual_seed(seed)
    parity, rows, per_cloud = [], [], []
    for blk, shp in DENSE.items():
        for bb in (B, 1):
            for masked in (True, False):
                raw, ctr, w1, b1, w2, b2, mask = dense_inputs(
                    gen, dev, bb, **{**shp, "masked": masked})
                args = (raw, ctr, w1, b1, w2, b2)
                if bb == 1:              # the per-cloud entry: (S, K, D)
                    args = (raw[0], ctr[0], w1, b1, w2, b2)
                    mask = None if mask is None else mask[0]
                out = gather_mlp(*args, mask=mask)
                ref = gather_mlp_ref(*args, mask=mask)
                torch.cuda.synchronize()
                err, tol = max_err(out, ref)
                parity.append(dict(name="gather_mlp", block=blk, b=bb,
                                   masked=masked, max_abs_err=err, tol=tol))
                check(err <= tol, f"gather_mlp {blk} B={bb} masked={masked}"
                      f": max|err| {err} > {tol}")
                if masked == shp["masked"]:
                    ms, plain_ms = time_pair(
                        lambda: gather_mlp(*args, mask=mask),
                        lambda: gather_mlp_ref(*args, mask=mask))
                    flops = 2 * bb * shp["s"] * shp["k"] * (
                        shp["d"] * shp["h"] + shp["h"] * shp["f"])
                    # 3xTF32: three TF32 products for each fp32 one
                    moved = nbytes(*args, mask, out)
                    bms, by = bound(3 * flops, moved, PEAK_TF32)
                    (rows if bb == B else per_cloud).append(dict(
                        name="gather_mlp", block=blk, route="cuda",
                        variant="mma_tf32x3", tflops=flops / ms / 1e9,
                        bound_fp32_ms=bound(flops, moved)[0],
                        source="src/repro_torch/csrc/gather_mlp.cu",
                        replaces="src/repro/kernels/gather_mlp/"
                                 f"gather_mlp.py:{239 if bb == B else 91}",
                        shape=f"B={bb} S={shp['s']} K={shp['k']} "
                              f"D={shp['d']} Dc={shp['dc']} H={shp['h']} "
                              f"F={shp['f']} masked={masked}",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None))
    for blk, shp in REUSE.items():
        for bb in (B, 1):
            for with_live in (True, False):
                pool, slot, comp, w1, b1, w2, b2, live = reuse_inputs(
                    gen, dev, bb, **shp)
                live = live if with_live else None
                args = (pool, slot, comp, w1, b1, w2, b2)
                if bb == 1:
                    args = (pool[0], slot[0], comp[0], w1, b1, w2, b2)
                    live = None if live is None else live[0]
                out = hub_reuse(*args, live=live)
                ref = hub_reuse_ref(*args, live=live)
                torch.cuda.synchronize()
                err, tol = max_err(out, ref)
                parity.append(dict(name="hub_reuse", block=blk, b=bb,
                                   masked=with_live, max_abs_err=err,
                                   tol=tol))
                check(err <= tol, f"hub_reuse {blk} B={bb} live="
                      f"{with_live}: max|err| {err} > {tol}")
                if with_live:
                    ms, plain_ms = time_pair(
                        lambda: hub_reuse(*args, live=live),
                        lambda: hub_reuse_ref(*args, live=live))
                    flops = 2 * bb * shp["hn"] * shp["c"] * (
                        shp["d"] * shp["h"] + shp["h"] * shp["f"])
                    moved = nbytes(*args, live, out)
                    bms, by = bound(3 * flops, moved, PEAK_TF32)
                    (rows if bb == B else per_cloud).append(dict(
                        name="hub_reuse", block=blk, route="cuda",
                        variant="mma_tf32x3", tflops=flops / ms / 1e9,
                        bound_fp32_ms=bound(flops, moved)[0],
                        source="src/repro_torch/csrc/hub_reuse.cu",
                        replaces="src/repro/kernels/hub_reuse/"
                                 f"hub_reuse.py:{307 if bb == B else 117}",
                        shape=f"B={bb} H={shp['hn']} C={shp['c']} "
                              f"M={shp['m']} K={shp['k']} D={shp['d']} "
                              f"Hd={shp['h']} F={shp['f']} live=True",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None))
    for name, shp in REUSE_WIDE.items():
        pool, slot, comp, w1, b1, w2, b2, live = reuse_inputs(
            gen, dev, 2, **shp)
        args = (pool, slot, comp, w1, b1, w2, b2)
        out = hub_reuse(*args, live=live)
        err, tol = max_err(out, hub_reuse_ref(*args, live=live))
        parity.append(dict(name="hub_reuse", block=name, b=2, masked=True,
                           max_abs_err=err, tol=tol))
        check(err <= tol, f"hub_reuse {name}: max|err| {err} > {tol}")
    return parity, rows, per_cloud


def make_requests(rng, n):
    """Seeded synthetic clouds of 512–1024 points: noisy ellipsoid shells
    and boxes, the shapes ModelNet-style classifiers see."""
    import numpy as np
    clouds = []
    for i in range(n):
        m = int(rng.integers(512, N_PAD + 1))
        if i % 2:
            p = rng.standard_normal((m, 3))
            p /= np.linalg.norm(p, axis=1, keepdims=True)
        else:
            p = rng.uniform(-1, 1, (m, 3))
        p = p * rng.uniform(0.4, 1.0, 3) + 0.01 * rng.standard_normal((m, 3))
        clouds.append(p.astype(np.float32))
    return clouds


def close(a, b) -> tuple[float, float]:
    err = (a - b).abs().max().item()
    return err, TOL * max(1.0, b.abs().max().item())


def breakdown(params, spec, batch, repeats=3) -> dict:
    """Host-clock ms of the forward's stages on one batch (each ended by
    a device sync; the best of ``repeats``): stage 1 builds the structures,
    stage 2 runs the FC dataflows, the tail is the global pool and head."""
    import torch
    from repro_torch.core.mlp import apply_mlp
    from repro_torch.engine import archs
    ctx = archs.EngineCtx.make("lpcn", "cuda")
    best = {}
    for _ in range(repeats):
        t0 = time.perf_counter()
        structs, nv = archs._structure_stack_b(spec, ctx, batch.xyz,
                                               batch.keys, batch.n_valid)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cx, cf = archs._compute_stack_b(params, spec, ctx, batch.xyz,
                                        batch.feats, structs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        apply_mlp(params.head, archs._global_pool_b(params, cx, cf, nv[-1]))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in (("structure_ms", t1 - t0), ("fc_ms", t2 - t1),
                     ("pool_head_ms", t3 - t2)):
            best[k] = min(best.get(k, float("inf")), v * 1e3)
    return best


def trace_requests(seed, trace=SERVE_TRACE):
    """The serving trace's events, one synthetic cloud per event, and the
    default key the server gives each rid (``fold_in(PRNGKey(seed),
    rid)``)."""
    import numpy as np
    import torch
    from repro_torch import random
    from repro_torch.data.synthetic import make_cloud
    from repro_torch.serve import synthetic_trace
    events = synthetic_trace(**trace, seed=seed)
    rng = np.random.default_rng(seed)
    clouds = [make_cloud(rng, e.n_points) for e in events]
    keys = random.fold_in(random.PRNGKey(seed), torch.arange(len(events)))
    return events, clouds, keys


def serve_run(engine, params, buckets, events, clouds, seed, **kw) -> dict:
    """Replay the trace once through a fresh ``PCNServer`` (its buckets
    warmed at construction) with the launch counts set to 0 just before
    the replay and read just after; take every response, exactly once.
    -> dict(server, report, responses by rid, launches, warm_s, replay_s)."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve import PCNServer, UnknownRequestError, replay
    t0 = time.perf_counter()
    server = PCNServer(engine, params, buckets, timeout_s=SERVE_TIMEOUT_S,
                       seed=seed, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rids = replay(server, events, lambda n, i: (clouds[i], None))
    server.close()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check(rids == list(range(len(events))),
          f"requests refused at admission: {rids}")
    responses = {}
    for rid in rids:
        responses[rid] = server.take(rid)    # a failed one raises here
        try:
            server.take(rid)
        except UnknownRequestError:
            pass
        else:
            check(False, f"rid {rid} answered twice")
    check(server.pending() == 0, "requests left pending after drain")
    return dict(server=server, report=server.report(), responses=responses,
                launches=launches, warm_s=warm_s, replay_s=replay_s)


def check_responses(name, responses, refs) -> float:
    """Every response within TOL·max(1, max|ref|) of its reference;
    -> the largest max |Δ|."""
    import torch
    worst = 0.0
    for rid, got in responses.items():
        check(got.shape == tuple(refs[rid].shape),
              f"{name}: rid {rid} has shape {got.shape}")
        err, tol = close(torch.from_numpy(got), refs[rid])
        check(err <= tol, f"{name}: rid {rid} max|err| {err} > {tol}")
        worst = max(worst, err)
    return worst


def serve_line(name, run, smi, rate_hz, max_abs_err) -> str:
    rep = run["report"]
    lat = rep["latency_ms"]
    return json.dumps({name: {
        "device": smi, "requests": rep["requests"],
        "rate_hz": rate_hz, "timeout_ms": rep["timeout_ms"],
        "dispatch_mode": rep["dispatch_mode"],
        "max_in_flight": rep["max_in_flight"],
        "e2e_ms": {q: lat["e2e"][q] for q in ("p50", "p95", "p99")},
        "queue_wait_ms": {q: lat["queue_wait"][q] for q in ("p50", "p99")},
        "service_ms": {q: lat["service"][q] for q in ("p50", "p99")},
        "throughput_rps": rep["throughput_rps"],
        "padding_waste_pct": rep["padding_waste_pct"],
        "dispatches": rep["dispatches"],
        "partial_batches": rep["partial_batches"],
        "per_bucket": rep["per_bucket"], "overlap": rep["overlap"],
        "faults": rep["faults"], "launches": run["launches"],
        "warm_s": run["warm_s"], "replay_s": run["replay_s"],
        "max_abs_err": max_abs_err}})


def serve_phase(spec, engine, reference, params, seed, smi,
                trace=SERVE_TRACE, bucket_sizes=SERVE_BUCKETS,
                batch=B) -> dict:
    """The main path: the trace through ``PCNServer`` async, sync and
    under chaos, each run checked (answers, launches, faults, values).
    -> dict(launches of the async run, phase times)."""
    import torch
    from repro_torch.serve import BucketSet, FaultPlan
    buckets = BucketSet.make(bucket_sizes, batch=batch)
    events, clouds, keys = trace_requests(seed, trace)
    n_blocks = len(spec.blocks)
    off_path = ("knn", "flash_attention", "ssd_chunk")
    times = {}

    def check_launches(name, launches, primary_runs):
        want = n_blocks * primary_runs
        check(launches["gather_mlp"] == launches["hub_reuse"] == want
              and not any(launches[k] for k in off_path),
              f"{name}: launches {launches}, expected gather_mlp == "
              f"hub_reuse == {want} and no entry kernel")

    runs = {}
    for name, kw in (("serve_async", dict(max_in_flight=4)),
                     ("serve_sync", dict(sync=True))):
        run = runs[name] = serve_run(engine, params, buckets, events, clouds,
                                     seed, **kw)
        rep = run["report"]
        check(not any(rep["faults"].values()),
              f"{name}: a healthy run degraded or failed: {rep['faults']}")
        check_launches(name, run["launches"], rep["dispatches"])
        times[f"{name}_s"] = run["replay_s"]
    # references after the counted runs: apply_single launches at B = 1
    t0 = time.perf_counter()
    refs = {rid: engine.apply_single(params, clouds[rid], key=keys[rid])
            .cpu() for rid in range(len(events))}
    times["apply_single_refs_s"] = time.perf_counter() - t0
    for name, run in runs.items():
        err = check_responses(name, run["responses"], refs)
        log(serve_line(name, run, smi, trace["rate_hz"], err))

    plan = FaultPlan.parse(SERVE_CHAOS)
    run = serve_run(engine, params, buckets, events, clouds, seed,
                    faults=plan, fallback="reference")
    rep, server = run["report"], run["server"]
    times["serve_chaos_s"] = run["replay_s"]
    check(plan.injected == [(1, "fail"), (3, "nan")],
          f"serve_chaos: injected {plan.injected}")
    check(rep["faults"]["degraded_dispatches"] == 2
          and rep["faults"]["failed_requests"] == 0
          and rep["faults"]["breaker_opened"] == 0,
          f"serve_chaos: faults {rep['faults']}, expected 2 degraded")
    # every dispatch tried the kernels but the failed one; the nan one
    # launched them before its output was poisoned
    check_launches("serve_chaos", run["launches"], rep["dispatches"] - 1)
    # a degraded batch's requests share its (bucket, start, done) stamps
    degraded = {(d.bucket, d.t_start, d.t_done)
                for d in server.metrics.dispatches if d.degraded}
    deg_rids = [r.rid for r in server.metrics.requests
                if (r.bucket, r.t_dispatch, r.t_done) in degraded]
    check(len(deg_rids) == sum(d.n_requests for d in server.metrics
                               .dispatches if d.degraded),
          "serve_chaos: degraded requests not matched to their batches")
    ref_refs = {rid: reference.apply_single(params, clouds[rid],
                                            key=keys[rid]).cpu()
                for rid in deg_rids}
    err = max(check_responses("serve_chaos degraded",
                              {r: run["responses"][r] for r in deg_rids},
                              ref_refs),
              check_responses("serve_chaos", {
                  r: v for r, v in run["responses"].items()
                  if r not in ref_refs}, refs))
    log(serve_line("serve_chaos", run, smi, trace["rate_hz"], err))
    log(f"serve_chaos: degraded rids {deg_rids} held against the "
        f"reference backend")
    return dict(launches=runs["serve_async"]["launches"], times=times)


def cli_phase(smi) -> float:
    """``python -m repro_torch.launch.serve --arch pointnet2_c --trace 16``
    in a subprocess: exit 0, every request answered, no fault; -> s."""
    out = ROOT / "build" / "serve_cli.json"
    out.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "pointnet2_c", "--trace", str(CLI_TRACE), "--serve-json", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    dt = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"cli: {line}")
    check(res.returncode == 0, f"the serving CLI exited {res.returncode}:\n"
          f"{res.stderr[-3000:]}")
    rep = json.loads(out.read_text())
    check(rep["answered"] == CLI_TRACE and not any(rep["faults"].values()),
          f"the serving CLI answered {rep['answered']}/{CLI_TRACE}, faults "
          f"{rep['faults']}")
    check(smi.startswith(rep["device"]),
          f"the CLI ran on {rep['device']}, not on {smi}")
    return dt


def structure_card_vs_cpu(spec, batch) -> dict:
    """Stage 1 of one batch on the card against the same code on the CPU,
    where the tests hold it bit-equal to the JAX package: mismatching
    entries per structure field (a near-tie rounded differently on the
    card shows here)."""
    from repro_torch.engine import archs
    ctx = archs.EngineCtx.make("lpcn", "cuda")
    card, _ = archs._structure_stack_b(spec, ctx, batch.xyz, batch.keys,
                                       batch.n_valid)
    host_b = batch.to("cpu")
    host, _ = archs._structure_stack_b(spec, ctx, host_b.xyz, host_b.keys,
                                       host_b.n_valid)
    diff = {}
    for i, (c, h) in enumerate(zip(card, host), 1):
        for name, x, y in (
                ("center_idx", c.center_idx, h.center_idx),
                ("nbr", c.nbr, h.nbr),
                ("members", c.islands.members, h.islands.members),
                ("reuse_slot", c.schedule.reuse_slot, h.schedule.reuse_slot)):
            diff[f"blk{i}.{name}"] = int((x.cpu() != y).sum())
    return diff


def device_profile(serve, batch) -> dict:
    """torch.profiler over one forward: the summed time of the kernels
    that ran on the device, the profiled host wall time, and the kernels
    that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kern)
    by_name: dict = {}
    for e in kern:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"profiled_wall_ms": wall_us / 1e3, "kernel_launches": len(kern),
            "device_busy_ms": busy_us / 1e3,
            "top": [{"name": k[:70], "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


def knn_mismatch(d, i, d_ref, i_ref, d_next) -> tuple[float, float, int,
                                                     int]:
    """(max|Δd|, tolerance, index mismatches, index mismatches where the
    order is decided: the sorted distance differs from both neighbours in
    its row by more than the tolerance).  ``d_next`` (S, 1) is the
    (k+1)-th distance, +inf when k = N, which the k-th must clear."""
    import torch
    tol = 1e-5 * max(1.0, d_ref.abs().max().item())
    ext = torch.cat([d_ref, d_next], 1)
    gap = (ext[:, 1:] - ext[:, :-1]).abs() > tol
    decided = torch.cat([torch.ones_like(gap[:, :1]), gap[:, :-1]], 1) & gap
    wrong = i != i_ref
    return ((d - d_ref).abs().max().item(), tol, int(wrong.sum()),
            int((wrong & decided).sum()))


def flash_flops(b, hq, sq, skv, d, causal) -> float:
    """2·D flops per (query, visible key) pair for each of q·kᵀ and p·v."""
    if causal:                         # top-left: row i sees min(i+1, Skv)
        m = min(sq, skv)
        pairs = m * (m + 1) // 2 + (sq - m) * skv
    else:
        pairs = sq * skv
    return 4.0 * b * hq * pairs * d


def flash_err(out, ref) -> dict:
    """max |out − ref|, |ref| where it sits, and ‖out − ref‖ / ‖ref‖."""
    diff = (out.float() - ref.float()).flatten()
    i = diff.abs().argmax()
    return dict(max_abs_err=diff[i].abs().item(),
                ref_at_max=ref.flatten()[i].abs().item(),
                rel_err=(diff.norm() / ref.float().norm()).item())


def at_offset(t, off):
    """``t`` copied into a flat buffer at an offset of ``off`` elements: a
    contiguous operand whose address is not 16-byte aligned."""
    flat = t.new_empty(t.numel() + off)
    view = flat[off:].view(t.shape)
    view.copy_(t)
    return view


def entry_inputs(gen, dev):
    """Full-width inputs of flash_attention (bf16, the same bf16 at an
    address off 16 bytes, f32) and ssd_chunk, drawn on the card from
    ``gen``; ssd as tests/test_kernels.py draws them (dt in [0.1, 1], cum
    a negative cumulative sum over the chunk)."""
    import torch
    f = QWEN2_72B
    qkv = {}
    for dt in (torch.bfloat16, torch.float32):
        qkv[str(dt).replace("torch.", "")] = tuple(
            torch.randn((f["b"], h, f["s"], f["d"]), generator=gen,
                        device=dev).to(dt)
            for h in (f["hq"], f["hkv"], f["hkv"]))
    qkv["bfloat16_unaligned"] = tuple(at_offset(t, 1)
                                      for t in qkv["bfloat16"])
    m = MAMBA2_2P7B
    lead = (m["bs"], m["nc"], m["q"])
    u = lambda lo, hi, shape: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device=dev)
    ssd = (torch.randn((*lead, m["h"], m["p"]), generator=gen, device=dev),
           torch.randn((*lead, m["s"]), generator=gen, device=dev),
           torch.randn((*lead, m["s"]), generator=gen, device=dev),
           u(0.1, 1.0, (*lead, m["h"])),
           -torch.cumsum(u(0.01, 0.2, (*lead, m["h"])), dim=2))
    return qkv, ssd


def entry_phase(dev, seed, spec, batch):
    """The three entry-point kernels.  Drive each once at full width with
    the launch counts reset (knn on stage 1 of ``batch``: every cloud, both
    blocks; flash_attention at a Qwen2-72B layer in bf16, unaligned bf16
    and f32; ssd_chunk
    at Mamba2-2.7B), read the counts, then hold each output against its
    plain version, run the ragged parity cases and time every shape.
    -> (launch counts, parity rows, kernel rows without launches)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.engine import archs
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ops import _variant
    from repro_torch.kernels.knn import knn, knn_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref
    ctx = archs.EngineCtx.make("lpcn", "cuda")
    structs, _ = archs._structure_stack_b(spec, ctx, batch.xyz, batch.keys,
                                          batch.n_valid)
    nv = batch.n_valid.tolist()
    knn_calls = {
        "blk1": [(structs[0].center_xyz[i].contiguous(),
                  batch.xyz[i, :nv[i]].contiguous(), spec.blocks[0].k)
                 for i in range(len(nv))],
        "blk2": [(structs[1].center_xyz[i].contiguous(),
                  structs[0].center_xyz[i].contiguous(), spec.blocks[1].k)
                 for i in range(len(nv))]}
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv, ssd_args = entry_inputs(gen, dev)
    torch.cuda.synchronize()

    # ---- the entry points, once each, counted ---------------------------
    kernels.reset_launch_counts()
    knn_out = {blk: [knn(*a) for a in calls]
               for blk, calls in knn_calls.items()}
    flash_out = {key: flash_attention(*a, causal=True)
                 for key, a in qkv.items()}
    ssd_out = ssd_chunk(*ssd_args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for name in ("knn", "flash_attention", "ssd_chunk"):
        check(launches[name] >= 1, f"{name} did not launch in its phase")
    check(launches["gather_mlp"] == launches["hub_reuse"] == 0,
          f"FC kernels launched in the entry phase: {launches}")
    routes = {v: kernels.LAUNCHES[f"flash_attention_{v}"]
              for v in ("wgmma", "simt")}
    check(routes == {"wgmma": 1, "simt": 2}, f"flash_attention routes "
          f"{routes}: bf16 should take wgmma, unaligned bf16 and f32 simt")

    parity, rows = [], []
    src = "src/repro_torch/csrc/"
    # ---- knn --------------------------------------------------------------
    for i_blk, (blk, calls) in enumerate(knn_calls.items()):
        err, tol, wrong, decided_wrong, vs_stage1 = 0.0, 0.0, 0, 0, 0
        for cloud, (args, (d, i)) in enumerate(zip(calls, knn_out[blk])):
            c, p, k = args
            d_ext, i_ext = knn_ref(c, p, min(k + 1, p.shape[0]))
            d_next = (d_ext[:, k:] if k < p.shape[0]
                      else torch.full_like(d_ext[:, :1], float("inf")))
            e, t, w, dw = knn_mismatch(d, i, d_ext[:, :k], i_ext[:, :k],
                                       d_next)
            check(e <= t, f"knn {blk} cloud {cloud}: max|err| {e} > {t}")
            err, tol = max(err, e), max(tol, t)
            wrong, decided_wrong = wrong + w, decided_wrong + dw
            nbr = structs[i_blk].nbr[cloud]
            vs_stage1 += int((nbr != i.long()).any(-1).sum())
        parity.append(dict(name="knn", block=blk, max_abs_err=err, tol=tol,
                           idx_mismatch=wrong,
                           idx_mismatch_decided=decided_wrong,
                           rows_differing_from_stage1_nbr=vs_stage1))
        check(decided_wrong == 0, f"knn {blk}: {decided_wrong} indices "
              f"differ where the distance order is decided")
        ms, plain_ms = time_pair(lambda: [knn(*a) for a in calls],
                                 lambda: [knn_ref(*a) for a in calls])
        n_pts = [a[1].shape[0] for a in calls]
        s, k = calls[0][0].shape[0], calls[0][2]
        # 9 flops a (center, point) pair: c·p and the expanded form
        flops = sum(9.0 * s * n for n in n_pts)
        nbytes_ = sum(4 * (3 * s + 3 * n + 2 * s * k) for n in n_pts)
        bms, by = bound(flops, nbytes_)
        rows.append(dict(
            name="knn", block=blk, route="cuda", source=src + "knn.cu",
            replaces="src/repro/kernels/knn/knn.py:86",
            shape=f"{len(calls)} calls, one per cloud: S={s} "
                  f"N={min(n_pts)}..{max(n_pts)} k={k}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None))
    # ---- flash_attention ---------------------------------------------------
    f = QWEN2_72B
    for name, (q, k, v) in qkv.items():
        dt = q.dtype
        variant = _variant(dt, f["d"], [t.data_ptr() for t in (q, k, v)])
        tol, rel_tol = FLASH_TOL[str(dt).replace("torch.", "")]
        e = flash_err(flash_out[name], attention_ref(q, k, v, causal=True))
        err = e["max_abs_err"]
        parity.append(dict(name="flash_attention", shape="qwen2_72b",
                           dtype=name, variant=variant, causal=True, **e,
                           tol=tol, rel_tol=rel_tol))
        check(bool(torch.isfinite(flash_out[name]).all()),
              f"flash_attention {name}: non-finite")
        check(err <= tol and e["rel_err"] <= rel_tol,
              f"flash_attention {name}: {e}, limits {tol}, {rel_tol}")
        t = time_turns({
            "plain": lambda: attention_ref(q, k, v, causal=True),
            "kernel": lambda: flash_attention(q, k, v, causal=True),
            "library": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)}, iters=10)
        flops = flash_flops(f["b"], f["hq"], f["s"], f["s"], f["d"], True)
        bms, by = bound(flops, nbytes(q, k, v, flash_out[name]),
                        PEAK_BF16 if dt == torch.bfloat16 else PEAK_FP32)
        rows.append(dict(
            name="flash_attention", block=f"qwen2_72b_{name}", route="cuda",
            variant=variant, tflops=flops / t["kernel"] / 1e9,
            source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/"
                     "flash_attention.py:77",
            shape=f"B={f['b']} Hq={f['hq']} Hkv={f['hkv']} Sq=Skv={f['s']} "
                  f"D={f['d']} causal {name}",
            max_abs_err=err, rel_err=e["rel_err"], ms=t["kernel"],
            plain_ms=t["plain"],
            bound_ms=bms, bound_by=by, library_ms=t["library"]))
    for b, hq, hkv, sq, skv, d, causal, name in FLASH_PARITY:
        dt = getattr(torch, name)
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dt)
        variant = _variant(dt, d, [t.data_ptr() for t in (q, k, v)])
        before = kernels.LAUNCHES[f"flash_attention_{variant}"]
        out = flash_attention(q, k, v, causal=causal)
        check(kernels.LAUNCHES[f"flash_attention_{variant}"] == before + 1,
              f"flash_attention parity D={d} {name}: not on route {variant}")
        ref = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "flash_attention: non-finite")
        e = flash_err(out, ref)
        tol, rel_tol = FLASH_TOL[name]
        parity.append(dict(name="flash_attention",
                           shape=f"B={b} Hq={hq} Hkv={hkv} Sq={sq} "
                                 f"Skv={skv} D={d}",
                           dtype=name, variant=variant, causal=causal, **e,
                           tol=tol, rel_tol=rel_tol))
        check(e["max_abs_err"] <= tol and e["rel_err"] <= rel_tol,
              f"flash_attention parity {parity[-1]['shape']} {name} "
              f"causal={causal}: {e}, limits {tol}, {rel_tol}")
    # ---- ssd_chunk ---------------------------------------------------------
    m = MAMBA2_2P7B
    y, st = ssd_out
    y_ref, st_ref = ssd_chunk_ref(*ssd_args)
    err, tol = 0.0, 0.0
    for part, out, ref in (("y_in", y, y_ref), ("states", st, st_ref)):
        e = (out - ref).abs().max().item()
        t = 2e-4 * max(1.0, ref.abs().max().item())
        parity.append(dict(name="ssd_chunk", shape="mamba2_2p7b", part=part,
                           max_abs_err=e, tol=t))
        check(e <= t, f"ssd_chunk {part}: max|err| {e} > {t}")
        err, tol = max(err, e), max(tol, t)
    ms, plain_ms = time_pair(lambda: ssd_chunk(*ssd_args),
                             lambda: ssd_chunk_ref(*ssd_args))
    bn, q, h, p, s = m["bs"] * m["nc"], m["q"], m["h"], m["p"], m["s"]
    # C·Bᵀ once a chunk; M·x over the q(q+1)/2 pairs i >= j and the state
    # product per head
    flops = 2.0 * bn * (q * q * s + h * p * (q * (q + 1) // 2 + s * q))
    bms, by = bound(flops, nbytes(*ssd_args, y, st))
    rows.append(dict(
        name="ssd_chunk", block="mamba2_2p7b", route="cuda",
        source=src + "ssd_chunk.cu",
        replaces="src/repro/kernels/ssd_chunk/ssd_chunk.py:64",
        shape=f"bs={m['bs']} nc={m['nc']} q={q} H={h} P={p} S={s}",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None))
    return launches, parity, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one lpcn forward with torch.profiler")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels, random
    from repro_torch.device import resolve_device
    from repro_torch.engine import Batch, PCNEngine
    from repro_torch.models.pointnet2 import POINTNET2_C

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device()
    phases = {}

    t = time.perf_counter()
    kernels.build_all()
    phases["build_s"] = time.perf_counter() - t
    log(f"build_s {phases['build_s']:.2f}")
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    hgmma = sass_count("flash_attention", "HGMMA")
    log(f"sass flash_attention: {hgmma} HGMMA instructions")
    check(hgmma > 0, "the flash_attention library has no HGMMA (wgmma)")
    for name in ("gather_mlp", "hub_reuse"):
        check(spilled_bytes(kernels.BUILD_LOG[name]) == 0,
              f"ptxas reports spills in {name}")
        hmma = sass_count(name, "HMMA", "TF32")
        log(f"sass {name}: {hmma} HMMA TF32 instructions")
        check(hmma > 0, f"the {name} library has no TF32 HMMA (mma.sync)")

    t = time.perf_counter()
    parity, rows, per_cloud = kernel_phase(dev, args.seed)
    phases["kernels_s"] = time.perf_counter() - t
    log(f"kernels_s {phases['kernels_s']:.2f}")
    log(json.dumps({"parity": parity}))
    log(json.dumps({"per_cloud": per_cloud}))

    # ---- the main path: the ported server on the card ------------------
    engine = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda")
    params = engine.init(seed=args.seed)
    # init leaves biases at zero; seeded nonzero biases keep the kernel
    # vs reference comparison from passing on exact zeros alone
    gen = torch.Generator().manual_seed(args.seed + 1)
    for mlp in (*params.blocks, params.global_mlp, params.head):
        for layer in mlp.layers:
            layer.b.copy_(0.1 * torch.randn(layer.b.shape, generator=gen))
    reference = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="reference")
    t = time.perf_counter()
    served = serve_phase(POINTNET2_C, engine, reference, params, args.seed,
                         smi.splitlines()[0])
    phases["serve_s"] = time.perf_counter() - t
    phases.update(served["times"])
    launches = served["launches"]
    log(f"serve_s {phases['serve_s']:.2f}; async run launches {launches}")
    phases["serve_cli_s"] = cli_phase(smi.splitlines()[0])

    # one (8, 1024) batch of the earlier slices' requests (the same clouds
    # and keys), input of the stage times and the phases below
    rng = np.random.default_rng(args.seed)
    batch = Batch.from_clouds(
        make_requests(rng, B), key=random.fold_in(
            random.PRNGKey(args.seed, dev), torch.arange(B, device=dev)),
        n_pad=N_PAD, device=dev)
    err, tol = close(engine.apply(params, batch),
                     reference.apply(params, batch))
    log(f"lpcn cuda vs reference: max|err| {err:.3g} (tol {tol:.3g})")
    check(err <= tol, "lpcn logits disagree with the reference backend")
    stages = breakdown(params, POINTNET2_C, batch)
    log(json.dumps({"lpcn_stages_ms": stages}))
    mismatch = structure_card_vs_cpu(POINTNET2_C, batch)
    log(json.dumps({"structure_card_vs_cpu_mismatches": mismatch}))
    check(not any(mismatch.values()),
          f"stage 1 on the card differs from the CPU, which the tests hold "
          f"bit-equal to JAX: {mismatch} (near-tie order, ROADMAP queue 3)")
    if args.profile:
        log(json.dumps({"lpcn_profile": device_profile(
            lambda b: engine.apply(params, b), batch)}))

    # ---- traditional mode: one batch ------------------------------------
    trad = PCNEngine(POINTNET2_C, mode="traditional", fc_backend="cuda")
    trad_ref = PCNEngine(POINTNET2_C, mode="traditional",
                         fc_backend="reference")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    lg = trad.apply(params, batch)
    torch.cuda.synchronize()
    phases["traditional_s"] = time.perf_counter() - t
    trad_launches = kernels.launch_counts()
    log(f"traditional_s {phases['traditional_s']:.3f}; launches "
        f"{trad_launches}")
    check(trad_launches == {**dict.fromkeys(trad_launches, 0),
                            "gather_mlp": len(POINTNET2_C.blocks)},
          "traditional launch counts")
    check(bool(torch.isfinite(lg).all()), "non-finite traditional logits")
    err, tol = close(lg, trad_ref.apply(params, batch))
    log(f"traditional cuda vs reference: max|err| {err:.3g} "
        f"(tol {tol:.3g})")
    check(err <= tol, "traditional logits disagree with the reference")

    # ---- entry kernels: knn, flash_attention, ssd_chunk -----------------
    t = time.perf_counter()
    entry_launches, entry_parity, entry_rows = entry_phase(
        dev, args.seed, POINTNET2_C, batch)
    phases["entry_s"] = time.perf_counter() - t
    log(f"entry_s {phases['entry_s']:.2f}; launches {entry_launches}")
    log(json.dumps({"entry_parity": entry_parity}))

    # the per-cloud entries (B = 1) are the same kernels: each wrapper
    # counts its kernel's launches whatever the shape
    rows += per_cloud
    for row in rows:
        row["launches"] = launches[row["name"]]
    for row in entry_rows:
        row["launches"] = entry_launches[row["name"]]
    rows += entry_rows
    log(json.dumps({"phases_s": phases}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
