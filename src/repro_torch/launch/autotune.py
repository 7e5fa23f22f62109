"""Measurement-driven tile plans for the two FC kernels on a card.

The port's counterpart of ``repro.launch.autotune``.  Per ``(kernel, B,
shape)`` cell the tuner lists the candidate plans (:func:`candidate_plans`:
the heuristic's knob first, then each other knob value that fits a
block's shared memory, then one launch per cloud), times them on the card
with CUDA events (:func:`measure`: warmed, the minimum over reps),
re-times the fastest few interleaved with the per-cloud launch, and
records the winner in the card-keyed store of ``repro_torch.kernels.plans``
(``results/tile_plans_torch.json``).  The wrappers consult that store on
every call without an explicit knob, so each later forward at a tuned
shape on that card launches the measured winner.

A candidate is promoted only if it fits by ``repro_torch.kernels.tiling``
(the first filter), if its launch passes the K001–K005 rules of
``repro_torch.analysis`` (as the JAX package lints each winner before it
promotes it; on the card K001 also holds tiling.py's shared-memory count
to the library's own, ``gather_mlp_smem_bytes`` /
``hub_reuse_smem_bytes``), and if its output
on the cell's inputs lies within 1e-4·max(1, max|ref|) of the heuristic
plan's (``rows`` and ``chunk`` change no sum's order and come out
bit-equal; ``nsplit`` sums H's partials in another grouping).

Model cells come from running the port's forward once under
``plans.bypass()`` and ``plans.capture()``: the tuner sees exactly the
calls the serving path makes, so the store's keys match on lookup.

    PYTHONPATH=src python -m repro_torch.launch.autotune \\
        --models pointnet2_c --batches 2,8 --points 1024 \\
        --out results/tile_plans_torch.json

It runs on the card and raises without one; there is no CPU timing.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import plans, tiling

#: the top FINALISTS screened candidates that pass the gate are re-timed
#: interleaved with the per-cloud launch for FINAL_PASSES passes
FINALISTS = 3
FINAL_PASSES = 4
TOL = 1e-4
BIG = 3.4e38
PER_CLOUD = {"variant": "per_cloud"}


def card_sms(device=None) -> int:
    """SMs of the CUDA device (the heuristic's input)."""
    return torch.cuda.get_device_properties(
        resolve_device(device)).multi_processor_count


def heuristic_knobs(kernel: str, dims: dict, sms: int) -> dict:
    """The knob the heuristic sets for the cell on a card of ``sms`` SMs
    (always candidate 0, so the winner never loses to the default)."""
    if kernel == "hub_reuse":
        if not tiling.knobs_of(kernel, dims, sms):      # the layered route
            return {}
        return {"chunk": tiling.hub_reuse_chunk(
            *(dims[n] for n in ("c", "m", "k", "d")), dims.get("h"))}
    shape = [dims[n] for n in ("b", "s", "k", "d", "dc", "h", "f")]
    way = tiling.route(*shape[2:])
    if way == "linear":
        return {"rows": tiling.linear_plan(*shape[:3], shape[-1], sms)
                ["rows"]}
    if way == "narrow":
        return {"rows": tiling.narrow_rows(*shape, sms)}
    return {"nsplit": tiling.wide_plan(*shape, sms)["nsplit"]}


def _launch_sig(kernel: str, dims: dict, knobs: dict, sms: int) -> tuple:
    """What a plan launches: candidates with equal signatures are one."""
    if "variant" in knobs:
        return ("per_cloud",)
    if kernel == "hub_reuse":
        if "chunk" not in knobs:
            return ("layered",)
        return tuple(64 if r <= 64 else 128
                     for r in tiling.hub_reuse_launches(dims["c"],
                                                        knobs["chunk"]))
    if "rows" in knobs:
        return ("rows", knobs["rows"])
    shape = [dims[n] for n in ("b", "s", "k", "d", "dc", "h", "f")]
    return ("nsplit", tiling.wide_plan(*shape, sms, knobs["nsplit"])
            ["nsplit"])


def candidate_plans(kernel: str, dims: dict, budget: int = 16,
                    sms: int | None = None) -> list:
    """The heuristic's knob, then each other value of the call's knob that
    fits (:func:`repro_torch.kernels.tiling.feasible`), at most ``budget``
    of them, then ``{"variant": "per_cloud"}``; a plan that launches what
    an earlier one does is dropped.  ``sms`` defaults to the card's."""
    sms = card_sms() if sms is None else sms
    out, seen = [], set()

    def admit(knobs):
        sig = _launch_sig(kernel, dims, knobs, sms)
        if sig in seen or not tiling.feasible(kernel, dims, knobs, sms):
            return
        seen.add(sig)
        out.append(knobs)

    admit(heuristic_knobs(kernel, dims, sms))
    values = {"rows": tiling.ROWS, "chunk": tiling.CHUNKS,
              "nsplit": range(1, tiling.wide_chunks(dims.get("h", 1)) + 1)}
    for name in tiling.knobs_of(kernel, dims, sms):   # none: hub layered
        for v in values[name]:
            admit({name: int(v)})
    out = out[:max(int(budget), 1)]
    if tiling.feasible(kernel, dims, {}, sms):   # the heuristic's, at B=1
        out.append(dict(PER_CLOUD))
    return out


# ---- the cell's operands and calls -----------------------------------------

def synth_cell_args(kernel: str, dims: dict, seed: int = 0, device=None):
    """Seeded operands of one cell, drawn on ``device`` (the card by
    default), masked as the serving path passes them."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    b, d, h, f = dims["b"], dims["d"], dims["h"], dims["f"]
    if h == 0:                  # one layer (either kernel)
        weights = (r(d, f, scale=(2 / d) ** .5), r(f, scale=.1))
    else:
        weights = (r(d, h, scale=(2 / d) ** .5), r(h, scale=.1),
                   r(h, f, scale=(2 / h) ** .5), r(f, scale=.1))
    if kernel == "gather_mlp":
        s, k = dims["s"], dims["k"]
        mask = torch.rand((b, s, k), generator=g, device=dev) < 0.8
        mask[:, ::7] = False                  # whole subsets dead
        return {"data": (r(b, s, k, d), r(b, s, dims["dc"])),
                "weights": weights, "mask": mask}
    hn, c, m, k = dims["hn"], dims["c"], dims["m"], dims["k"]
    slot = torch.randint(-1, c, (b, hn, m, k), generator=g, device=dev,
                         dtype=torch.int32)
    slot[:, :, ::9] = -1                      # subsets with no cached slot
    live = torch.rand((b, hn, m, k), generator=g, device=dev) < 0.9
    return {"data": (r(b, hn, c, d), slot, r(b, hn, m, f, scale=.01)),
            "weights": weights, "mask": live}


def cell_call(kernel: str, args: dict, knobs: dict):
    """A zero-argument call of the kernel's wrapper on the cell's operands
    under the plan ``knobs`` (``{"rows": …}``, ``{"variant": …}``, …)."""
    from ..kernels.gather_mlp import gather_mlp
    from ..kernels.hub_reuse import hub_reuse
    kw = dict(knobs)
    w = args["weights"]
    if kernel == "gather_mlp":
        raw, ctr = args["data"]
        return lambda: gather_mlp(raw, ctr, *w, mask=args["mask"], **kw)
    pool, slot, comp = args["data"]
    return lambda: hub_reuse(pool, slot, comp, *w, live=args["mask"], **kw)


def measure(call, reps: int = 5, inner: int = 10) -> float:
    """ms a call on the card: CUDA events around ``inner`` calls, after a
    warm-up, the minimum over ``reps``."""
    if not torch.cuda.is_available():
        raise RuntimeError("autotune measures on a CUDA device and none is "
                           "available (there is no CPU timing)")
    call()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(int(reps), 1)):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(inner):
            call()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1) / inner)
    return best


def compare(out, ref) -> tuple:
    """(max |out − ref| off the -BIG identity, limit 1e-4·max(1,
    max|ref|), bit-equal); inf where the -BIG entries differ."""
    sentinel = ref <= -BIG / 2
    if not torch.equal(out <= -BIG / 2, sentinel):
        return float("inf"), TOL, False
    rest = ~sentinel
    if not bool(rest.any()):
        return 0.0, TOL, bool(torch.equal(out, ref))
    err = (out[rest] - ref[rest]).abs().max().item()
    lim = TOL * max(1.0, ref[rest].abs().max().item())
    return err, lim, bool(torch.equal(out, ref))


def lint_knobs(kernel: str, dims: dict, knobs: dict, sms: int,
               device) -> tuple:
    """The launch the plan ``knobs`` makes for the cell on a card of
    ``sms`` SMs and its K001–K005 findings (``repro_torch.analysis``) ->
    ``(site, findings)``.  On the card the library answers for its own
    shared memory (``site.smem_library``, which K001 holds to tiling.py's
    ``site.smem``) and wide plan.  A finding disqualifies the plan from
    promotion."""
    from ..analysis.kernels import lint_plan
    return lint_plan(kernel, dims, knobs, sms=sms,
                     card=torch.device(device).type == "cuda")


def smem_counts(kernel: str, dims: dict, knobs: dict, sms: int,
                device) -> tuple:
    """(shared-memory bytes of the plan's largest launch by tiling.py, by
    the library; None off the card): :func:`lint_knobs`'s site."""
    site, _ = lint_knobs(kernel, dims, knobs, sms, device)
    return site.smem, site.smem_library


def autotune_cell(kernel: str, dims: dict, *, budget: int = 16,
                  reps: int = 5, seed: int = 0,
                  store: plans.PlanStore | None = None, timer=None,
                  log=None, device=None, sms: int | None = None) -> dict:
    """Tune one cell on ``device`` (the card by default) and record the
    winner in ``store`` keyed by that device.

    ``timer(call, knobs) -> ms`` is injectable (the tests give a cost
    model); the default is :func:`measure`.  A screening pass times every
    candidate once and runs the gate (no K001–K005 finding on its launch,
    :func:`lint_knobs`, which on the card holds tiling.py's shared memory
    to the library's; the output within the limit of the heuristic
    plan's);
    the fastest :data:`FINALISTS` that pass are re-timed interleaved with
    the per-cloud launch for :data:`FINAL_PASSES` passes, min-merged.
    Where the per-cloud launch beats every finalist, the cell records
    ``{"variant": "per_cloud"}``; a cell whose route has no knob
    (hub_reuse's layered route) records nothing else, its heuristic
    being its only batched plan.  The entry carries the measurement:
    every candidate's ms, difference from the heuristic's output,
    bit-equality and shared memory, the heuristic's and the per-cloud
    ms, and the card."""
    device = resolve_device(device)
    if sms is None:
        sms = card_sms(device)
    store = store if store is not None else plans.active_store()
    dims = {k: int(v) for k, v in dims.items()}
    args = synth_cell_args(kernel, dims, seed=seed, device=device)
    if timer is None:
        timer = lambda call, knobs: measure(call, reps=reps)  # noqa: E731
    key = plans.plan_key(kernel, dims)

    cands = candidate_plans(kernel, dims, budget, sms)
    base = cell_call(kernel, args, cands[0])()
    rows, timed = [], []
    for knobs in cands:
        call = cell_call(kernel, args, knobs)
        try:
            ms = float(timer(call, knobs))
            err, lim, same = compare(call(), base)
        except (RuntimeError, ValueError) as e:
            if log:
                log(f"  {key}: candidate {knobs} failed: "
                    f"{type(e).__name__}: {e}")
            continue
        site, lint = lint_knobs(kernel, dims, knobs, sms, device)
        gate = None
        if lint:       # K001 holds tiling.py's smem to the library's too
            gate = "; ".join(f"{f.rule}: {f.message}" for f in lint)
        elif err > lim:
            gate = f"output {err:.3g} from the heuristic's, past {lim:.3g}"
        rows.append(dict(knobs=dict(knobs), ms=ms, max_diff=err,
                         bit_equal=same, smem=site.smem,
                         smem_library=site.smem_library,
                         rejected=gate))
        timed.append([ms, knobs, gate])
    if not timed or timed[0][1] is not cands[0]:
        raise RuntimeError(f"autotune: the heuristic plan of {key} did "
                           f"not run")
    heuristic_ms = timed[0][0]
    batched = [t for t in timed if "variant" not in t[1]]
    finalists = [t for t in sorted(batched, key=lambda t: t[0])
                 if t[2] is None][:FINALISTS]
    if not finalists:
        raise RuntimeError(f"autotune: no batched plan of {key} passes the "
                           f"gate: {[r['rejected'] for r in rows]}")
    per_cloud = next((t for t in timed if "variant" in t[1]), None)
    pc_ok = per_cloud is not None and per_cloud[2] is None
    pc_call = cell_call(kernel, args, PER_CLOUD) if pc_ok else None
    calls = [cell_call(kernel, args, t[1]) for t in finalists]
    for _ in range(FINAL_PASSES):
        for t, call in zip(finalists, calls):
            t[0] = min(t[0], float(timer(call, t[1])))
        if pc_ok:
            per_cloud[0] = min(per_cloud[0], float(timer(pc_call,
                                                         PER_CLOUD)))
    ms, knobs, _ = min(finalists, key=lambda t: t[0])
    pc_ms = per_cloud[0] if per_cloud is not None else None
    context = dict(
        heuristic=dict(cands[0]), heuristic_ms=heuristic_ms,
        per_cloud_ms=pc_ms, batched_ms=ms, batched_winner=dict(knobs),
        candidates=rows, searched=len(rows), reps=reps, seed=seed,
        device=plans.device_name(device))
    if pc_ok and pc_ms < ms:
        entry = {**PER_CLOUD, "provenance": "autotuned", "measured_ms": pc_ms,
                 **context}
    else:
        entry = {**knobs, "provenance": "autotuned", "measured_ms": ms,
                 **context}
    if entry.get("variant") or knobs:
        store.record(kernel, dims, entry, device=device)
    if log:
        win = entry.get("variant") or knobs
        log(f"{key}: {win} -> {entry['measured_ms']:.4f} ms (heuristic "
            f"{cands[0]} {heuristic_ms:.4f} ms, per_cloud "
            f"{'-' if pc_ms is None else f'{pc_ms:.4f}'} ms)")
    return entry


def ensure_plan(kernel: str, dims: dict, *,
                store: plans.PlanStore | None = None, device=None,
                **tune_kw) -> dict:
    """The stored plan of a cell on ``device``, tuned first on a miss."""
    store = store if store is not None else plans.active_store()
    dims = {k: int(v) for k, v in dims.items()}
    hit = store.lookup(kernel, device=resolve_device(device), **dims)
    if hit is not None:
        return hit
    return autotune_cell(kernel, dims, store=store, device=device,
                         **tune_kw)


# ---- the cells of a model --------------------------------------------------

def model_cells(spec, batch: int, n: int, mode: str = "lpcn",
                seed: int = 0, device=None,
                fc_backend: str = "cuda") -> list:
    """The (kernel, dims) cells the port's forward at (spec, B, N) resolves
    plans for, in the order it launches them: the forward runs once, on
    seeded synthetic clouds, under ``plans.bypass()`` (so what the store
    holds changes nothing) and ``plans.capture()``."""
    from .. import random
    from ..data.synthetic import make_cloud
    from ..engine import Batch, apply, init
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    xyz = np.stack([make_cloud(rng, n) for _ in range(batch)])
    f_in = spec.in_feats
    feats = None if f_in <= 3 else np.concatenate(
        [xyz, rng.uniform(0, 1, (batch, n, f_in - 3)).astype(np.float32)],
        -1)
    b = Batch.make(xyz, feats, key=random.PRNGKey(seed, device),
                   device=device)
    params = init(spec, seed, device)
    with plans.bypass(), plans.capture() as used:
        apply(params, b, spec=spec, mode=mode, fc_backend=fc_backend,
              device=device)
    cells, seen = [], set()
    for rec in used:
        key = plans.plan_key(rec["kernel"], rec["dims"])
        if key not in seen:
            seen.add(key)
            cells.append((rec["kernel"], rec["dims"]))
    return cells


def autotune_model(spec, batch: int, n: int, mode: str = "lpcn", *,
                   store: plans.PlanStore | None = None,
                   skip_existing: bool = True, seed: int = 0, device=None,
                   **tune_kw) -> list:
    """Tune every cell the model's forward resolves at (B, N)."""
    store = store if store is not None else plans.active_store()
    device = resolve_device(device)
    entries = []
    for kernel, dims in model_cells(spec, batch, n, mode=mode, seed=seed,
                                    device=device):
        if skip_existing and store.lookup(kernel, device=device,
                                          **dims) is not None:
            continue
        entries.append(autotune_cell(kernel, dims, store=store, seed=seed,
                                     device=device, **tune_kw))
    return entries


# ---- CLI -------------------------------------------------------------------

def _resolve_spec(name: str, points: int, reduced: bool):
    from dataclasses import replace
    from ..models import MODEL_ZOO
    if name not in MODEL_ZOO:
        raise SystemExit(f"unknown model {name!r}; pick from "
                         f"{', '.join(sorted(MODEL_ZOO))}")
    _, spec = MODEL_ZOO[name]
    if reduced:
        spec = replace(spec, blocks=tuple(
            replace(b, n_centers=min(b.n_centers, max(points // 4, 16)),
                    k=min(b.k, 16)) for b in spec.blocks))
    return spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.autotune",
        description="measure the FC kernels' tile plans on the card and "
                    "keep the winners in the plan store the wrappers "
                    "consult")
    ap.add_argument("--models", default="pointnet2_c",
                    help="comma-separated MODEL_ZOO names")
    ap.add_argument("--batches", default="2,8",
                    help="comma-separated batch sizes (one cell set per B)")
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--mode", default="lpcn",
                    choices=("traditional", "lpcn"))
    ap.add_argument("--reduced", action="store_true",
                    help="shrink blocks like launch/serve --reduced")
    ap.add_argument("--budget", type=int, default=16,
                    help="most batched candidates timed per cell")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--retune", action="store_true",
                    help="re-measure cells already in the store")
    ap.add_argument("--out", default=None,
                    help=f"plan store path (default ${plans.ENV_VAR} or "
                         f"{plans.DEFAULT_PATH})")
    args = ap.parse_args(argv)

    device = resolve_device(None)
    out = args.out or plans.default_path()
    plans.configure(out)           # add to the store already there
    store = plans.active_store()
    n_before = len(store)
    for mname in args.models.split(","):
        spec = _resolve_spec(mname.strip(), args.points, args.reduced)
        for b in (int(x) for x in args.batches.split(",")):
            print(f"== autotune {mname} B={b} N={args.points} "
                  f"mode={args.mode} on {plans.device_name(device)} ==",
                  flush=True)
            autotune_model(spec, b, args.points, mode=args.mode,
                           store=store, skip_existing=not args.retune,
                           budget=args.budget, reps=args.reps,
                           seed=args.seed, device=device, log=print)
    path = store.save(out)
    print(f"plan store: {len(store)} entries "
          f"({len(store) - n_before} new) -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
