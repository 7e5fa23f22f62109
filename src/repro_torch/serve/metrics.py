"""Per-request latency accounting for the serving layer.

Every admitted request gets three timestamps — arrival (``submit``),
dispatch (its batch fired) and done (logits materialized) — from which
the report derives the three serving latencies:

    queue_wait = t_dispatch - t_arrival     (batching/timeout cost)
    service    = t_done     - t_dispatch    (engine execution, shared by
                                             the whole batch)
    e2e        = t_done     - t_arrival     (what the user sees)

reported as p50/p95/p99/mean/max in milliseconds, alongside throughput
(requests per second over the active window) and padding waste — the
fraction of padded (B, N) slots·rows that carried no real points, the
price of quantizing ragged traffic onto fixed bucket shapes.

With async dispatch, ``t_dispatch`` is stamped when execution actually
*begins* on an executor thread and ``t_done`` at completion — so
service time is attributed at completion, and time spent queued behind
a full in-flight table lands in queue-wait where it belongs.  The
``overlap`` report section quantifies the concurrency itself:
in-flight depth at fire time, busy time vs its interval union
(``overlap_pct``), and the device-idle gap the sync dispatcher pays.

The failure-handling layer reports through the same object: a
``faults`` section counts everything that did *not* go down the happy
path — admission rejections (``rejected_invalid``,
``shed_queue_full``), post-admission sheds (``deadline_miss``),
dispatch outcomes (``degraded_dispatches`` answered by the fallback
backend, ``failed_dispatches``/``failed_requests`` that surfaced a
structured :class:`~repro_torch.serve.errors.RequestError`) and breaker
trips (``breaker_opened``) — so a chaos trace's report shows exactly
how much traffic was refused, degraded or failed, per counter.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np

#: the fault counters every report carries (schema-stable: all present,
#: zero when nothing went wrong)
FAULT_COUNTERS = (
    "rejected_invalid",      # admission: ValidationError (bad payload)
    "shed_queue_full",       # admission: QueueFullError (backpressure)
    "deadline_miss",         # queued request shed past its deadline
    "degraded_dispatches",   # answered by the fallback backend
    "failed_dispatches",     # batch failed outright (primary + fallback)
    "failed_requests",       # requests riding failed batches + sheds
    "breaker_opened",        # circuit-breaker trips across buckets
)

PERCENTILES = (50, 95, 99)


def percentile_summary(xs) -> dict:
    """{"p50", "p95", "p99", "mean", "max"} of a sample (ms in, ms out);
    all-zero on an empty sample so reports stay schema-stable."""
    if len(xs) == 0:
        return {f"p{q}": 0.0 for q in PERCENTILES} | {"mean": 0.0,
                                                      "max": 0.0}
    a = np.asarray(xs, np.float64)
    out = {f"p{q}": float(np.percentile(a, q)) for q in PERCENTILES}
    out["mean"] = float(a.mean())
    out["max"] = float(a.max())
    return out


@dataclass(frozen=True)
class RequestRecord:
    """Timing of one answered request."""
    rid: int
    bucket: tuple[int, int]          # (batch, n_points)
    n_points: int                    # true (unpadded) size
    t_arrival: float
    t_dispatch: float
    t_done: float

    @property
    def queue_wait_s(self) -> float:
        return self.t_dispatch - self.t_arrival

    @property
    def service_s(self) -> float:
        return self.t_done - self.t_dispatch

    @property
    def e2e_s(self) -> float:
        return self.t_done - self.t_arrival


@dataclass(frozen=True)
class DispatchRecord:
    """One fired batch."""
    bucket: tuple[int, int]
    n_requests: int                  # real requests in the batch
    valid_points: int                # sum of true sizes
    partial: bool                    # fired by timeout below capacity
    service_s: float
    degraded: bool = False           # answered by the fallback backend
    t_start: float = 0.0             # execution began (clock value)
    t_done: float = 0.0              # outputs materialized
    depth: int = 1                   # in-flight batches incl. this one


@dataclass
class ServeMetrics:
    """Accumulates request/dispatch records plus the fault counters;
    ``report()`` renders the benchmark-JSON section."""
    requests: list = field(default_factory=list)
    dispatches: list = field(default_factory=list)
    counters: Counter = field(default_factory=Counter)

    def record_dispatch(self, bucket, reqs, t_dispatch, t_done, *,
                        degraded: bool = False, depth: int = 1):
        """``reqs``: the fired requests as (rid, n_points, t_arrival).
        ``t_dispatch`` is when execution *began* (in async mode the
        executor stamps it at the top of the walk, so service time is
        measured at completion against the true start — queue-wait
        absorbs any wait for an in-flight slot); ``depth`` is the
        in-flight depth at fire time."""
        self.dispatches.append(DispatchRecord(
            bucket=bucket.key, n_requests=len(reqs),
            valid_points=sum(n for _, n, _ in reqs),
            partial=len(reqs) < bucket.batch,
            service_s=t_done - t_dispatch, degraded=degraded,
            t_start=t_dispatch, t_done=t_done, depth=depth))
        if degraded:
            self.counters["degraded_dispatches"] += 1
        for rid, n, t_arr in reqs:
            self.requests.append(RequestRecord(
                rid=rid, bucket=bucket.key, n_points=n, t_arrival=t_arr,
                t_dispatch=t_dispatch, t_done=t_done))

    def record_rejection(self, counter: str):
        """Admission-guard refusal (``rejected_invalid`` /
        ``shed_queue_full``); the request never queued."""
        self.counters[counter] += 1

    def record_shed(self, n_requests: int = 1):
        """Queued requests shed past their deadline."""
        self.counters["deadline_miss"] += n_requests
        self.counters["failed_requests"] += n_requests

    def record_failed_dispatch(self, n_requests: int):
        """A batch whose every request surfaced a RequestError."""
        self.counters["failed_dispatches"] += 1
        self.counters["failed_requests"] += n_requests

    def record_breaker_opened(self):
        self.counters["breaker_opened"] += 1

    def report(self, **extra) -> dict:
        """The serving report: latency percentiles (ms), throughput,
        padding waste, per-bucket traffic.  ``extra`` (e.g.
        ``compile_count=...``, ``buckets=[...]``) is merged in."""
        reqs, disp = self.requests, self.dispatches
        lat = {
            name: percentile_summary([1e3 * getattr(r, f"{name}_s")
                                      for r in reqs])
            for name in ("queue_wait", "service", "e2e")
        }
        if reqs:
            t0 = min(r.t_arrival for r in reqs)
            t1 = max(r.t_done for r in reqs)
            rps = len(reqs) / max(t1 - t0, 1e-9)
        else:
            rps = 0.0
        padded = sum(d.bucket[0] * d.bucket[1] for d in disp)
        valid = sum(d.valid_points for d in disp)
        per_bucket: dict[str, dict] = {}
        for d in disp:
            k = f"{d.bucket[0]}x{d.bucket[1]}"
            pb = per_bucket.setdefault(
                k, {"dispatches": 0, "partial": 0, "requests": 0,
                    "degraded": 0})
            pb["dispatches"] += 1
            pb["partial"] += int(d.partial)
            pb["requests"] += d.n_requests
            pb["degraded"] += int(d.degraded)
        return {
            "requests": len(reqs),
            "dispatches": len(disp),
            "full_batches": sum(not d.partial for d in disp),
            "partial_batches": sum(d.partial for d in disp),
            "throughput_rps": rps,
            "latency_ms": lat,
            "padding_waste_pct":
                100.0 * (1.0 - valid / padded) if padded else 0.0,
            "per_bucket": per_bucket,
            "overlap": self._overlap_summary(),
            "faults": {k: int(self.counters.get(k, 0))
                       for k in FAULT_COUNTERS},
            **extra,
        }

    def _overlap_summary(self) -> dict:
        """How concurrent the dispatches actually were, from their
        recorded execution intervals: in-flight depth at fire time,
        total busy time vs its union (``overlap_pct`` > 0 means batches
        genuinely ran concurrently), and the idle gap — span time no
        dispatch covered (the sync dispatcher's serialization cost
        shows up here)."""
        ivs = sorted((d.t_start, d.t_done) for d in self.dispatches
                     if d.t_done > d.t_start)
        depths = [d.depth for d in self.dispatches]
        if not ivs:
            return {"inflight_depth_max": max(depths, default=0),
                    "inflight_depth_mean": 0.0, "busy_ms": 0.0,
                    "idle_gap_ms": 0.0, "overlap_pct": 0.0}
        busy = sum(e - s for s, e in ivs)
        union = 0.0
        cur_s, cur_e = ivs[0]
        for s, e in ivs[1:]:
            if s > cur_e:                # disjoint: close the run
                union += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        union += cur_e - cur_s
        span = max(e for _, e in ivs) - ivs[0][0]
        return {
            "inflight_depth_max": int(max(depths, default=0)),
            "inflight_depth_mean":
                float(np.mean(depths)) if depths else 0.0,
            "busy_ms": 1e3 * busy,
            "idle_gap_ms": 1e3 * max(span - union, 0.0),
            "overlap_pct":
                100.0 * (1.0 - union / busy) if busy > 0 else 0.0,
        }
