"""Synthetic ragged arrival traces and their replay loop.

A trace models the traffic shape real PCN serving sees (the HgPCN
argument: system-level integration, not isolated kernels, is where
speedups die): request *arrivals* are a Poisson process (exponential
inter-arrival gaps at ``rate_hz``) and cloud *sizes* are log-normal —
a long right tail of big scans over a mass of small objects — clipped
to the served range.  Both streams are seeded and deterministic.

``replay`` pushes a trace through a :class:`PCNServer` in real time:
sleep until each arrival (in short slices, polling so timeouts keep
firing between arrivals), submit, and drain at the end.  If the engine
falls behind the arrival rate the backlog simply grows and queue-wait
percentiles show it — that is the measurement, not an error.

Replay composes with async dispatch unchanged: ``submit``/``poll``
never block on device compute (batches go in flight and the loop keeps
admitting, which is the whole point), the trailing ``drain`` *joins*
every in-flight batch, and service/queue-wait attribution stays
correct because the metrics layer stamps service at execution start →
completion, not at fire.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TraceEvent:
    t: float                         # arrival offset from trace start (s)
    n_points: int


def synthetic_trace(*, n_requests: int, rate_hz: float, n_median: int,
                    sigma: float = 0.35, n_min: int = 16,
                    n_max: int | None = None,
                    seed: int = 0) -> list[TraceEvent]:
    """Poisson arrivals at ``rate_hz``; log-normal sizes with median
    ``n_median`` and log-std ``sigma``, clipped to [n_min, n_max]."""
    rng = np.random.default_rng(seed)
    if n_requests < 1:
        return []
    gaps = rng.exponential(1.0 / rate_hz, n_requests)
    ts = np.cumsum(gaps) - gaps[0]           # first arrival at t=0
    sizes = np.round(rng.lognormal(np.log(n_median), sigma,
                                   n_requests)).astype(int)
    sizes = np.clip(sizes, n_min,
                    n_max if n_max is not None else sizes.max())
    return [TraceEvent(float(t), int(n)) for t, n in zip(ts, sizes)]


def replay(server, events, make_request, *, sleep=time.sleep,
           deadline_s: float | None = None) -> list[int | None]:
    """Replay ``events`` through ``server`` in real time.

    ``make_request(n_points, index) -> (xyz, feats)`` synthesizes each
    cloud (feats may be None).  Returns one entry per event, in
    submission order: the rid, or ``None`` for a request the admission
    guard shed (queue full / invalid payload — already counted in the
    server's ``faults`` metrics; under chaos or overload, sheds are
    part of the measurement, not an abort).  Every admitted rid has an
    outcome after the trailing ``drain``.

    ``deadline_s`` stamps each submitted request with that TTL (on top
    of the server-level default when None).
    """
    from .errors import AdmissionError

    t0 = server.clock()
    rids: list[int | None] = []
    for i, ev in enumerate(events):
        while True:
            dt = (t0 + ev.t) - server.clock()
            if dt <= 0:
                break
            server.poll()                    # timeouts fire while we wait
            sleep(min(dt, max(server.timeout_s / 4, 1e-4)))
        xyz, feats = make_request(ev.n_points, i)
        try:
            rids.append(server.submit(xyz, feats, deadline_s=deadline_s))
        except AdmissionError:
            rids.append(None)                # shed at the door; counted
                                             # by the admission guard
        server.poll()
    server.drain()
    return rids
