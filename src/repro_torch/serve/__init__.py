"""Continuous-batching PCN serving — the async request layer (the port of
``repro.serve``).

Variable-size clouds are admitted one at a time, quantized onto a small
set of warmed (batch, n_points) buckets, coalesced into padded
:class:`~repro_torch.engine.Batch`es on the engine's device (``n_valid``
masks the padding end to end, so padded execution is exact) and fired on
batch-full or timeout, with per-request p50/p95/p99 latency, throughput
and padding-waste reporting.

    from repro_torch import engine, serve

    eng = engine.PCNEngine(spec, mode="lpcn", fc_backend="cuda")
    params = eng.init(seed=0)
    server = serve.PCNServer(eng, params,
                             serve.BucketSet.make([512, 1024], batch=8),
                             timeout_s=0.01)
    rid = server.submit(xyz)          # (N, 3), any N <= largest bucket
    server.poll()                     # fire due batches (timeout path)
    logits = server.take(rid)         # answered exactly once (numpy)
    print(server.report())            # percentiles, throughput, waste

The failure-handling layer hardens this for an adverse world: a typed
error taxonomy (:mod:`~repro_torch.serve.errors`) behind an admission
guard (NaN/Inf/dtype validation, size ceilings, bounded lanes with
shed-on-full), per-bucket circuit breakers with a one-shot
``"reference"``-backend fallback for failed batches, per-request
deadlines with poll-time shedding, and a deterministic fault-injection
harness (:mod:`~repro_torch.serve.faults`) so chaos replays are
reproducible.

CLI: ``python -m repro_torch.launch.serve --arch pointnet2_c --trace 64``.
"""
from .breaker import CircuitBreaker
from .buckets import Bucket, BucketSet
from .dispatcher import PCNServer
from .errors import (AdmissionError, QueueFullError, RequestError,
                     ServeError, UnknownRequestError, ValidationError)
from .faults import Fault, FaultPlan, InjectedFault
from .metrics import (FAULT_COUNTERS, DispatchRecord, RequestRecord,
                      ServeMetrics, percentile_summary)
from .queue import AdmissionQueue, Request
from .trace import TraceEvent, replay, synthetic_trace

__all__ = [
    "AdmissionError", "Bucket", "BucketSet", "PCNServer",
    "AdmissionQueue", "Request", "ServeMetrics", "RequestRecord",
    "DispatchRecord", "percentile_summary", "TraceEvent",
    "synthetic_trace", "replay",
    "ServeError", "ValidationError", "QueueFullError", "RequestError",
    "UnknownRequestError", "CircuitBreaker", "Fault", "FaultPlan",
    "InjectedFault", "FAULT_COUNTERS",
]
