"""The dispatcher: continuous batching over warmed size buckets,
hardened for an adverse world, with async in-flight dispatch.

:class:`PCNServer` is the serving handle.  It coalesces admitted
requests into the tightest bucket's batch shape and fires on either of
two triggers:

  * **batch-full** — a lane reaches its bucket's capacity; the batch
    fires immediately, inside ``submit`` (no poll latency on the hot
    path under load);
  * **timeout** — ``poll()`` fires any non-empty lane whose *oldest*
    request has waited ``timeout_s``, padding the short batch up to
    capacity with empty fill clouds (``n_valid == 0`` — fully masked by
    the PR-2 ragged contract), so light traffic is answered within one
    timeout instead of starving behind an unfillable batch.

Every fired batch has exactly its bucket's (B, N) shape — cloud rows
padded via :meth:`Batch.from_clouds(..., n_pad=N)
<repro_torch.engine.Batch.from_clouds>` on the engine's device, missing
batch rows zero-filled and fully masked — so the engine is warmed **once
per bucket** and every kernel launch of traffic runs at a warmed shape.
Responses are exact: batch row i over its valid prefix equals
``engine.apply_single`` on that request's cloud and key.

Async dispatch (the overlap layer):

By default (``sync=False``) a fired batch does **not** block the firing
thread: the fire path registers an in-flight record (atomically with
the queue take and the slot check) and hands host padding + execution +
blocking readback to a bounded executor, so bucket A's host padding and
admission overlap bucket B's device compute, and up to ``max_in_flight``
batches are in flight at once.  Executor threads launch on the current
stream of the engine's device (each worker enters that device first), so
every batch's kernels queue on the one stream the wrappers read, and a
batch's readback waits for it.  The forwards themselves take turns under
one lock: the port's forward is thousands of eager launches made from
the host, and threads that make them at once contend for the
interpreter, so concurrent forwards are slower than consecutive ones
(``tools/serve_concurrency.py``).  What overlaps is everything around
them: admission, host padding, readback and injected stalls.  The
pieces:

* **Slot gating** — ``submit``/``poll`` only fire while fewer than
  ``max_in_flight`` batches are in flight; otherwise due batches stay
  queued (admission never blocks) and a completion pumps them out.
* **Completion path** — the executor task runs the *same*
  primary/fallback walk as sync mode and resolves outcomes under the
  lock: results into the response table, breaker verdicts recorded,
  deadlines enforced against the completion clock, counters updated —
  then fires any newly due lane while slots are free.
* **Coherent observation** — ``take(rid)`` *blocks* until an in-flight
  rid resolves (then returns or raises exactly as in sync mode);
  ``drain()`` fires everything queued and joins all in-flight work, so
  ``pending() == 0`` afterwards; ``pending()`` counts queued *plus*
  in-flight requests.
* **Sync A/B** — ``sync=True`` keeps the old fully-blocking behavior
  (fire resolves before returning) for benchmarking and for tests that
  assert post-submit state deterministically.

Failure handling (the hardened layer; identical semantics in both
modes — the async layer wraps the walk, it does not reimplement it):

* **Admission guard** — ``submit`` refuses poisoned payloads
  (:class:`ValidationError`: NaN/Inf, wrong shape/dtype), oversize
  clouds (:class:`AdmissionError`) and overload
  (:class:`QueueFullError` once a lane hits ``max_lane_depth``) with
  structured errors *before* anything reaches a kernel.
* **Fault isolation** — an engine failure (raised exception *or*
  non-finite output, detected at completion) fails only that batch: the
  dispatcher retries the batch exactly once on the ``fallback`` backend
  (default ``"reference"``: the plain PyTorch path, on the engine's
  device), and only if that also fails do the
  batch's requests surface a structured :class:`RequestError` via
  ``take``.  Other buckets, and other in-flight batches, are untouched.
* **Circuit breaker** — per bucket: consulted at *fire* time
  (``allow_primary``), verdicts recorded at *completion* time, so
  ``breaker_fail_streak`` consecutive primary failures trip it open,
  after which dispatches skip the primary entirely (straight to the
  fallback — degraded, not broken; with no fallback they fail fast)
  until a half-open probe after ``breaker_cooldown_s`` finds the
  primary healthy again.
* **Deadlines** — a request may carry a deadline (per-request
  ``deadline_s`` or the server default); ``poll``/``drain`` shed
  queued requests that can no longer be answered in time, and the
  completion path drops answers that arrive past their deadline
  (both surface ``RequestError(reason="deadline")`` from ``take``)
  instead of handing back answers nobody is waiting for.
* **Fault injection** — pass ``faults=``
  :class:`~repro_torch.serve.faults.FaultPlan`: fault steps are *drawn* at
  fire time, under the lock, in firing order (deterministic even with
  several batches in flight) and *applied* around the primary engine
  call on the executor thread; the fallback path stays clean, which is
  exactly what makes injected chaos recoverable and testable.

Every non-happy path increments a counter in the metrics ``faults``
section (rejected/shed/deadline-miss/degraded/failed/breaker-opened),
so a chaos trace's report quantifies the damage.

Thread model: admission, polling and completions may come from
different threads — queue/result/breaker/counter state is
lock-protected; engine execution, host padding and readback all run
outside the lock so submissions keep landing while batches are in
flight.  Single-threaded callers just call ``submit``/``poll``/
``drain`` in a loop.
"""
from __future__ import annotations

import functools
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import contextlib

import numpy as np
import torch

from .. import random
from ..engine.params import Batch
from .breaker import CircuitBreaker
from .buckets import Bucket, BucketSet
from .errors import (AdmissionError, QueueFullError, RequestError,
                     UnknownRequestError, ValidationError)
from .metrics import ServeMetrics
from .queue import AdmissionQueue, key_data


class _PoisonedOutput(RuntimeError):
    """Internal: the engine returned non-finite values for a request's
    valid rows — a fault even though nothing raised."""


@dataclass
class _InFlight:
    """One fired batch not yet resolved: everything the completion path
    needs, fixed at fire time (breaker verdict, drawn fault step) so
    the walk is deterministic regardless of completion order."""
    seq: int
    bucket: Bucket
    reqs: list
    batch: object
    try_primary: bool
    step: int | None = None          # drawn fault step (primary only)
    fault: object = None             # drawn Fault | None
    depth: int = 1                   # in-flight depth incl. this batch
    future: object = None            # executor handle (async mode)


@dataclass
class _Outcome:
    """What one executed batch produced (primary and fallback verdicts
    kept apart: the breaker judges only the primary)."""
    rows: dict | None
    primary_err: Exception | None
    fallback_err: Exception | None
    degraded: bool
    t_start: float
    t_done: float


class PCNServer:
    """Continuous-batching front end over a :class:`PCNEngine`.

    Parameters
    ----------
    engine:    a ``repro_torch.engine.PCNEngine`` (any mode/backend; on
               its device, which defaults to the GPU).  The port's engine
               has no mesh yet, so there is no data-axis check on the
               bucket batches.
    params:    the engine params served to every request.
    buckets:   a :class:`BucketSet` (or iterable of :class:`Bucket`).
    timeout_s: max queue-wait of a lane's oldest request before a
               partial batch fires.
    clock:     injectable monotonic clock (tests pass a fake one to make
               timeout/deadline/breaker policy deterministic).
    warmup:    warm every bucket at construction (one forward per
               bucket through ``engine.bucket_callable``, which builds any
               kernel not built yet).  ``False`` warms lazily on each
               bucket's first dispatch.
    max_lane_depth: per-bucket queue bound; a submit into a full lane
               sheds with :class:`QueueFullError` (None = unbounded).
    deadline_s: default per-request deadline (seconds from arrival);
               ``submit(..., deadline_s=)`` overrides per request.
               None = requests never expire.
    fallback:  FC backend name for the one-shot degraded retry when a
               dispatch fails (``None`` disables: failures surface
               immediately).  The fallback engine is built on the
               primary's device and warmed lazily, per bucket, on first
               use.
    breaker_fail_streak / breaker_cooldown_s: per-bucket circuit
               breaker: consecutive primary failures to trip, and how
               long it stays open before a half-open probe.
    faults:    optional :class:`~repro_torch.serve.faults.FaultPlan`; fault
               steps are drawn at fire time (deterministic firing
               order) and applied around the primary engine call only
               (the fallback path is never faulted).
    validate:  run the payload guard (NaN/Inf/dtype) on every submit.
    max_in_flight: how many fired batches may be unresolved at once
               (the executor bound); due batches beyond it stay queued
               until a completion frees a slot.
    sync:      ``True`` restores fully-blocking dispatch (every fire
               resolves before returning) — the A/B baseline.
    seed:      per-request keys default to ``fold_in(PRNGKey(seed),
               rid)`` (threefry, bit-equal to ``jax.random``), derived on
               the host because the queue holds keys as host data.
    """

    def __init__(self, engine, params, buckets, *, timeout_s: float = 0.01,
                 clock=time.monotonic, warmup: bool = True, seed: int = 0,
                 max_lane_depth: int | None = None,
                 deadline_s: float | None = None,
                 fallback: str | None = "reference",
                 breaker_fail_streak: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 faults=None, validate: bool = True,
                 max_in_flight: int = 4, sync: bool = False):
        self.engine = engine
        self.params = params
        self.buckets = (buckets if isinstance(buckets, BucketSet)
                        else BucketSet(buckets))
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, "
                             f"got {max_in_flight}")
        self.timeout_s = float(timeout_s)
        self.clock = clock
        self.deadline_s = deadline_s
        self.fallback = fallback
        self.faults = faults
        self.max_in_flight = int(max_in_flight)
        self.sync = bool(sync)
        self.queue = AdmissionQueue(self.buckets,
                                    max_lane_depth=max_lane_depth,
                                    validate=validate)
        self.metrics = ServeMetrics()
        self.breakers: dict[tuple[int, int], CircuitBreaker] = {
            b.key: CircuitBreaker(breaker_fail_streak, breaker_cooldown_s,
                                  clock=clock)
            for b in self.buckets}
        self._base_key = random.PRNGKey(seed, "cpu")
        self._results: dict[int, object] = {}   # ndarray | RequestError
        self._callables: dict[tuple[int, int], object] = {}
        self._fallback_engine = None
        self._fallback_callables: dict[tuple[int, int], object] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._aux_lock = threading.Lock()       # lazy warm-ups / executor
        self._exec_lock = threading.Lock()      # one forward at a time
        self._inflight: dict[int, _InFlight] = {}
        self._inflight_rids: set[int] = set()
        self._seq = 0
        self._pool: ThreadPoolExecutor | None = None
        if warmup:
            for b in self.buckets:
                self._callable_for(b)

    # -- per-bucket seam ----------------------------------------------------

    def _callable_for(self, bucket: Bucket):
        """Per-bucket callable (engine seam; warmed on first use of the
        bucket, cached thereafter).  Thread-safe: two in-flight batches
        racing a lazy warm-up warm it once."""
        fn = self._callables.get(bucket.key)
        if fn is None:
            with self._aux_lock:
                fn = self._callables.get(bucket.key)
                if fn is None:
                    with self._exec_lock:
                        fn = self.engine.bucket_callable(
                            self.params, bucket.batch, bucket.n_points)
                    fn = self._callables[bucket.key] = self._in_turn(fn)
        return fn

    def _fallback_callable_for(self, bucket: Bucket):
        """The degraded-path callable: same spec, mode and device, FC
        backend swapped to ``self.fallback``.  Built and warmed lazily —
        healthy serving never pays for it (the first degraded dispatch of
        a bucket absorbs the warm-up; that cost lands in its service
        time, visibly)."""
        fn = self._fallback_callables.get(bucket.key)
        if fn is None:
            with self._aux_lock:
                fn = self._fallback_callables.get(bucket.key)
                if fn is None:
                    if self._fallback_engine is None:
                        eng = self.engine
                        self._fallback_engine = type(eng)(
                            eng.spec, mode=eng.mode,
                            fc_backend=self.fallback,
                            isl_kw=eng.isl_kw, device=eng.device)
                    with self._exec_lock:
                        fn = self._fallback_engine.bucket_callable(
                            self.params, bucket.batch, bucket.n_points)
                    fn = self._fallback_callables[bucket.key] = \
                        self._in_turn(fn)
        return fn

    def _in_turn(self, fn):
        """``fn`` under the execution lock, so executor threads run the
        forward one at a time.  On an NVIDIA H100 the (8, 1024) lpcn
        forward runs 7.5 times a second alone, 3.7 from two threads at
        once and 1.4 from four, and 7.5 again from four that take turns
        (``tools/serve_concurrency.py``)."""
        def in_turn(batch):
            with self._exec_lock:
                return fn(batch)
        return in_turn

    def _executor(self) -> ThreadPoolExecutor:
        ex = self._pool
        if ex is None:
            with self._aux_lock:
                ex = self._pool
                if ex is None:
                    ex = self._pool = ThreadPoolExecutor(
                        max_workers=self.max_in_flight,
                        thread_name_prefix="pcn-serve")
        return ex

    @property
    def compile_count(self) -> int:
        """(batch, n_points) buckets the *primary* engine has warmed so
        far through ``bucket_callable`` — one per bucket.  The port has
        no jit cache: this counts warm-ups, which is where each shape's
        one-time cost (kernel builds, allocator growth) lands.  The lazy
        fallback engine keeps its own count."""
        return self.engine.compile_count

    # -- admission ----------------------------------------------------------

    def submit(self, xyz, feats=None, key=None, *,
               deadline_s: float | None = None) -> int:
        """Admit one cloud; returns its request id.  Fires immediately
        if this request fills its bucket's batch and an in-flight slot
        is free (never blocks on device compute in async mode; with all
        slots busy the full lane waits for a completion to pump it).

        Raises the structured admission taxonomy: :class:`ValidationError`
        (NaN/Inf, bad shape/dtype), :class:`AdmissionError` (no bucket
        fits), :class:`QueueFullError` (lane at its depth bound) — each
        counted in the metrics ``faults`` section.

        ``deadline_s`` (seconds from now; default: the server-level
        ``deadline_s``) marks when the answer stops being useful:
        ``poll``/``drain`` shed the request once it expires, and an
        in-flight answer completing past it is dropped.
        """
        now = self.clock()
        ttl = self.deadline_s if deadline_s is None else deadline_s
        t_deadline = None if ttl is None else now + ttl
        with self._lock:
            if key is None:
                key = random.fold_in(self._base_key,
                                     self.queue._next_rid)
            try:
                req = self.queue.submit(xyz, feats, key, now, t_deadline)
            except QueueFullError:
                self.metrics.record_rejection("shed_queue_full")
                raise
            except ValidationError:
                self.metrics.record_rejection("rejected_invalid")
                raise
            except AdmissionError:
                # bucket-policy refusal (empty / beyond the size ceiling)
                self.metrics.record_rejection("rejected_invalid")
                raise
            rec = None
            if (len(self.queue.lane(req.bucket)) >= req.bucket.batch
                    and self._slot_free_locked()):
                rec = self._register_locked(
                    req.bucket,
                    self.queue.take(req.bucket, req.bucket.batch))
        if rec is not None:
            self._launch(rec)
        return req.rid

    # -- dispatch -----------------------------------------------------------

    def _slot_free_locked(self) -> bool:
        """May one more batch go in flight?  (Caller holds the lock.)"""
        return self.sync or len(self._inflight) < self.max_in_flight

    def _shed_expired(self) -> list[int]:
        """Drop queued requests past their deadline; each becomes a
        ``RequestError(reason="deadline")`` outcome and a
        ``deadline_miss`` count."""
        now = self.clock()
        with self._lock:
            shed = self.queue.shed_expired(now)
            for r in shed:
                self.metrics.record_shed()
                self._results[r.rid] = RequestError(
                    r.rid, "deadline", bucket=r.bucket.key)
        return [r.rid for r in shed]

    def poll(self) -> list[int]:
        """Shed expired requests, then fire every lane that is due
        (full, or oldest request past the timeout) while in-flight
        slots are free; returns the rids this call shed or fired (fired
        rids are resolved on return in sync mode, possibly still in
        flight in async mode — ``ready``/``take`` observe them
        coherently either way)."""
        done: list[int] = self._shed_expired()
        for bucket in self.buckets:
            while True:
                now = self.clock()
                with self._lock:
                    rec = None
                    if self._slot_free_locked():
                        lane = self.queue.lane(bucket)
                        full = len(lane) >= bucket.batch
                        timed_out = (len(lane) > 0 and
                                     now - lane[0].t_arrival
                                     >= self.timeout_s)
                        if full or timed_out:
                            rec = self._register_locked(
                                bucket,
                                self.queue.take(bucket, bucket.batch))
                if rec is None:
                    break
                done += self._launch(rec)
        return done

    def drain(self) -> list[int]:
        """Shed expired requests, fire everything still queued
        regardless of timeout (waiting for in-flight slots as needed),
        then **join** all in-flight work (end of a trace / shutdown).
        Afterwards ``pending() == 0``: every admitted rid has an
        outcome."""
        done: list[int] = self._shed_expired()
        for bucket in self.buckets:
            while True:
                with self._cond:
                    while not self._slot_free_locked():
                        self._cond.wait()
                    reqs = self.queue.take(bucket, bucket.batch)
                    rec = self._register_locked(bucket, reqs) \
                        if reqs else None
                if rec is None:
                    break
                done += self._launch(rec)
        with self._cond:
            while self._inflight:
                self._cond.wait()
        return done

    def _pump(self):
        """Called after a completion freed a slot (async mode): fire
        due lanes (full, or timed out) while slots stay free, so the
        device never idles behind a full in-flight table."""
        if self.sync:
            return
        while True:
            now = self.clock()
            rec = None
            with self._lock:
                if not self._slot_free_locked():
                    return
                for bucket in self.buckets:
                    lane = self.queue.lane(bucket)
                    full = len(lane) >= bucket.batch
                    timed_out = (len(lane) > 0 and
                                 now - lane[0].t_arrival >= self.timeout_s)
                    if full or timed_out:
                        rec = self._register_locked(
                            bucket, self.queue.take(bucket, bucket.batch))
                        break
            if rec is None:
                return
            self._launch(rec)

    # -- execution ----------------------------------------------------------

    def _build_batch(self, bucket: Bucket, reqs) -> Batch:
        n_fill = bucket.batch - len(reqs)
        feat_dim = self.engine.spec.in_feats
        clouds = [r.xyz for r in reqs] + [
            np.zeros((0, 3), np.float32)] * n_fill
        feats = None
        if feat_dim > 3:
            feats = [r.feats for r in reqs] + [
                np.zeros((0, feat_dim), np.float32)] * n_fill
        fill_key = key_data(random.PRNGKey(0))
        keys = np.stack([r.key for r in reqs]
                        + [fill_key] * n_fill).astype(np.uint32)
        return Batch.from_clouds(clouds, feats=feats, key=keys,
                                 n_pad=bucket.n_points,
                                 device=self.engine.device)

    def _run(self, fn, batch, reqs) -> dict[int, np.ndarray]:
        """Execute one callable and slice out per-request rows,
        checking every valid row is finite (a backend returning NaN is
        a fault even when nothing raised).  The one copy to the host
        waits for the batch's work on the stream."""
        out = fn(batch).cpu().numpy()
        rows: dict[int, np.ndarray] = {}
        for i, r in enumerate(reqs):
            row = out[i]
            # seg heads return (N, n_classes); valid prefix only
            row = row[:r.n_points] if row.ndim == 2 else row
            if not np.isfinite(row).all():
                raise _PoisonedOutput(
                    f"non-finite output for rid {r.rid} "
                    f"(bucket {bucket_str(r.bucket)})")
            rows[r.rid] = row
        return rows

    def _register_locked(self, bucket: Bucket, reqs) -> _InFlight:
        """Fix the fire-time decisions and register the in-flight
        record — breaker consult and fault draw happen here, in firing
        order, atomically with the queue take and the slot check (the
        caller holds the lock), so the in-flight table never exceeds
        ``max_in_flight`` and fault steps stay deterministic."""
        try_primary = self.breakers[bucket.key].allow_primary()
        rec = _InFlight(seq=self._seq, bucket=bucket, reqs=reqs,
                        batch=None, try_primary=try_primary)
        self._seq += 1
        if try_primary and self.faults is not None:
            rec.step, rec.fault = self.faults.draw()
        self._inflight[rec.seq] = rec
        self._inflight_rids.update(r.rid for r in reqs)
        rec.depth = len(self._inflight)
        return rec

    def _launch(self, rec: _InFlight) -> list[int]:
        """Run a registered batch: inline in sync mode, on the bounded
        executor otherwise (host padding rides the executor thread too
        — that is the admission↔padding↔compute overlap).  Returns the
        fired rids."""
        if self.sync:
            self._complete(rec, self._execute(rec))
        else:
            rec.future = self._executor().submit(self._task, rec)
            rec.future.add_done_callback(
                functools.partial(self._future_guard, rec))
        return [r.rid for r in rec.reqs]

    def _device_scope(self):
        """The engine's CUDA device as the thread's current one (executor
        threads start on device 0, and the kernels launch on the current
        stream of their operands' device); nothing on the CPU."""
        if self.engine.device.type == "cuda":
            return torch.cuda.device(self.engine.device)
        return contextlib.nullcontext()

    def _execute(self, rec: _InFlight) -> _Outcome:
        """The full batch walk — host padding, engine execution and
        readback, entirely outside the lock, with the engine's device
        current.  Never raises: verdicts travel in the
        :class:`_Outcome` for ``_complete`` to judge."""
        with self._device_scope():
            bucket, reqs = rec.bucket, rec.reqs
            t_start = self.clock()          # service includes host padding
            batch = rec.batch = self._build_batch(bucket, reqs)
            rows = None
            primary_err: Exception | None = None
            fallback_err: Exception | None = None
            degraded = False
            if rec.try_primary:
                try:
                    fn = self._callable_for(bucket)
                    if self.faults is not None:
                        rows = self._run(
                            lambda b, _fn=fn: self.faults.apply(
                                _fn, b, rec.step, rec.fault),
                            batch, reqs)
                    else:
                        rows = self._run(fn, batch, reqs)
                except Exception as e:      # noqa: BLE001 — judged by
                    primary_err = e         # _complete (breaker + reason)
            if rows is None and self.fallback is not None:
                try:
                    rows = self._run(self._fallback_callable_for(bucket),
                                     batch, reqs)
                    degraded = True
                except Exception as e:      # noqa: BLE001 — both sides down;
                    fallback_err = e        # surfaces as RequestError
            return _Outcome(rows, primary_err, fallback_err, degraded,
                            t_start, self.clock())

    def _task(self, rec: _InFlight):
        """Executor body: execute, then resolve.  ``_execute`` never
        raises; ``_future_guard`` backstops a completion-path bug."""
        self._complete(rec, self._execute(rec))

    def _complete(self, rec: _InFlight, out: _Outcome):
        """Resolve one executed batch under the lock: record the
        breaker verdict (completion-time), enforce deadlines against
        the completion clock, stash per-request outcomes, update
        counters, wake blocked ``take``/``drain`` — then pump newly
        due lanes into the freed slot."""
        bucket, reqs = rec.bucket, rec.reqs
        with self._cond:
            br = self.breakers[bucket.key]
            if rec.try_primary:
                if out.primary_err is None:
                    br.record_success()
                else:
                    opened_before = br.open_count
                    br.record_failure()
                    if br.open_count > opened_before:
                        self.metrics.record_breaker_opened()
            if out.rows is not None:
                live = []
                for r in reqs:
                    if (r.t_deadline is not None
                            and out.t_done >= r.t_deadline):
                        # answered too late to be useful: same outcome
                        # and counters as a queue-side shed
                        self.metrics.record_shed()
                        self._results[r.rid] = RequestError(
                            r.rid, "deadline", bucket=bucket.key)
                    else:
                        live.append(r)
                self.metrics.record_dispatch(
                    bucket, [(r.rid, r.n_points, r.t_arrival)
                             for r in live],
                    out.t_start, out.t_done, degraded=out.degraded,
                    depth=rec.depth)
                self._results.update(
                    {r.rid: out.rows[r.rid] for r in live})
            else:
                err = (out.primary_err if out.primary_err is not None
                       else out.fallback_err)
                if not rec.try_primary and self.fallback is None:
                    reason = "circuit_open"
                elif isinstance(err, _PoisonedOutput):
                    reason = "poisoned_output"
                else:
                    reason = "engine"
                self.metrics.record_failed_dispatch(len(reqs))
                for r in reqs:
                    self._results[r.rid] = RequestError(
                        r.rid, reason, bucket=bucket.key,
                        cause=None if err is None else repr(err),
                        degraded_attempted=(rec.try_primary
                                            and self.fallback
                                            is not None))
            del self._inflight[rec.seq]
            self._inflight_rids.difference_update(r.rid for r in reqs)
            self._cond.notify_all()
        self._pump()

    def _future_guard(self, rec: _InFlight, fut):
        """Done-callback on every in-flight future: an exception that
        escaped the completion path (a dispatcher bug — ``_execute``
        converts engine failures itself) must not strand its requests
        or vanish silently."""
        err = fut.exception()
        if err is None:
            return
        warnings.warn(f"in-flight completion crashed: {err!r}",
                      RuntimeWarning, stacklevel=2)
        with self._cond:
            if rec.seq not in self._inflight:
                return
            del self._inflight[rec.seq]
            self._inflight_rids.difference_update(
                r.rid for r in rec.reqs)
            self.metrics.record_failed_dispatch(len(rec.reqs))
            for r in rec.reqs:
                self._results[r.rid] = RequestError(
                    r.rid, "engine", bucket=rec.bucket.key,
                    cause=repr(err))
            self._cond.notify_all()

    # -- responses ----------------------------------------------------------

    def take(self, rid: int) -> np.ndarray:
        """Pop the outcome for ``rid`` (each resolved exactly once).

        **Blocks** while ``rid`` rides an in-flight batch (async mode:
        the completion path resolves it and wakes us).  Returns the
        logits for an answered request; raises its
        :class:`RequestError` for a failed/shed one (also popped —
        failures are observed exactly once, like responses); raises
        :class:`UnknownRequestError` (a ``KeyError``) with a diagnosis
        when there is nothing to pop: still queued (unfired — blocking
        would deadlock a single-threaded caller), already taken, or
        never submitted."""
        with self._cond:
            while rid in self._inflight_rids:
                self._cond.wait()
            if rid in self._results:
                out = self._results.pop(rid)
            elif rid in self.queue.pending_rids():
                raise UnknownRequestError(
                    rid, "still pending — poll()/drain() until "
                         "ready(rid) before taking")
            elif isinstance(rid, int) and 0 <= rid < self.queue._next_rid:
                raise UnknownRequestError(
                    rid, "already taken (outcomes pop on first take — "
                         "exactly-once semantics)")
            else:
                raise UnknownRequestError(
                    rid, "never submitted to this server")
        if isinstance(out, RequestError):
            raise out
        return out

    def ready(self, rid: int) -> bool:
        """An outcome (response *or* structured failure) is available.
        False while the rid is queued or in flight."""
        with self._lock:
            return rid in self._results

    def failed(self, rid: int) -> bool:
        """The available outcome is a :class:`RequestError` (peek —
        does not consume it)."""
        with self._lock:
            return isinstance(self._results.get(rid), RequestError)

    def pending(self) -> int:
        """Requests admitted but not yet resolved: queued + in flight."""
        with self._lock:
            return self.queue.pending() + len(self._inflight_rids)

    def close(self):
        """Join all in-flight work and shut the executor down
        (idempotent; a later async fire lazily rebuilds the pool)."""
        with self._cond:
            while self._inflight:
                self._cond.wait()
        with self._aux_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def report(self, **extra) -> dict:
        """Serving report (see :meth:`ServeMetrics.report`) annotated
        with the bucket config, dispatch mode, compile count, per-bucket
        breaker states and the fault plan (if any)."""
        return self.metrics.report(
            buckets=[list(b.key) for b in self.buckets],
            timeout_ms=1e3 * self.timeout_s,
            dispatch_mode="sync" if self.sync else "async",
            max_in_flight=self.max_in_flight,
            compile_count=self.compile_count,
            engine=repr(self.engine),
            fallback=self.fallback,
            breakers={bucket_str(k): br.snapshot()
                      for k, br in self.breakers.items()},
            fault_plan=(None if self.faults is None
                        else self.faults.summary()),
            **extra)


def bucket_str(key) -> str:
    return f"{key[0]}x{key[1]}"
