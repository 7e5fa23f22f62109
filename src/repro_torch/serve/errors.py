"""Typed error taxonomy for the serving layer.

Every way a request can fail is a distinct type, so callers branch on
``isinstance`` instead of parsing messages, and every failure carries
the structured context (rid, bucket, stage, cause) the client and the
metrics layer need:

* :class:`ServeError` — root of the taxonomy.
* :class:`AdmissionError` — refused at the door, never queued.  Its
  subclasses split the *reason* the door said no:

  - :class:`ValidationError` — the payload itself is unservable
    (non-finite coordinates, wrong shape/dtype, absurd size).  Poisoned
    clouds are refused here, before they can reach a batched kernel
    where a NaN silently corrupts a whole batch.
  - :class:`QueueFullError` — backpressure: the request is well-formed
    but its bucket's lane is at its depth bound.  Shedding at admission
    (tail drop) keeps queue-wait bounded for everything already
    admitted; the client should retry with backoff.

* :class:`RequestError` — admitted, then failed downstream (engine
  fault, poisoned output, missed deadline, open breaker with no
  fallback).  Stored as the request's *outcome*: ``take(rid)`` raises
  it, so a failed request is observable exactly once, like a response.
  With async dispatch these outcomes are produced by the *completion*
  path: an in-flight batch that fails resolves to the same reasons at
  the same counters as a synchronous one, and a deadline is judged
  against the completion clock (``reason="deadline"`` covers both a
  queue-side shed and an answer that materialized too late).
* :class:`UnknownRequestError` — ``take`` on a rid that is pending,
  never existed, or was already taken (also a :class:`KeyError`, for
  callers that predate the taxonomy).

``AdmissionError`` doubles as a ``ValueError`` so pre-taxonomy call
sites (``except ValueError``) keep working.
"""
from __future__ import annotations


class ServeError(Exception):
    """Root of the serving-layer error taxonomy."""


class AdmissionError(ServeError, ValueError):
    """A request the admission guard refused — it never queued.

    Subclasses say why: :class:`ValidationError` (bad payload),
    :class:`QueueFullError` (backpressure shed).  Plain
    ``AdmissionError`` covers the bucket-policy refusals (empty cloud,
    larger than every bucket)."""


class ValidationError(AdmissionError):
    """The payload is unservable: non-finite coordinates, wrong
    shape/dtype, or a size beyond the configured ceiling."""


class QueueFullError(AdmissionError):
    """The request's bucket lane is at its depth bound — shed on
    admission (tail drop) so already-admitted requests keep their
    bounded queue wait.  Retry with backoff."""

    def __init__(self, bucket_key, depth: int):
        self.bucket_key = tuple(bucket_key)
        self.depth = int(depth)
        super().__init__(
            f"bucket {self.bucket_key} lane is full ({self.depth} "
            f"queued); request shed — retry with backoff, raise "
            f"max_lane_depth, or add dispatch capacity")


class RequestError(ServeError):
    """An admitted request that failed after admission.

    Stored as the request's outcome: ``PCNServer.take(rid)`` raises it
    (exactly once, like a response), so failed requests never hang as
    forever-pending.

    Attributes
    ----------
    rid:     the failed request id.
    reason:  machine-readable stage tag — ``"engine"`` (the batch's
             engine execution raised), ``"poisoned_output"`` (the
             engine returned non-finite values), ``"deadline"`` (shed:
             could no longer be answered in time), ``"circuit_open"``
             (the bucket's breaker is open and no fallback is
             configured).
    bucket:  (batch, n_points) key of the bucket it was riding.
    cause:   ``repr`` of the underlying exception, if any.
    degraded_attempted: the one-shot fallback retry also ran (and
             failed) before this error was recorded.
    """

    def __init__(self, rid: int, reason: str, *, bucket=None,
                 cause: str | None = None,
                 degraded_attempted: bool = False):
        self.rid = int(rid)
        self.reason = str(reason)
        self.bucket = None if bucket is None else tuple(bucket)
        self.cause = cause
        self.degraded_attempted = bool(degraded_attempted)
        bits = [f"request {self.rid} failed ({self.reason})"]
        if self.bucket is not None:
            bits.append(f"bucket {self.bucket}")
        if self.degraded_attempted:
            bits.append("fallback retry also failed")
        if self.cause:
            bits.append(f"cause: {self.cause}")
        super().__init__("; ".join(bits))


class UnknownRequestError(ServeError, KeyError):
    """``take(rid)`` has nothing for this rid.  Carries a hint telling
    the caller which exactly-once rule they tripped: the request is
    still pending (poll/drain first), was already taken (responses pop
    on first take), or never existed."""

    def __init__(self, rid: int, hint: str):
        self.rid = rid
        self.hint = hint
        super().__init__(f"no response for rid {rid!r}: {hint}")

    def __str__(self):  # KeyError.__str__ would repr() the message
        return self.args[0]
