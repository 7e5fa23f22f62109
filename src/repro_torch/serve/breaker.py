"""Per-bucket circuit breaker: stop hammering a backend that keeps
failing.

Classic three-state machine, one instance per bucket (failures are
per-executable — one bucket's broken tile plan must not take out the
others):

* **closed** — healthy.  Every dispatch tries the primary backend;
  ``fail_streak`` consecutive failures trip the breaker.
* **open** — the primary is presumed broken.  ``allow_primary()`` says
  no (the dispatcher goes straight to its fallback, or fails fast) so
  a persistently-broken bucket *degrades* instead of re-raising the
  same fault at every dispatch.  After ``cooldown_s`` the next
  ``allow_primary()`` transitions to half-open and grants one probe.
* **half-open** — exactly one probe dispatch is in flight on the
  primary.  Success closes the breaker; failure re-opens it (fresh
  cooldown).  While the probe is out, further ``allow_primary()``
  calls keep saying no.

The clock is injected (same pattern as the dispatcher timeout) so the
open → half-open → closed walk is deterministic under a fake clock.

With async dispatch the two sides of the protocol split across time:
``allow_primary()`` is consulted at *fire* time (under the server
lock, in firing order) and ``record_success``/``record_failure`` land
at *completion* time, when the in-flight batch resolves.  Several
batches fired before the first failure completes may all try the
primary — the breaker judges verdicts in completion order, which is
the only order that exists for an async pipeline.  The instance itself
is not locked; the dispatcher serializes access under its own lock.
"""
from __future__ import annotations

import time

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker with a timed half-open probe.

    Parameters
    ----------
    fail_streak: consecutive primary failures that trip the breaker.
    cooldown_s:  how long the breaker stays open before granting a
                 half-open probe.
    clock:       injectable monotonic clock.
    """

    def __init__(self, fail_streak: int = 3, cooldown_s: float = 1.0,
                 clock=time.monotonic):
        if fail_streak < 1:
            raise ValueError(f"fail_streak must be >= 1, got {fail_streak}")
        self.fail_streak = int(fail_streak)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.state = CLOSED
        self.failures = 0            # current consecutive-failure run
        self.opened_at: float | None = None
        self.open_count = 0          # times the breaker tripped (metrics)

    def allow_primary(self) -> bool:
        """May the next dispatch try the primary backend?

        Transitions open → half-open (and grants the probe) when the
        cooldown has elapsed; in half-open, the probe slot is already
        taken, so the answer is no until it reports back."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.clock() - self.opened_at >= self.cooldown_s:
                self.state = HALF_OPEN
                return True
            return False
        return False                 # HALF_OPEN: probe already in flight

    def record_success(self):
        """Primary dispatch (or half-open probe) succeeded."""
        self.state = CLOSED
        self.failures = 0
        self.opened_at = None

    def record_failure(self):
        """Primary dispatch (or half-open probe) failed."""
        self.failures += 1
        if self.state == HALF_OPEN or self.failures >= self.fail_streak:
            if self.state != OPEN:
                self.open_count += 1
            self.state = OPEN
            self.opened_at = self.clock()

    def snapshot(self) -> dict:
        """Metrics view: current state + trip count."""
        return {"state": self.state, "failures": self.failures,
                "open_count": self.open_count}

    def __repr__(self):
        return (f"CircuitBreaker({self.state}, failures={self.failures}/"
                f"{self.fail_streak}, cooldown={self.cooldown_s}s)")
