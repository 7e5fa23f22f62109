"""Deterministic fault injection for the serving layer.

A :class:`FaultPlan` maps *dispatch steps* (0-based, counted across all
buckets in firing order) to faults, and wraps the per-bucket engine
callable so chosen dispatches misbehave on purpose:

* ``fail``  — raise :class:`InjectedFault` instead of running;
* ``nan``   — run the engine, then poison the output with NaNs, on the
  output's own device (the dispatcher must *detect* this — a backend
  returning garbage is a fault even when nothing raised);
* ``slow``  — run the engine, then stall ``arg_ms`` (latency spike;
  drives deadline/shed behavior downstream).

Plans are data, not chance: an explicit plan lists its steps
(``FaultPlan.parse("fail@1,nan@3,slow@5:80")`` — the ``--faults`` CLI
syntax), and a randomized plan is *pre-sampled* from a seed into the
same explicit form (``FaultPlan.bernoulli``), so a chaos trace replays
identically in tests, ``launch/serve.py --faults`` and ``chip_smoke.py``.
The step counter lives on the plan and is drawn under a lock; the async
dispatcher calls :meth:`FaultPlan.draw` at *fire* time (in firing
order, under its own lock) and :meth:`FaultPlan.apply` later on an
executor thread, so steps stay deterministic even when several batches
are in flight and complete out of order.  ``plan.wrap(fn)`` composes
the two for synchronous callers and may wrap many per-bucket
callables; they all advance the one shared counter, matching the
server's global dispatch order.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

KINDS = ("fail", "nan", "slow")


class InjectedFault(RuntimeError):
    """The exception a ``fail`` step raises — a distinct type so tests
    and the dispatcher's failure records can tell injected chaos from
    organic engine bugs."""

    def __init__(self, step: int):
        self.step = step
        super().__init__(f"injected engine fault at dispatch step {step}")


@dataclass(frozen=True)
class Fault:
    """One injected misbehavior: ``kind`` ∈ {fail, nan, slow}; ``arg``
    is the stall in ms for ``slow`` (unused otherwise)."""
    kind: str
    arg: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; pick from {KINDS}")


class FaultPlan:
    """A deterministic schedule of faults over dispatch steps.

    ``events`` maps step index -> :class:`Fault`.  ``wrap(fn)`` returns
    a callable with ``fn``'s signature that consults (and advances) the
    plan's shared step counter on every call.
    """

    def __init__(self, events: dict[int, Fault] | None = None, *,
                 sleep=time.sleep):
        self.events = {int(k): v for k, v in (events or {}).items()}
        bad = [k for k in self.events if k < 0]
        if bad:
            raise ValueError(f"fault steps must be >= 0, got {sorted(bad)}")
        self.sleep = sleep           # injectable for fake-clock tests
        self.step = 0                # next dispatch's index
        self.injected: list[tuple[int, str]] = []   # (step, kind) fired
        self._lock = threading.Lock()   # draw() is called at fire time,
                                        # possibly from several threads

    # -- construction --------------------------------------------------------

    @classmethod
    def parse(cls, spec: str, *, sleep=time.sleep) -> "FaultPlan":
        """Parse the CLI syntax: comma-separated ``kind@step[:arg_ms]``
        items, e.g. ``"fail@1,nan@3,slow@5:80"``."""
        events: dict[int, Fault] = {}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            try:
                kind, rest = item.split("@", 1)
                step, _, arg = rest.partition(":")
                fault = Fault(kind.strip(), float(arg) if arg else 0.0)
                step = int(step)
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f"bad fault item {item!r} (want kind@step[:arg_ms], "
                    f"kind in {KINDS}): {e}") from e
            if step in events:
                raise ValueError(f"duplicate fault step {step} in {spec!r}")
            events[step] = fault
        return cls(events, sleep=sleep)

    @classmethod
    def bernoulli(cls, *, seed: int, n_steps: int, p_fail: float = 0.0,
                  p_nan: float = 0.0, p_slow: float = 0.0,
                  slow_ms: float = 50.0, sleep=time.sleep) -> "FaultPlan":
        """Pre-sample a randomized plan over ``n_steps`` dispatches.
        Sampling happens here, once, from ``seed`` — the resulting plan
        is explicit and replays identically."""
        rng = np.random.default_rng(seed)
        events: dict[int, Fault] = {}
        for step in range(n_steps):
            u = rng.uniform()
            if u < p_fail:
                events[step] = Fault("fail")
            elif u < p_fail + p_nan:
                events[step] = Fault("nan")
            elif u < p_fail + p_nan + p_slow:
                events[step] = Fault("slow", slow_ms)
        return cls(events, sleep=sleep)

    # -- injection -----------------------------------------------------------

    def draw(self) -> tuple[int, Fault | None]:
        """Consume one dispatch step (thread-safe): returns the step
        index and the fault scheduled for it (``None`` for a clean
        step), advancing the shared counter and recording the
        injection.  The dispatcher draws at *fire* time, under its own
        lock, so step order matches firing order even when execution
        completes out of order on executor threads."""
        with self._lock:
            step, self.step = self.step, self.step + 1
            fault = self.events.get(step)
            if fault is not None:
                self.injected.append((step, fault.kind))
            return step, fault

    def apply(self, fn, batch, step: int, fault: Fault | None):
        """Execute ``fn(batch)`` under a previously drawn fault:
        ``fail`` raises :class:`InjectedFault` before the engine runs,
        ``nan`` poisons the output tensor on its own device,
        ``slow`` stalls after it;
        ``fault=None`` is the clean path.  Split from :meth:`draw` so
        drawing (ordered, at fire time) and execution (later, on an
        executor thread) need not share a thread."""
        if fault is not None and fault.kind == "fail":
            raise InjectedFault(step)
        out = fn(batch)
        if fault is None:
            return out
        if fault.kind == "nan":
            return torch.full_like(out, float("nan"))
        self.sleep(fault.arg / 1e3)      # "slow"
        return out

    def next_fault(self) -> Fault | None:
        """Consume one step of the plan (compat shim over
        :meth:`draw`): returns the fault scheduled for the current
        dispatch, advancing the shared counter."""
        return self.draw()[1]

    def wrap(self, fn):
        """Wrap one engine callable (draw + apply at call time; the
        synchronous composition).  Every wrapped callable advances the
        plan's one shared step counter in dispatch order."""
        def faulty(batch):
            step, fault = self.draw()
            return self.apply(fn, batch, step, fault)
        return faulty

    def summary(self) -> dict:
        """Report block: what was planned and what actually fired."""
        return {
            "planned": {str(k): v.kind for k, v in
                        sorted(self.events.items())},
            "injected": [{"step": s, "kind": k} for s, k in self.injected],
            "steps_seen": self.step,
        }

    def __repr__(self):
        ev = ",".join(f"{v.kind}@{k}" for k, v in sorted(self.events.items()))
        return f"FaultPlan({ev or 'empty'}, step={self.step})"
