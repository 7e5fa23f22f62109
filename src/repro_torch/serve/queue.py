"""Admission queue: where ragged traffic meets the bucket policy — and
the admission *guard*: where poisoned or excess traffic is refused.

``submit`` validates a request before anything else touches it —
shape/dtype policy and NaN/Inf rejection via the engine's own
:func:`~repro_torch.engine.params.validate_cloud` (a non-finite cloud
that reaches a batched kernel corrupts its whole batch silently, so it
must be stopped here, with a structured
:class:`~repro_torch.serve.errors.ValidationError`), then assigns it the
tightest bucket and a per-request PRNG key, stamps its arrival time
(and deadline, if any) and appends it to that bucket's FIFO lane.

Lanes are *bounded*: ``max_lane_depth`` caps how many requests a bucket
may hold, and a submit into a full lane is shed with
:class:`~repro_torch.serve.errors.QueueFullError` (tail drop — the newest
request is refused; everything already admitted keeps its FIFO place
and its bounded queue wait).  An unbounded queue under overload is a
latency time bomb: every admitted request would wait behind the whole
backlog.

Lanes keep arrival order *within* a bucket — the dispatcher drains each
lane front-first, so no request can be overtaken by a later one of the
same bucket (the starvation bound is the dispatch timeout, not queue
discipline).

The queue is host-side only: payloads stay numpy until the dispatcher
pads a fired lane slice into a device
:class:`~repro_torch.engine.Batch`.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..engine.params import validate_cloud
from .buckets import Bucket, BucketSet
from .errors import QueueFullError, ValidationError


def key_data(key) -> np.ndarray:
    """Canonicalize a key to host (2,) uint32 — the form
    :meth:`Batch.from_clouds` stacks per cloud.  Takes the port's int64
    key words (a tensor, on any device) or uint32 key data (what a JAX
    ``PRNGKey`` becomes under ``np.asarray``)."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    return np.asarray(key).astype(np.uint32)


@dataclass
class Request:
    """One admitted cloud waiting for (or answered by) a dispatch."""
    rid: int
    xyz: np.ndarray                  # (Ni, 3) float32
    feats: np.ndarray | None         # (Ni, F) float32 or None
    key: np.ndarray                  # (2,) uint32 raw PRNG key data
    bucket: Bucket
    t_arrival: float
    t_deadline: float | None = None  # absolute clock value; None = none

    @property
    def n_points(self) -> int:
        return self.xyz.shape[0]


class AdmissionQueue:
    """Per-bucket bounded FIFO lanes behind the admission guard.

    ``max_lane_depth``: per-bucket queue bound (None = unbounded, the
    pre-backpressure behavior).  ``validate``: run the payload guard on
    every submit (on by default; the engine benchmark loops that
    synthesize their own clouds may turn it off).
    """

    def __init__(self, buckets: BucketSet, *,
                 max_lane_depth: int | None = None, validate: bool = True):
        if max_lane_depth is not None and max_lane_depth < 1:
            raise ValueError(
                f"max_lane_depth must be >= 1 (or None), got "
                f"{max_lane_depth}")
        self.buckets = buckets
        self.max_lane_depth = max_lane_depth
        self.validate = validate
        self._lanes: dict[tuple[int, int], deque[Request]] = {
            b.key: deque() for b in buckets}
        self._next_rid = 0

    def submit(self, xyz, feats, key, now: float,
               t_deadline: float | None = None) -> Request:
        """Admit one cloud; raises :class:`ValidationError` for a bad
        payload, :class:`AdmissionError` if no bucket fits,
        :class:`QueueFullError` if the bucket's lane is at its depth
        bound.  Returns the enqueued :class:`Request`."""
        xyz = np.asarray(xyz)
        if xyz.ndim != 2 or xyz.shape[-1] != 3:
            raise ValidationError(
                f"a request is one cloud, shape (N, 3); got {xyz.shape}")
        if self.validate:
            try:
                xyz = validate_cloud(xyz, "xyz")
            except ValueError as e:
                raise ValidationError(str(e)) from e
        else:
            xyz = np.asarray(xyz, np.float32)
        if feats is not None:
            feats = np.asarray(feats)
            if feats.ndim != 2 or feats.shape[0] != xyz.shape[0]:
                raise ValidationError(
                    f"feats must be (N, F) aligned with xyz "
                    f"({xyz.shape[0]} points); got "
                    f"{getattr(feats, 'shape', None)}")
            if self.validate:
                try:
                    feats = validate_cloud(feats, "feats")
                except ValueError as e:
                    raise ValidationError(str(e)) from e
            else:
                feats = np.asarray(feats, np.float32)
        bucket = self.buckets.bucket_for(xyz.shape[0])
        lane = self._lanes[bucket.key]
        if (self.max_lane_depth is not None
                and len(lane) >= self.max_lane_depth):
            raise QueueFullError(bucket.key, len(lane))
        req = Request(
            rid=self._next_rid, xyz=xyz, feats=feats,
            key=key_data(key), bucket=bucket, t_arrival=now,
            t_deadline=t_deadline)
        self._next_rid += 1
        lane.append(req)
        return req

    def lane(self, bucket: Bucket) -> deque:
        return self._lanes[bucket.key]

    def take(self, bucket: Bucket, count: int) -> list[Request]:
        """Pop up to ``count`` requests from the lane front (FIFO)."""
        lane = self._lanes[bucket.key]
        return [lane.popleft() for _ in range(min(count, len(lane)))]

    def shed_expired(self, now: float) -> list[Request]:
        """Remove (from any lane position) every queued request whose
        deadline has passed — device compute spent on them would be
        wasted; the dispatcher records them as deadline misses.
        Surviving requests keep their FIFO order."""
        shed: list[Request] = []
        for key, lane in self._lanes.items():
            expired = {r.rid for r in lane
                       if r.t_deadline is not None and now >= r.t_deadline}
            if expired:
                shed.extend(r for r in lane if r.rid in expired)
                self._lanes[key] = deque(
                    r for r in lane if r.rid not in expired)
        return shed

    def pending(self) -> int:
        return sum(len(lane) for lane in self._lanes.values())

    def pending_rids(self) -> set[int]:
        """The rids currently queued (the dispatcher's unknown-rid
        diagnosis needs to tell pending from never-submitted)."""
        return {r.rid for lane in self._lanes.values() for r in lane}

    def oldest_wait(self, bucket: Bucket, now: float) -> float:
        """Age of the lane's front request (0.0 for an empty lane)."""
        lane = self._lanes[bucket.key]
        return (now - lane[0].t_arrival) if lane else 0.0
