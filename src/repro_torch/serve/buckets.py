"""Size buckets: the fixed set of (batch, n_points) shapes the server
serves.

Every fired batch has exactly its bucket's shape, so ragged traffic is
quantized onto a small set of shapes that the server warms once each at
start (the first forward at a shape builds whatever kernel is not built
yet and sizes the caching allocator's blocks).  A :class:`Bucket` is one
such shape: up to ``batch`` clouds, each padded to ``n_points`` rows.
:class:`BucketSet` owns the policy: a request of ``n`` points maps to the
*tightest* bucket (smallest ``n_points >= n``), which bounds per-request
padding waste by the gap between adjacent bucket sizes.

``BucketSet.plan`` derives bucket edges from an observed/expected size
distribution (quantile edges, rounded up to an alignment), for callers
that don't hand-pick sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from .errors import AdmissionError


@dataclass(frozen=True)
class Bucket:
    """One served batch shape: up to ``batch`` clouds padded to
    ``n_points`` rows each."""
    batch: int
    n_points: int

    def __post_init__(self):
        if self.batch < 1 or self.n_points < 1:
            raise ValueError(f"bucket needs batch >= 1 and n_points >= 1, "
                             f"got ({self.batch}, {self.n_points})")

    @property
    def key(self) -> tuple[int, int]:
        return (self.batch, self.n_points)

    def __str__(self):
        return f"({self.batch}x{self.n_points})"


class BucketSet:
    """An ordered set of buckets plus the request -> bucket policy."""

    def __init__(self, buckets: Iterable[Bucket]):
        bs = sorted(buckets, key=lambda b: b.n_points)
        if not bs:
            raise ValueError("BucketSet needs at least one bucket")
        sizes = [b.n_points for b in bs]
        if len(set(sizes)) != len(sizes):
            raise ValueError(f"duplicate bucket n_points in {sizes}")
        self.buckets: tuple[Bucket, ...] = tuple(bs)

    @property
    def max_points(self) -> int:
        return self.buckets[-1].n_points

    def bucket_for(self, n: int) -> Bucket:
        """Tightest admissible bucket for an ``n``-point cloud (smallest
        ``n_points >= n``); raises :class:`AdmissionError` for n < 1 or
        n beyond the largest bucket."""
        if n < 1:
            raise AdmissionError(
                f"cannot serve a {n}-point cloud (need n >= 1)")
        for b in self.buckets:
            if b.n_points >= n:
                return b
        raise AdmissionError(
            f"cloud has {n} points but the largest bucket is "
            f"{self.max_points}; add a larger bucket or downsample the "
            f"request")

    @staticmethod
    def make(n_sizes: Sequence[int], batch: int) -> "BucketSet":
        """Uniform-batch bucket set from explicit pad sizes."""
        return BucketSet(Bucket(batch, int(n)) for n in n_sizes)

    @staticmethod
    def plan(sizes: Sequence[int], *, n_buckets: int = 2, batch: int = 4,
             align: int = 64) -> "BucketSet":
        """Derive bucket edges from a sample of request sizes: quantile
        edges (equal request mass per bucket), each rounded up to a
        multiple of ``align`` so the padded shapes stay aligned.
        The top edge always covers ``max(sizes)``."""
        if len(sizes) == 0:
            raise ValueError("plan needs a non-empty size sample")
        qs = np.quantile(np.asarray(sizes, np.float64),
                         [(i + 1) / n_buckets for i in range(n_buckets)])
        edges = sorted({int(-(-max(q, 1) // align) * align) for q in qs})
        return BucketSet(Bucket(batch, e) for e in edges)

    def __iter__(self):
        return iter(self.buckets)

    def __len__(self):
        return len(self.buckets)

    def __repr__(self):
        return f"BucketSet[{', '.join(map(str, self.buckets))}]"
