"""Workload accounting — the paper's "theoretical workload optimization".

Counts, as the paper defines them (§V, §VI-B):

  baseline (traditional, no reuse):
      feature fetches   = sum over subsets of K
      MLP point-evals   = sum over subsets of K

  L-PCN (Islandization Unit):
      feature fetches   = unique cached points per island (pool fills)
                        + positions whose point never got a cache slot
                          (capacity overflow -> fetched again)
      MLP point-evals   = the same computed positions
                        + one delta-compensation MLP eval per non-hub
                          subset (the paper's "one-time overhead of
                          supplementary computation", §VI-B)
      solo subsets (island-capacity overflow) count at baseline cost.

Derived: fetch_saving = 1 − lpcn/baseline (paper Fig. 15 green bars), the
overall-memory saving folds in weight traffic (yellow bars), compute
saving (grey bars).  :func:`analyze` takes the batched structures of the
engine and gives one (B,) int64 counter per cloud.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .hub_schedule import Schedule
from .islandize import Islands
from .sampling import sqdist

COUNTERS = ("baseline_fetches", "lpcn_fetches", "baseline_mlp_evals",
            "lpcn_mlp_evals", "n_subsets", "n_islands_used")


def _at_least_one(v):
    """max(v, 1) of a python number or a counter tensor / array."""
    if isinstance(v, (int, float)):
        return max(v, 1)
    if isinstance(v, torch.Tensor):
        return torch.clamp(v, min=1)
    return np.maximum(v, 1)


@dataclass
class WorkloadReport:
    """Counters as :func:`analyze` makes them: (B,) int64 tensors for a
    batch, 0-d for one cloud; ``.concrete()`` gives python ints / numpy
    arrays.  ``k`` is the block's neighbor count (the first block's for a
    network total)."""
    baseline_fetches: int
    lpcn_fetches: int
    baseline_mlp_evals: int
    lpcn_mlp_evals: int
    n_subsets: int
    n_islands_used: int
    k: int

    @property
    def fetch_saving(self):
        return 1.0 - self.lpcn_fetches / _at_least_one(self.baseline_fetches)

    @property
    def compute_saving(self):
        return 1.0 - self.lpcn_mlp_evals / _at_least_one(
            self.baseline_mlp_evals)

    def memory_saving(self, feat_bytes: int, weight_bytes: int,
                      tile_rows: int = 16):
        """Overall-memory-access saving (paper's yellow bars).  Weight
        traffic model: the systolic FCU re-streams the layer weights once
        per ``tile_rows`` input rows (output-stationary tiling), so weight
        bytes scale with ceil(rows/tile_rows)."""
        def total(fetches):
            wpasses = -(-fetches // tile_rows)
            return fetches * feat_bytes + wpasses * weight_bytes
        base = total(self.baseline_fetches)
        ours = total(self.lpcn_fetches)
        return 1.0 - ours / _at_least_one(base)

    def scaled(self, mlp_flops_per_point: int) -> dict:
        return dict(
            baseline_flops=self.baseline_mlp_evals * mlp_flops_per_point,
            lpcn_flops=self.lpcn_mlp_evals * mlp_flops_per_point)

    def counters(self) -> tuple:
        return tuple(getattr(self, name) for name in COUNTERS)

    def concrete(self) -> "WorkloadReport":
        """Tensor counters as python ints (0-d) or numpy arrays ((B,))."""
        def g(v):
            if not isinstance(v, torch.Tensor):
                return v
            arr = v.cpu().numpy()
            return int(arr) if arr.ndim == 0 else arr
        return WorkloadReport(*(g(v) for v in self.counters()), self.k)

    @classmethod
    def sum_counters(cls, reports) -> "WorkloadReport":
        """Sum the counters of several reports (layers may differ in k;
        the first one's is kept)."""
        return cls(*(sum(xs) for xs in zip(*(r.counters() for r in reports))),
                   reports[0].k)

    @staticmethod
    def total(reports: list) -> "WorkloadReport":
        """Aggregate layer reports into a whole-network report."""
        if not reports:
            return WorkloadReport(0, 0, 0, 0, 0, 0, 0)
        return WorkloadReport.sum_counters([r.concrete() for r in reports])


def analyze(islands: Islands, sched: Schedule, k: int) -> WorkloadReport:
    """Exact workload counters of one DS layer over batched (B, …)
    islands and schedule -> a report of (B,) int64 counters, summed over
    every axis but the batch one."""
    def total(x):
        return x.reshape(x.shape[0], -1).sum(-1)

    live = sched.reuse_slot >= 0        # (B, H, M, K) cached positions
    first = sched.is_first              # fills (computed once)
    valid = sched.subset_valid          # (B, H, M)
    # positions holding a real point (ragged -1 slots never count)
    pos_valid = valid[..., None] & sched.pos_live

    n_rows = total(valid)
    n_solo = total(islands.solo)
    n_subsets = n_rows + n_solo
    computed_cached = total(first & live)              # pool fills
    overflow = total(pos_valid & ~live)                # never cached
    # one delta-MLP eval per non-hub processed subset
    n_non_hub = total(torch.clamp(valid.sum(-1) - 1, min=0))

    base = n_subsets * k
    lpcn_fetch = computed_cached + overflow + n_solo * k
    lpcn_mlp = computed_cached + overflow + n_non_hub + n_solo * k
    return WorkloadReport(
        baseline_fetches=base, lpcn_fetches=lpcn_fetch,
        baseline_mlp_evals=base, lpcn_mlp_evals=lpcn_mlp,
        n_subsets=n_subsets, n_islands_used=total(valid.any(-1)), k=k)


def overlap_histogram(nbr_idx: torch.Tensor, centers: torch.Tensor,
                      groups=(16, 16, 32)) -> dict:
    """Paper Fig. 4(b), on ONE cloud's (S, K) neighbor ids and (S, 3)
    centers: per subset, sort the other subsets by center distance and
    take the share of its gathered points each one also gathers, within
    distance groups (the nearest 16, the next 16, the next 32, the rest).
    -> {group: (mean, max)}.

    The overlap counts row i's slots whose id occurs in row j, through a
    (S, ids) membership table instead of an (S, S, K, K) comparison."""
    S, K = nbr_idx.shape
    d = sqdist(centers[:, None, :], centers[None, :, :])
    d.fill_diagonal_(float("inf"))
    order = torch.sort(d, dim=-1, stable=True).indices          # (S, S)
    ids = nbr_idx - nbr_idx.min()                   # -1 slots match too
    member = torch.zeros((S, int(ids.max()) + 1), dtype=torch.float32,
                         device=nbr_idx.device)
    member.scatter_(1, ids, 1.0)                               # row j has id
    hits = member[:, ids.reshape(-1)].reshape(S, S, K).sum(-1)  # (j, i)
    ov = hits.T / K                                             # (i, j)
    ov_sorted = torch.gather(ov, 1, order)
    out, lo = {}, 0
    for g in groups:
        seg = ov_sorted[:, lo:lo + g]
        out[f"near_{lo}_{lo + g}"] = (float(seg.mean()), float(seg.max()))
        lo += g
    rest = ov_sorted[:, lo:S - 1]
    out["rest"] = (float(rest.mean()), float(rest.max()))
    return out
