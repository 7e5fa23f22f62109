"""Workload-reduction baselines the paper compares against (§VI-C), the
port's copy of ``repro.models.baselines``.

Mesorasi [16], Delayed-Aggregation: evaluate MLP(p, f) once for every
input point into a Point Feature Table (PFT), and MLP(c, 0) once per
center; a subset's result is then approximated by gather-combine:

    MLP(p − c, f)  ≈  PFT[p] − MLP(c, 0)        (exact iff MLP is linear)

This is "fully approximate" (every position approximated), where L-PCN
approximates only reused positions.  Its cost: N + S MLP evaluations, and
a PFT of N × F_out whose re-fetch traffic becomes the bottleneck (paper
Fig. 17's off-chip setting).  The PFT MLP runs over whole point sets as
plain ``torch.matmul`` (``apply_mlp``), as the JAX package leaves it to
XLA outside any Pallas kernel.

GDPCA [5] reduces the input bit width, not the evaluation count; it
changes no computation here, so it has no counterpart in this module.
"""
from __future__ import annotations

import torch

from ..core.islandize import _take
from ..core.mlp import MLP, apply_mlp, post_pool_activation
from ..core.workload import WorkloadReport


def _gather_rows(table, idx):
    """``table[..., idx, :]`` per leading batch entry: table (..., N, F),
    idx (..., S, K) -> (..., S, K, F); negative indices count from the end
    and the rest clamp into range, as a JAX gather takes them."""
    lead, n = idx.shape[:-2], table.shape[-2]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    out = _take(table.reshape((-1,) + table.shape[-2:]),
                idx.reshape((-1,) + idx.shape[-2:]))
    return out.reshape(lead + out.shape[1:])


def mesorasi_fc(mlp: MLP, xyz, feats, nbr_idx, centers_xyz,
                center_feats=None, kind: str = "sa"):
    """Delayed-Aggregation FC step.  xyz (..., N, 3), feats (..., N, F),
    nbr_idx (..., S, K), centers_xyz (..., S, 3) and, for ``kind="edge"``,
    center_feats (..., S, F), with any leading batch axes.  Returns
    (..., S, F_out) like ``fc_traditional``; the approximation error
    appears through the MLP's nonlinearity."""
    if kind == "sa":
        # PFT over all points: MLP(p, f); center table: MLP(c, 0)
        pft = apply_mlp(mlp, torch.cat([xyz, feats], dim=-1))
        c_in = torch.cat([centers_xyz, centers_xyz.new_zeros(
            centers_xyz.shape[:-1] + (feats.shape[-1],))], dim=-1)
        c_tab = apply_mlp(mlp, c_in)
        combined = _gather_rows(pft, nbr_idx) - c_tab[..., None, :]
    else:  # edge: MLP(f_j − f_i, f_i) ≈ MLP(f_j, 0) − MLP(f_i, 0) + MLP(0, f_i)
        pft = apply_mlp(mlp, torch.cat([feats, torch.zeros_like(feats)],
                                       dim=-1))
        cf = center_feats
        zc = torch.zeros_like(cf)
        c_neg = apply_mlp(mlp, torch.cat([cf, zc], dim=-1))
        c_self = apply_mlp(mlp, torch.cat([zc, cf], dim=-1))
        combined = (_gather_rows(pft, nbr_idx) - c_neg[..., None, :]
                    + c_self[..., None, :])
    return post_pool_activation(mlp, combined.amax(-2))


def mesorasi_workload(n_points: int, n_subsets: int, k: int
                      ) -> WorkloadReport:
    """Mesorasi's evaluation and fetch counts for one layer: N PFT
    evaluations + S center evaluations; every position re-fetches its PFT
    row (the delayed-aggregation phase's traffic)."""
    base = n_subsets * k
    return WorkloadReport(
        baseline_fetches=base, lpcn_fetches=base,   # PFT refetch ≈ base
        baseline_mlp_evals=base, lpcn_mlp_evals=n_points + n_subsets,
        n_subsets=n_subsets, n_islands_used=0, k=k)
