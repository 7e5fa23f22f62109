"""Quickstart: the batched engine API, end to end.

Shows the paper's full story through ``repro_torch.engine``: a batch of
clouds runs DS -> Octree-based Islandization -> Hub-based Scheduling ->
islandized Feature Computation -> logits, with swappable FC backends
("reference" plain PyTorch vs "cuda", the hand-written kernels) and the
workload report and exactness check against the traditional path.  The
port of the JAX package's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import engine, random
from ..data.synthetic import make_cloud
from ..device import resolve_device

# DGCNN(c)-style single block: activation at block end -> exact reuse
SPEC = engine.PCNSpec(
    name="dgcnn_quickstart",
    blocks=(engine.BlockSpec(1024, 32, (64, 128), kind="edge",
                             sampler="all"),),
    head_dims=(64,),
    n_classes=10,
    activation="block_end",
)


def main(argv=None) -> dict:
    """-> the two checked errors ({"exact": max |islandized − traditional|,
    "kernels": max |cuda − reference|})."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    xyz = np.stack([make_cloud(rng, 1024) for _ in range(4)])
    params = engine.init(SPEC, seed=0, device=dev)
    batch = engine.Batch.make(xyz, key=random.PRNGKey(0), device=dev)
    run = dict(spec=SPEC, isl_kw=dict(island_size=32, cache_capacity_x=2.0),
               device=dev)

    # lpcn/reference logits + workload report (per cloud)
    logits, rep = engine.apply_with_reports(params, batch, **run)
    print(f"batched logits: {tuple(logits.shape)}  (B clouds -> B logits)")
    fetches = int(rep.lpcn_fetches.sum())
    base = int(rep.baseline_fetches.sum())
    evals = int(rep.lpcn_mlp_evals.sum())
    base_e = int(rep.baseline_mlp_evals.sum())
    print(f"feature fetches:     {fetches} / {base} "
          f"(saving {1 - fetches / base:.1%})")
    print(f"MLP point-evals:     {evals} / {base_e} "
          f"(saving {1 - evals / base_e:.1%})")

    # exactness vs the traditional path (paper §VI-E, block-end case)
    ref = engine.apply(params, batch, mode="traditional", **run)
    err = float((logits - ref).abs().max())
    print(f"max |islandized - traditional| = {err:.2e}  (exact reuse)")
    assert err < 1e-3

    # backend agreement: the kernels vs the plain PyTorch backend
    cud = engine.apply(params, batch, mode="lpcn", fc_backend="cuda", **run)
    kerr = float((logits - cud).abs().max())
    print(f"max |cuda - reference|         = {kerr:.2e}")
    assert kerr < 1e-4
    return {"exact": err, "kernels": kerr}


if __name__ == "__main__":
    main()
