"""Analytic per-device memory of every LM cell on the production meshes
(the port of ``repro.launch.memreport``; no trace, seconds):

    PYTHONPATH=src python -m repro_torch.launch.memreport [--multi-pod]

The meshes are those of a fake world (``launch.mesh.fake_world``): 256
ranks (16 x 16) or, with ``--multi-pod``, 512 (2 x 16 x 16), none
launched.  Each cell's bytes are ``launch.memmodel``'s; ``fits_hbm`` says
whether they fit one H100's 80 GB.
"""
from __future__ import annotations

import argparse
import json
import os

from ..configs import ARCH_IDS, SHAPES, SUBQUADRATIC, get_config
from . import memmodel
from .mesh import fake_world, make_production_mesh, release_world


def report(mesh, multi_pod: bool) -> list:
    """One record a cell (JAX's keys and bytes; ``fits_hbm``)."""
    dp = 32 if multi_pod else 16
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, sp in SHAPES.items():
            if sname == "long_500k" and arch not in SUBQUADRATIC:
                continue
            if sp.kind == "train":
                mb = max(min(16, sp.global_batch // dp), 1)
                accum = 2 if cfg.family == "moe" else 4
                r = memmodel.train_footprint(cfg, sname, mesh, mb,
                                             accum_bytes=accum)
            elif sp.kind == "decode":
                r = memmodel.decode_footprint(cfg, sname, mesh)
            else:  # prefill: no grads/opt/residual pyramid, last-token head
                full = memmodel.train_footprint(cfg, sname, mesh, 1)
                work = (full["working_set_bytes"]
                        + full["residuals_bytes"] // max(cfg.n_layers, 1)
                        * 2)
                r = {"params_bytes": full["params_bytes"],
                     "working_set_bytes": work,
                     "total_bytes": full["params_bytes"] + work}
                r["fits_hbm"] = memmodel.fits(r["total_bytes"])
            r.update(arch=arch, shape=sname,
                     gib=round(r["total_bytes"] / 2**30, 2))
            out.append(r)
            print(f"{arch:28s} {sname:12s} {r['gib']:7.2f} GiB/device "
                  f"fits_hbm={r['fits_hbm']}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/memmodel.json")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    fake_world(512 if args.multi_pod else 256)
    try:
        out = report(make_production_mesh(multi_pod=args.multi_pod,
                                          device="meta"), args.multi_pod)
    finally:
        release_world()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1, default=str)
    return out


if __name__ == "__main__":
    main()
