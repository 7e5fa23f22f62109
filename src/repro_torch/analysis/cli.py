"""``python -m repro_torch.analysis`` — run every rule family and report.

Usage:

    python -m repro_torch.analysis                 # full matrix on the card
    python -m repro_torch.analysis --strict        # exit 1 on unsuppressed errors
    python -m repro_torch.analysis --json results/analysis_report_torch.json
    python -m repro_torch.analysis --models pointnet2 --modes lpcn --quick
    python -m repro_torch.analysis --strict --device cpu    # no card

``--quick`` restricts the matrix to one model family (no serving,
sharded or entry-kernel targets) and skips the executable R004 probe.
Every target runs once on the CPU (the kernels' plain versions; its sites
derived with ``repro_torch.HW``'s SM count) and is traced there for the
masking lint.  On the card (the default, as for every entry point of the
port; exit 2 where there is none) each target runs there as well: its
kernels launch, the plans captured there are linted with the card's SM
count and the built libraries' own plans and shared memory (K001,
K003), and each card site must equal its CPU-derived twin (K003).
``--device cpu`` runs the CPU half alone.  The report is the JAX
package's schema (``level``, ``rules``, ``kernel_sites``, ``findings``,
``summary``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..device import resolve_device
from . import targets as T
from .findings import (RULES, Finding, active, apply_suppressions,
                       scan_suppressions)
from .kernels import kernel_findings, kernel_sites
from .masking import masked_reduction_findings
from .repolint import _iter_sources, repo_findings
from .retrace import leaf_findings, static_findings


def _src_suppressions(src_root: str | None):
    """Suppressions declared anywhere under src/repro_torch apply to
    logical-location findings via their fnmatch pattern."""
    if src_root is None:
        here = os.path.dirname(os.path.abspath(__file__))
        src_root = os.path.dirname(os.path.dirname(here))
    sups, meta = [], []
    for path in _iter_sources(src_root):
        s, m = scan_suppressions(path)
        sups.extend(s)
        meta.extend(m)
    return sups, meta


def _site_key(site) -> tuple:
    return (site.kernel, tuple(sorted(site.dims.items())),
            json.dumps(site.launch, sort_keys=True), site.smem)


def run_target(t, *, card_sms=None):
    """Run one target under ``plans.bypass()`` and ``plans.capture()``
    (the heuristic plans, whatever tile-plan store the host carries:
    autotuned entries are linted at promotion) -> its kernel sites."""
    from ..kernels import plans
    with plans.bypass(), plans.capture() as log:
        t.run()
    card = t.device.type == "cuda"
    return kernel_sites(log, where=t.name, sms=card_sms if card else None,
                        card=card)


def analyze_targets(target_list, suppressions=(), card_targets=None):
    """Run and trace each target and apply the K, M001 and R001–R003
    families.  ``card_targets``: the same targets on the card, whose
    sites are linted and held against the CPU's.  Returns ``(findings,
    kernel_inventory)``."""
    findings: list[Finding] = []
    inventory: list[dict] = []
    card_sms = None
    if card_targets:
        card_sms = torch.cuda.get_device_properties(
            card_targets[0].device).multi_processor_count
    for i, t in enumerate(target_list):
        try:
            sites = run_target(t)
        except Exception as e:  # a target that cannot run is itself a defect
            findings.append(Finding(
                "K003", f"target failed to run: {type(e).__name__}: {e}",
                where=t.name))
            continue
        shown, matched = sites, None
        if card_targets:
            ct = card_targets[i]
            try:
                shown = run_target(ct, card_sms=card_sms)
            except Exception as e:
                findings.append(Finding(
                    "K003", f"target failed to run on the card: "
                            f"{type(e).__name__}: {e}", where=ct.name))
                shown = []
            matched = [_site_key(a) == _site_key(b)
                       for a, b in zip(shown, sites)]
            if len(shown) != len(sites):
                findings.append(Finding(
                    "K003", f"{len(shown)} kernel calls on the card, "
                            f"{len(sites)} derived on the CPU", where=t.name))
            for site, ok, cpu in zip(shown, matched, sites):
                if not ok:
                    findings.append(Finding(
                        "K003", f"the card's site {_site_key(site)} differs "
                                f"from the CPU-derived {_site_key(cpu)}",
                        where=site.where))
            findings.extend(kernel_findings(shown))
        findings.extend(kernel_findings(sites))
        if t.trace is not None:
            try:
                gm = t.trace()
            except Exception as e:
                findings.append(Finding(
                    "M001", f"target failed to trace: {type(e).__name__}: "
                            f"{e}", where=t.name))
            else:
                findings.extend(masked_reduction_findings(
                    gm, point_sizes=t.point_sizes, where=t.name))
        dev = card_targets[i] if card_targets else t
        if dev.operands is not None:
            findings.extend(leaf_findings(dev.operands, where=dev.name,
                                          device=dev.device))
        if t.statics:
            findings.extend(static_findings(t.statics, where=t.name))
        for j, site in enumerate(shown):
            inventory.append({
                "target": t.name, "site": site.where, "kernel": site.kernel,
                "family": t.family, "grid": list(site.grid),
                "dimension_semantics": list(site.semantics),
                "footprint_bytes": site.smem,
                "vmem_budget_mb": site.smem_limit / 2**20,
                "smem_limit": site.smem_limit,
                "smem_library": site.smem_library,
                "dims": site.dims, "plan": site.plan, "launch": site.launch,
                "device": (card_targets[i] if card_targets else t
                           ).device.type,
                "matches_cpu": None if matched is None else (
                    matched[j] if j < len(matched) else False),
            })
    return apply_suppressions(findings, list(suppressions)), inventory


def retrace_exec_findings(device="cpu") -> list[Finding]:
    """R004: one small engine, the JAX package's four same-shape input
    forms (raw tensor, Batch, Batch with n_valid, keys of numpy origin)
    must resolve their plans once.  This runs the forward."""
    from .. import engine, random
    from ..engine.params import Batch
    from ..kernels import plans
    from .retrace import cache_growth_findings

    device = torch.device(device)
    spec = T.reduced_specs()["pointnet2"]
    eng = engine.PCNEngine(spec, mode="lpcn", fc_backend="cuda",
                           device=device)
    params = eng.init(0)
    xyz, _ = T._clouds(spec, (96, 96))
    raw = torch.as_tensor(xyz, device=device)
    mixes = [
        (params, raw),                                          # raw tensor
        (params, Batch.make(raw, key=random.PRNGKey(1), device=device)),
        (params, Batch.make(raw, key=random.PRNGKey(1), n_valid=[96, 40],
                            device=device)),
        (params, Batch.make(raw, key=torch.stack(                # numpy keys
            [random.PRNGKey(i) for i in range(2)]).numpy().astype(
                "uint32"), device=device)),
    ]
    with plans.bypass():
        return cache_growth_findings(
            eng.apply, mixes,
            where=f"engine:pointnet2/lpcn/cuda/{device.type}/cache")


def build_report(findings, inventory, level: str) -> dict:
    errors = active(findings, "error")
    warnings = active(findings, "warning")
    return {
        "level": level,
        "rules": {rid: {"severity": sev, "description": desc}
                  for rid, (sev, desc) in RULES.items()},
        "kernel_sites": inventory,
        "findings": [f.to_dict() for f in findings],
        "summary": {
            "findings": len(findings),
            "errors": len(errors),
            "warnings": len(warnings),
            "suppressed": sum(f.suppressed for f in findings),
            "strict_ok": not errors,
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis over the engine matrix, the kernel "
                    "launches and the port's source")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 if any unsuppressed error-severity finding")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the JSON report here")
    p.add_argument("--models", nargs="*", default=list(T.MODELS),
                   choices=list(T.MODELS))
    p.add_argument("--modes", nargs="*", default=list(T.MODES),
                   choices=list(T.MODES))
    p.add_argument("--quick", action="store_true",
                   help="one model family, skip the executable R004 probe")
    p.add_argument("--no-exec", action="store_true",
                   help="skip the executable R004 cache-growth probe")
    p.add_argument("--no-repo", action="store_true",
                   help="skip the AST repo lint")
    p.add_argument("--device", default=None, choices=("cpu", "cuda"),
                   help="cuda (the default): run every target on the CPU "
                        "and on the card and hold the card's launches "
                        "against the CPU's; cpu: the CPU alone")
    args = p.parse_args(argv)
    try:
        on_card = resolve_device(args.device).type == "cuda"
    except RuntimeError as e:
        print(f"repro_torch.analysis: {e} (--device cpu)", file=sys.stderr)
        return 2

    models = args.models[:1] if args.quick else args.models
    sups, meta = _src_suppressions(None)
    kw = dict(models=models, modes=args.modes,
              include_serve=not args.quick, include_dist=not args.quick,
              include_entries=not args.quick)
    target_list = T.default_targets(device="cpu", **kw)
    card = T.default_targets(device="cuda", **kw) if on_card else None
    findings, inventory = analyze_targets(target_list, suppressions=sups,
                                          card_targets=card)
    findings.extend(meta)
    if not args.no_repo:
        findings.extend(repo_findings())
    if not (args.quick or args.no_exec):
        for dev in ("cpu",) + (("cuda",) if card else ()):
            findings.extend(apply_suppressions(retrace_exec_findings(dev),
                                               sups))

    level = "quick" if args.quick else "full"
    report = build_report(findings, inventory, level)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, default=str)

    for f in findings:
        print(f)
    s = report["summary"]
    print(f"repro_torch.analysis [{level}]: {len(target_list)} targets, "
          f"{len(inventory)} kernel sites, {s['findings']} findings "
          f"({s['errors']} errors, {s['warnings']} warnings, "
          f"{s['suppressed']} suppressed)")
    if args.strict and not s["strict_ok"]:
        print("STRICT: unsuppressed errors present", file=sys.stderr)
        return 1
    return 0
