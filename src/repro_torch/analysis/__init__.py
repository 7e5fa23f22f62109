"""repro_torch.analysis — static analysis for the port's contracts.

The counterpart of ``repro.analysis``: four rule families over the kernel
launches a forward resolves, ATen graphs of the eager FC stage and the
port's source (no kernel launches on the CPU; ``--device cuda`` runs the
matrix on the card too and holds its launches against the CPU's):

=======  ==========================================================
family   rules
=======  ==========================================================
kernel   K001 shared-memory budget · K002 route alignment · K003
         grid coverage · K004 resident-operand coverage · K005 one
         writer a tile unless merged in order (no atomics)
retrace  R001 numpy / other-device operand · R002 python-scalar
         operand · R003 unhashable plan key · R004 plan-cache,
         library-load or store-lookup growth
masking  M001 unguarded reduction over a point axis
repo     A001 torch random call without generator= · A002 dist
         import on the fast path · A003 wall-clock in compute code ·
         A004 silent error-swallowing except in the serving layer ·
         A005 dropped future in the serving layer
=======  ==========================================================

CLI: ``python -m repro_torch.analysis [--strict] [--json PATH]
[--device cpu|cuda]``; inline suppressions:
``# analysis: allow <rule id> [pattern] -- justification``.
"""
from .findings import (ERROR, WARNING, Finding, RULES, Suppression, active,
                       apply_suppressions, scan_suppressions)
from .kernels import (KernelSite, OperandInfo, check_kernel_site,
                      kernel_findings, kernel_sites, lint_plan,
                      site_from_capture)
from .masking import masked_reduction_findings, trace_graph
from .repolint import repo_findings
from .retrace import (cache_growth_findings, cache_size, leaf_findings,
                      static_findings)
from .targets import (Target, default_targets, reduced_specs,
                      spec_point_sizes)

__all__ = [
    "ERROR", "WARNING", "Finding", "RULES", "Suppression", "active",
    "apply_suppressions", "scan_suppressions",
    "KernelSite", "OperandInfo", "check_kernel_site", "kernel_findings",
    "kernel_sites", "lint_plan", "site_from_capture",
    "masked_reduction_findings", "trace_graph",
    "repo_findings",
    "cache_growth_findings", "cache_size", "leaf_findings",
    "static_findings",
    "Target", "default_targets", "reduced_specs", "spec_point_sizes",
]
