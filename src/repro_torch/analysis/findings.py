"""Finding records, the rule catalog, and inline suppressions.

The port's copy of ``repro.analysis.findings``.  Every rule in
``repro_torch.analysis`` reports through a :class:`Finding`: a rule id, a
severity, a message, and a *location* string.  Locations are either
``path:line`` (AST rules) or a logical path like
``engine:pointnet2/lpcn/cuda/gather_mlp#0`` (kernel-site, graph and
operand rules); suppression patterns match against this string with
:mod:`fnmatch`.

Suppression syntax (inline comment, same line or the line above the
flagged source line; for logical findings put it anywhere under
``src/repro_torch``, with a pattern narrow enough to name the shapes it
excuses, as ``analysis/targets.py`` does):

    # analysis: allow <rule id> [fnmatch pattern] -- justification

The justification after ``--`` is mandatory: a suppression without one
does not take effect and is itself reported as ``S001``.
"""
from __future__ import annotations

import fnmatch
import re
from dataclasses import asdict, dataclass

ERROR = "error"
WARNING = "warning"

#: rule id -> (default severity, what it means for the CUDA kernels and
#: eager PyTorch)
RULES: dict[str, tuple[str, str]] = {
    # kernel-site lint (analysis/kernels.py)
    "K001": (ERROR, "a launch's shared memory exceeds a block's (227 KB), or "
                    "tiling.py's count differs from the built library's"),
    "K002": (ERROR, "a route's alignment precondition fails (row tile vs "
                    "padded K, wgmma's 16-byte rows, F tile widths, chunk)"),
    "K003": (ERROR, "the grid misses an output row or column, launches a "
                    "block wholly out of range, or differs from the plan "
                    "that launched"),
    "K004": (ERROR, "an operand the plan keeps resident in shared memory "
                    "does not cover its array"),
    "K005": (ERROR, "two blocks write one output tile and the plan does not "
                    "merge them in order (the kernels use no atomics)"),
    # host-side hazards of eager PyTorch (analysis/retrace.py)
    "R001": (ERROR, "numpy array or tensor on another device reaching an "
                    "entry point (a silent host copy on every call)"),
    "R002": (WARNING, "python scalar where a dtype is fixed (promotion "
                      "hazard: bf16 vs float32 rounding)"),
    "R003": (ERROR, "unhashable value in a memoised plan key (the "
                    "wrappers cannot resolve the call)"),
    "R004": (ERROR, "plan caches, kernel library loads or plan-store "
                    "lookups grew across same-shape input mixes"),
    # ragged-masking lint (analysis/masking.py)
    "M001": (ERROR, "reduction over a point axis without an n_valid mask / "
                    "sentinel fill"),
    # repo lint (analysis/repolint.py)
    "A001": (ERROR, "torch random call without an explicit generator= "
                    "(parity with JAX rests on explicit generators)"),
    "A002": (ERROR, "module-level repro_torch.dist / torch.distributed "
                    "import reachable from the mesh=None fast path"),
    "A003": (ERROR, "wall-clock call inside repro_torch.{core,kernels,"
                    "engine} compute code"),
    "A004": (ERROR, "blanket except in repro_torch.serve that neither "
                    "re-raises nor uses the caught error"),
    "A005": (ERROR, "future in repro_torch.serve whose result or exception "
                    "is never consumed"),
    # meta
    "S001": (WARNING, "suppression comment without a '-- justification' is "
                      "inactive"),
}


@dataclass
class Finding:
    rule: str
    message: str
    where: str            # "path:line" or a logical location
    severity: str = ""    # defaults from RULES at __post_init__
    file: str | None = None
    line: int | None = None
    suppressed: bool = False
    justification: str | None = None

    def __post_init__(self):
        if not self.severity:
            self.severity = RULES.get(self.rule, (ERROR, ""))[0]

    def to_dict(self) -> dict:
        d = asdict(self)
        d["description"] = RULES.get(self.rule, ("", ""))[1]
        return d

    def __str__(self):
        tag = " [suppressed]" if self.suppressed else ""
        return (f"{self.severity.upper()} {self.rule} {self.where}: "
                f"{self.message}{tag}")


@dataclass(frozen=True)
class Suppression:
    rule: str
    pattern: str          # fnmatch pattern vs Finding.where ("*" = any)
    justification: str
    file: str
    line: int


_SUPPRESS_RE = re.compile(
    r"#\s*analysis:\s*allow\s+(?P<rule>[A-Z]\d{3})"
    r"(?:\s+(?P<pattern>[^\s#]+))?"
    r"(?:\s*--\s*(?P<why>.+?))?\s*$"
)


def scan_suppressions(path: str, text: str | None = None):
    """Collect inline suppressions from one source file.

    Returns ``(suppressions, meta_findings)`` where meta_findings holds an
    S001 for every justification-less (and therefore inactive)
    suppression comment."""
    if text is None:
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
    sups: list[Suppression] = []
    meta: list[Finding] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        why = (m.group("why") or "").strip()
        if not why:
            meta.append(Finding(
                "S001",
                f"suppression for {m.group('rule')} has no '-- justification'",
                where=f"{path}:{lineno}", file=path, line=lineno))
            continue
        sups.append(Suppression(
            rule=m.group("rule"), pattern=m.group("pattern") or "*",
            justification=why, file=path, line=lineno))
    return sups, meta


def _matches(sup: Suppression, finding: Finding) -> bool:
    if sup.rule != finding.rule:
        return False
    # AST findings are line-scoped: the comment must sit on the flagged
    # line or the line directly above it, in the same file.
    if finding.file is not None and finding.line is not None:
        return (sup.file == finding.file
                and sup.line in (finding.line, finding.line - 1)
                and fnmatch.fnmatch(finding.where, sup.pattern))
    # logical findings match purely on the location pattern.
    return fnmatch.fnmatch(finding.where, sup.pattern)


def apply_suppressions(findings, suppressions):
    """Mark findings matched by a suppression; returns the same list."""
    for f in findings:
        for s in suppressions:
            if _matches(s, f):
                f.suppressed = True
                f.justification = s.justification
                break
    return findings


def active(findings, severity: str | None = None):
    """Unsuppressed findings, optionally filtered by severity."""
    out = [f for f in findings if not f.suppressed]
    if severity is not None:
        out = [f for f in out if f.severity == severity]
    return out
