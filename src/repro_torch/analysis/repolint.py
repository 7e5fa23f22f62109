"""Repo lint: AST-level forbidden-pattern rules over ``src/repro_torch``.

The port's copy of ``repro.analysis.repolint``, its rules read for eager
PyTorch:

* **A001** — a ``torch`` random call (``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``multinomial``, ``normal``, ``bernoulli``,
  ``poisson``, the ``*_like`` forms, ``torch.nn.init``'s random fills, or
  a tensor's in-place ``uniform_`` / ``normal_`` / ``random_`` / ...)
  without an explicit ``generator=``: the global generator's stream
  depends on every earlier draw in the process, and the port's parity
  with JAX rests on explicit generators (``repro_torch/random.py``).
* **A002** — a *module-level* ``repro_torch.dist`` or
  ``torch.distributed`` import in any module reachable (module-level
  import graph) from the ``mesh=None`` fast path roots
  (``repro_torch.engine``, ``repro_torch.serve``).  The compliant pattern
  is a function-level deferred import on the ``mesh`` branch (see
  ``engine/engine.py``, which imports ``engine/sharded.py`` only with a
  mesh); ``tests/test_torch_dist.py`` holds the same contract at run
  time.
* **A003** — wall-clock calls (``time.time`` / ``perf_counter`` /
  ``monotonic`` / ..., ``datetime.now``) inside the compute packages
  (``core``, ``kernels``, ``engine``): a forward that reads the clock is
  not a function of its inputs.  Host-side layers (``serve``, ``launch``,
  ``ckpt``, ``data``) may read clocks freely.
* **A004** — a bare ``except:`` (or blanket ``except Exception`` /
  ``except BaseException``) inside ``repro_torch.serve`` whose handler
  neither re-raises nor *uses* the caught exception: the fault-isolation
  layer turns failures into structured ``RequestError`` outcomes, and a
  handler that swallows one turns a failed request into a pending one.
* **A005** — a dropped future inside ``repro_torch.serve``: a
  ``.submit(...)`` whose result is discarded, or whose bound future is
  never consumed via ``.result`` / ``.exception`` /
  ``.add_done_callback`` (``.done()`` / ``.cancel()`` don't count).
  Bindings that escape the scope (returned, passed, stored) hand the
  obligation to the consumer and pass.

A004 and A005 are the JAX package's checks unchanged.  Inline
suppressions (``# analysis: allow A00x -- why``) on the flagged line or
the line above apply; see :mod:`repro_torch.analysis.findings`.
"""
from __future__ import annotations

import ast
import os

from .findings import Finding, apply_suppressions, scan_suppressions

PACKAGE = "repro_torch"

#: packages whose code computes a forward (A003)
COMPUTE_PACKAGES = ("repro_torch.core", "repro_torch.kernels",
                    "repro_torch.engine")

#: mesh=None fast-path roots for the A002 reachability check
FAST_PATH_ROOTS = ("repro_torch.engine", "repro_torch.serve")

#: what A002 keeps off the fast path
DIST_MODULES = ("repro_torch.dist", "torch.distributed")

#: package whose except handlers the A004 silent-swallow check covers
#: (the fault-isolation layer: errors must convert, never vanish)
ERROR_CONVERTING_PACKAGE = "repro_torch.serve"

#: torch's sampling functions, each taking ``generator=`` (A001)
_TORCH_RANDOM = {
    "torch." + f for f in (
        "rand", "randn", "randint", "randperm", "multinomial", "normal",
        "bernoulli", "poisson", "rand_like", "randn_like", "randint_like")
} | {
    "torch.nn.init." + f for f in (
        "uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
        "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
        "orthogonal_", "sparse_")
}

#: a tensor's in-place random fills, each taking ``generator=`` (A001)
_TENSOR_RANDOM = {"uniform_", "normal_", "random_", "exponential_",
                  "bernoulli_", "geometric_", "cauchy_", "log_normal_"}

#: except-clause types A004 treats as blanket catches
#: imports the module-level import graph follows
_TRACKED = (PACKAGE, "torch.distributed")

_BLANKET_EXCEPTS = {"Exception", "BaseException", "builtins.Exception",
                    "builtins.BaseException"}

#: Future methods that surface the stored exception (A005 consumers)
_FUTURE_CONSUMERS = {"result", "exception", "add_done_callback"}

#: Future methods that DON'T — a binding used only through these still
#: drops any error the submitted work raised
_FUTURE_STATE_ATTRS = {"done", "cancel", "cancelled", "running"}

_WALLCLOCK = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.thread_time", "time.perf_counter_ns",
    "time.time_ns", "time.monotonic_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}


def _module_name(root: str, path: str) -> str:
    rel = os.path.relpath(path, root)
    parts = rel[:-3].split(os.sep)          # strip .py; the package first
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _iter_sources(src_root: str):
    pkg = os.path.join(src_root, PACKAGE)
    for dirpath, _dirnames, filenames in os.walk(pkg):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


class _ModuleScan(ast.NodeVisitor):
    """One file: alias map, module-level tracked imports, flagged calls."""

    def __init__(self, module: str, path: str):
        self.module = module
        self.path = path
        self.aliases: dict[str, str] = {}       # local name -> dotted path
        self.top_imports: list[tuple[str, int]] = []   # (module, line)
        self.calls: list[tuple[str, int]] = []  # (resolved dotted call, line)
        self.random_calls: list[tuple[str, int]] = []  # A001 (call, line)
        self.swallows: list[tuple[int, str]] = []      # (line, clause) A004
        self.dropped_futures: list[tuple[int, str]] = []   # (line, desc) A005
        self._fn_depth = 0

    # -- imports ---------------------------------------------------------
    def _resolve_from(self, node: ast.ImportFrom) -> str | None:
        if node.level == 0:
            return node.module
        # relative import: anchor at this module's package
        base = self.module.split(".")
        if self.path.endswith("__init__.py"):
            base = base + ["_"]                  # package itself counts as level-1
        anchor = base[:-node.level]
        if node.module:
            anchor = anchor + node.module.split(".")
        return ".".join(anchor) if anchor else None

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0])
            if a.asname:
                self.aliases[a.asname] = a.name
            if self._fn_depth == 0 and a.name.startswith(_TRACKED):
                self.top_imports.append((a.name, node.lineno))
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        mod = self._resolve_from(node)
        if mod:
            for a in node.names:
                self.aliases[a.asname or a.name] = f"{mod}.{a.name}"
            if self._fn_depth == 0:
                if mod.startswith(_TRACKED):
                    self.top_imports.append((mod, node.lineno))
                for a in node.names:
                    sub = f"{mod}.{a.name}"
                    if sub.startswith(_TRACKED):    # from torch import
                        self.top_imports.append((sub, node.lineno))
        self.generic_visit(node)

    # -- calls -----------------------------------------------------------
    def _dotted(self, node) -> str | None:
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.aliases.get(node.id, node.id)
        return ".".join([head] + list(reversed(parts)))

    def visit_Call(self, node: ast.Call):
        dotted = self._dotted(node.func)
        if dotted:
            self.calls.append((dotted, node.lineno))
        seeded = any(k.arg == "generator" for k in node.keywords)
        method = (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _TENSOR_RANDOM)
        if not seeded and (dotted in _TORCH_RANDOM or (
                method and dotted not in _TORCH_RANDOM
                and not (dotted or "").startswith("torch.nn.init."))):
            self.random_calls.append((dotted or f".{node.func.attr}",
                                      node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        self._fn_depth += 1
        self.generic_visit(node)
        self._fn_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- except handlers (A004) ------------------------------------------
    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        types = ([] if node.type is None
                 else node.type.elts if isinstance(node.type, ast.Tuple)
                 else [node.type])
        blanket = node.type is None or any(
            self._dotted(t) in _BLANKET_EXCEPTS for t in types)
        if blanket:
            body_nodes = [n for stmt in node.body for n in ast.walk(stmt)]
            reraises = any(isinstance(n, ast.Raise) for n in body_nodes)
            uses_caught = node.name is not None and any(
                isinstance(n, ast.Name) and n.id == node.name
                for n in body_nodes)
            if not (reraises or uses_caught):
                clause = ("bare except" if node.type is None else
                          "except " + " | ".join(
                              filter(None, (self._dotted(t)
                                            for t in types))))
                self.swallows.append((node.lineno, clause))
        self.generic_visit(node)


def _is_submit_call(node) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "submit")


def _load_dotted(node) -> str | None:
    """Dotted path of a Name/Attribute chain (no call resolution)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return ".".join([node.id] + list(reversed(parts)))


def _dropped_futures(tree) -> list[tuple[int, str]]:
    """(line, description) for every ``.submit(...)`` whose outcome can
    never surface: the call's result discarded as a bare expression
    statement, or bound to a name/attribute that is only ever touched
    through non-consuming state checks (or never again at all).  A
    binding that escapes — returned, passed as an argument, stored
    somewhere, or accessed through a non-Future attribute — hands the
    obligation on and passes."""
    out = []
    scopes = [(tree, tree.body)]
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append((node, node.body))
    for scope, body in scopes:
        # statements of THIS scope only; nested defs are their own scope
        stmts, stack = [], list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            stmts.append(n)
            stack.extend(ast.iter_child_nodes(n))
        # parent links over the full scope: a closure may consume the
        # future its enclosing function submitted
        parent = {c: p for p in ast.walk(scope)
                  for c in ast.iter_child_nodes(p)}
        for n in stmts:
            if isinstance(n, ast.Expr) and _is_submit_call(n.value):
                out.append((n.lineno, ".submit(...) result discarded"))
                continue
            if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and _is_submit_call(n.value)):
                continue
            target = _load_dotted(n.targets[0])
            if target is None:
                continue
            consumed = False
            for m in ast.walk(scope):
                if (m is n.targets[0]
                        or not isinstance(getattr(m, "ctx", None), ast.Load)
                        or _load_dotted(m) != target):
                    continue
                p = parent.get(m)
                if isinstance(p, ast.Attribute):
                    if p.attr in _FUTURE_CONSUMERS:
                        consumed = True
                    elif p.attr not in _FUTURE_STATE_ATTRS:
                        consumed = True     # not a Future API: not ours
                else:
                    consumed = True         # escapes: consumer's problem
            if not consumed:
                out.append((n.lineno,
                            f"future {target!r} never consumed (no "
                            f".result/.exception/.add_done_callback)"))
    return out


def _scan_modules(src_root: str) -> dict[str, _ModuleScan]:
    scans = {}
    for path in _iter_sources(src_root):
        mod = _module_name(src_root, path)
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
        scan = _ModuleScan(mod, path)
        scan.source = text
        try:
            tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            raise SyntaxError(f"{path}: {e}") from e
        scan.visit(tree)
        scan.dropped_futures = _dropped_futures(tree)
        scans[mod] = scan
    return scans


def _reachable(scans: dict[str, _ModuleScan], roots) -> set[str]:
    known = set(scans)
    seen, frontier = set(), [r for r in roots if r in known]
    while frontier:
        mod = frontier.pop()
        if mod in seen:
            continue
        seen.add(mod)
        # importing a module imports every package __init__ above it
        parts = mod.split(".")
        for i in range(1, len(parts)):
            parent = ".".join(parts[:i])
            if parent in known and parent not in seen:
                frontier.append(parent)
        for imp, _line in scans[mod].top_imports:
            if imp in known and imp not in seen:
                frontier.append(imp)
    return seen


def repo_findings(src_root: str | None = None) -> list[Finding]:
    """Run A001–A005 (plus S001 for malformed suppressions) over the
    port's source tree rooted at ``src_root`` (default: the ``src/``
    directory this package was imported from)."""
    if src_root is None:
        here = os.path.dirname(os.path.abspath(__file__))   # .../analysis
        src_root = os.path.dirname(os.path.dirname(here))
    scans = _scan_modules(src_root)
    findings: list[Finding] = []
    suppressions = []
    for scan in scans.values():
        sups, meta = scan_suppressions(scan.path, scan.source)
        suppressions.extend(sups)
        findings.extend(meta)

    for mod, scan in sorted(scans.items()):
        for dotted, line in scan.random_calls:
            findings.append(Finding(
                "A001",
                f"{dotted}(...) without generator= draws from torch's "
                f"global generator — pass an explicit torch.Generator "
                f"(see repro_torch/random.py)",
                where=f"{scan.path}:{line}", file=scan.path, line=line))
        for dotted, line in scan.calls:
            if dotted in _WALLCLOCK and mod.startswith(COMPUTE_PACKAGES):
                findings.append(Finding(
                    "A003",
                    f"wall-clock call {dotted} in compute package scope "
                    f"({mod}) — a forward that reads the clock is not a "
                    f"function of its inputs; move it to the host-side "
                    f"caller",
                    where=f"{scan.path}:{line}", file=scan.path, line=line))
        if mod.startswith(ERROR_CONVERTING_PACKAGE):
            for line, clause in scan.swallows:
                findings.append(Finding(
                    "A004",
                    f"{clause} in {mod} neither re-raises nor uses the "
                    f"caught exception — the fault-isolation layer must "
                    f"convert failures to structured errors "
                    f"(RequestError / a counted rejection), never "
                    f"swallow them",
                    where=f"{scan.path}:{line}", file=scan.path, line=line))
            for line, desc in scan.dropped_futures:
                findings.append(Finding(
                    "A005",
                    f"{desc} in {mod} — an error raised on the executor "
                    f"thread lives only on the future; join it, read "
                    f".exception(), or attach a done-callback so the "
                    f"failure reaches the completion path",
                    where=f"{scan.path}:{line}", file=scan.path, line=line))

    reach = _reachable(scans, FAST_PATH_ROOTS)
    for mod in sorted(reach):
        for imp, line in scans[mod].top_imports:
            if any(imp == d or imp.startswith(d + ".")
                   for d in DIST_MODULES):
                findings.append(Finding(
                    "A002",
                    f"module-level import of {imp} in {mod}, which is "
                    f"reachable from the mesh=None fast path — defer it "
                    f"into the mesh branch (see engine/engine.py)",
                    where=f"{scans[mod].path}:{line}",
                    file=scans[mod].path, line=line))
                break
    return apply_suppressions(findings, suppressions)
