"""Shape-keyed, card-keyed tile-plan store for the two FC kernels.

The port's counterpart of ``repro.kernels.plans``.  The autotuner
(``repro_torch.launch.autotune``) times candidate plans per ``(kernel, B,
shape)`` cell on a card and keeps the winners here
(``results/tile_plans_torch.json`` by default, or ``$REPRO_TORCH_TILE_PLANS``).
The wrappers of ``gather_mlp`` and ``hub_reuse`` consult the active store
when they resolve a call's plan, in this order:

    explicit knob (``kernel_kw``)  >  store hit ("autotuned")  >  heuristic

A miss, or an entry that is invalid or no longer fits, resolves by the
heuristic (the entry warns, ``RuntimeWarning``); an explicit knob that
does not fit raises.

Each entry is keyed by the card as well as the cell,
``"<torch.cuda.get_device_name()>|" + plan_key(kernel, dims)`` (``"cpu|…"``
for a CPU forward), so an entry measured on another card is a miss.  The
file is JSON version 1, ``{"version": 1, "plans": {key: entry}}``, and an
entry holds one knob (:data:`~repro_torch.kernels.tiling.KNOBS`):

    gather_mlp  {"rows": 64|128}     (narrow and linear routes)
                {"nsplit": n}        (wide route)
    hub_reuse   {"chunk": 64|128}    (resident route, either form)

A one-layer call of either kernel (``w2`` None) is keyed with ``h=0``, so
its cell never meets the two-layer cell of the same widths.

or ``{"variant": "per_cloud"}`` (one launch per cloud, at B = 1: the cell
where the batched launch measured slower; the JAX package's ``"vmap"``),
with ``"provenance": "autotuned"`` and the measurement's context.

Changing the store, or entering and leaving :func:`bypass`, clears the
wrappers' memo of resolved plans (:func:`register_cache_clearer`), so the
next call resolves anew.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from contextlib import contextmanager

from .tiling import CHUNKS, KNOBS, ROWS

VERSION = 1
DEFAULT_PATH = os.path.join("results", "tile_plans_torch.json")
ENV_VAR = "REPRO_TORCH_TILE_PLANS"
VARIANTS = ("per_cloud",)


def plan_key(kernel: str, dims: dict) -> str:
    """Canonical cell key, the JAX package's, e.g.
    ``"gather_mlp|b=2,d=35,dc=3,f=128,h=64,k=8,s=64"``."""
    if kernel not in KNOBS:
        raise ValueError(f"unknown kernel {kernel!r}; "
                         f"expected one of {sorted(KNOBS)}")
    return kernel + "|" + ",".join(
        f"{k}={int(v)}" for k, v in sorted(dims.items()))


_NAMES: dict = {}


def device_name(device=None) -> str:
    """The name entries are keyed by: ``torch.cuda.get_device_name`` of a
    CUDA device (the current one where ``device`` is None and a card is
    there), else the device type (``"cpu"``)."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = torch.cuda.current_device() if dev.index is None else dev.index
    name = _NAMES.get(index)
    if name is None:
        name = _NAMES[index] = torch.cuda.get_device_name(index)
    return name


def store_key(kernel: str, dims: dict, device=None) -> str:
    """``"<device name>|" + plan_key(kernel, dims)``."""
    return f"{device_name(device)}|{plan_key(kernel, dims)}"


def knobs(kernel: str, entry: dict) -> dict:
    """The knob fields of a plan entry (``{}`` for a per_cloud one)."""
    return {k: entry[k] for k in KNOBS[kernel] if entry.get(k) is not None}


def _int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def entry_error(kernel: str, entry) -> str | None:
    """Why ``entry`` is not a usable plan for ``kernel`` (None = valid).
    Checked on load and on record, so a hand-edited or version-skewed
    store degrades to the heuristic instead of failing a forward."""
    if kernel not in KNOBS:
        return f"unknown kernel {kernel!r}"
    if not isinstance(entry, dict):
        return "entry is not an object"
    foreign = sorted(({k for ks in KNOBS.values() for k in ks}
                      - set(KNOBS[kernel])) & set(entry))
    if foreign:
        return f"{foreign} are not knobs of {kernel}"
    set_knobs = knobs(kernel, entry)
    variant = entry.get("variant")
    if variant is not None:
        if variant not in VARIANTS:
            return f"unknown variant {variant!r} (expected 'per_cloud')"
        if set_knobs:
            return f"a per_cloud entry sets no knob, got {set_knobs}"
    elif len(set_knobs) != 1:
        return (f"needs exactly one of {list(KNOBS[kernel])}, got "
                f"{set_knobs}")
    for name, v in set_knobs.items():
        if not _int(v):
            return f"{name!r} must be an int, got {v!r}"
        if name == "rows" and v not in ROWS:
            return f"'rows' must be one of {ROWS}, got {v}"
        if name == "chunk" and v not in CHUNKS:
            return f"'chunk' must be one of {CHUNKS}, got {v}"
        if name == "nsplit" and v < 1:
            return f"'nsplit' must be a positive int, got {v}"
    if entry.get("provenance") != "autotuned":
        return (f"provenance {entry.get('provenance')!r} != 'autotuned' "
                f"(only measured winners belong in the store)")
    return None


class PlanStore:
    """A dict of :func:`store_key` -> plan entries with JSON persistence.

    ``load`` never raises on a bad file: a corrupt or mis-versioned file,
    or an invalid entry, warns (``RuntimeWarning``) and is dropped, so
    the wrappers resolve those cells by the heuristic."""

    def __init__(self, entries: dict | None = None,
                 path: str | None = None):
        self.entries: dict = dict(entries or {})
        self.path = path

    @classmethod
    def load(cls, path: str) -> "PlanStore":
        store = cls(path=path)
        if not os.path.exists(path):
            return store
        try:
            with open(path, encoding="utf-8") as fh:
                raw = json.load(fh)
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            warnings.warn(
                f"tile-plan store {path!r} is unreadable "
                f"({type(e).__name__}: {e}); the heuristic plans every "
                f"cell", RuntimeWarning, stacklevel=2)
            return store
        if not isinstance(raw, dict) or raw.get("version") != VERSION:
            warnings.warn(
                f"tile-plan store {path!r} has version "
                f"{raw.get('version') if isinstance(raw, dict) else '?'} "
                f"!= {VERSION}; ignoring it (re-run python -m "
                f"repro_torch.launch.autotune)", RuntimeWarning,
                stacklevel=2)
            return store
        for key, entry in (raw.get("plans") or {}).items():
            parts = str(key).split("|")
            kernel = parts[1] if len(parts) == 3 else None
            err = ("not '<device>|<kernel>|<dims>'" if kernel is None
                   else entry_error(kernel, entry))
            if err:
                warnings.warn(
                    f"tile-plan store {path!r}: dropping entry {key!r} "
                    f"({err}); the heuristic plans this cell",
                    RuntimeWarning, stacklevel=2)
                continue
            store.entries[key] = entry
        return store

    def lookup(self, kernel: str, *, device=None, **dims) -> dict | None:
        entry = self.entries.get(store_key(kernel, dims, device))
        return dict(entry) if entry is not None else None

    def record(self, kernel: str, dims: dict, entry: dict, *,
               device=None) -> str:
        """Insert a winner (validated: the tuner made it, so a bad entry is
        a fault, not a degradation) and clear the wrappers' plan memo."""
        err = entry_error(kernel, entry)
        if err:
            raise ValueError(f"refusing to record invalid plan for "
                             f"{plan_key(kernel, dims)}: {err}")
        key = store_key(kernel, dims, device)
        self.entries[key] = dict(entry)
        _clear_kernel_caches()
        return key

    def save(self, path: str | None = None) -> str:
        path = path or self.path or default_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"version": VERSION,
                       "plans": {k: self.entries[k]
                                 for k in sorted(self.entries)}},
                      fh, indent=1, sort_keys=True)
        self.path = path
        return path

    def __len__(self) -> int:
        return len(self.entries)


# ---- module state: the active store, bypass and capture --------------------

_lock = threading.Lock()
_store: PlanStore | None = None
_configured: bool = False        # configure() called (None = in-memory)
_configured_path: str | None = None
_bypass_depth = 0
_captures: list = []
_clearers: list = []


def default_path() -> str:
    return os.environ.get(ENV_VAR) or DEFAULT_PATH


def register_cache_clearer(fn) -> None:
    """The wrappers register their plan memo's ``clear`` here, so a store
    change is seen by the next call."""
    _clearers.append(fn)


def _clear_kernel_caches() -> None:
    for fn in _clearers:
        fn()


def configure(path: str | None) -> None:
    """Point the active store at ``path`` (None = a fresh in-memory store,
    nothing read from or written to disk)."""
    global _store, _configured, _configured_path
    with _lock:
        _configured = True
        _configured_path = path
        _store = PlanStore() if path is None else PlanStore.load(path)
    _clear_kernel_caches()


def refresh() -> None:
    """Re-read the configured (or default) store from disk."""
    global _store
    with _lock:
        path = _configured_path if _configured else default_path()
        _store = PlanStore() if path is None else PlanStore.load(path)
    _clear_kernel_caches()


def active_store() -> PlanStore:
    """The store the wrappers consult (loaded at first use from
    ``$REPRO_TORCH_TILE_PLANS`` or ``results/tile_plans_torch.json``)."""
    global _store
    with _lock:
        if _store is None:
            _store = PlanStore.load(default_path())
        return _store


def enabled() -> bool:
    return _bypass_depth == 0


@contextmanager
def bypass():
    """No store lookups inside the block: the wrappers resolve by the
    heuristic (explicit knobs still apply)."""
    global _bypass_depth
    _bypass_depth += 1
    _clear_kernel_caches()
    try:
        yield
    finally:
        _bypass_depth -= 1
        _clear_kernel_caches()


@contextmanager
def capture():
    """Record every plan the wrappers resolve inside the block, the plans
    actually launched.  Yields a list of ``{"kernel", "dims", "plan"}``
    dicts; a plan holds its ``provenance`` ("override", "autotuned" or
    "heuristic"), ``variant``, the route and its knob (None where the
    heuristic's depends on a card the call did not run on)."""
    log: list = []
    _captures.append(log)
    try:
        yield log
    finally:
        _captures.remove(log)


def capturing() -> bool:
    return bool(_captures)


def note_plan(kernel: str, dims: dict, plan: dict) -> None:
    """Called by the wrappers with each call's resolved plan."""
    for log in _captures:
        log.append({"kernel": kernel, "dims": dict(dims),
                    "plan": dict(plan)})


_lookups = [0]


def lookup_count() -> int:
    """Calls of :func:`lookup` so far (the wrappers call it where a call
    shape's plan is not memoised yet)."""
    return _lookups[0]


def lookup(kernel: str, *, device=None, **dims) -> dict | None:
    """Store lookup honouring :func:`bypass`; None on a miss."""
    _lookups[0] += 1
    if not enabled():
        return None
    return active_store().lookup(kernel, device=device, **dims)
