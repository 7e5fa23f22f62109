"""Build and load the hand-written CUDA kernels, and check what a wrapper
hands them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/repro_torch/lib<name>-<hash>.so`` at
the repository root, keyed by a hash of the source, the headers in
``csrc/`` (``*.cuh``) and the flags, then loaded with ``ctypes``.  The
build runs at first use, so a fresh checkout builds everything it
launches; :func:`build` starts one ``nvcc`` per
source, all at once.  Nothing here runs at import time.

One lock guards the build, the library table and the launch counts, so
serving threads that reach a cold kernel together build it once, and a
count taken from several threads loses no launch.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches per wrapper, counted where the wrapper launches
LAUNCHES: collections.Counter = collections.Counter()
# nvcc's output per built source (register and shared-memory use), kept
# beside each library as lib<name>-<hash>.log
BUILD_LOG: dict = {}

_LIBS: dict = {}
_LOCK = threading.Lock()


def count_launch(*names: str) -> None:
    """Add one to each named count (a wrapper calls it where it launches
    its kernel, and nowhere else)."""
    with _LOCK:
        for name in names:
            LAUNCHES[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, every
    header in ``csrc/`` (a header edit rebuilds its includers) and the
    flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(names) -> float:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all in parallel.  Returns the wall seconds; raises with the
    compiler's output if one fails."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names) -> float:
    t0 = time.perf_counter()
    todo = []
    for n in names:
        out = library_path(n)
        if not out.exists():
            todo.append((n, out))
        elif out.with_suffix(".log").exists():
            BUILD_LOG[n] = out.with_suffix(".log").read_text()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                          f"{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                _build_locked([name])
                lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check_launch(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{prefix} launch failed: CUDA error {code} "
                           f"({fn(code).decode()})")


def check_operands(name: str, tensors: dict, device,
                   dtypes: dict | None = None) -> None:
    """Every operand on ``device``, contiguous, and of the dtype the caller
    allows for it in ``dtypes`` (operand name -> ``torch.dtype``), float32
    where it names none."""
    dtypes = dtypes or {}
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        want = dtypes.get(arg, "torch.float32")
        if str(t.dtype) != str(want):
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}, expected "
                             f"{want}")
