"""Lazy ``nvcc`` build of the port's CUDA sources and their ``ctypes`` binding.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/klba_torch/lib<name>-<digest>.so`` beside the package (the
checkout's ``build/`` directory), where ``<digest>`` hashes the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edited source never
reuses a stale library.  The build runs at first use, never at import:
importing this module needs no compiler and no card.

Each source has its own build lock, taken only around its own build and
load: a first-use build of ``rounds_scan.cu`` (about 40 s) blocks later
callers of that library until it is ready, and no other.  A solve the
watchdog abandons in the middle of a build leaves the build running in its
worker; the build finishes, the library is kept, and the next call reuses
it.  Every fresh build is counted (``utils/observability.compile_count``),
after its lock is released.

Every kernel wrapper counts its launches through :func:`count_launch`,
which holds one lock around the increment, so launches from several
threads at once all count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "klba_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# Guards _LOCKS; each source's own lock guards its build and load.
_LOCK = threading.Lock()
_LOCKS: Dict[str, threading.Lock] = {}


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` to a kernel wrapper's ``launches`` under one process-wide
    lock.  The sidecar's handler threads, the watchdog's workers and the
    scrubber launch from several threads at once, and ``+=`` on an
    attribute is a read and a write that a thread switch can split."""
    with _LAUNCH_LOCK:
        wrapper.launches += n


def _lock_for(name: str) -> threading.Lock:
    with _LOCK:
        lock = _LOCKS.get(name)
        if lock is None:
            lock = _LOCKS[name] = threading.Lock()
        return lock


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the port's CUDA kernels "
        "are built from csrc/ at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (addressed by its content, the
    shared headers' and the flags)."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library exists; returns
    (output path, process or None)."""
    out = library_path(name)
    if out.exists():
        return out, None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    with open(out.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
    return out, (proc, tmp)


def _finish(name: str, out: Path, started) -> Path:
    if started is None:
        return out
    proc, tmp = started
    if proc.wait() != 0:
        raise RuntimeError(
            f"nvcc failed to build csrc/{name}.cu:\n"
            + out.with_suffix(".log").read_text()
        )
    os.replace(tmp, out)
    return out


def build_all() -> Dict[str, float]:
    """Build every ``csrc/*.cu``, one nvcc per source, all started
    together (each under its build lock).  Returns the seconds until each
    library was ready."""
    from ..utils.observability import note_kernel_build

    t0 = time.perf_counter()
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    locks = [_lock_for(name) for name in names]
    fresh = 0
    seconds = {}
    for lock in locks:
        lock.acquire()
    try:
        started = {name: _start(name) for name in names}
        for name, (out, proc) in started.items():
            _finish(name, out, proc)
            fresh += proc is not None
            seconds[name] = time.perf_counter() - t0
    finally:
        for lock in locks:
            lock.release()
    for _ in range(fresh):
        note_kernel_build()
    return seconds


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (registers,
    shared memory and spills from ``-Xptxas -v``); empty if none."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    fresh = False
    with _lock_for(name):
        lib = _LIBS.get(name)
        if lib is None:
            out, started = _start(name)
            lib = ctypes.CDLL(str(_finish(name, out, started)))
            fresh = started is not None
            _LIBS[name] = lib
    if fresh:
        from ..utils.observability import note_kernel_build

        note_kernel_build()
    return lib
