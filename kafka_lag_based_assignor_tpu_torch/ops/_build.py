"""Lazy ``nvcc`` build of the port's CUDA sources and their ``ctypes`` binding.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/klba_torch/lib<name>-<digest>.so`` beside the package (the
checkout's ``build/`` directory), where ``<digest>`` hashes the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edited source never
reuses a stale library.  The build runs at first use, never at import:
importing this module needs no compiler and no card.
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
_LOCK = threading.Lock()


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
    together.  Returns the seconds until each library was ready."""
    t0 = time.perf_counter()
    started = {p.stem: _start(p.stem) for p in sorted(CSRC.glob("*.cu"))}
    seconds = {}
    for name, (out, proc) in started.items():
        _finish(name, out, proc)
        seconds[name] = time.perf_counter() - t0
    return seconds


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (registers,
    shared memory and spills from ``-Xptxas -v``); empty if none."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_finish(name, *_start(name))))
            _LIBS[name] = lib
        return lib
