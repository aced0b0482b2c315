"""The native greedy core: ``native/greedy.cpp`` built with ``g++`` and bound
with ``ctypes`` (the ``native`` solver).

Counterpart of ``kafka_lag_based_assignor_tpu/native/__init__.py``.  The
library is built at first use into ``build/klba_torch/`` beside the
package, under a name that hashes the source and the flags (as
:func:`..ops._build.library_path` does for the CUDA sources), never into
the package directory.  There is no fallback: a missing ``g++`` or a failed
build raises ``RuntimeError``, and a non-zero return code of the core raises
``ValueError``; nothing answers from the Python oracle instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np

from ..ops import _build
from ..ops.dispatch import assign_per_topic
from ..types import AssignmentMap, TopicPartitionLag

SOURCE = Path(__file__).resolve().parent / "greedy.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where ``greedy.cpp`` builds to (addressed by its content and flags)."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    return _build.BUILD_DIR / f"libklba_native-{digest}.so"


def _build_library(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the native solver builds native/greedy.cpp "
            "at first use and needs a C++ compiler"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build native/greedy.cpp:\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded native library, built on first use; raises when it cannot
    be built or loaded.  A fresh build is counted
    (``utils/observability.compile_count``) after the lock is released."""
    global _lib
    fresh = False
    with _LOCK:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build_library(out)
                fresh = True
            lib = ctypes.CDLL(str(out))
            lib.klba_assign_greedy.restype = ctypes.c_int
            lib.klba_assign_greedy.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        lib = _lib
    if fresh:
        from ..utils.observability import note_kernel_build

        note_kernel_build()
    return lib


def available() -> bool:
    """Whether the native library can be built (or is built) and loaded."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def assign_topic_native(
    lags: np.ndarray, partition_ids: np.ndarray, num_consumers: int
) -> np.ndarray:
    """Run the native core on one topic's columns; returns choice int32[P]."""
    lib = load()
    lags = np.ascontiguousarray(lags, dtype=np.int64)
    pids = np.ascontiguousarray(partition_ids, dtype=np.int32)
    if pids.shape != lags.shape or lags.ndim != 1:
        raise ValueError(
            f"lags and partition_ids must be one-dimensional and of one length, "
            f"got {lags.shape} and {pids.shape}"
        )
    out = np.empty(lags.shape[0], dtype=np.int32)
    rc = lib.klba_assign_greedy(
        lags.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(lags.shape[0]),
        ctypes.c_int32(num_consumers),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise ValueError(f"klba_assign_greedy failed with code {rc}")
    return out


def assign_native(
    partition_lag_per_topic: Mapping[str, Sequence[TopicPartitionLag]],
    subscriptions: Mapping[str, Sequence[str]],
) -> AssignmentMap:
    """Map-level native solve: the same surface and the same output as the
    host oracle and the device dispatch."""
    return assign_per_topic(
        partition_lag_per_topic, subscriptions, assign_topic_native
    )
