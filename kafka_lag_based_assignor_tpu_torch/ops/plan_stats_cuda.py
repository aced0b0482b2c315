"""Binding of the plan-statistics kernel (``csrc/plan_stats.cu``).

The kernel replaces ``kafka_lag_based_assignor_tpu/ops/plan_stats.py::
plan_stats_pallas``; the source says what bounds it.  :func:`launch` is
called by :func:`.plan_stats.plan_stats` for CUDA tensors only, after that
wrapper has checked the inputs; it allocates the outputs and the kernel's
scratch in one tensor and raises if the launch fails.
"""

from __future__ import annotations

import ctypes

import torch


def _bind():
    from ._build import load

    lib = load("plan_stats")
    fn = lib.klba_plan_stats
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.klba_plan_stats_scratch.argtypes = [ctypes.c_int] * 2
    lib.klba_plan_stats_scratch.restype = ctypes.c_longlong
    lib.klba_cuda_error_string.argtypes = [ctypes.c_int]
    lib.klba_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(ws_u, count_u, wsum_u, A, B):
    """(load f32[C], colsum f32[C]) from the kernel, on the inputs' card."""
    U, C = ws_u.shape[0], A.shape[0]
    lib = _bind()
    dev = ws_u.device
    buf = torch.empty(2 * C + lib.klba_plan_stats_scratch(U, C), dtype=torch.float32,
                      device=dev)
    out = buf[: 2 * C].view(2, C)
    with torch.cuda.device(dev):
        err = lib.klba_plan_stats(
            ws_u.data_ptr(), count_u.data_ptr(), wsum_u.data_ptr(),
            A.data_ptr(), B.data_ptr(), buf[2 * C:].data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(),
            U, C, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "plan_stats kernel launch failed: "
            + lib.klba_cuda_error_string(err).decode()
        )
    return out[0], out[1]
