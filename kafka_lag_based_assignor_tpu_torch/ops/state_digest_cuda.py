"""Binding of the integrity-digest kernel (``csrc/state_digest.cu``, K6).

The kernel replaces ``kafka_lag_based_assignor_tpu/ops/linear_ot_pallas.py::
state_digest_pallas`` and the XLA row-table lane beside it; the source says
what bounds it.  :func:`launch` is called by :func:`.refine.state_digest`
for CUDA tensors only, after that wrapper has checked the inputs; it
allocates the output and the scratch and raises if the launch fails.
"""

from __future__ import annotations

import ctypes

import torch


def _bind():
    from ._build import load

    lib = load("state_digest")
    fn = lib.klba_state_digest
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    lib.klba_state_digest_scratch_bytes.argtypes = [ctypes.c_int]
    lib.klba_state_digest_scratch_bytes.restype = ctypes.c_longlong
    lib.klba_cuda_error_string.argtypes = [ctypes.c_int]
    lib.klba_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(lags_p, choice_p, counts, num_consumers: int, row_tab=None):
    """int64[5] digest from the kernel, on the inputs' card (lane 4 is
    meaningless when ``row_tab`` is None)."""
    C = int(num_consumers)
    M = 0 if row_tab is None else int(row_tab.shape[1])
    lib = _bind()
    dev = lags_p.device
    scratch = torch.empty(
        lib.klba_state_digest_scratch_bytes(C), dtype=torch.uint8, device=dev
    )
    out = torch.empty(5, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.klba_state_digest(
            lags_p.data_ptr(), choice_p.data_ptr(), counts.data_ptr(),
            0 if row_tab is None else row_tab.data_ptr(),
            lags_p.shape[0], C, M, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "state_digest kernel launch failed: "
            + lib.klba_cuda_error_string(err).decode()
        )
    return out
