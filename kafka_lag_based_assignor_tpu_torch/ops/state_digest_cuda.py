"""Binding of the integrity-digest kernel (``csrc/state_digest.cu``, K6).

The kernel replaces ``kafka_lag_based_assignor_tpu/ops/linear_ot_pallas.py::
state_digest_pallas`` and the XLA row-table lane beside it; the source says
what bounds it.  :func:`launch` is called by :func:`.refine.state_digest`
for CUDA tensors only, after that wrapper has checked the inputs; it
allocates the output and raises if the launch fails.  :func:`launch_rows`
is the batched entry (``klba_state_digest_rows``) that
:func:`.refine.state_digest_rows` calls: one launch for a coalescer wave's
N states, the rows on the grid's y axis, a scratch row each.
:func:`launch_shard` is the per-shard entry (``klba_state_digest_shard``)
that :func:`.refine.state_digest_sharded` calls once a shard of a placed
resident state: the shard's partial lanes and occupancy histogram.

The kernel's accumulators, ticket and histogram live in a scratch buffer
that is zeroed once for each (device, stream) and grown when a call needs
more consumers than it holds; the kernel leaves it zero, so a repeated call
allocates no scratch and enqueues no memset.  The library is bound once.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

#: 64-bit words before the histogram: five sums, then the ticket.
ACC_WORDS = 8
_fn = None
_fn_rows = None
_fn_shard = None
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def scratch_bytes(num_consumers: int) -> int:
    """Bytes of scratch a call at C consumers needs: the accumulator words,
    then an int32 histogram of C bins."""
    return 8 * ACC_WORDS + 4 * int(num_consumers)


def scratch_row_bytes(num_consumers: int) -> int:
    """Bytes between two rows' scratch in a batched call: a row's scratch
    rounded up to whole 64-bit words."""
    return 8 * (ACC_WORDS + (int(num_consumers) + 1) // 2)


def scratch_for(device: torch.device, stream: int, num_consumers: int,
                rows: int = 1) -> torch.Tensor:
    """The scratch for (device, stream), holding at least ``num_consumers``
    bins for each of ``rows`` states: zeroed when made (or grown), then kept
    (the kernel leaves it zero)."""
    key = (device.index if device.index is not None else -1, stream)
    need = (scratch_bytes(num_consumers) if rows <= 1
            else int(rows) * scratch_row_bytes(num_consumers))
    buf = _scratch.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.uint8, device=device)
        _scratch[key] = buf
    return buf


def _bind():
    global _fn
    if _fn is None:
        from ._build import load

        lib = load("state_digest")
        fn = lib.klba_state_digest
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        lib.klba_cuda_error_string.argtypes = [ctypes.c_int]
        lib.klba_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn, lib.klba_cuda_error_string
    return _fn


def _bind_rows():
    global _fn_rows
    if _fn_rows is None:
        from ._build import load

        lib = load("state_digest")
        fn = lib.klba_state_digest_rows
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fn_rows = fn
    return _fn_rows


def _bind_shard():
    global _fn_shard
    if _fn_shard is None:
        from ._build import load

        lib = load("state_digest")
        fn = lib.klba_state_digest_shard
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _fn_shard = fn
    return _fn_shard


def launch_shard(lags, choice, counts, num_consumers: int, row_tab, lo: int,
                 total_rows: int, lead: bool):
    """The partial lanes int64[5] and the histogram int32[C] of the row
    shard ``[lo, lo + Bs)`` of a ``total_rows``-row state, on the shard's
    card: lags int64[Bs], choice int32[Bs], counts int32[C], row_tab
    int32[C, M] (the replicated copies on that card)."""
    C = int(num_consumers)
    fn = _bind_shard()
    _, error_string = _bind()
    dev = lags.device
    part = torch.empty(5, dtype=torch.int64, device=dev)
    hist = torch.empty(C, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        err = fn(lags.data_ptr(), choice.data_ptr(), counts.data_ptr(),
                 row_tab.data_ptr(), lags.shape[0], int(lo), int(total_rows), C,
                 int(row_tab.shape[1]), 1 if lead else 0,
                 scratch_for(dev, stream, C).data_ptr(), part.data_ptr(),
                 hist.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"state_digest_sharded kernel launch failed: {error_string(err).decode()}")
    return part, hist


def launch_rows(lags, choice, counts, num_consumers: int, row_tab):
    """int64[N, 5] digests of N states in one launch, on the inputs' card:
    lags int64[N, B], choice int32[N, B], counts int32[N, C], row_tab
    int32[N, C, M]."""
    N, B = lags.shape
    C = int(num_consumers)
    M = int(row_tab.shape[2])
    fn = _bind_rows()
    _, error_string = _bind()
    dev = lags.device
    out = torch.empty((N, 5), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        err = fn(lags.data_ptr(), choice.data_ptr(), counts.data_ptr(),
                 row_tab.data_ptr(), B, C, M, N,
                 scratch_for(dev, stream, C, rows=N).data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"state_digest_rows kernel launch failed: {error_string(err).decode()}")
    return out


def launch(lags_p, choice_p, counts, num_consumers: int, row_tab=None):
    """int64[5] digest from the kernel, on the inputs' card (lane 4 is
    meaningless when ``row_tab`` is None)."""
    C = int(num_consumers)
    M = 0 if row_tab is None else int(row_tab.shape[1])
    fn, error_string = _bind()
    dev = lags_p.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    out = torch.empty(5, dtype=torch.int64, device=dev)
    args = (lags_p.data_ptr(), choice_p.data_ptr(), counts.data_ptr(),
            None if row_tab is None else row_tab.data_ptr(), lags_p.shape[0], C, M,
            scratch_for(dev, stream, C).data_ptr(), out.data_ptr(), stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"state_digest kernel launch failed: {error_string(err).decode()}")
    return out
