"""The P-step greedy scan (K7): the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

The JAX package runs these steps as a ``lax.scan`` inside
``kafka_lag_based_assignor_tpu/ops/scan_kernel.py::assign_topic_scan``;
there is no Pallas kernel to replace.  On the card a loop of torch ops
would be several launches a step, P steps a topic, so the kernel in
``csrc/scan_greedy.cu`` runs the whole loop: one thread block per topic,
every consumer's slot in registers.  See the source for what bounds it.

:func:`scan_greedy` is the wrapper.  A CUDA tensor launches the kernel or
raises; a CPU tensor runs :func:`scan_greedy_torch`, the plain version.
Both accept the same inputs and raise on the same ones.
"""

from __future__ import annotations

import ctypes

import torch

from .rounds_cuda import MAX_SLOTS
from .scan_kernel import _argmin_consumer

_fn = None


def _check(sorted_lags, sorted_valid, num_consumers: int, eligible) -> int:
    """Raise on what the kernel does not take; return C."""
    if sorted_lags.device.type not in ("cuda", "cpu"):
        raise ValueError(f"scan_greedy runs on cuda or cpu, not {sorted_lags.device}")
    if sorted_lags.dim() != 2 or sorted_lags.dtype != torch.int64:
        raise ValueError(f"sorted_lags must be int64[T, P], got {sorted_lags.dtype}"
                         f"{list(sorted_lags.shape)}")
    if sorted_valid.dtype != torch.uint8 or sorted_valid.shape != sorted_lags.shape:
        raise ValueError(f"sorted_valid must be uint8{list(sorted_lags.shape)}, got "
                         f"{sorted_valid.dtype}{list(sorted_valid.shape)}")
    C = int(num_consumers)
    if C < 1:
        raise ValueError("the greedy scan needs at least one consumer")
    if C > MAX_SLOTS:
        raise ValueError(f"{C} consumers are above the greedy scan's limit of "
                         f"{MAX_SLOTS} (16 slots a thread over 1,024 threads)")
    tensors = [sorted_lags, sorted_valid]
    if eligible is not None:
        if eligible.dtype != torch.uint8 or tuple(eligible.shape) != (C,):
            raise ValueError(f"eligible must be uint8[{C}], got {eligible.dtype}"
                             f"{list(eligible.shape)}")
        tensors.append(eligible)
    if any(x.device != sorted_lags.device for x in tensors):
        raise ValueError("sorted_lags, sorted_valid and eligible must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("sorted_lags, sorted_valid and eligible must be contiguous")
    return C


def scan_greedy_torch(sorted_lags, sorted_valid, num_consumers: int, eligible=None):
    """Plain PyTorch version of the kernel: the JAX ``step`` body over every
    topic at once, one step a sorted row, up to the last valid row of any
    topic.  Each step takes :func:`..ops.scan_kernel._argmin_consumer` and
    gives the valid rows' lags to the winners; invalid rows get -1, and
    with no eligible consumer every row does.  Returns (sorted_choice
    int32[T, P], counts int32[T, C], totals int64[T, C])."""
    T, P = sorted_lags.shape
    C = int(num_consumers)
    dev = sorted_lags.device
    elig = (torch.ones(C, dtype=torch.bool, device=dev) if eligible is None
            else eligible.bool())
    choice = torch.full((T, P), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((T, C), dtype=torch.int32, device=dev)
    totals = torch.zeros((T, C), dtype=torch.int64, device=dev)
    ok = sorted_valid.bool() & elig.any()
    rows_valid = torch.nonzero(ok.any(dim=0))
    n = int(rows_valid.max()) + 1 if rows_valid.numel() else 0
    topics = torch.arange(T, device=dev)
    for s in range(n):
        who = _argmin_consumer(counts, totals, elig)
        v = ok[:, s]
        counts[topics, who] += v.to(torch.int32)
        totals[topics, who] += torch.where(v, sorted_lags[:, s], 0)
        choice[:, s] = torch.where(v, who, -1).to(torch.int32)
    return choice, counts, totals


def _bind():
    global _fn
    if _fn is None:
        from ._build import load

        lib = load("scan_greedy")
        fn = lib.klba_scan_greedy
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.klba_cuda_error_string.argtypes = [ctypes.c_int]
        lib.klba_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn, lib.klba_cuda_error_string
    return _fn


def _launch(sorted_lags, sorted_valid, num_consumers: int, eligible):
    T, P = sorted_lags.shape
    C = int(num_consumers)
    dev = sorted_lags.device
    choice = torch.empty((T, P), dtype=torch.int32, device=dev)
    counts = torch.empty((T, C), dtype=torch.int32, device=dev)
    totals = torch.empty((T, C), dtype=torch.int64, device=dev)
    if T == 0:
        return choice, counts, totals
    fn, error_string = _bind()
    args = (sorted_lags.data_ptr(), sorted_valid.data_ptr(),
            None if eligible is None else eligible.data_ptr(),
            choice.data_ptr(), counts.data_ptr(), totals.data_ptr(), T, P, C,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"scan_greedy kernel launch failed: {error_string(err).decode()}")
    scan_greedy.launches += 1
    return choice, counts, totals


def scan_greedy(sorted_lags, sorted_valid, num_consumers: int, eligible=None):
    """The greedy scan over presorted rows.

    Args:
      sorted_lags: int64[T, P] — each topic's lags in processing order.
      sorted_valid: uint8[T, P] — their validity (0 = padding).
      num_consumers: C, at most ``MAX_SLOTS``.
      eligible: uint8[C] or None (every consumer eligible).

    Returns (sorted_choice int32[T, P]: the consumer of each sorted row, -1
    where invalid or where no consumer is eligible; counts int32[T, C];
    totals int64[T, C], wrapping on overflow).  A CUDA tensor launches the
    kernel (and counts the launch in ``scan_greedy.launches``) or raises; a
    CPU tensor runs :func:`scan_greedy_torch`.
    """
    C = _check(sorted_lags, sorted_valid, num_consumers, eligible)
    if sorted_lags.device.type == "cpu":
        return scan_greedy_torch(sorted_lags, sorted_valid, C, eligible)
    return _launch(sorted_lags, sorted_valid, C, eligible)


scan_greedy.launches = 0
