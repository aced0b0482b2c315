"""The P-step greedy scan (K7): the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

The JAX package runs these steps as a ``lax.scan`` inside
``kafka_lag_based_assignor_tpu/ops/scan_kernel.py::assign_topic_scan``;
there is no Pallas kernel to replace.  The kernel in
``csrc/scan_greedy.cu`` computes the same function as rounds: the eligible
set is fixed, so the steps fill rounds of E valid rows (E the eligible
consumers), each a sort of the E consumers by (total, index) on K1's
network in its three forms (``ops/rounds_cuda``): one thread block a topic
up to 16,384 eligible consumers, one thread-block cluster up to 131,072,
one block with its slots in device scratch above.  See the source for what
bounds it.  The wrapper picks
its instantiation (``scan_plan``: E, and the key form by K1's rule) from
what the caller knows on the host (``lag_range``: the main path's, with
every consumer eligible, reads nothing from the card), else from one host
read.

:func:`scan_greedy` is the wrapper.  A CUDA tensor launches the kernel or
raises; a CPU tensor runs :func:`scan_greedy_torch`, the plain version, the
literal step form.  Both accept the same inputs and raise on the same ones.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import count_launch
from .rounds_cuda import rank_bits_for, slots_for, wide_scratch
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


def host_lag_range(lags: np.ndarray, n_valid: np.ndarray) -> tuple:
    """The ``lag_range`` of :func:`scan_greedy` from host arrays: (the least
    lag, the largest |lag| times the most valid rows of a topic, a bound on
    any topic's sum of |valid lags|).  ``lags`` int64[T, P] holds every row,
    padding included (it only widens the range); ``n_valid`` int[T]."""
    if lags.size == 0:
        return 0, 0.0
    low, high = int(lags.min()), int(lags.max())
    return low, float(max(high, -low)) * float(np.max(n_valid, initial=0))


def scan_plan(sorted_lags, sorted_valid, num_consumers: int, eligible=None,
              lag_range=None) -> tuple:
    """(E, rank_bits) of a launch: E the eligible consumers (C without a
    mask), which sets the kernel's sort width (``rounds_cuda.slots_for(E)``
    slots); rank_bits the key form by K1's rule
    (:func:`..ops.rounds_cuda.rank_bits_for`) over each topic's valid lags,
    > 0 the packed key, 0 the two-key form.  Lags that are negative, or
    whose sum in a topic reaches 2^(61 - rank_bits) (lags near 2^62: the
    totals wrap), take the two-key form.  ``lag_range`` (as
    :func:`host_lag_range` gives it) stands in for the lags; without it, or
    with a mask, the plan takes one host read."""
    C = int(num_consumers)
    if lag_range is not None:
        low, bound = lag_range
        E = C if eligible is None else int(eligible.bool().sum())
        return E, rank_bits_for(C, bound, low)
    f64 = torch.float64
    live = torch.where(sorted_valid.bool(), sorted_lags, 0)
    if live.numel():
        bound, low = live.to(f64).abs().sum(dim=1).amax(), live.amin().to(f64)
    else:
        bound = low = torch.zeros((), dtype=f64, device=sorted_lags.device)
    n_eligible = (torch.full((), C, dtype=f64, device=sorted_lags.device) if eligible is None
                  else eligible.bool().sum().to(f64))
    bound, low, E = torch.stack([bound, low, n_eligible]).tolist()
    return int(E), rank_bits_for(C, bound, low)


def _bind():
    global _fn
    if _fn is None:
        from ._build import load

        lib = load("scan_greedy")
        fn = lib.klba_scan_greedy
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        lib.klba_cuda_error_string.argtypes = [ctypes.c_int]
        lib.klba_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn, lib.klba_cuda_error_string
    return _fn


def _launch(sorted_lags, sorted_valid, num_consumers: int, eligible, rank_bits=None,
            lag_range=None):
    """Launch the kernel in the key form of ``scan_plan``, or in the one
    ``rank_bits`` names (0: the two-key form, which takes any input)."""
    T, P = sorted_lags.shape
    C = int(num_consumers)
    dev = sorted_lags.device
    choice = torch.empty((T, P), dtype=torch.int32, device=dev)
    counts = torch.empty((T, C), dtype=torch.int32, device=dev)
    totals = torch.empty((T, C), dtype=torch.int64, device=dev)
    if T == 0:
        return choice, counts, totals
    E, planned = scan_plan(sorted_lags, sorted_valid, C, eligible, lag_range)
    rank_bits = planned if rank_bits is None else rank_bits
    fn, error_string = _bind()
    scratch = wide_scratch(T, slots_for(E), dev)
    args = (sorted_lags.data_ptr(), sorted_valid.data_ptr(),
            None if eligible is None else eligible.data_ptr(),
            choice.data_ptr(), counts.data_ptr(), totals.data_ptr(), T, P, C,
            E, rank_bits, None if scratch is None else scratch.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"scan_greedy kernel launch failed: {error_string(err).decode()}")
    count_launch(scan_greedy)
    return choice, counts, totals


def scan_greedy(sorted_lags, sorted_valid, num_consumers: int, eligible=None,
                lag_range=None):
    """The greedy scan over presorted rows.

    Args:
      sorted_lags: int64[T, P] — each topic's lags in processing order.
      sorted_valid: uint8[T, P] — their validity (0 = padding).
      num_consumers: C >= 1 (above 16,384 eligible consumers the kernel
        sorts on a thread-block cluster, above 131,072 in its scratch form,
        :func:`..ops.rounds_cuda.wide_scratch`).
      eligible: uint8[C] or None (every consumer eligible).
      lag_range: None, or (least lag, bound on any topic's sum of |valid
        lags|) as the caller knows them on the host (:func:`host_lag_range`);
        with no mask the launch then reads nothing from the card.  A range
        that does not hold the lags may give a wrong answer on the card.

    Returns (sorted_choice int32[T, P]: the consumer of each sorted row, -1
    where invalid or where no consumer is eligible; counts int32[T, C];
    totals int64[T, C], wrapping on overflow).  A CUDA tensor launches the
    kernel (and counts the launch in ``scan_greedy.launches``) or raises; a
    CPU tensor runs :func:`scan_greedy_torch`.
    """
    C = _check(sorted_lags, sorted_valid, num_consumers, eligible)
    if sorted_lags.device.type == "cpu":
        return scan_greedy_torch(sorted_lags, sorted_valid, C, eligible)
    return _launch(sorted_lags, sorted_valid, C, eligible, lag_range=lag_range)


scan_greedy.launches = 0
