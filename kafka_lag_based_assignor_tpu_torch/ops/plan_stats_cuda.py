"""Binding of the plan-statistics kernel (``csrc/plan_stats.cu``, K3).

The kernel replaces ``kafka_lag_based_assignor_tpu/ops/plan_stats.py::
plan_stats_pallas``; the source says what bounds it.  :func:`launch` is
called by :func:`.plan_stats.plan_stats` for CUDA tensors only, after that
wrapper has checked the inputs; it allocates the outputs and raises if the
launch fails.

The kernel has two forms with the same arithmetic, chosen by shape
(:func:`form_for`): ``"cluster"``, one launch of one thread-block cluster
that needs no scratch, and ``"pass"``, the row-tile pass over the whole card
(:func:`pass_geometry`), whose tickets and partial rows (and, above about
57,000 consumers, the plan's tile) live in scratch.
That scratch is kept for each (device, stream) and grown when a call needs
more (:func:`scratch_for`); the tickets are zeroed when made and the kernel
leaves them zero, so no call at a shape seen before allocates scratch or
enqueues a memset.  The library is bound once.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

#: Consumers up to which A and B fit a lane's registers: the cluster form's
#: limit (``klba::kRegCols``).
REG_COLS = 1024
#: Padded value rows up to which one cluster is faster than the whole card
#: (measured on the H100, ``PERF.md``): the cluster form's other limit.
CLUSTER_MAX_ROWS = 2048
#: Value rows a tile of the pass form.
VAL_TILE = 16

_NEEDS = ("both", "load", "colsum")
_fn = None
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def form_for(U: int, C: int) -> str:
    """The kernel form a call at U value rows and C consumers takes."""
    return "cluster" if C <= REG_COLS and U <= CLUSTER_MAX_ROWS else "pass"


def pass_geometry(U: int, C: int) -> Tuple[int, int, int, int]:
    """(tile, per, tickets, floats) of the pass form: tiles of VAL_TILE rows
    in groups of ``per`` = ceil(sqrt(tiles)) tiles; the tickets it takes
    (the pass's and the exit count) and the floats of its partial rows (the
    tile rows of both marginals and, with more than one group, the group
    rows).  ``klba_plan_stats`` checks that its scratch holds both."""
    tiles = -(-U // VAL_TILE)
    per = math.isqrt(tiles - 1) + 1
    groups = -(-tiles // per)
    return VAL_TILE, per, tiles + groups + 3, 2 * tiles * C + (2 * groups * C if groups > 1 else 0)


def scratch_for(device: torch.device, stream: int, tickets: int, floats: int):
    """The pass form's scratch for (device, stream), holding at least
    ``tickets`` int32 tickets and ``floats`` floats of partial rows: the
    tickets zeroed when made (or grown), then kept (the kernel leaves them
    zero; it writes every partial row before it reads it)."""
    key = (device.index if device.index is not None else -1, stream)
    held = _scratch.get(key)
    if held is None or held[0].numel() < tickets or held[1].numel() < floats:
        have = (0, 0) if held is None else (held[0].numel(), held[1].numel())
        held = (torch.zeros(max(tickets, have[0]), dtype=torch.int32, device=device),
                torch.empty(max(floats, have[1]), dtype=torch.float32, device=device))
        _scratch[key] = held
    return held


def _bind():
    global _fn
    if _fn is None:
        from ._build import load

        lib = load("plan_stats")
        fn = lib.klba_plan_stats
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 8 + [i32, ptr, ctypes.c_longlong] + [i32] * 4 + [ptr]
        fn.restype = i32
        lib.klba_row_tile_x_floats.argtypes = [i32]
        lib.klba_row_tile_x_floats.restype = ctypes.c_longlong
        lib.klba_cuda_error_string.argtypes = [i32]
        lib.klba_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn, lib.klba_cuda_error_string, lib.klba_row_tile_x_floats
    return _fn


def launch(ws_u, count_u, wsum_u, A, B, need: str = "both", form: str | None = None):
    """(load, colsum) f32[C] from the kernel, on the inputs' card, with None
    for the marginal ``need`` leaves out.  ``form`` forces a form (the
    cluster form takes C <= 1024 only); by default :func:`form_for`."""
    U, C = ws_u.shape[0], A.shape[0]
    form = form_for(U, C) if form is None else form
    if need not in _NEEDS or form not in ("cluster", "pass"):
        raise ValueError(f"need {need!r} / form {form!r}")
    fn, error_string, x_floats = _bind()
    dev = ws_u.device
    w1, w2 = {"both": (wsum_u, count_u), "load": (wsum_u, None),
              "colsum": (count_u, None)}[need]
    out = torch.empty(C if w2 is None else 2 * C, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch, tile, per = (None, 0, None, 0), 0, 0
    if form == "pass":
        tile, per, n_tickets, n_floats = pass_geometry(U, C)
        # The plan's tile lives after the partial rows where it does not fit
        # shared memory (0 floats where it does).
        with torch.cuda.device(dev):
            x = x_floats(C)
        if x < 0:
            raise RuntimeError("plan_stats: the card's SM count could not be read")
        n_floats += x
        tickets, rows = scratch_for(dev, stream, n_tickets, n_floats)
        scratch = (tickets.data_ptr(), tickets.numel(), rows.data_ptr(), rows.numel())
    at = out.data_ptr()
    args = (ws_u.data_ptr(), w1.data_ptr(), None if w2 is None else w2.data_ptr(),
            A.data_ptr(), B.data_ptr(), at, None if w2 is None else at + 4 * C,
            *scratch, U, C, tile, per, stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"plan_stats kernel launch failed: {error_string(err).decode()}")
    if need == "both":
        return out[:C], out[C:]
    return (out, None) if need == "load" else (None, out)
