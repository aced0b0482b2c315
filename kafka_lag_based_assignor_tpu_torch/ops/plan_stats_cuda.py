"""Binding of the plan-statistics kernel (``csrc/plan_stats.cu``, K3).

The kernel replaces ``kafka_lag_based_assignor_tpu/ops/plan_stats.py::
plan_stats_pallas``; the source says what bounds it.  :func:`launch` is
called by :func:`.plan_stats.plan_stats` for CUDA tensors only, after that
wrapper has checked the inputs; it allocates the outputs and raises if the
launch fails.

The kernel has three forms, chosen by shape (:func:`form_for`):
``"cluster"``, one launch of one thread-block cluster that needs no
scratch; ``"pass"``, the row-tile pass over the whole card (both up to
1,024 consumers, with the same arithmetic); and ``"columns"``, the column
form above 1,024 consumers (two launches: the value rows' statistics over
column tiles, then the columns).  The last two keep their tickets and
partial rows (and the column form its row statistics) in scratch, sized by
:func:`pass_geometry`, kept for each (device, stream) and grown when a call
needs more (:func:`scratch_for`); the tickets are zeroed when made and the
kernel leaves them zero, so no call at a shape seen before allocates
scratch or enqueues a memset.  The library is bound once.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

#: Consumers up to which A and B fit a lane's registers: the cluster and
#: pass forms' limit (``klba::kRegCols``); the column form above.
REG_COLS = 1024
#: Padded value rows up to which one cluster is faster than the whole card
#: (measured on the H100, ``PERF.md``): the cluster form's other limit.
CLUSTER_MAX_ROWS = 2048
#: Value rows a tile of the pass form.
VAL_TILE = 16
#: Value rows a tile of the column form.
COL_VAL_TILE = 64
#: Consumers a column tile of the column form (``klba::kColTile``).
COL_TILE = 1024
#: Value rows a block of the column form's statistics (``klba::kThreads``).
STATS_ROWS = 256

_NEEDS = ("both", "load", "colsum")
_fn = None
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def form_for(U: int, C: int) -> str:
    """The kernel form a call at U value rows and C consumers takes."""
    if C > REG_COLS:
        return "columns"
    return "cluster" if U <= CLUSTER_MAX_ROWS else "pass"


def pass_geometry(U: int, C: int) -> Tuple[int, int, int, int]:
    """(tile, per, tickets, floats) of the pass form (C <= REG_COLS) or the
    column form (above): tiles of VAL_TILE (COL_VAL_TILE) rows in groups of
    ``per`` = ceil(sqrt(tiles)) tiles; the tickets it takes and the floats
    of its partial rows (the tile rows of both marginals and, with more
    than one group, the group rows).  The pass form's tickets: tiles +
    groups + 3 (a tile's, a group's, the last group's, the work queue's and
    the exit count).  The column form's: (tiles + groups + 1) for each
    column tile of COL_TILE consumers, the column tiles' totals' ticket,
    one a STATS_ROWS-row block of the statistics and the exit count; its
    floats add the row statistics, 4 a row and 2 a row and column tile, and
    4 of alignment slack.  ``klba_plan_stats`` checks that its scratch holds
    both."""
    cols = C > REG_COLS
    tile = COL_VAL_TILE if cols else VAL_TILE
    tiles = -(-U // tile)
    per = math.isqrt(tiles - 1) + 1
    groups = -(-tiles // per)
    floats = 2 * tiles * C + (2 * groups * C if groups > 1 else 0)
    if not cols:
        return tile, per, tiles + groups + 3, floats
    n_ct = -(-C // COL_TILE)
    tickets = (tiles + groups + 1) * n_ct + 1 + -(-U // STATS_ROWS) + 1
    return tile, per, tickets, floats + 4 + U * (4 + 2 * n_ct)


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
        lib.klba_cuda_error_string.argtypes = [i32]
        lib.klba_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn, lib.klba_cuda_error_string
    return _fn


def launch(ws_u, count_u, wsum_u, A, B, need: str = "both", form: str | None = None):
    """(load, colsum) f32[C] from the kernel, on the inputs' card, with None
    for the marginal ``need`` leaves out.  ``form`` forces a form: the
    cluster (C <= 1024 only) or the whole-card pass, ``"pass"``, which
    takes its column form above 1,024 consumers (``"columns"`` names that
    form, and takes C > 1024 only); by default :func:`form_for`."""
    U, C = ws_u.shape[0], A.shape[0]
    form = form_for(U, C) if form is None else form
    if need not in _NEEDS or form not in ("cluster", "pass", "columns") or (
            form == "cluster" and C > REG_COLS) or (form == "columns" and C <= REG_COLS):
        raise ValueError(f"need {need!r} / form {form!r} at C {C}")
    fn, error_string = _bind()
    dev = ws_u.device
    w1, w2 = {"both": (wsum_u, count_u), "load": (wsum_u, None),
              "colsum": (count_u, None)}[need]
    out = torch.empty(C if w2 is None else 2 * C, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch, tile, per = (None, 0, None, 0), 0, 0
    if form != "cluster":
        tile, per, n_tickets, n_floats = pass_geometry(U, C)
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
