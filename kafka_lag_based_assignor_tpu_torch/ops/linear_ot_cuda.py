"""The linear-OT kernels: wrappers of ``csrc/linear_ot.cu`` and their plain
PyTorch versions.

Counterpart of ``superblock_partials_pallas`` (K5) and
``mirror_prox_step_pallas`` (K4) in
``kafka_lag_based_assignor_tpu/ops/linear_ot_pallas.py``; the source says
what bounds them.  Each wrapper checks its inputs, then launches the kernel
for a CUDA tensor (counting the launch) or raises, and runs its plain
version for a CPU tensor:

* :func:`superblock_partials` — per-superblock partial marginals
  ``(load[Sb, C], colsum[Sb, C])``; plain version
  :func:`..ops.linear_ot._superblock_partials`.  Counts in
  ``superblock_partials.launches``.
* :func:`mirror_prox_step` — one extragradient step, ``(load1, load2,
  colsum2)``; plain version :func:`mirror_prox_step_torch`.  On the card
  one host call launches two kernels: K5's pass at (A, B) for the load,
  whose last block also computes the damped step and A_half, and K5's pass
  at (A_half, B).  It counts once in ``mirror_prox_step.launches`` and
  twice in ``superblock_partials.launches``.

Each card call allocates its outputs and the kernel's scratch in one
tensor.  Both take any consumer count: above 1,024 consumers each pass is
the column form of ``csrc/row_tiles.cuh`` (two launches, the rows'
statistics then the columns), so a step launches four kernels there.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import linear_ot
from ._build import count_launch

#: Work items a tile at most (``kMaxSplit`` in ``csrc/row_tiles.cuh``).
_MAX_SPLIT = 8
def _check(ws_b, cnt_b, A, B, scalars=()) -> None:
    if ws_b.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the linear-OT kernels run on cuda or cpu, not {ws_b.device}")
    if ws_b.dim() != 3 or ws_b.dtype != torch.float32:
        raise ValueError(f"ws_b must be float32[Sb, tpb, tile], got {ws_b.dtype}"
                         f"{list(ws_b.shape)}")
    C = A.shape[0] if A.dim() == 1 else -1
    checks = [("cnt_b", cnt_b, tuple(ws_b.shape)), ("A", A, (C,)), ("B", B, (C,))]
    checks += [(name, t, ()) for name, t in scalars]
    for name, t, shape in checks:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32{list(shape)}, got {t.dtype}"
                             f"{list(t.shape)}")
        if t.device != ws_b.device:
            raise ValueError("the linear-OT kernel inputs must be on one device")
    if not all(t.is_contiguous() for t in (ws_b, cnt_b, A, B)):
        raise ValueError("ws_b, cnt_b, A and B must be contiguous")
    if ws_b.numel() == 0:
        raise ValueError("the linear-OT kernels need at least one row")
    if C < 1:
        raise ValueError(f"the linear-OT kernels take 1 or more consumers, got {C}")


def admit_sharded(rows_per_shard: int, num_consumers: int, tile: int) -> None:
    """Per-shard admission of the sharded linear duals (the counterpart of
    ``linear_pallas_admit_sharded``): each shard launches K5 over its own
    ``rows_per_shard`` rows in tiles of ``tile``, so K5's limits apply to
    that slice.  Raises ``ValueError`` outside them, on either device (the
    same shapes the kernel's own check refuses)."""
    rows, C, tile = int(rows_per_shard), int(num_consumers), int(tile)
    if C < 1:
        raise ValueError(f"the linear-OT kernels take 1 or more consumers, got {C}")
    if tile < 1 or rows < tile or rows % tile:
        raise ValueError(
            f"a shard of {rows} rows does not split into tiles of {tile}"
        )
    if rows > (1 << 31) or (rows // tile) * _MAX_SPLIT > (1 << 30):
        raise ValueError(f"a shard of {rows} rows is past the K5 kernel's limits")


def _bind():
    from ._build import load

    lib = load("linear_ot")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.klba_superblock_partials.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.klba_superblock_partials.restype = i32
    lib.klba_mirror_prox_step.argtypes = ([ptr] * 6 + [ctypes.c_float] + [ptr] * 4
                                          + [i32] * 4 + [ptr])
    lib.klba_mirror_prox_step.restype = i32
    lib.klba_linear_ot_scratch.argtypes = [i32] * 4
    lib.klba_linear_ot_scratch.restype = ctypes.c_longlong
    lib.klba_row_tile_smem_bytes.argtypes = [i32]
    lib.klba_row_tile_smem_bytes.restype = ctypes.c_longlong
    lib.klba_row_tile_col_tiles.argtypes = [i32]
    lib.klba_row_tile_col_tiles.restype = i32
    lib.klba_cuda_error_string.argtypes = [i32]
    lib.klba_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _call(name: str, shape, ws_b, cnt_b, A, B, *args):
    """One call of ``lib.<name>`` on the inputs' card, its outputs (a
    tensor of ``shape``, one output per row) and scratch in one allocation;
    ``args`` go between the duals and the scratch.  Returns the outputs."""
    Sb, tpb, tile = ws_b.shape
    C = A.shape[0]
    lib = _bind()
    dev = ws_b.device
    n = math.prod(shape)
    with torch.cuda.device(dev):
        scratch = lib.klba_linear_ot_scratch(Sb, tpb, tile, C)
        buf = torch.empty(n + scratch, dtype=torch.float32, device=dev)
        outs = buf[:n].view(shape).unbind(0)
        err = getattr(lib, name)(
            ws_b.data_ptr(), cnt_b.data_ptr(), A.data_ptr(), B.data_ptr(), *args,
            buf[n:].data_ptr(), *(o.data_ptr() for o in outs),
            Sb, tpb, tile, C, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.klba_cuda_error_string(err).decode())
    return outs


def superblock_partials(ws_b, cnt_b, A, B):
    """Per-superblock partial marginals of the implicit plan.

    Args: ws_b, cnt_b float32[Sb, tpb, tile] (scaled lags and validity
    weights by row, padding rows 0); A, B float32[C], C >= 1.
    Returns (load float32[Sb, C], colsum float32[Sb, C]), each superblock's
    tiles summed in tile order.
    """
    _check(ws_b, cnt_b, A, B)
    if ws_b.device.type == "cpu":
        return linear_ot._superblock_partials(ws_b, cnt_b, A, B)
    out = _call("klba_superblock_partials", (2, ws_b.shape[0], A.shape[0]),
                ws_b, cnt_b, A, B)
    count_launch(superblock_partials)
    return out


superblock_partials.launches = 0


def mirror_prox_step_torch(ws_b, cnt_b, A, B, sc, prev_spread, eta: float):
    """Plain PyTorch version of the step: the predictor load at (A, B),
    the damped step scale, A_half, and the corrector load and colsum at
    (A_half, B)."""
    load1 = linear_ot._ordered_sum(linear_ot._superblock_partials(ws_b, cnt_b, A, B)[0])
    spread = load1.max() - load1.min()
    sc_new = torch.where(spread > prev_spread, sc * 0.5,
                         torch.clamp(sc * 1.2, max=1.0))
    A_half = A + (eta * sc_new) * (load1 - linear_ot._mean_padded(load1))
    load2, colsum2 = linear_ot._superblock_partials(ws_b, cnt_b, A_half, B)
    return load1, linear_ot._ordered_sum(load2), linear_ot._ordered_sum(colsum2)


def mirror_prox_step(ws_b, cnt_b, A, B, sc, prev_spread, eta: float):
    """One extragradient step of the mirror-prox duals.

    Args: ws_b, cnt_b, A, B as :func:`superblock_partials`; sc and
    prev_spread float32 scalars (0-dim tensors on the inputs' device);
    eta the step size.  Returns (load1, load2, colsum2) float32[C].
    """
    _check(ws_b, cnt_b, A, B, (("sc", sc), ("prev_spread", prev_spread)))
    if ws_b.device.type == "cpu":
        return mirror_prox_step_torch(ws_b, cnt_b, A, B, sc, prev_spread, eta)
    out = _call("klba_mirror_prox_step", (3, A.shape[0]), ws_b, cnt_b, A, B, sc.data_ptr(),
                prev_spread.data_ptr(), ctypes.c_float(eta))
    count_launch(mirror_prox_step)
    count_launch(superblock_partials, 2)
    return out


mirror_prox_step.launches = 0
