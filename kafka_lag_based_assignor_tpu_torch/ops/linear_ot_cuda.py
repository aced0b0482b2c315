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
  it launches K5 at (A, B) for the load, its own extrapolation kernel
  (counted in ``mirror_prox_step.launches``) and K5 at (A_half, B): the
  two K5 passes count in ``superblock_partials.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import linear_ot
from .kernel_admission import lane_pad
from .rounds_cuda import MAX_SLOTS

#: Largest consumer count the kernel takes: the round scan's, so every
#: solver admits the same consumer groups.
MAX_CONSUMERS = MAX_SLOTS


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
    if not 1 <= C <= MAX_CONSUMERS:
        raise ValueError(
            f"the linear-OT kernels take 1 to {MAX_CONSUMERS} consumers, got {C}"
        )


def _bind():
    from ._build import load

    lib = load("linear_ot")
    fn = lib.klba_superblock_partials
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.klba_mirror_extrapolate
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p,
                                            ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.klba_cuda_error_string.argtypes = [ctypes.c_int]
    lib.klba_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            + lib.klba_cuda_error_string(err).decode()
        )


def _launch_partials(ws_b, cnt_b, A, B, colsum: bool):
    """K5 on the card, counted in ``superblock_partials.launches``:
    (sb_load [Sb, C], sb_col [Sb, C], load [C], colsum [C]), the colsum
    pair None when ``colsum`` is false."""
    Sb, tpb, tile = ws_b.shape
    C = A.shape[0]
    k = 2 if colsum else 1
    dev = ws_b.device
    parts = torch.empty((k, Sb * tpb, lane_pad(C)), dtype=torch.float32, device=dev)
    sb = torch.empty((k, Sb, C), dtype=torch.float32, device=dev)
    tot = torch.empty((k, C), dtype=torch.float32, device=dev)

    def second(t):
        return t[1] if colsum else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _bind()
    with torch.cuda.device(dev):
        err = lib.klba_superblock_partials(
            ws_b.data_ptr(), cnt_b.data_ptr(), A.data_ptr(), B.data_ptr(),
            ptr(parts[0]), ptr(second(parts)), ptr(sb[0]), ptr(second(sb)),
            ptr(tot[0]), ptr(second(tot)), Sb, tpb, tile, C, lane_pad(C),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "superblock_partials")
    superblock_partials.launches += 1
    return sb[0], second(sb), tot[0], second(tot)


def superblock_partials(ws_b, cnt_b, A, B):
    """Per-superblock partial marginals of the implicit plan.

    Args: ws_b, cnt_b float32[Sb, tpb, tile] (scaled lags and validity
    weights by row, padding rows 0); A, B float32[C], 1 <= C <= 16384.
    Returns (load float32[Sb, C], colsum float32[Sb, C]), each superblock's
    tiles summed in tile order.
    """
    _check(ws_b, cnt_b, A, B)
    if ws_b.device.type == "cpu":
        return linear_ot._superblock_partials(ws_b, cnt_b, A, B)
    sb_load, sb_col, _, _ = _launch_partials(ws_b, cnt_b, A, B, colsum=True)
    return sb_load, sb_col


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
    _, _, load1, _ = _launch_partials(ws_b, cnt_b, A, B, colsum=False)
    a_half = torch.empty_like(A)
    lib = _bind()
    dev = ws_b.device
    with torch.cuda.device(dev):
        err = lib.klba_mirror_extrapolate(
            load1.data_ptr(), A.data_ptr(), sc.data_ptr(), prev_spread.data_ptr(),
            float(eta), a_half.data_ptr(), A.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "mirror_prox_step")
    mirror_prox_step.launches += 1
    _, _, load2, colsum2 = _launch_partials(ws_b, cnt_b, a_half, B, colsum=True)
    return load1, load2, colsum2


mirror_prox_step.launches = 0
