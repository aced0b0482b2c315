"""Linear-space OT quality mode: O(P + C)-memory mirror-prox solve.

Counterpart of ``kafka_lag_based_assignor_tpu/ops/linear_ot.py``.  The
same implicit plan ``logX[p, j] = -ws_p * A_j + B_j`` as the dense
Sinkhorn solver (:mod:`..models.sinkhorn`), iterated without the host
dedup pre-pass:

* **Mirror-prox duals** (Log-Averaged Mirror Prox, arXiv:2511.11359 —
  pattern only): an extragradient step, the gradient evaluated at the
  current duals (predictor) and at the extrapolated point (corrector).
  Each marginal evaluation streams the P axis in fixed-size tiles grouped
  into ``_SUPERBLOCKS`` blocks whose partials are always combined in the
  same left-to-right order; live memory is O(tile * C + P + C).  On the
  card one iteration is one step (:func:`.linear_ot_cuda.mirror_prox_step`,
  K4): two launches of the superblock-partials pass (K5), the first of
  which also computes the extrapolation in its last block.
* **Push-relabel-style additive rounding** (arXiv:2203.03732 — pattern
  only): the parallel rounding, exchange refinement and greedy portfolio
  shared with the Sinkhorn solver
  (:func:`..models.sinkhorn._round_refine_portfolio`).  The additive
  guarantee ``max consumer load <= total/C + max_lag`` is asserted on
  every solve.

The loop runs on the host: it reads one scalar from the card an iteration
(the stop test).  Mode selection lives in :mod:`.dispatch`.
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..types import AssignmentMap, TopicPartitionLag
from ..utils.config import validate_quality_tile as validate_tile
from ..utils import metrics
from ..utils.device import DeviceLike, resolve_device
from .kernel_admission import lane_pad as _lane_pad

LOGGER = logging.getLogger(__name__)

#: Fixed number of accumulation blocks along the P axis; their partial
#: marginals are combined in a fixed left-to-right order.
_SUPERBLOCKS = 8

#: Default rows per tile (the ``tpu.assignor.quality.tile`` default).
DEFAULT_TILE = 1024

#: Mirror-prox extragradient step size.
MIRROR_PROX_ETA = 8.0


def plan_shape(num_rows: int, tile: int):
    """Padded solve geometry ``(P2, tile_eff, n_tiles)``: ``P2`` the pow2
    bucket (>= 64 so the 8 superblocks stay non-empty), ``tile_eff`` the
    tile shrunk so the superblock split is exact."""
    from .packing import pad_bucket

    P2 = pad_bucket(max(int(num_rows), _SUPERBLOCKS * 8))
    t = max(8, min(validate_tile(tile), P2 // _SUPERBLOCKS))
    return P2, t, P2 // t


def _ws_cnt(lags, valid, scale: float):
    """Per-row f32 scaled lags (an f64 divide by the host scale, then the
    f32 cast, as the JAX package does) and validity weights."""
    w = torch.where(valid, lags, 0).to(torch.float64)
    return (w / scale).to(torch.float32), valid.to(torch.float32)


def _to_blocks(x, P2: int, nblocks: int, tile: int):
    """Pad a [P] vector to P2 rows (weight 0) and reshape to
    [nblocks, tiles_per_block, tile]."""
    x = torch.nn.functional.pad(x, (0, P2 - x.shape[0]))
    return x.reshape(nblocks, (P2 // nblocks) // tile, tile).contiguous()


def _tile_softmax(w, A, B):
    """The implicit plan's rows for the row weights ``w`` [..., rows]:
    softmax over the C consumers of ``-w * A + B``, shape [..., rows, C].
    (The JAX package masks the lane-padded consumers to -1e30, whose exp
    is an exact 0; here the pad consumers are simply not there.)"""
    return torch.softmax(-w[..., None] * A + B, dim=-1)


def _superblock_partials(ws_blocks, cnt_blocks, A, B):
    """Plain version of K5: per-superblock partials ``(load[Sb, C],
    colsum[Sb, C])``, each superblock's tiles added in order from zero
    (the carry of JAX's ``lax.scan``)."""
    Sb, tpb, _ = ws_blocks.shape
    loads, cols = [], []
    for s in range(Sb):
        x = _tile_softmax(ws_blocks[s], A, B)                   # [tpb, tile, C]
        tl = (ws_blocks[s][..., None] * x).sum(dim=1)           # [tpb, C]
        tc = (cnt_blocks[s][..., None] * x).sum(dim=1)
        acc_l = torch.zeros_like(A)
        acc_c = torch.zeros_like(A)
        for t in range(tpb):
            acc_l = acc_l + tl[t]
            acc_c = acc_c + tc[t]
        loads.append(acc_l)
        cols.append(acc_c)
    return torch.stack(loads), torch.stack(cols)


def _ordered_sum(parts):
    """Fixed left-to-right combine of [S, C] partials from ``parts[0]``."""
    acc = parts[0]
    for s in range(1, parts.shape[0]):
        acc = acc + parts[s]
    return acc


def _mean_padded(v):
    """Mean of a [C] f32 vector as a sum over the lane-padded C_pad
    elements (pads are zeros) divided by C, the JAX package's reduction
    shape."""
    C = v.shape[0]
    return torch.nn.functional.pad(v, (0, _lane_pad(C) - C)).sum() / float(C)


def _noise_seed(C: int, device):
    from .plan_stats import noise

    return noise(torch.zeros(C, dtype=torch.int32, device=device),
                 torch.arange(C, dtype=torch.int32, device=device))


def mirror_prox(step_fn, num_consumers: int, iters: int, n_valid: float,
                eta: float = MIRROR_PROX_ETA, tol: float = 2e-5, device=None):
    """The mirror-prox dual loop.

    ``step_fn(A, B, sc, prev_spread) -> (load1, load2, colsum2)`` is one
    extragradient step: the predictor load at (A, B), the damped
    extrapolation, and the corrector marginals at the extrapolated point
    (:func:`.linear_ot_cuda.mirror_prox_step`).  The loop re-derives the
    step scale from ``load1``.  The damped step and the two-residual stop
    mirror the Sinkhorn iteration.  The stop test reads one scalar from
    the device an iteration.

    Returns ``(A, B, rounds)``.
    """
    C = int(num_consumers)
    f32 = dict(dtype=torch.float32, device=device)
    cap = torch.tensor(max(float(n_valid), 1.0), **f32) / C
    A = torch.zeros(C, **f32)
    B = _noise_seed(C, device)
    sc = torch.tensor(1.0, **f32)
    prev_spread = torch.tensor(float("inf"), **f32)
    it = 0
    while it < iters:
        load1, load2, colsum2 = step_fn(A, B, sc, prev_spread)
        spread = load1.max() - load1.min()
        sc = torch.where(spread > prev_spread, sc * 0.5,
                         torch.clamp(sc * 1.2, max=1.0))
        A = A + (eta * sc) * (load2 - _mean_padded(load2))
        upd = torch.log(cap / (colsum2 + 1e-9))
        B = B + upd
        delta = torch.maximum(spread, upd.abs().max())
        prev_spread = spread
        it += 1
        if not bool(delta > tol):
            break
    return A, B, it


def _linear_duals(lags, valid, scale: float, n_valid: int, *,
                  num_consumers: int, iters: int, tile: int):
    """The whole dual solve on the inputs' device: tile-blocked ws and
    count vectors, then the mirror-prox loop with one step an iteration
    (the kernels on the card, their plain version on the CPU)."""
    from .linear_ot_cuda import mirror_prox_step

    C = int(num_consumers)
    P2, t, _ = plan_shape(lags.shape[0], tile)
    ws, cnt = _ws_cnt(lags, valid, scale)
    ws_b = _to_blocks(ws, P2, _SUPERBLOCKS, t)
    cnt_b = _to_blocks(cnt, P2, _SUPERBLOCKS, t)

    def step_fn(A, B, sc, prev_spread):
        return mirror_prox_step(ws_b, cnt_b, A, B, sc, prev_spread,
                                eta=MIRROR_PROX_ETA)

    return mirror_prox(step_fn, C, iters, n_valid, device=lags.device)


def additive_bound(lags, valid, num_consumers: int) -> float:
    """The additive guarantee on the max consumer load:
    ``total_valid_lag / C + max_lag``."""
    vals = np.asarray(lags)[np.asarray(valid)]
    if vals.size == 0:
        return 0.0
    total = float(vals.sum(dtype=np.float64))
    return total / int(num_consumers) + float(vals.max())


# The last linear solve's record: geometry, duals rounds, the device.
_LAST: Optional[dict] = None


def last_solve_info() -> Optional[dict]:
    return _LAST


def _peak_bytes_estimate(P2: int, C: int, tile: int) -> int:
    """The JAX package's device-memory model of the duals solve (the
    operator-facing ``klba_quality_last_peak_bytes`` gauge, kept as the
    same formula so both packages export one number): 25 bytes a row (the
    int64 lags, the bool mask, an f64 intermediate and the f32 ws and
    count vectors), ~3 live (tile, C) f32 blocks, the per-superblock
    partials and the dual/marginal vectors."""
    return (
        25 * P2
        + 3 * tile * C * 4
        + 2 * _SUPERBLOCKS * C * 4
        + 8 * C * 4
    )


def record_linear_solve(lags_p, valid_p, totals_np, num_consumers: int, *,
                        tiles: int, tile: int, rounds: int,
                        backend: str) -> None:
    """Assert the additive bound against the solved totals (a miss means
    the rounding contract broke: it raises rather than serve an
    unbalanced assignment), then keep the ``_LAST`` record and record the
    quality-plane metrics (the JAX package's series)."""
    global _LAST
    C = int(num_consumers)
    bound = additive_bound(lags_p, valid_p, C)
    max_tot = float(totals_np.max()) if totals_np.size else 0.0
    if bound > 0.0 and max_tot > bound * (1.0 + 1e-6) + 0.5:
        raise RuntimeError(
            f"linear OT additive rounding bound violated: max consumer "
            f"load {max_tot:.0f} > total/C + max_lag = {bound:.0f} "
            "(push-relabel additive guarantee, ops/linear_ot)"
        )
    P2 = int(lags_p.shape[0])
    _LAST = {
        "backend": backend,
        "rows": P2,
        "consumers": C,
        "tile": int(tile),
        "tiles": int(tiles),
        "duals_rounds": int(rounds),
        "peak_bytes_estimate": _peak_bytes_estimate(P2, C, int(tile)),
    }
    metrics.REGISTRY.counter(
        "klba_quality_solve_total", {"mode": "linear"}
    ).inc()
    metrics.REGISTRY.gauge("klba_quality_last_tile_count").set(int(tiles))
    metrics.REGISTRY.gauge("klba_quality_last_peak_bytes").set(
        _LAST["peak_bytes_estimate"]
    )


def finish_from_duals(lags_d, pids_d, valid_d, A, B, num_consumers: int,
                      refine_iters: int, *, tiles: int, tile: int,
                      rounds: int, backend: str):
    """Rounding, refinement and portfolio on the device, then the bound
    check on the host.  Returns host ``(choice, counts, totals)``."""
    from ..models.sinkhorn import _round_refine_portfolio

    C = int(num_consumers)
    # The phase ends in the host read of its results.
    with metrics.device_phase("rounding"):
        choice, counts, totals = _round_refine_portfolio(
            lags_d, pids_d, valid_d, A, B,
            num_consumers=C, refine_iters=int(refine_iters),
        )
        choice_np, counts_np, totals_np = (
            x.cpu().numpy() for x in (choice, counts, totals)
        )
    record_linear_solve(
        lags_d.cpu().numpy(), valid_d.cpu().numpy(), totals_np, C,
        tiles=tiles, tile=tile, rounds=rounds, backend=backend,
    )
    return choice_np, counts_np, totals_np


def _trivial_assignment(lags_np, valid_np, num_consumers: int):
    """Host fast path for C == 1 or an all-invalid topic."""
    C = int(num_consumers)
    choice = np.where(valid_np, 0, -1).astype(np.int32)
    counts = np.zeros(C, np.int64)
    totals = np.zeros(C, np.int64)
    counts[0] = int(valid_np.sum())
    totals[0] = int(lags_np[valid_np].sum(dtype=np.int64))
    return choice, counts, totals


def assign_topic_linear(lags, partition_ids, valid, num_consumers: int,
                        iters: int = 24, refine_iters: Optional[int] = None,
                        tile: Optional[int] = None, device: DeviceLike = None):
    """Integral, count-balanced assignment from the linear-space
    mirror-prox duals; output ``(choice int32[P] in input order, counts,
    totals)`` as numpy arrays.

    Takes host arrays (the scale and validity aggregation run in numpy).
    ``tile`` overrides the process-wide ``tpu.assignor.quality.tile``
    knob; ``refine_iters=None`` selects the Sinkhorn solver's per-path
    auto budget; ``device`` defaults to the CUDA card.
    """
    from ..models.sinkhorn import (
        _AUTO_REFINE_PARALLEL,
        _AUTO_REFINE_SCAN,
        _SCAN_ROUNDING_MAX_P,
        _scale_np,
    )
    from .dispatch import quality_tile

    dev = resolve_device(device)
    C = int(num_consumers)
    lags_np = np.ascontiguousarray(np.asarray(lags), dtype=np.int64)
    valid_np = np.ascontiguousarray(np.asarray(valid), dtype=bool)
    pids_np = np.ascontiguousarray(np.asarray(partition_ids), dtype=np.int32)
    n_valid = int(valid_np.sum())
    if C < 2 or n_valid == 0:
        return _trivial_assignment(lags_np, valid_np, max(C, 1))
    P = int(lags_np.shape[0])
    _, tile_e, n_tiles = plan_shape(P, quality_tile() if tile is None else tile)
    if refine_iters is None:
        refine_iters = (
            _AUTO_REFINE_PARALLEL if P > _SCAN_ROUNDING_MAX_P else _AUTO_REFINE_SCAN
        )
    scale = _scale_np(lags_np, valid_np, C)
    with metrics.device_phase("h2d", sync=dev):
        lags_d, pids_d, valid_d = (
            torch.from_numpy(a).to(dev) for a in (lags_np, pids_np, valid_np)
        )
    # The loop's stop test reads a device scalar every iteration, the last
    # one included, so the phase ends with the duals complete.
    with metrics.device_phase("duals"):
        A, B, rounds = _linear_duals(
            lags_d, valid_d, scale, n_valid, num_consumers=C, iters=int(iters),
            tile=tile_e,
        )
    return finish_from_duals(
        lags_d, pids_d, valid_d, A, B, C, refine_iters,
        tiles=n_tiles, tile=tile_e, rounds=rounds, backend=dev.type,
    )


def assign_linear(
    partition_lag_per_topic: Mapping[str, Sequence[TopicPartitionLag]],
    subscriptions: Mapping[str, Sequence[str]],
    iters: int = 24,
    refine_iters: Optional[int] = None,
    device: DeviceLike = None,
) -> AssignmentMap:
    """Map-level linear-mode solve (same surface as
    :func:`..models.sinkhorn.assign_sinkhorn`); per-topic independence
    preserved.  ``device`` defaults to the CUDA card."""
    from .dispatch import assign_per_topic
    from .packing import pad_topic_rows

    dev = resolve_device(device)

    def solve_topic(lags, pids, num_consumers):
        lags_p, pids_p, valid = pad_topic_rows(lags, pids)
        return assign_topic_linear(
            lags_p, pids_p, valid, num_consumers=num_consumers,
            iters=iters, refine_iters=refine_iters, device=dev,
        )[0]

    return assign_per_topic(partition_lag_per_topic, subscriptions, solve_topic)
