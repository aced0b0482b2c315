"""Sinkhorn-style optimal-transport relaxation solver (implicit plan).

Counterpart of ``kafka_lag_based_assignor_tpu/models/sinkhorn.py``: the
framework's quality alternative to greedy LPT.  It optimizes the max/mean
lag imbalance directly while keeping ``max - min assigned partitions <= 1``.

* relaxation: X in [0,1]^{P x C}, row-stochastic; objective sum_j load_j^2;
  a damped mirror step on the centered load gradient, then one Sinkhorn
  column scaling toward the balanced count marginal;
* the plan is never materialized: the log-plan stays exactly
  ``-ws_p * A_j + B_j`` (plus a row normalizer that cancels), so the state
  is two f32[C] vectors, and each iteration needs the plan's two marginals
  over the DEDUPLICATED lag-value axis (:mod:`..ops.plan_stats`, the K3
  kernel on the card);
* rounding: partitions in descending-lag order pick the least-loaded open
  consumer with the plan as a tie-break bonus (P <= 4096), or the parallel
  argmax + capacity repair (larger P); then the exchange refinement
  (:mod:`..ops.refine`);
* portfolio: the greedy rounds solve (the K1 kernel) runs too, and the
  assignment with the smaller maximum consumer load is returned, so the
  quality mode never loses to greedy.

The quality router (:func:`..ops.dispatch.resolve_quality_mode`) sends
large topics to the linear-space mode (:mod:`..ops.linear_ot`) under the
same output contract.  The loops run on the host and read one scalar from
the device an iteration (the stop tests); the sequential rounding is P
dependent steps of small torch ops (the JAX package's ``lax.scan``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..ops.plan_stats import implicit_plan_argmax, implicit_plan_rows, noise, plan_stats
from ..types import AssignmentMap, TopicPartitionLag
from ..utils import metrics
from ..utils.device import DeviceLike, resolve_device

# At or below this many partition rows the sequential rounding runs;
# above it the parallel rounding.
_SCAN_ROUNDING_MAX_P = 4096

# Auto refinement budgets per rounding path (refine_iters=None).
_AUTO_REFINE_SCAN = 24
_AUTO_REFINE_PARALLEL = 96

# The OT rounding is refined only while its peak load is within this
# factor of greedy's; beyond it the refine starts from greedy's answer.
_START_SLACK = 3

# The rounding tail's sorts (:func:`_tail_sort_rows`): a sort of n rows
# keeps about 48 B a row of its own live (int64 keys, values, an iota, the
# indices and the radix sort's double buffers), so a group narrower than
# this many consumers sorts in up to _TAIL_SORT_CHUNKS chunks.
_TAIL_SORT_WIDTH = 512
_TAIL_SORT_CHUNKS = 4

# Cap on the deduplicated value axis; above it the tail of the value
# distribution is log-bucketed (each bin by its weighted mean, so both
# marginals stay mass-preserving).
_DEDUP_CAP = 4096
# How many of the largest unique values stay exact above the cap.
_DEDUP_EXACT_TOP = _DEDUP_CAP // 2


def _scale_np(lags: np.ndarray, valid: np.ndarray, C: int) -> float:
    """Host half of THE scale definition: ideal per-consumer load
    ``max(total valid lag, 1) / C``, accumulated and divided in float64
    like :func:`_scaled_ws`."""
    return max(float(lags[valid].sum()), 1.0) / C


def _scaled_ws(lags: torch.Tensor, valid: torch.Tensor, C: int) -> torch.Tensor:
    """Device half of the scale definition: f32 per-row scaled lags,
    invalid rows 0.  The sum and divide run in f64 (on the card too)."""
    w = torch.where(valid, lags, 0).to(torch.float64)
    scale = torch.clamp(w.sum(), min=1.0) / C
    return (w / scale).to(torch.float32)


def _quantize_tail(uniq: np.ndarray, counts: np.ndarray):
    """Aggregate (uniq asc, counts) onto <= _DEDUP_CAP representative
    values: the _DEDUP_EXACT_TOP largest stay exact; the tail maps onto
    log-spaced bins (plus a bin for value 0), each represented by its
    weighted mean.  Returns (vals, counts, vsums), vsums exact per bin."""
    split = len(uniq) - _DEDUP_EXACT_TOP
    head_v, head_c = uniq[split:], counts[split:]
    tail_v, tail_c = uniq[:split], counts[:split]
    nbins = _DEDUP_CAP - _DEDUP_EXACT_TOP
    pos = tail_v > 0
    lo = float(tail_v[pos].min()) if pos.any() else 1.0
    hi = float(tail_v.max())
    if hi <= lo:
        edges = np.array([lo], dtype=np.float64)
    else:
        edges = np.geomspace(lo, hi, num=nbins - 1)
    idx = np.digitize(tail_v, edges)
    cnt_b = np.bincount(idx, weights=tail_c.astype(np.float64),
                        minlength=nbins)
    vsum_b = np.bincount(
        idx,
        weights=tail_v.astype(np.float64) * tail_c.astype(np.float64),
        minlength=nbins,
    )
    nz = cnt_b > 0
    rep_b = np.zeros_like(vsum_b)
    rep_b[nz] = vsum_b[nz] / cnt_b[nz]
    head_vf = head_v.astype(np.float64)
    head_cf = head_c.astype(np.float64)
    vals = np.concatenate([rep_b[nz], head_vf])
    cnts = np.concatenate([cnt_b[nz], head_cf])
    vsums = np.concatenate([vsum_b[nz], head_vf * head_cf])
    return vals, cnts, vsums


def _dedup_weights(lags: np.ndarray, valid: np.ndarray, C: int):
    """Host aggregation onto the unique-lag-value axis, padded to the
    power-of-two bucket (padding rows carry count = wsum = 0).

    Returns (ws_u f32[U_pad], count_u f32[U_pad], wsum_u f32[U_pad]).
    """
    from ..ops.packing import pad_bucket

    vals = lags[valid]
    scale = _scale_np(lags, valid, C)
    uniq, counts = np.unique(vals, return_counts=True)
    if len(uniq) > _DEDUP_CAP:
        vals_r, cnts_r, vsums_r = _quantize_tail(uniq, counts)
    else:
        vals_r = uniq.astype(np.float64)
        cnts_r = counts.astype(np.float64)
        vsums_r = vals_r * cnts_r
    U = max(len(vals_r), 1)
    U_pad = pad_bucket(U)
    ws_u = np.zeros(U_pad, np.float32)
    count_u = np.zeros(U_pad, np.float32)
    wsum_u = np.zeros(U_pad, np.float32)
    ws_u[: len(vals_r)] = vals_r / scale
    count_u[: len(vals_r)] = cnts_r
    wsum_u[: len(vals_r)] = vsums_r / scale
    return ws_u, count_u, wsum_u


def _sinkhorn_duals(ws_u, count_u, wsum_u, num_consumers: int,
                    iters: int = 24, eta: float = 8.0, tol: float = 2e-5):
    """Damped mirror-descent / Sinkhorn iteration with a convergence stop,
    on the device of the dedup weights.

    The step scale halves whenever the load spread grew since the last
    iteration and recovers by 1.2x (capped at 1) otherwise; the loop stops
    once both the load spread and the column correction
    ``max |log(cap / colsum)|`` are at most ``tol``, or after ``iters``.
    Two ``plan_stats`` calls an iteration, each for the one marginal its
    half-step reads, and one scalar read.
    Returns (A, B) f32[C].
    """
    C = int(num_consumers)
    dev = ws_u.device
    cap = torch.clamp(count_u.sum(), min=1.0) / C
    A = torch.zeros(C, dtype=torch.float32, device=dev)
    # Symmetry-breaking seed (the noise-free iteration has a symmetric
    # fixpoint).
    B = noise(torch.zeros(C, dtype=torch.int32, device=dev),
              torch.arange(C, dtype=torch.int32, device=dev))
    scale = torch.tensor(1.0, dtype=torch.float32, device=dev)
    prev_spread = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    for _ in range(iters):
        load, _ = plan_stats(ws_u, count_u, wsum_u, A, B, need="load")
        spread = load.max() - load.min()
        scale = torch.where(spread > prev_spread, scale * 0.5,
                            torch.clamp(scale * 1.2, max=1.0))
        A = A + (eta * scale) * (load - load.mean())
        _, colsum = plan_stats(ws_u, count_u, wsum_u, A, B, need="colsum")
        upd = torch.log(cap / (colsum + 1e-9))
        B = B + upd
        delta = torch.maximum(spread, upd.abs().max())
        prev_spread = spread
        if not bool(delta > tol):
            break
    return A, B


def sinkhorn_duals(lags, valid, num_consumers: int, iters: int = 24,
                   eta: float = 8.0, device: DeviceLike = None):
    """Run the implicit-plan iteration on host arrays; returns ``(A, B,
    ws)`` tensors on ``device`` (default the CUDA card): the f32[C] duals
    and the f32[P] scaled lags."""
    dev = resolve_device(device)
    lags_np = np.asarray(lags)
    valid_np = np.asarray(valid, dtype=bool)
    C = int(num_consumers)
    metrics.REGISTRY.counter(
        "klba_quality_solve_total", {"mode": "sinkhorn"}
    ).inc()
    ws_u, count_u, wsum_u = (
        torch.from_numpy(a).to(dev) for a in _dedup_weights(lags_np, valid_np, C)
    )
    A, B = _sinkhorn_duals(ws_u, count_u, wsum_u, C, iters=iters, eta=eta)
    ws = _scaled_ws(torch.from_numpy(lags_np).to(dev),
                    torch.from_numpy(valid_np).to(dev), C)
    return A, B, ws


def _round_parallel(lags, ws, valid, A, B, C: int, floor_cap: int, extras: int,
                    cap_vec=None, cap_max=None, sort_rows=None):
    """Parallel plan rounding (no per-partition scan).

    ``cap_vec`` (int32[C] summing to the valid row count) replaces the
    uniform floor/ceil capacities with explicit per-consumer seat counts
    (the federated weighted rounding, :mod:`..ops.fedsolve`); ``cap_max``
    must then bound its largest entry: it sizes the open-slot enumeration.
    ``sort_rows`` bounds the rows a sort takes at a time
    (:func:`..ops.sortops.stable_argsort`; default one sort of every row).
    ``ws=None`` makes the scaled lags here (:func:`_scaled_ws`), freed once
    read.

    1. each partition takes its noise-free plan-argmax consumer;
    2. capacity repair: within each consumer's takers (lag descending) the
       first cap_j keep their seat;
    3. the overflow re-seats positionally: the k-th largest-lag overflow
       row takes the k-th open slot, slots ordered round-robin over the
       consumers by ascending kept load.  Count spread <= 1 by
       construction (each count equals its ``cap_vec`` entry with one).

    Returns choice int32[P] (input order, -1 for invalid rows).
    """
    from ..ops.sortops import stable_argsort, unsort

    P = lags.shape[0]
    dev = lags.device
    rows = P if sort_rows is None else int(sort_rows)
    i64max = torch.iinfo(torch.int64).max
    if cap_vec is None:
        cap = floor_cap + (torch.arange(C, device=dev) < extras).to(torch.int64)
    else:
        cap = torch.as_tensor(cap_vec, device=dev).to(torch.int64)

    # The lexicographic (jstar, -lag) order: a stable sort by -lag, then a
    # stable sort by the argmax consumer.  Row ids are int32, and each [P]
    # buffer is freed once dead: at 128 consumers the tail's peak must stay
    # within 1/8 of the [P, C] f32 plan, 64 B a row.
    by_lag = stable_argsort(torch.where(valid, -lags, i64max), rows)
    if ws is None:
        ws = _scaled_ws(lags, valid, C)
    key = implicit_plan_argmax(ws, valid, A, B, tie_noise=False)[by_lag]
    by_j = stable_argsort(key, rows)
    sj = key[by_j]
    del key
    # Each row's lag rank, int32: its lag's first place in the lag order,
    # equal for equal lags (the overflow's sort key).
    rank = _lag_rank(lags, by_lag)
    perm = by_lag[by_j]
    del by_lag, by_j
    bnd = torch.searchsorted(sj, torch.arange(C + 1, dtype=sj.dtype, device=dev))
    # Row i keeps its seat while its place in its consumer's run is under
    # the consumer's cap: i < bnd[j] + cap[j] (int32: P and the caps fit).
    seat_end = (bnd[:-1] + cap).to(torch.int32)
    keep = torch.arange(P, dtype=torch.int32, device=dev) < seat_end[torch.clamp(sj, 0, C - 1)]
    keep &= sj < C

    kept_cnt = torch.minimum(bnd[1:] - bnd[:-1], cap)
    csum = torch.cat([ws.new_zeros(1), torch.cumsum(torch.where(keep, ws[perm], 0.0), 0)])
    kept_load = csum[bnd[1:]] - csum[bnd[:-1]]
    del csum, ws
    rem = cap - kept_cnt

    # Open slots in (round, load-rank) order: round r holds a slot of each
    # consumer with more than r seats left, consumers by ascending kept
    # load (the slots' (r, load rank) keys are distinct, so this is their
    # sorted order; the closed slots sorted after them are never taken).
    by_load = torch.argsort(kept_load, stable=True)
    cap_max = int(cap_max) if cap_max is not None else P // C + 1
    rounds = torch.arange(cap_max, device=dev)[:, None]
    slot_j = by_load.to(torch.int32).repeat(cap_max)[(rem[by_load][None, :] > rounds).reshape(-1)]

    # Overflow rows in lag-desc order meet the slots positionally: the
    # overflow rows alone, in their (jstar, -lag) order, sorted stably by
    # lag rank, are the k-th largest-lag overflow rows, ties in that order.
    choice_sorted = torch.where(keep, sj, -1)
    del sj
    over = torch.nonzero(valid[perm] & ~keep).squeeze(1).to(torch.int32)
    del keep
    key = rank[perm[over]]
    del rank
    if over.numel():
        over = over[stable_argsort(key, rows)]
        choice_sorted[over] = slot_j[: over.numel()]
    del over, slot_j, key
    return unsort(perm, choice_sorted)


def _lag_rank(lags, by_lag):
    """int32[P]: each row's first place in the lag order ``by_lag`` (rows by
    descending lag) among the rows of its lag, so that rows compare as their
    lags do; the invalid rows, sorted last, rank by their own lags too (they
    are never compared)."""
    P = lags.shape[0]
    sorted_lags = lags[by_lag]
    first = torch.ones(P, dtype=torch.bool, device=lags.device)
    first[1:] = sorted_lags[1:] != sorted_lags[:-1]
    del sorted_lags
    place = torch.where(first, torch.arange(P, dtype=torch.int32, device=lags.device), 0)
    del first
    rank = torch.empty(P, dtype=torch.int32, device=lags.device)
    rank[by_lag] = torch.cummax(place, 0).values
    return rank


def _round_sequential(lags, ws, valid, A, B, C: int, floor_cap: int, extras: int):
    """Sequential rounding: partitions in descending-lag order (padding
    last) each take the least-(scaled-)loaded open consumer, the plan row
    deciding ties as a sub-unit bonus.  A consumer is open under the floor
    capacity, or at it while ceil-seats remain.  Returns choice int32[P]
    (input order, -1 invalid).

    The plan rows do not depend on the loop state, so they are computed a
    chunk of rows at a time; what stays sequential is P dependent steps
    of about twenty small torch ops each (the JAX package's ``lax.scan``).
    """
    P = ws.shape[0]
    dev = ws.device
    neg_lag = torch.where(valid, -lags, torch.iinfo(torch.int64).max)
    order = torch.argsort(neg_lag, stable=True)
    valid_s, ws_s = valid[order], ws[order]
    j = torch.arange(C, device=dev)
    counts = torch.zeros(C, dtype=torch.int64, device=dev)
    totals = torch.zeros(C, dtype=torch.float32, device=dev)
    extras_left = torch.tensor(extras, dtype=torch.int64, device=dev)
    who_s = torch.empty(P, dtype=torch.int64, device=dev)
    chunk = 256
    for lo in range(0, P, chunk):
        bonus = 0.01 * implicit_plan_rows(order[lo: lo + chunk], ws_s[lo: lo + chunk], A, B)
        for i in range(lo, min(lo + chunk, P)):
            at_floor = (counts == floor_cap) & (extras_left > 0)
            open_mask = (counts < floor_cap) | at_floor
            score = torch.where(open_mask, totals - bonus[i - lo], float("inf"))
            who = torch.argmin(score)
            one_hot = (j == who) & valid_s[i]
            counts += one_hot
            totals += torch.where(one_hot, ws_s[i], 0.0)
            # take & at_floor[who], without indexing by a device scalar
            # (which would read it back to the host every step).
            extras_left -= (one_hot & at_floor).any().to(torch.int64)
            who_s[i] = who
    choice = torch.empty(P, dtype=torch.int32, device=dev)
    choice[order] = torch.where(valid_s, who_s, -1).to(torch.int32)
    return choice


def _tail_sort_rows(P: int, C: int) -> int:
    """Rows a sort of the rounding tail takes at a time: every row when the
    [P, C] f32 plan is at least _TAIL_SORT_WIDTH consumers wide (a whole
    sort's buffers are then under 3/32 of it), else P in up to
    _TAIL_SORT_CHUNKS chunks, so that at 128 consumers the tail stays
    within 1/8 of the plan.  The chunking changes no bit."""
    chunks = min(_TAIL_SORT_CHUNKS, -(-_TAIL_SORT_WIDTH // max(int(C), 1)))
    return -(-int(P) // chunks)


def _round_refine_portfolio(lags, partition_ids, valid, A, B, *,
                            num_consumers: int, refine_iters: int):
    """Shared rounding + refine + portfolio tail of both quality modes:
    round the implicit plan of the ``(A, B)`` duals, refine the more
    promising start, and never return worse than greedy.  Every buffer is
    [P]- or [C, M]-shaped.  Returns (choice int32[P], counts, totals)."""
    from ..ops.packing import table_rows
    from ..ops.refine import build_choice_tables, refine_rounds_resident
    from ..ops.rounds_kernel import assign_topic_rounds
    from ..ops.sortops import segment_sum

    C = int(num_consumers)
    P = lags.shape[0]
    n_valid = int(valid.sum())
    floor_cap = n_valid // C
    extras = n_valid - floor_cap * C
    rows = _tail_sort_rows(P, C)
    if P > _SCAN_ROUNDING_MAX_P:
        # The rounding makes the scaled lags itself and frees them once read.
        choice = _round_parallel(lags, None, valid, A, B, C, floor_cap, extras, sort_rows=rows)
    else:
        choice = _round_sequential(lags, _scaled_ws(lags, valid, C), valid, A, B, C,
                                   floor_cap, extras)

    # Refine the OT rounding only while its peak is within _START_SLACK of
    # greedy's; otherwise refine greedy's start.
    g_choice, g_counts, g_totals = assign_topic_rounds(
        lags, partition_ids, valid, num_consumers=C, sort_rows=rows
    )
    ot_totals = segment_sum(
        torch.where(valid, lags, 0), torch.where(valid, choice, -1), C
    )
    use_ot_start = ot_totals.max() <= _START_SLACK * g_totals.max()
    start = torch.where(use_ot_start, choice, g_choice)
    del choice

    row_tab, r_counts, r_totals = build_choice_tables(
        lags, valid, start, C, table_rows(P, C), sort_rows=rows
    )
    s_choice, _, s_counts, s_totals, _, _ = refine_rounds_resident(
        lags, start, row_tab, r_counts, r_totals, num_consumers=C,
        iters=refine_iters, max_pairs=min(C // 2, 64),
    )

    # Portfolio: never return worse than greedy.
    use_s = s_totals.max() < g_totals.max()
    return (
        torch.where(use_s, s_choice, g_choice),
        torch.where(use_s, s_counts.to(torch.int32), g_counts),
        torch.where(use_s, s_totals, g_totals),
    )


def assign_topic_sinkhorn(lags, partition_ids, valid, num_consumers: int,
                          iters: int = 24, refine_iters: Optional[int] = None,
                          device: DeviceLike = None):
    """Integral, count-balanced assignment of one padded topic from the
    implicit Sinkhorn plan (host arrays in; ``device`` defaults to the CUDA
    card).

    The quality router may send the topic to the linear mode
    (:func:`..ops.linear_ot.assign_topic_linear`), which returns numpy
    arrays; the dense path returns tensors on ``device``.  Either way:
    (choice int32[P] in input order, counts[C], totals[C]).
    ``refine_iters=None`` selects the per-rounding-path auto budget.
    """
    from ..ops.dispatch import resolve_quality_mode

    dev = resolve_device(device)
    C = int(num_consumers)
    lags_np = np.ascontiguousarray(np.asarray(lags), dtype=np.int64)
    valid_np = np.ascontiguousarray(np.asarray(valid), dtype=bool)
    pids_np = np.ascontiguousarray(np.asarray(partition_ids), dtype=np.int32)
    if resolve_quality_mode(lags_np.shape[0], C) == "linear":
        from ..ops.linear_ot import assign_topic_linear

        return assign_topic_linear(
            lags_np, pids_np, valid_np, num_consumers=C, iters=iters,
            refine_iters=refine_iters, device=dev,
        )
    metrics.REGISTRY.counter(
        "klba_quality_solve_total", {"mode": "sinkhorn"}
    ).inc()
    ws_u, count_u, wsum_u = (
        torch.from_numpy(a).to(dev) for a in _dedup_weights(lags_np, valid_np, C)
    )
    P = lags_np.shape[0]
    if refine_iters is None:
        refine_iters = (
            _AUTO_REFINE_PARALLEL if P > _SCAN_ROUNDING_MAX_P else _AUTO_REFINE_SCAN
        )
    lags_d, pids_d, valid_d = (
        torch.from_numpy(a).to(dev) for a in (lags_np, pids_np, valid_np)
    )
    A, B = _sinkhorn_duals(ws_u, count_u, wsum_u, C, iters=iters)
    return _round_refine_portfolio(
        lags_d, pids_d, valid_d, A, B,
        num_consumers=C, refine_iters=refine_iters,
    )


def assign_sinkhorn(
    partition_lag_per_topic: Mapping[str, Sequence[TopicPartitionLag]],
    subscriptions: Mapping[str, Sequence[str]],
    iters: int = 24,
    refine_iters: Optional[int] = None,
    device: DeviceLike = None,
) -> AssignmentMap:
    """Map-level Sinkhorn solve (same surface as
    :func:`..ops.dispatch.assign_device`); per-topic independence
    preserved.  ``iters`` / ``refine_iters`` are the config layer's
    ``tpu.assignor.sinkhorn.iters`` / ``tpu.assignor.refine.iters``;
    ``device`` defaults to the CUDA card."""
    from ..ops.dispatch import assign_per_topic
    from ..ops.packing import pad_topic_rows

    dev = resolve_device(device)

    def solve_topic(lags, pids, num_consumers):
        lags_p, pids_p, valid = pad_topic_rows(lags, pids)
        return assign_topic_sinkhorn(
            lags_p, pids_p, valid, num_consumers=num_consumers,
            iters=iters, refine_iters=refine_iters, device=dev,
        )[0]

    return assign_per_topic(partition_lag_per_topic, subscriptions, solve_topic)
