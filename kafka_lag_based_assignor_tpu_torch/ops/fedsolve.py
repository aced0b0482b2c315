"""Federated Sinkhorn building blocks: dual-seeded rounds over lag shards.

Counterpart of ``kafka_lag_based_assignor_tpu/ops/fedsolve.py``.  The
Sinkhorn quality solver (:mod:`..models.sinkhorn`) keeps its iteration state
in two f32[C] dual vectors ``(A, B)`` and reads two marginals of the implicit
plan a step, both plain sums over rows

    load_j   = sum_shards  load_j^(s)
    colsum_j = sum_shards  colsum_j^(s)

so N parties each holding a SHARD of the rows can run the global iteration by
exchanging their consumer-axis contributions (Federated Sinkhorn,
arXiv:2502.07021): raw per-partition lags never leave a shard.  This module
is the device math of the federated plane (:mod:`..federated` owns the
protocol):

* :func:`shard_summary` — the handshake scalars (total lag, valid count)
  whose global sums fix the shared scale ``max(total, 1) / C`` and the
  balanced count marginal ``n / C``;
* :func:`shard_dedup` — the host dedup of one shard under an explicit
  (global) scale, with the single-leader path's log-bucketing cap;
* :func:`shard_marginals` — this shard's ``(load, colsum)`` under the
  current duals: :func:`.plan_stats.plan_stats` with ``need="both"``, the K3
  kernel on the card (one launch a call);
* :func:`dual_step` — one damped mirror/Sinkhorn step on the summed
  marginals (the leader's loop body, one step at a time so the exchange can
  interleave network rounds);
* :func:`initial_duals` — the shared start (zero A, the hash-noise B0);
* :func:`round_local_shard` — the dual-seeded rounding of this shard
  (:func:`..models.sinkhorn._round_parallel`), the row tables and the
  resident refine with the other shards' converged loads as a fixed base,
  swap-only when the seats are capacity-weighted.

Every entry that touches a tensor takes ``device`` (None: the CUDA card,
raising without one; ``"cpu"`` the plain path) and returns numpy arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.sinkhorn import _DEDUP_CAP, _quantize_tail, _round_parallel
from ..utils.device import DeviceLike, fetch, resolve_device
from .plan_stats import noise, plan_stats

#: Cap on the refine pair width of the dual-seeded local round (the
#: single-leader Sinkhorn path's bound).
_MAX_PAIRS = 64

#: Convergence tolerance of the exchange loop (the leader's).
DUAL_TOL = 2e-5


def shard_summary(lags, valid) -> Tuple[int, int]:
    """Host scalars of one shard: ``(total_lag, n_valid)``."""
    lags_np = np.asarray(lags)
    valid_np = np.asarray(valid)
    return int(lags_np[valid_np].sum()), int(valid_np.sum())


def shard_dedup(lags, valid, scale: float):
    """One shard's rows deduplicated onto the unique-lag-value axis under an
    explicit GLOBAL scale (a shard's local total is not the unit the global
    duals live in).  Returns ``(ws_u, count_u, wsum_u)`` f32, pow2-padded."""
    from .packing import pad_bucket

    lags_np = np.asarray(lags)
    valid_np = np.asarray(valid)
    vals = lags_np[valid_np]
    uniq, counts = np.unique(vals, return_counts=True)
    if len(uniq) > _DEDUP_CAP:
        vals_r, cnts_r, vsums_r = _quantize_tail(uniq, counts)
    else:
        vals_r = uniq.astype(np.float64)
        cnts_r = counts.astype(np.float64)
        vsums_r = vals_r * cnts_r
    scale = max(float(scale), 1e-9)
    U = max(len(vals_r), 1)
    U_pad = pad_bucket(U)
    ws_u = np.zeros(U_pad, np.float32)
    count_u = np.zeros(U_pad, np.float32)
    wsum_u = np.zeros(U_pad, np.float32)
    ws_u[: len(vals_r)] = vals_r / scale
    count_u[: len(vals_r)] = cnts_r
    wsum_u[: len(vals_r)] = vsums_r / scale
    return ws_u, count_u, wsum_u


def _on(dev: torch.device, *arrays):
    """Host arrays (or scalars) as f32 tensors on ``dev``."""
    return [torch.from_numpy(np.array(a, dtype=np.float32)).to(dev) for a in arrays]


def shard_marginals(ws_u, count_u, wsum_u, A, B, device: DeviceLike = None):
    """This shard's contribution under duals ``(A, B)``: ``(load f32[C],
    colsum f32[C])``, the exchanged payload.  Padding rows carry count =
    wsum = 0 and add nothing, so shards of different padded sizes sum
    correctly.  One K3 launch on the card."""
    dev = resolve_device(device)
    load, colsum = plan_stats(*_on(dev, ws_u, count_u, wsum_u, A, B), need="both")
    return fetch(load, colsum)


def dual_step(A, B, load_sum, colsum_sum, cap, step_scale: float,
              prev_spread: float, eta: float = 8.0, device: DeviceLike = None):
    """One damped mirror/Sinkhorn step on globally summed marginals, in f32.

    ``cap`` is the count-marginal target: the uniform scalar ``n / C``, or
    an [C] vector of capacity-weighted targets summing to ``n``.  Both
    half-steps use the same round's marginals (one network exchange a step);
    the trajectory lags the leader's by a half-step and converges to the same
    fixpoint.  Returns ``(A, B, step_scale, spread, delta)``, the last three
    as Python floats (the convergence test is on the host, between rounds).
    """
    dev = resolve_device(device)
    A, B, load, colsum, cap = _on(dev, A, B, load_sum, colsum_sum, cap)
    scale = torch.tensor(step_scale, dtype=torch.float32, device=dev)
    spread = load.max() - load.min()
    scale = torch.where(
        spread > torch.tensor(prev_spread, dtype=torch.float32, device=dev),
        scale * 0.5, torch.clamp(scale * 1.2, max=1.0),
    )
    A = A + (np.float32(eta) * scale) * (load - load.mean())
    upd = torch.log(cap / (colsum + 1e-9))
    B = B + upd
    delta = torch.maximum(spread, upd.abs().max())
    A, B, scale, spread, delta = fetch(A, B, scale, spread, delta)
    return A, B, float(scale), float(spread), float(delta)


def initial_duals(num_consumers: int, device: DeviceLike = None):
    """The shared deterministic dual seed: zero ``A`` and the single-leader
    iteration's hash-noise ``B0``; every peer computes it identically."""
    dev = resolve_device(device)
    C = int(num_consumers)
    B0 = noise(torch.zeros(C, dtype=torch.int32, device=dev),
               torch.arange(C, dtype=torch.int32, device=dev))
    return np.zeros(C, np.float32), fetch(B0)[0]


def _round_local(lags, valid, ws, A, B, base_totals, num_consumers: int,
                 refine_iters: int, cap_vec=None, cap_max: int = 0):
    from .packing import table_rows
    from .refine import build_choice_tables, refine_rounds_resident

    C = int(num_consumers)
    P = lags.shape[0]
    n_valid = int(valid.sum())
    floor_cap = n_valid // C
    extras = n_valid - floor_cap * C
    # Weighted shards: explicit seat counts replace floor/ceil, and the
    # refine runs swap-only so the weighted counts hold exactly.
    choice = _round_parallel(
        lags, ws, valid, A, B, C, floor_cap, extras,
        cap_vec=cap_vec, cap_max=cap_max if cap_vec is not None else None,
    )
    # A weighted seat count can exceed the uniform ceil(P / C) + 1 rows:
    # the table is sized to the largest.
    m_rows = max(table_rows(P, C), int(cap_max))
    row_tab, r_counts, r_totals = build_choice_tables(lags, valid, choice, C, m_rows)
    # The other shards' converged loads ride as a fixed per-consumer base,
    # so the local exchanges lower the GLOBAL peak.
    s_choice, _, s_counts, s_totals, _, _ = refine_rounds_resident(
        lags, choice, row_tab, r_counts, r_totals + base_totals,
        num_consumers=C, iters=refine_iters, max_pairs=min(C // 2, _MAX_PAIRS),
        allow_moves=cap_vec is None,
    )
    return s_choice, s_counts, s_totals - base_totals


def apportion_counts(n: int, weights) -> np.ndarray:
    """Largest-remainder apportionment of ``n`` seats over non-negative
    ``weights`` (uniform when they are degenerate).  Returns int32[C]
    summing to exactly ``n``."""
    w = np.asarray(weights, dtype=np.float64)
    w = np.where(np.isfinite(w) & (w > 0), w, 0.0)
    if w.sum() <= 0:
        w = np.ones_like(w)
    quota = float(n) * w / w.sum()
    base = np.floor(quota).astype(np.int64)
    rem = int(n - base.sum())
    if rem > 0:
        order = np.argsort(-(quota - base), kind="stable")
        base[order[:rem]] += 1
    return base.astype(np.int32)


def round_local_shard(lags, num_consumers: int, A, B, scale: float, base_load,
                      refine_iters: Optional[int] = None, capacity_frac=None,
                      device: DeviceLike = None):
    """Dual-seeded integral rounding of ONE shard.

    ``lags`` are the unpadded local rows (sorted-pid order; padded here to
    the pow2 bucket), ``A`` / ``B`` the converged global duals, ``scale`` the
    shared normalization, ``base_load`` f32[C] the summed load marginal of
    every other shard (ws units), held fixed in lag units while the local
    refine balances the global peaks.  Locally count-balanced (floor/ceil of
    the local row count), unless ``capacity_frac`` (fractions summing to
    ~1) apportions the seats by capacity (:func:`apportion_counts`); the
    refine is then swap-only, so the weighted counts hold exactly.

    Returns ``(choice int32[P] in input order, counts int32[C], local totals
    int64[C] in lag units)``.
    """
    from .packing import pad_topic_rows

    dev = resolve_device(device)
    P = int(np.asarray(lags).shape[0])
    lags_p, _, valid = pad_topic_rows(np.asarray(lags, dtype=np.int64))
    if refine_iters is None:
        # The auto budget grows with the shard: the parallel rounding leaves
        # O(P) repair work; the weighted, swap-only path converges slower.
        if capacity_frac is not None:
            refine_iters = min(2048, max(512, int(lags_p.shape[0]) // 2))
        else:
            refine_iters = min(1024, max(128, int(lags_p.shape[0]) // 8))
    scale = max(float(scale), 1e-9)
    lags_t = torch.from_numpy(lags_p).to(dev)
    valid_t = torch.from_numpy(valid).to(dev)
    ws = (torch.where(valid_t, lags_t, 0).to(torch.float64) / scale).to(torch.float32)
    base_totals = torch.from_numpy(
        (np.asarray(base_load, dtype=np.float64) * scale).astype(np.int64)).to(dev)
    A_t, B_t = _on(dev, A, B)
    kw = dict(num_consumers=int(num_consumers), refine_iters=int(refine_iters))
    if capacity_frac is not None:
        cap_np = apportion_counts(P, capacity_frac)
        # cap_max sizes the open-slot enumeration and the table: the next
        # pow2 of the largest seat count, bounded by the padded rows (the
        # JAX package's bucketing of a static argument, kept for the bits).
        cap_ceil = 1 << max(int(cap_np.max()) - 1, 0).bit_length()
        kw.update(cap_vec=torch.from_numpy(cap_np).to(dev),
                  cap_max=min(cap_ceil, int(lags_p.shape[0])))
    choice, counts, totals = _round_local(lags_t, valid_t, ws, A_t, B_t, base_totals, **kw)
    choice, counts, totals = fetch(choice, counts, totals)
    return choice[:P], counts, totals
