"""Streaming rebalance with warm start: the BASELINE config-5 loop.

Counterpart of ``kafka_lag_based_assignor_tpu/ops/streaming.py`` for one
device.  :class:`StreamingAssignor` keeps the
previous choice vector as a warm start across rebalances of one topic:

* **cold start / shape change / guardrail trip** — the cold chain: the
  greedy solve (the round-scan kernel on the card), the [C, M] row-table
  build and a parity refine (budget ``cold_refine_iters``); its outputs seed
  the resident state;
* **warm epoch** — the kept assignment is scored under the new lags on the
  host (one weighted bincount).  Within ``refine_threshold`` of the
  input-driven bound the epoch is a **no-op**: no churn, no device work.
  Otherwise one fused warm refine runs on the device over the resident
  state: the totals re-derived from the resident table, then bulk
  anti-ranked swap rounds with a partner fan of 8, an exchange budget of
  ``refine_iters`` (churn <= 2 x refine_iters) and a quality limit;
* **resident state** — four device tensors live between epochs: the padded
  choice int32[B], the row table int32[C, M], the counts int32[C] and the
  padded lags int64[B].  A dense warm epoch uploads the lag vector (int32
  when the range allows); a **delta epoch** uploads only the changed
  (index, value) pairs, padded to a pow2 K, and scatters them into the
  resident lag buffer.  A warm refine reads back only the changed
  assignments (``ops/delta``) when they fit the budget's width;
* **integrity** — every refine dispatch computes the digest of the state it
  starts from (``ops/refine.state_digest``, the K6 kernel on the card) and
  the host compares it with its own truth (``utils/scrub``).  A mismatch
  quarantines the engine (the resident state is dropped) and raises
  :class:`..utils.scrub.CorruptStateDetected`; the next epoch rebuilds the
  resident state from the host and so heals;
* **megabatch** — :meth:`StreamingAssignor.submit_epoch` routes a warm
  epoch's resident refine through a :class:`.coalesce.MegabatchCoalescer`:
  the epoch parks on a future, and the coalescer runs it with every
  concurrent stream's epoch of the same shape as one batched dispatch.
  While a stream's roster is locked its resident state is a
  :class:`.coalesce.ResidentRow` handle into the coalescer's stacked batch;
  an inline dispatch materializes it first;
* **membership change** — :meth:`StreamingAssignor.remap_members` keeps
  every surviving member's partitions; a host repair pass re-seats orphans
  and count overflow;
* **sharded cold solve** — when the mesh manager elects the P-axis-sharded
  backend for the shape (``mesh_backend``; :func:`.dispatch.
  sharded_solve_manager`), ONE sharded dispatch (:mod:`..sharded.solve`)
  serves the cold solve: the linear-OT duals unless the quality mode is
  pinned to "sinkhorn", then the seed + exchange program.  Its choice seeds
  the next warm epoch as :meth:`StreamingAssignor.seed_choice` does (the
  resident state is rebuilt from it); a sharded failure degrades the
  manager and the single-device chain serves the same epoch;
* **resident placement** — under the same election, an adopted resident
  state is placed over the ("p",) mesh (:mod:`..sharded.resident`): the
  [B] choice and lags in D row shards, the table and counts replicated
  (``klba_resident_placed_total{axis="p"}``).  A warm refine on a placed
  state first probes the collective (``mesh.collective``; a lost collective
  or a degraded manager drops the state and re-solves the epoch cold on the
  current rung), then digests the state shard by shard
  (:func:`.refine.state_digest_sharded`, K6's shard entry), gathers the rows
  onto the lead device, runs the single-device refine and places the
  successors again.  A delta epoch scatters each index into its owning
  shard.  Every epoch and digest is bit-identical to the unplaced engine's.

**Telemetry and drills** (the JAX engine's series, spans and fault
points): every epoch runs under the ``stream.epoch`` span (inside it
``stream.cold_solve``, ``stream.linear_solve``, ``stream.h2d``,
``stream.refine`` and ``stream.h2d_delta``), feeds the churn and quality
series, writes a ``stream_epoch`` flight record (also into the engine's own
``flight`` ring when it has one, as the sidecar gives each stream), and a
guardrail trip marks the trace and dumps the flight recorder;
``step_trace=True`` wraps each epoch in a ``torch.profiler`` range.  The
fault points ``stream.refine`` (epoch entry), ``delta.diff`` and
``delta.apply`` (both fall back to the dense upload within the epoch) and
``device.corrupt.*`` (a seeded bit flip in a resident tensor as it is
adopted, which the next dispatch's digest must catch) drive the failure
paths; every quarantine, heal and delta resync is counted by
``utils/scrub.record_quarantine``.

On a CUDA device every kernel that fails to build or launch raises out of
:meth:`StreamingAssignor.rebalance`; only the delta dispatch re-syncs
dense first, as in the JAX engine.  The padded bucket
is ``pad_bucket(P)`` (pow2) on the card and ``pad_chunk(P)`` on the CPU, as
the JAX package picks by backend; M = ``table_rows(B, C)`` and the bulk
round's clone stripes depend on it, so the two buckets can pick different
swaps.
"""

from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..sharded import collectives
from ..sharded.resident import PlacedResident, place_resident, shardable_rows
from ..utils import faults, metrics
from ..utils import scrub as scrub_mod
from ..utils import trace as trace_mod
from ..utils.device import DeviceLike, fetch as _fetch, resolve_device
from ..utils.observability import count_constrained_bound
from .batched import _narrow_choice, assign_stream, stream_payload
from .delta import apply_assignment_delta, compact_changed, readback_k
from .packing import pad_bucket, pad_chunk, table_rows
from .refine import (
    build_choice_tables,
    refine_rounds_resident,
    state_digest,
    state_digest_sharded,
)

LOGGER = logging.getLogger(__name__)

# Delta-epoch K ladder: a sparse (indices, values) update pads to a pow2 K
# bucket; an engine's ladder tops out at DELTA_MIN_K << (delta_buckets - 1).
# Per-entry upload cost: int32 index + int64 value.
DELTA_MIN_K = 16
_DELTA_ENTRY_BYTES = 4 + 8

# Adaptive delta cutoff: the window of observed per-epoch changed
# fractions, the sample floor below which the global knob serves, the
# quantile the cutoff tracks and its safety margin.
_ADAPT_WINDOW = 64
_ADAPT_MIN_SAMPLES = 8
_ADAPT_QUANTILE = 0.9
_ADAPT_MARGIN = 1.5


def delta_bucket(n_changed: int) -> int:
    """Pow2 K bucket a delta of ``n_changed`` entries pads to."""
    n = max(int(n_changed), 1)
    if n <= DELTA_MIN_K:
        return DELTA_MIN_K
    return 1 << (n - 1).bit_length()


def delta_k_ladder(buckets: int) -> list:
    """The bounded K ladder for ``buckets`` rungs."""
    return [DELTA_MIN_K << i for i in range(max(int(buckets), 0))]


@dataclass
class StreamingStats:
    cold_start: bool = False
    guardrail_tripped: bool = False  # warm quality fell past the guardrail
    refined: bool = False  # a device refine dispatch ran this epoch
    churn: int = 0  # partitions whose consumer changed vs previous epoch
    repaired_rows: int = 0  # rows re-seated by the membership repair pass
    max_mean_imbalance: float = 1.0
    imbalance_bound: float = 1.0  # input-driven lower bound max_lag/mean
    count_spread: int = 0
    refine_rounds: int = 0  # resident-refine rounds the dispatch ran
    refine_exchanges: int = 0  # exchanges it applied (churn <= 2x this)
    # The delta/dense cutoff in force this epoch.
    delta_effective_fraction: float = 0.0
    sharded_solve: bool = False  # this epoch's cold solve ran P-sharded

    @property
    def quality_ratio(self) -> float:
        """Achieved imbalance normalized to the input-driven bound."""
        return self.max_mean_imbalance / max(self.imbalance_bound, 1.0)


def _pad_choice(choice, B: int):
    """Padded int32[B] view of a choice vector that is either already the
    padded resident buffer or an exact-shape start (-1 on padding)."""
    if choice.shape[0] == B and choice.dtype == torch.int32:
        return choice
    out = torch.full((B,), -1, dtype=torch.int32, device=choice.device)
    out[: choice.shape[0]] = choice
    return out


def _pad_lags(lags, B: int):
    """The exact-shape lag upload widened to int64 and zero-padded to B."""
    out = torch.zeros(B, dtype=torch.int64, device=lags.device)
    out[: lags.shape[0]] = lags
    return out


def _refine_core(
    lags_p, choice_p, row_tab, counts, totals, limit, P: int,
    num_consumers: int, iters: int, max_pairs, exchange_budget: int,
    bulk: bool = False, delta_k: int = 0, digest=None,
):
    """Shared tail of every refine dispatch: the digest, the resident round
    loop and the narrowed host-facing output.  Returns (narrow choice[P],
    choice int32[B], row_tab, counts, lags int64[B], totals int64[C],
    rounds, exchanges, digest int64[5]); everything after the first element
    is the resident successor state.  ``bulk`` selects the warm engine's
    bulk swap rounds with a fan of 8; cold chains keep the parity body.

    ``delta_k > 0`` appends the O(changed) readback tail ``(d_idx
    int32[K], d_vals narrow[K], d_n int32)`` diffing the ENTRY choice
    against the exit choice over ``[:P]``.  ``digest`` is the entry state's
    digest when the caller took it already (a placed state, shard by
    shard)."""
    # The digest audits the state the epoch STARTED from (post-scatter for
    # delta epochs), not the refine's output: the rounds rewrite the choice
    # entries they move, so an output-side digest could read clean over a
    # corrupt input row the loop happened to touch.  Input-side, the first
    # dispatch over a corrupt buffer catches it, deterministically.
    if digest is None:
        digest = state_digest(lags_p, choice_p, counts, num_consumers, row_tab=row_tab)
    entry_choice = choice_p
    # The refine builds new tensors and never writes its inputs, so
    # ``entry_choice`` stays the entry state for the readback diff.
    choice_p, row_tab, counts, totals, rounds, ex = refine_rounds_resident(
        lags_p, choice_p, row_tab, counts, totals,
        num_consumers=num_consumers, iters=iters, max_pairs=max_pairs,
        exchange_budget=exchange_budget, quality_limit=limit,
        bulk_transfer=bulk, fan=8 if bulk else 1,
    )
    narrow = _narrow_choice(choice_p[:P], num_consumers)
    base = (narrow, choice_p, row_tab, counts, lags_p, totals, rounds, ex, digest)
    if delta_k <= 0:
        return base
    return base + compact_changed(entry_choice, choice_p, narrow, P, delta_k)


def _cold_chain(payload, num_consumers: int, pack_shift: int, iters: int,
                max_pairs, bucket: int):
    """Cold solve -> table build -> parity refine over one exact-shape lag
    upload (the JAX package's ``_pallas_cold_chain`` and ``_stream_device``
    + ``_refine_chain``): the greedy round scan, then the padded resident
    state.  Same outputs as :func:`_refine_core`."""
    P = payload.shape[0]
    B = int(bucket)
    C = int(num_consumers)
    choice0 = assign_stream(payload, C, pack_shift=pack_shift)
    lags_p = _pad_lags(payload, B)
    choice_p = _pad_choice(choice0.to(torch.int32), B)
    valid = torch.arange(B, device=payload.device) < P
    row_tab, counts, totals = build_choice_tables(
        lags_p, valid, choice_p, C, table_rows(B, C)
    )
    return _refine_core(
        lags_p, choice_p, row_tab, counts, totals, -1.0, P, C, iters,
        max_pairs, 0,
    )


def _warm_fused_build(lags, choice, limit, num_consumers: int, iters: int,
                      max_pairs, exchange_budget: int, bucket: int):
    """Warm dispatch, table-BUILDING variant: used when the resident state
    is stale (repair, remap, seed, quarantine); pays one padded-size sort
    to rebuild the table, then runs the same bulk refine."""
    P = lags.shape[0]
    B = int(bucket)
    lags_p = _pad_lags(lags, B)
    choice_p = _pad_choice(choice, B)
    valid = torch.arange(B, device=lags.device) < P
    row_tab, counts, totals = build_choice_tables(
        lags_p, valid, choice_p, num_consumers, table_rows(B, num_consumers)
    )
    return _refine_core(
        lags_p, choice_p, row_tab, counts, totals, limit, P, num_consumers,
        iters, max_pairs, exchange_budget, bulk=True,
    )


def _resident_totals(lags_p, row_tab, counts):
    """The per-consumer totals under the lags, from the resident table (the
    device side of the host's quality bincount)."""
    B, M = lags_p.shape[0], row_tab.shape[1]
    slot_ok = torch.arange(M, device=lags_p.device)[None, :] < counts[:, None]
    return torch.where(
        slot_ok, lags_p[torch.clamp(row_tab.long(), 0, B - 1)], 0
    ).sum(dim=1)


def _warm_fused_resident(lags, choice, row_tab, counts, limit,
                         num_consumers: int, iters: int, max_pairs,
                         exchange_budget: int, delta_k: int = 0):
    """THE warm-epoch dispatch over the resident (choice, row_tab, counts):
    the exact-shape lag upload padded, the totals re-derived from the
    table, and the bulk refine, which tests the quality limit before its
    first round.  ``delta_k > 0`` appends the O(changed) readback tail."""
    P = lags.shape[0]
    lags_p = _pad_lags(lags, choice.shape[0])
    return _refine_core(
        lags_p, choice, row_tab, counts, _resident_totals(lags_p, row_tab, counts),
        limit, P, num_consumers, iters, max_pairs, exchange_budget, bulk=True,
        delta_k=delta_k,
    )


def _warm_fused_delta(idx, vals, lags_p, choice, row_tab, counts, limit,
                      P: int, num_consumers: int, iters: int, max_pairs,
                      exchange_budget: int, delta_k: int = 0):
    """THE delta-epoch dispatch: scatter the padded ``[K]`` (index, value)
    update into a copy of the resident lag buffer, then run the warm body
    of :func:`_warm_fused_resident`.  Padding entries carry (0, index 0's
    new value): a duplicate write of one identical value, well-defined for
    ``index_put_``.  After the scatter the buffer holds the lags a dense
    upload would have, so the result is the dense path's."""
    lags_p = lags_p.clone()
    lags_p[idx.long()] = vals
    return _refine_core(
        lags_p, choice, row_tab, counts, _resident_totals(lags_p, row_tab, counts),
        limit, P, num_consumers, iters, max_pairs, exchange_budget, bulk=True,
        delta_k=delta_k,
    )


class StreamingAssignor:
    """Stateful engine for one topic's periodic rebalance at fixed scale.

    ``imbalance_guardrail`` bounds how far the bounded-churn warm path may
    drift from balance: after a warm rebalance, if ``max_mean_imbalance >
    guardrail * max(input bound, 1)`` the epoch is re-solved cold.  None
    disables it.  ``device`` defaults to the CUDA card (``device="cpu"``
    runs the plain PyTorch path).

    The per-engine outcome counters: ``delta_epochs`` (``applied`` /
    ``fallback``), ``rb_delta_epochs`` (``applied`` / ``fallback`` /
    ``overflow``) and the warm paths' transfer bytes ``h2d_bytes`` /
    ``d2h_bytes`` (``dense`` / ``delta``); each also feeds the process-wide
    registry series of the JAX engine (``klba_delta_epochs_total``,
    ``klba_rb_delta_epochs_total``, ``klba_h2d_bytes_total``,
    ``klba_d2h_bytes_total``).
    """

    def __init__(
        self,
        num_consumers: int,
        refine_iters: int = 128,
        imbalance_guardrail: Optional[float] = None,
        cold_refine_iters: int = 64,
        refine_threshold: Optional[float] = 1.02,
        # Opt-in per-epoch profiler range: each epoch runs inside
        # ``torch.profiler.record_function("klba_stream_epoch:<epoch>")``,
        # so a trace of the warm loop shows the epoch boundaries (the JAX
        # engine's StepTraceAnnotation).  Off by default: the range costs a
        # little even with no profiler attached.  Neither package's own code
        # sets it: it is public-API parity with the JAX engine's constructor,
        # for a user who profiles the warm loop.
        step_trace: bool = False,
        # Optional PER-STREAM flight-recorder ring: every epoch record
        # written to the process-wide ring (metrics.FLIGHT) is also copied
        # here (the sidecar keeps one small ring per live stream and serves
        # it through the stream_flight wire method).
        flight: Optional[metrics.FlightRecorder] = None,
        delta_enabled: bool = True,
        delta_max_fraction: float = 0.125,
        delta_buckets: int = 6,
        delta_adaptive: bool = True,
        # Multi-device backend selection for COLD solves (sharded/): "auto"
        # follows the process-wide active mesh manager through ops/dispatch;
        # an explicit MeshManager pins this engine to it; None pins the
        # engine single-device (a mesh-off sidecar's engines must not adopt
        # a co-resident instance's mesh).
        mesh_backend="auto",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.mesh_backend = mesh_backend
        # True when the LAST cold solve was served by the sharded backend.
        self._cold_was_sharded = False
        self.num_consumers = int(num_consumers)
        self.refine_iters = int(refine_iters)
        self.cold_refine_iters = int(cold_refine_iters)
        if imbalance_guardrail is not None and imbalance_guardrail < 1.0:
            raise ValueError(
                f"imbalance_guardrail={imbalance_guardrail} must be >= 1.0"
            )
        if refine_threshold is not None and refine_threshold < 1.0:
            raise ValueError(
                f"refine_threshold={refine_threshold} must be >= 1.0"
            )
        self.imbalance_guardrail = imbalance_guardrail
        self.refine_threshold = refine_threshold
        self.step_trace = bool(step_trace)
        self.flight = flight
        if not 0.0 < float(delta_max_fraction) <= 1.0:
            raise ValueError(
                f"delta_max_fraction={delta_max_fraction} must be in (0, 1]"
            )
        if int(delta_buckets) < 0:
            raise ValueError(f"delta_buckets={delta_buckets} must be >= 0")
        self.delta_enabled = bool(delta_enabled) and int(delta_buckets) > 0
        self.delta_max_fraction = float(delta_max_fraction)
        self.delta_buckets = int(delta_buckets)
        self.delta_adaptive = bool(delta_adaptive)
        self._churn_fractions = deque(maxlen=_ADAPT_WINDOW)
        self.last_effective_delta_fraction = self.delta_max_fraction
        ladder = delta_k_ladder(self.delta_buckets)
        self._delta_kmax = ladder[-1] if self.delta_enabled else 0
        # Set by submit_epoch for one epoch: the resident warm dispatch then
        # parks on this coalescer (ops/coalesce) instead of running inline,
        # with this SLO placement (class, rank, absolute deadline).
        self._coalescer = None
        self._slo_submit = ("standard", 1, None)
        self._epoch_num = 0
        self.h2d_bytes = {"dense": 0, "delta": 0}
        self.d2h_bytes = {"dense": 0, "delta": 0}
        self.delta_epochs = {"applied": 0, "fallback": 0}
        self.rb_delta_epochs = {"applied": 0, "fallback": 0, "overflow": 0}
        # Pre-bound registry series (utils/metrics), the JAX engine's: the
        # per-epoch records are plain observes, not name lookups.
        reg = metrics.REGISTRY
        self._m_eff_fraction = reg.gauge("klba_delta_effective_fraction")
        self._m_churn = reg.histogram("klba_stream_churn")
        self._m_quality_milli = reg.histogram("klba_stream_quality_ratio_milli")
        self._m_quality_last = reg.gauge("klba_stream_quality_ratio")
        self._m_guardrail = reg.counter("klba_stream_guardrail_trips_total")
        self._m_h2d = {p: reg.counter("klba_h2d_bytes_total", {"path": p})
                       for p in ("dense", "delta")}
        self._m_d2h = {p: reg.counter("klba_d2h_bytes_total", {"path": p})
                       for p in ("dense", "delta")}
        self._m_delta = {o: reg.counter("klba_delta_epochs_total", {"outcome": o})
                         for o in ("applied", "fallback", "resync")}
        self._m_rb = {o: reg.counter("klba_rb_delta_epochs_total", {"outcome": o})
                      for o in ("applied", "fallback", "overflow")}
        self._prev_choice: Optional[np.ndarray] = None
        # The resident state between dispatches: (padded int32 choice[B],
        # row table int32[C, M], counts int32[C], padded int64 lags[B]) on
        # the engine's device, a PlacedResident while it is placed over the
        # mesh's "p" axis, a ResidentRow handle while this stream's roster
        # is locked in a coalescer, or None while stale.
        self._resident = None
        # Host mirror of the resident lag buffer's first P entries (the base
        # the delta differ diffs against); lives and dies with the resident.
        self._lag_mirror: Optional[np.ndarray] = None
        # The buffer classes the last failed integrity check named; None
        # while healthy.
        self._quarantined: Optional[list] = None
        self.last_stats = StreamingStats()

    def rebalance(self, lags: np.ndarray) -> np.ndarray:
        """Produce choice int32[P] for the current lag vector."""
        faults.fire("stream.refine")  # fault point: poisoned warm stream
        self._epoch_num += 1
        with metrics.span("stream.epoch"):
            if self.step_trace:
                from torch.profiler import record_function

                with record_function(f"klba_stream_epoch:{self._epoch_num}"):
                    choice = self._rebalance_inner(lags)
            else:
                choice = self._rebalance_inner(lags)
        s = self.last_stats
        ratio = s.quality_ratio
        self._m_churn.observe(s.churn)
        self._m_quality_milli.observe(int(ratio * 1000))
        self._m_quality_last.set(ratio)
        rec = {
            "epoch": self._epoch_num,
            "P": int(lags.shape[0]),
            "C": self.num_consumers,
            "cold_start": s.cold_start,
            "refined": s.refined,
            "guardrail_tripped": s.guardrail_tripped,
            "churn": s.churn,
            "repaired_rows": s.repaired_rows,
            "quality_ratio": ratio,
            "max_mean_imbalance": s.max_mean_imbalance,
            "imbalance_bound": s.imbalance_bound,
            "count_spread": s.count_spread,
            "refine_rounds": s.refine_rounds,
            "refine_exchanges": s.refine_exchanges,
            "delta_effective_fraction": s.delta_effective_fraction,
            "sharded_solve": s.sharded_solve,
        }
        if self.flight is not None:
            # A recorder takes ownership of its record (annotates it in
            # place), so the per-stream ring gets its own shallow copy.
            self.flight.record("stream_epoch", dict(rec))
        metrics.FLIGHT.record("stream_epoch", rec)
        if s.guardrail_tripped:
            self._m_guardrail.inc()
            trace_mod.mark("guardrail")
            metrics.FLIGHT.auto_dump(
                "guardrail", {"epoch": self._epoch_num, "quality_ratio": ratio}
            )
        return choice

    def submit_epoch(
        self,
        lags: np.ndarray,
        coalescer,
        slo_class: str = "standard",
        rank: int = 1,
        deadline_at: Optional[float] = None,
    ) -> np.ndarray:
        """One rebalance epoch whose warm resident dispatch, if the epoch
        needs one, goes through ``coalescer``
        (:class:`.coalesce.MegabatchCoalescer`) instead of running inline:
        the epoch parks on a future and is batched with every concurrent
        stream's epoch of the same shape.  Everything else is
        :meth:`rebalance`: the host quality gate still skips balanced
        epochs, cold solves and table-building dispatches stay inline, and a
        flush failure surfaces on this stream only.

        ``slo_class`` / ``rank`` / ``deadline_at`` place the submission
        (:mod:`..utils.overload`): rank orders the flush, and
        ``deadline_at`` (absolute, on the registry clock) lets the flush
        re-route or shed a row whose budget cannot survive a wave."""
        self._coalescer = coalescer
        self._slo_submit = (str(slo_class), int(rank), deadline_at)
        try:
            return self.rebalance(lags)
        finally:
            self._coalescer = None
            self._slo_submit = ("standard", 1, None)

    def _note_delta(self, outcome: str) -> None:
        self.delta_epochs[outcome] += 1
        self._m_delta[outcome].inc()

    def _note_readback(self, outcome: str) -> None:
        self.rb_delta_epochs[outcome] += 1
        self._m_rb[outcome].inc()

    def _note_h2d(self, path: str, nbytes: int) -> None:
        self.h2d_bytes[path] += nbytes
        self._m_h2d[path].inc(nbytes)

    def _note_d2h(self, path: str, nbytes: int) -> None:
        self.d2h_bytes[path] += nbytes
        self._m_d2h[path].inc(nbytes)

    def _rebalance_inner(self, lags: np.ndarray) -> np.ndarray:
        lags = np.ascontiguousarray(lags, dtype=np.int64)
        if lags.size and int(lags.min()) < 0:
            raise ValueError("lags must be non-negative")
        P = lags.shape[0]
        stats = StreamingStats()
        # The delta/dense cutoff in force this epoch, from PAST fractions.
        self.last_effective_delta_fraction = self._effective_delta_fraction()
        stats.delta_effective_fraction = self.last_effective_delta_fraction
        self._m_eff_fraction.set(self.last_effective_delta_fraction)

        bound = count_constrained_bound(lags, self.num_consumers)
        # f64 sum for the guard: an int64 sum could wrap past 2**63.
        exact_bincount = float(lags.sum(dtype=np.float64)) < float(1 << 53)

        prev = self._prev_choice
        if prev is None or prev.shape[0] != P:
            stats.cold_start = True
            choice = self._cold_solve(lags)
            stats.sharded_solve = self._cold_was_sharded
            prev_for_churn = None
            self._fill_quality_stats(stats, choice, lags, bound, exact_bincount)
        else:
            # Membership repair re-seats only the moving rows, host-side.
            prev_for_churn = prev
            choice, stats.repaired_rows = self._repair_choice(prev, lags)
            if stats.repaired_rows:
                self._drop_resident()  # device state is stale now
            # Score the KEPT assignment under the new lags; refine only when
            # it is past the threshold (else a no-op: no device work).
            self._fill_quality_stats(stats, choice, lags, bound, exact_bincount)
            needs_refine = self.refine_iters > 0 and (
                self.refine_threshold is None
                or stats.max_mean_imbalance
                > self.refine_threshold * max(stats.imbalance_bound, 1.0)
            )
            if needs_refine:
                choice = self._dispatch_warm_refine(lags, choice, stats)
                stats.refined = True

        # Quality guardrail: try the bounded refine first when the threshold
        # skipped it; only an epoch it cannot rescue re-solves cold.
        if self.imbalance_guardrail is not None and not stats.cold_start:
            allowance = self.imbalance_guardrail * max(stats.imbalance_bound, 1.0)
            if (
                stats.max_mean_imbalance > allowance
                and not stats.refined
                and self.refine_iters > 0
            ):
                choice = self._dispatch_warm_refine(lags, choice, stats)
                stats.refined = True
            if stats.max_mean_imbalance > allowance:
                stats.guardrail_tripped = True
                stats.cold_start = True
                choice = self._cold_solve(lags)
                stats.sharded_solve = self._cold_was_sharded
                self._fill_quality_stats(stats, choice, lags, bound, exact_bincount)

        if prev_for_churn is not None:
            stats.churn = int((choice != prev_for_churn).sum())
        self._prev_choice = choice
        self.last_stats = stats
        return choice

    def _bucket(self, P: int) -> int:
        """Padded refine shape: the pow2 bucket on the card, the finer
        4096-chunk on the CPU (where a pow2 pad wastes up to ~2x sort
        work), as the JAX package picks by backend."""
        return pad_chunk(P) if self.device.type == "cpu" else pad_bucket(P)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _drop_resident(self) -> None:
        """Invalidate the resident state AND its host lag mirror together."""
        self._resident = None
        self._lag_mirror = None

    def _adopt_resident(self, resident, lags: np.ndarray) -> None:
        """Install a dispatch's resident successors and mirror the lags they
        were computed under (copied).  A quarantined engine reaching this
        point has healed: the successors were rebuilt from host truth
        (counted per buffer).  The ``device.corrupt.*`` fault points fire
        here, so a drill can flip bits in the freshly adopted tensors (host
        mirror left intact) and exercise the detect/quarantine/heal path, after
        the state is placed over the mesh when the manager elects it.  A
        :class:`.coalesce.ResidentRow` handle is installed as it is."""
        if self._quarantined is not None:
            scrub_mod.record_quarantine(
                self._quarantined, "healed", source="rebuild"
            )
            self._quarantined = None
        resident = self._place_resident(resident, lags.shape[0])
        self._resident = self._corrupt_resident(resident, lags.shape[0])
        self._lag_mirror = np.array(lags, dtype=np.int64, copy=True)

    def _resident_mesh_manager(self, num_rows: int):
        """The mesh manager electing the P backend for ``num_rows`` rows, or
        None: ``mesh_backend`` pinned or ``"auto"`` (through
        :func:`.dispatch.sharded_solve_manager`), the ``solve_min_rows``
        floor, two consumers at least.  The sharded cold solve and the
        resident placement share it, so the state is placed exactly when
        the cold path shards."""
        mb = self.mesh_backend
        if mb is None:
            return None  # pinned single-device
        if mb == "auto":
            from .dispatch import sharded_solve_manager

            return sharded_solve_manager(num_rows, self.num_consumers)
        return mb if (
            mb.active
            and self.num_consumers >= 2
            and mb.should_shard_solve(num_rows)
        ) else None

    def _place_resident(self, resident, P: int):
        """The P-axis placement of a freshly adopted resident state
        (:mod:`..sharded.resident`) when the manager elects it and the
        bucket divides the mesh; values are unchanged.  A locked roster's
        handle is kept as it is (the coalescer places rosters).  A failure
        keeps the single-device tensors and degrades the manager."""
        if hasattr(resident, "materialize"):
            return resident
        mgr = self._resident_mesh_manager(P)
        if mgr is None:
            return resident
        try:
            mesh = mgr.solve_mesh()
            if not shardable_rows(mesh, int(resident[0].shape[0])):
                return resident
            placed = place_resident(mesh, resident)
        except Exception:  # noqa: BLE001 — single-device is the fallback
            LOGGER.warning(
                "resident P-shard placement failed; keeping the single-device "
                "tensors", exc_info=True,
            )
            mgr.degrade("resident")
            return resident
        metrics.REGISTRY.counter(
            "klba_resident_placed_total", {"axis": "p"}
        ).inc()
        return placed

    def _corrupt_resident(self, resident, P: int):
        """The chaos injection site (fault points ``device.corrupt.choice``
        / ``.counts`` / ``.lags`` / ``.row_tab``): when a drill's plan
        fires, one seeded bit of the named resident tensor is flipped — the
        host mirror is deliberately NOT updated, so the device state
        silently diverges as a real memory fault would.  One global load
        when no injector is active.  A locked roster's handle is skipped:
        the coalescer owns that injection site.  On a placed state the bit
        flips in the shard that owns the row (each replica of a replicated
        tensor), the same bit the unplaced state would take."""
        if hasattr(resident, "materialize"):
            return resident
        if not isinstance(resident, PlacedResident):
            resident = tuple(resident)
        if faults.active() is None:
            return resident
        plan = scrub_mod.corruption_plan(limit=P)
        if not plan:
            return resident
        slot = {"choice": 0, "row_tab": 1, "counts": 2, "lags": 3}
        if isinstance(resident, PlacedResident):
            return self._corrupt_placed(resident, plan, slot, P)
        bufs = list(resident)
        for buffer, seed in plan:
            i = slot[buffer]
            host = scrub_mod.flip_bit(
                bufs[i].cpu().numpy(), seed,
                # counts and the [C, M] row table are audited over their
                # FULL extent, so no prefix bound.
                limit=None if buffer in ("counts", "row_tab") else P,
            )
            bufs[i] = torch.from_numpy(host).to(bufs[i].device)
            LOGGER.warning(
                "injected device.corrupt.%s bit flip (seed %d)", buffer, seed,
            )
        return tuple(bufs)

    @staticmethod
    def _corrupt_placed(resident: PlacedResident, plan, slot, P: int) -> PlacedResident:
        shards = [list(s) for s in resident.shards]
        for buffer, seed in plan:
            i = slot[buffer]
            if buffer in ("counts", "row_tab"):
                flipped = scrub_mod.flip_bit(shards[0][i].cpu().numpy(), seed)
                for s in shards:
                    s[i] = torch.from_numpy(flipped).to(s[i].device)
            else:
                whole = np.concatenate([s[i].cpu().numpy() for s in shards])
                flipped = scrub_mod.flip_bit(whole, seed, limit=P)
                d, _ = resident.owner(int(np.flatnonzero(whole != flipped)[0]))
                lo = resident.row_offsets[d]
                block = flipped[lo: lo + shards[d][i].shape[0]]
                shards[d][i] = torch.from_numpy(block.copy()).to(shards[d][i].device)
            LOGGER.warning(
                "injected device.corrupt.%s bit flip (seed %d) into the placed "
                "state", buffer, seed,
            )
        return PlacedResident(shards)

    def quarantine_resident(self, buffers, source: str = "scrub",
                            record: bool = True) -> None:
        """Quarantine the resident state: drop it and its lag mirror; the
        host previous choice stays, the truth the next dispatch rebuilds
        from, and the heal is counted when that rebuild is adopted.
        ``record=False`` skips the quarantine/heal accounting."""
        self._quarantined = list(buffers) if record else None
        self._drop_resident()
        if record:
            scrub_mod.record_quarantine(buffers, "quarantined", source=source)

    @property
    def quarantined(self) -> bool:
        """True between a failed integrity check and the healing rebuild."""
        return self._quarantined is not None

    def _verify_digest(self, digest, P: int, lag_sum: Optional[int],
                       source: str) -> None:
        """Compare a dispatch's digest with host truth; a mismatch
        quarantines the engine (the successors are never adopted) and
        raises :class:`..utils.scrub.CorruptStateDetected`."""
        fails = scrub_mod.digest_failures(digest, P, lag_sum)
        if not fails:
            return
        LOGGER.warning(
            "resident-state digest FAILED (%s) on the %s path; quarantining",
            ",".join(fails), source,
        )
        self.quarantine_resident(fails, source=source)
        raise scrub_mod.CorruptStateDetected(
            f"resident-state digest mismatch ({','.join(fails)}) on the "
            f"{source} path; stream quarantined — the state heals on the next "
            "epoch",
            fails,
        )

    def _cold_solve(self, lags: np.ndarray) -> np.ndarray:
        """Fresh greedy solve + parity refine (budget ``cold_refine_iters``,
        0 disables), the sharded backend when the mesh manager elects it
        (:meth:`_sharded_cold_solve`), or the linear-OT solve when the
        quality mode is pinned to "linear"."""
        self._cold_was_sharded = False
        with metrics.span("stream.cold_solve"):
            return self._cold_solve_inner(lags)

    def _sharded_cold_solve(self, lags: np.ndarray):
        """The P-axis-sharded cold backend: when the mesh manager elects to
        shard this shape, ONE sharded dispatch replaces the single-device
        chain, and the resident state is left stale for the next warm epoch
        to rebuild from this choice.  Returns None when the single-device
        backend should serve: the mesh unconfigured or degraded, the shape
        below the floor, or a sharded dispatch failing (which also degrades
        the manager, so every later selection falls back too)."""
        mgr = self._resident_mesh_manager(lags.shape[0])
        if mgr is None:
            return None
        # Under "auto" (and a pinned "linear") the cold solve runs the
        # mirror-prox duals P-sharded; a pinned "sinkhorn" keeps the
        # seed + exchange program.
        from ..sharded.solve import solve_linear_sharded, solve_sharded
        from .dispatch import quality_mode

        solver = solve_sharded if quality_mode() == "sinkhorn" else solve_linear_sharded
        try:
            with metrics.span("stream.sharded_solve"):
                choice = solver(mgr.solve_mesh(), lags, self.num_consumers,
                                refine_iters=self.cold_refine_iters)[0]
        except Exception:
            LOGGER.warning(
                "sharded cold solve failed; degrading to the single-device "
                "backend", exc_info=True,
            )
            mgr.degrade("solve")
            return None
        self._cold_was_sharded = True
        self._drop_resident()
        return np.asarray(choice).astype(np.int32)

    def _cold_solve_inner(self, lags: np.ndarray) -> np.ndarray:
        C = self.num_consumers
        sharded = self._sharded_cold_solve(lags)
        if sharded is not None:
            return sharded
        linear = self._linear_cold_solve(lags)
        if linear is not None:
            return linear
        payload, shift = stream_payload(lags)
        if self.cold_refine_iters <= 0 or C < 2:
            self._drop_resident()
            return assign_stream(self._upload(payload), C, pack_shift=shift
                                 ).cpu().numpy().astype(np.int32)
        P = lags.shape[0]
        with metrics.span("stream.h2d"):
            # ONE upload, shared by the solve and the refine.
            with metrics.device_phase("h2d", sync=self.device):
                payload_d = self._upload(payload)
        narrow, *resident = _cold_chain(
            payload_d, C, shift, self.cold_refine_iters, None, self._bucket(P),
        )
        # The refine executable INCLUDING its readback (_fetch ends in a
        # host read).
        with metrics.device_phase("refine"):
            narrow_np, digest_np = _fetch(narrow, resident[7])
        self._verify_digest(digest_np, P, int(lags.sum(dtype=np.int64)), "cold")
        self._adopt_resident(resident[:4], lags)
        return narrow_np.astype(np.int32)

    def _linear_cold_solve(self, lags: np.ndarray):
        """The linear-OT cold solve, selected only when
        ``tpu.assignor.quality.mode`` is pinned to "linear"; serves the
        choice as a cold seed (resident dropped, rebuilt by the next warm
        epoch).  Returns None when not selected."""
        from .dispatch import quality_mode

        if quality_mode() != "linear" or self.num_consumers < 2:
            return None
        from .linear_ot import assign_topic_linear
        from .packing import pad_topic_rows

        with metrics.span("stream.linear_solve"):
            lags_p, pids_p, valid_p = pad_topic_rows(lags)
            choice, _, _ = assign_topic_linear(
                lags_p, pids_p, valid_p, num_consumers=self.num_consumers,
                refine_iters=self.cold_refine_iters, device=self.device,
            )
        self._drop_resident()
        return np.asarray(choice)[: lags.shape[0]].astype(np.int32)

    def _quality_limit(self, bound: float, total_lag: float) -> float:
        """Device-side early-exit target: the peak consumer total at the
        tighter of refine_threshold / guardrail.  Negative disables."""
        ratios = [
            r for r in (self.refine_threshold, self.imbalance_guardrail)
            if r is not None
        ]
        if not ratios:
            return -1.0
        mean_load = total_lag / max(self.num_consumers, 1)
        return min(ratios) * max(bound, 1.0) * mean_load

    def _dispatch_warm_refine(
        self, lags: np.ndarray, choice: np.ndarray, stats: StreamingStats
    ) -> np.ndarray:
        """ONE device dispatch for the warm epoch's quality work: the kept
        assignment's totals under the new lags, the quality test and the
        bulk exchange rounds with their three exits (target met, peak
        stagnant for ``patience`` rounds, exchange budget spent).  Fills
        ``stats`` from the dispatch's own totals and counts.

        On a placed state this is a sharded dispatch boundary, as the cold
        solve's: the collective is probed (``mesh.collective``) before the
        launch.  A lost collective, or a manager that degraded under another
        stream, drops the resident state and re-solves the epoch cold on the
        current rung: a valid answer, one rung down."""
        with metrics.span("stream.refine"):
            if isinstance(self._resident, PlacedResident):
                from ..sharded.mesh import MeshCollectiveError

                mgr = self._resident_mesh_manager(lags.shape[0])
                try:
                    if mgr is None:
                        raise MeshCollectiveError("the mesh no longer elects "
                                                  "the P placement")
                    mgr.check_collective()
                except MeshCollectiveError:
                    LOGGER.warning(
                        "mesh collective lost at the warm-refine boundary; "
                        "re-solving this epoch on the degraded placement"
                    )
                    self._drop_resident()
                    stats.cold_start = True
                    out = self._cold_solve(lags)
                    stats.sharded_solve = self._cold_was_sharded
                    return out
            return self._dispatch_warm_refine_inner(lags, choice, stats)

    def _dispatch_warm_refine_inner(
        self, lags: np.ndarray, choice: np.ndarray, stats: StreamingStats
    ) -> np.ndarray:
        C = self.num_consumers
        P = lags.shape[0]
        B = self._bucket(P)
        budget = self.refine_iters
        # 16 pairs: the top 2 over-target consumers, each fanned across 8
        # light partners a round.
        pairs = min(C // 2, 16)
        limit = self._quality_limit(
            stats.imbalance_bound, float(lags.sum(dtype=np.float64))
        )
        # Host truth for the digest and the delta conservation check: the
        # int64 lag sum, wrapping as the device sums do.
        lag_sum = int(lags.sum(dtype=np.int64))
        # The O(changed) readback width; ``rb_base`` is the host view the
        # compaction diffs against (the resident entry choice always equals
        # ``choice``: every host-side edit drops the resident state).
        rb_k = readback_k(budget, P) if self.delta_enabled else 0
        rb_base = choice
        payload, _ = stream_payload(lags)
        resident = self._resident
        warm = dict(num_consumers=C, iters=budget, max_pairs=pairs,
                    exchange_budget=budget)
        # The resident state is the engine's own tensors, a placed state or,
        # while its roster is locked in a coalescer, a ResidentRow handle.
        handle_matches = getattr(resident, "matches", None)
        placed = isinstance(resident, PlacedResident)
        if resident is not None and (
            handle_matches(B, C, table_rows(B, C))
            if handle_matches is not None
            else (resident.bucket == B and resident.table_shape == (C, table_rows(B, C)))
            if placed
            else (resident[0].shape[0] == B
                  and tuple(resident[1].shape) == (C, table_rows(B, C)))
        ):
            out = None
            delta = self._delta_plan(lags, payload)
            if self._coalescer is not None:
                done = self._submit_to_coalescer(
                    lags, payload, resident.gather() if placed else resident,
                    limit, delta, lag_sum, B, warm, stats)
                if done is not None:
                    return done
            if handle_matches is not None:
                # An inline dispatch needs the stream's own tensors: leaving
                # the roster materializes its row (the next coalesced wave
                # re-stacks and re-locks).
                resident = resident.materialize()
            if delta is not None:
                out = self._dispatch_delta(delta, resident, limit, P, warm, rb_k)
                if out is None:
                    # The delta dispatch failed (an injected delta.apply
                    # fault, a scatter error): re-sync dense through the
                    # table-BUILD variant, which needs only host state, as
                    # the JAX engine does.
                    self._note_h2d("dense", payload.nbytes)
                    out = _warm_fused_build(
                        self._upload(payload),
                        self._upload(choice.astype(np.int32)),
                        limit, bucket=B, **warm,
                    )
                # Divergence check — the conservation law: refine permutes
                # ownership, never lag mass, so the device totals must sum
                # to the host lag sum.  A mismatch re-syncs dense on the
                # delta's own successors.
                elif int(out[5].sum()) != lag_sum:
                    LOGGER.warning(
                        "delta epoch diverged from the host lag sum; "
                        "re-syncing with a dense upload"
                    )
                    self._note_delta("fallback")
                    scrub_mod.record_quarantine(
                        ["lags"], "resynced", source="delta"
                    )
                    self._note_h2d("dense", payload.nbytes)
                    # The readback tail of the resync diffs against the
                    # failed dispatch's exit choice, not the host's view.
                    rb_base = None
                    out = _warm_fused_resident(
                        self._upload(payload), out[1], out[2], out[3], limit,
                        delta_k=rb_k, **warm,
                    )
                else:
                    self._note_delta("applied")
            if out is None:
                self._note_h2d("dense", payload.nbytes)
                if placed:
                    lags_p = np.zeros(B, dtype=np.int64)
                    lags_p[:P] = lags
                    out = self._placed_refine(
                        resident, collectives.split(lags_p, resident.devices),
                        limit, P, warm, rb_k,
                    )
                else:
                    out = _warm_fused_resident(
                        self._upload(payload), resident[0], resident[1], resident[2],
                        limit, delta_k=rb_k, **warm,
                    )
        else:
            self._note_h2d("dense", payload.nbytes)
            out = _warm_fused_build(
                self._upload(payload), self._upload(choice.astype(np.int32)),
                limit, bucket=B, **warm,
            )
        (narrow, choice_p, row_tab, counts, lags_p, totals, rounds, ex,
         digest) = out[:9]
        successors = (choice_p, row_tab, counts, lags_p)
        if len(out) > 9 and rb_base is not None:
            # O(changed) readback: the compaction tail, the digest and the
            # stats in one fetch (a host read: the phase ends with the
            # refine complete).
            with metrics.device_phase("refine"):
                d_idx, d_vals, d_n, digest_np, totals_np, counts_np = _fetch(
                    out[9], out[10], out[11], digest, totals, counts
                )
            n = int(d_n)
            if n <= rb_k:
                self._verify_digest(digest_np, P, lag_sum, "epoch")
                self._note_d2h("delta", d_idx.nbytes + d_vals.nbytes + 4)
                self._note_readback("applied")
                self._adopt_resident(successors, lags)
                self._fill_stats_from_device(stats, totals_np, counts_np, rounds, ex)
                return apply_assignment_delta(rb_base, d_idx, d_vals, n)
            # More changed rows than the tail holds: the dense narrow vector
            # is already computed — a second fetch, never a re-dispatch.
            self._note_readback("overflow")
        elif len(out) > 9:
            self._note_readback("fallback")
        with metrics.device_phase("refine"):
            narrow_np, digest_np, totals_np, counts_np = _fetch(
                narrow, digest, totals, counts
            )
        self._note_d2h("dense", narrow_np.nbytes)
        self._verify_digest(digest_np, P, lag_sum, "epoch")
        self._adopt_resident(successors, lags)
        self._fill_stats_from_device(stats, totals_np, counts_np, rounds, ex)
        return narrow_np.astype(np.int32)

    def _submit_to_coalescer(self, lags, payload, resident, limit, delta,
                             lag_sum: int, B: int, warm: dict, stats):
        """Park this epoch's resident refine on the coalescer; returns the
        choice, or None when the flush re-routed the row to the inline path
        (:class:`.coalesce.DeadlineReroute`: this parked thread dispatches
        it).  A row whose readback digest failed quarantines the engine and
        raises :class:`..utils.scrub.CorruptStateDetected`."""
        from ..utils.watchdog import capture_abandon_check
        from .coalesce import DeadlineReroute, EpochSubmission

        klass, rank, deadline_at = self._slo_submit
        try:
            r = self._coalescer.submit(EpochSubmission(
                payload=payload, bucket=B, resident=resident, limit=limit,
                scope=metrics.capture_scope(), owner=self,
                abandoned=capture_abandon_check(), klass=klass, rank=rank,
                deadline_at=deadline_at,
                delta_idx=delta[0][: delta[3]] if delta is not None else None,
                delta_vals=delta[1][: delta[3]] if delta is not None else None,
                lag_sum=lag_sum, **warm,
            )).result()
        except DeadlineReroute:
            return None
        except scrub_mod.CorruptStateDetected as exc:
            # The wave found this row diverged: the coalescer evicted the
            # roster; the handle points into the frozen corrupt batch and
            # must never be used again.
            self.quarantine_resident(exc.buffers, source="wave")
            raise
        self._adopt_resident(r.resident, lags)
        self._fill_stats_from_device(stats, r.totals, r.counts, r.rounds, r.exchanges)
        return r.narrow[: lags.shape[0]].astype(np.int32)

    def _effective_delta_fraction(self) -> float:
        """The delta/dense cutoff for the next epoch: the global knob until
        the window holds enough samples, then ``q90 * margin`` of the
        observed fractions, clamped to [knob/4, min(2*knob, 0.5)]."""
        base = self.delta_max_fraction
        if not (self.delta_adaptive and self.delta_enabled):
            return base
        w = self._churn_fractions
        if len(w) < _ADAPT_MIN_SAMPLES:
            return base
        q = sorted(w)[int(_ADAPT_QUANTILE * (len(w) - 1))]
        hi = min(2.0 * base, 0.5)
        lo = base / 4.0
        return float(min(max(_ADAPT_MARGIN * q, lo), hi))

    def _delta_plan(self, lags: np.ndarray, payload):
        """This epoch's padded (idx, vals) delta against the host lag
        mirror, or None when the epoch uploads dense: delta mode off, no
        mirror, the changed fraction over the cutoff, the K bucket over the
        ladder, or a padded delta no smaller than the dense payload.
        Returns ``(idx int32[K], vals int64[K], upload_bytes, n_changed)``."""
        if not self.delta_enabled:
            return None
        mirror = self._lag_mirror
        if mirror is None or mirror.shape[0] != lags.shape[0]:
            return None
        try:
            faults.fire("delta.diff")
            changed = np.flatnonzero(lags != mirror)
        except Exception:  # noqa: BLE001 — dense is the safe fallback
            LOGGER.warning("delta diff failed; uploading dense", exc_info=True)
            self._note_delta("fallback")
            return None
        n = int(changed.size)
        P = lags.shape[0]
        self._churn_fractions.append(n / max(P, 1))
        K = delta_bucket(n)
        if (
            n > self.last_effective_delta_fraction * P
            or K > self._delta_kmax
            or K * _DELTA_ENTRY_BYTES >= payload.nbytes
        ):
            self._note_delta("fallback")
            return None
        idx = np.zeros(K, dtype=np.int32)
        idx[:n] = changed
        # Padding entries write index 0's NEW value: a no-op either way.
        vals = np.full(K, int(lags[0]), dtype=np.int64)
        vals[:n] = lags[changed]
        return idx, vals, idx.nbytes + vals.nbytes, n

    def _dispatch_delta(self, delta, resident, limit, P: int, warm: dict,
                        rb_k: int):
        """One delta dispatch over the resident 4-tuple; returns its output
        tuple, or None when the dispatch failed (the fault point
        ``delta.apply`` fires first): the caller re-syncs dense within the
        same epoch, warm host state intact."""
        idx, vals, nbytes, n = delta
        try:
            faults.fire("delta.apply")
            with metrics.span("stream.h2d_delta"):
                if isinstance(resident, PlacedResident):
                    out = self._placed_refine(
                        resident, self._scatter_placed(resident, idx, vals),
                        limit, P, warm, rb_k,
                    )
                else:
                    out = _warm_fused_delta(
                        self._upload(idx), self._upload(vals), resident[3],
                        resident[0], resident[1], resident[2], limit, P,
                        delta_k=rb_k, **warm,
                    )
        except Exception:  # noqa: BLE001 — dense re-sync is the contract
            LOGGER.warning(
                "delta apply failed (%d changed); falling back to a dense "
                "upload", n, exc_info=True,
            )
            self._note_delta("fallback")
            return None
        self._note_h2d("delta", nbytes)
        return out

    @staticmethod
    def _scatter_placed(resident: PlacedResident, idx: np.ndarray, vals: np.ndarray):
        """The delta's (index, value) pairs scattered into copies of the
        placed lag shards, each pair into the shard that owns its row."""
        out = []
        for lo, t in zip(resident.row_offsets, resident.lag_shards):
            sel = (idx >= lo) & (idx < lo + t.shape[0])
            t = t.clone()
            if sel.any():
                t[torch.from_numpy(idx[sel] - lo).long().to(t.device)] = (
                    torch.from_numpy(vals[sel]).to(t.device))
            out.append(t)
        return out

    def _placed_refine(self, resident: PlacedResident, lag_shards, limit, P: int,
                       warm: dict, rb_k: int):
        """The warm refine of a placed state under the epoch's lag shards:
        the digest shard by shard (K6's shard entry, one launch a shard),
        the rows gathered onto the lead device, then the single-device warm
        body.  Its successors are placed again when adopted.  Holds the
        mesh's dispatch gate: the digest is a multi-shard program."""
        from ..sharded.mesh import dispatch_gate

        with dispatch_gate():
            digest = state_digest_sharded(
                lag_shards, resident.choice_shards, [s[2] for s in resident.shards],
                warm["num_consumers"], [s[1] for s in resident.shards],
                resident.row_offsets,
            )
            choice, row_tab, counts, _ = resident.gather()
            lags_p = collectives.all_gather(lag_shards, tiled=True)[0]
            return _refine_core(
                lags_p, choice, row_tab, counts,
                _resident_totals(lags_p, row_tab, counts), limit, P, bulk=True,
                delta_k=rb_k, digest=digest, **warm,
            )

    def _fill_stats_from_device(self, stats: StreamingStats, totals, counts,
                                rounds, ex) -> None:
        """Quality stats from the dispatch's own int64 totals and counts."""
        totals = np.asarray(totals)
        counts = np.asarray(counts)
        mean = totals.mean()
        stats.max_mean_imbalance = float(totals.max() / mean) if mean else 1.0
        stats.count_spread = int(counts.max() - counts.min())
        stats.refine_rounds = int(rounds)
        stats.refine_exchanges = int(ex)

    def _fill_quality_stats(self, stats: StreamingStats, choice: np.ndarray,
                            lags: np.ndarray, bound: float,
                            exact_bincount: bool) -> None:
        """Host quality stats of ``choice``; ``bound`` and
        ``exact_bincount`` depend only on the epoch's lags."""
        # The f64 weighted bincount is exact while the total stays below
        # 2**53; beyond it the exact scatter-add.
        if exact_bincount:
            totals = np.bincount(
                choice, weights=lags, minlength=self.num_consumers
            ).astype(np.int64)
        else:
            totals = np.zeros(self.num_consumers, dtype=np.int64)
            np.add.at(totals, choice.astype(np.int64), lags)
        counts = np.bincount(choice, minlength=self.num_consumers)
        mean = totals.mean()
        stats.max_mean_imbalance = float(totals.max() / mean) if mean else 1.0
        stats.count_spread = int(counts.max() - counts.min())
        stats.imbalance_bound = bound

    def remap_members(self, old_to_new: np.ndarray, new_num_consumers: int) -> None:
        """Carry warm state across a membership change: ``old_to_new[i]`` is
        consumer i's new dense index (-1 if it left; joiners extend the
        range).  Orphans and count overflow are re-seated by the next
        :meth:`rebalance`'s repair pass; churn is bounded by ``orphans +
        capacity overflow + 2 * refine_iters``."""
        old_to_new = np.ascontiguousarray(old_to_new, dtype=np.int32)
        if self._prev_choice is not None:
            prev = self._prev_choice
            valid = (prev >= 0) & (prev < old_to_new.shape[0])
            remapped = np.full(prev.shape[0], -1, dtype=np.int32)
            remapped[valid] = old_to_new[prev[valid]]
            self._prev_choice = remapped
        self._drop_resident()  # device state predates the remap
        self.num_consumers = int(new_num_consumers)

    def _repair_choice(self, choice: np.ndarray, lags: np.ndarray):
        """Seat unowned rows and enforce the count invariant host-side.

        After :meth:`remap_members`, some rows are orphaned (-1) and the
        surviving members' counts may exceed the new ceiling
        ``ceil(P / C)``.  Overflowing owners release their SMALLEST-lag
        rows (cheapest churn); then orphans, largest lag first, go to the
        least-loaded open consumer — the count-primary greedy rule over
        only the moving rows, O(moving * C) host work on a few hundred
        rows, versus a full device re-solve.  A final correction pass
        restores ``max - min <= 1`` exactly: with a non-divisible P the
        cap-based release alone leaves every survivor at ceil while the
        joiner cannot reach floor (e.g. P=401, C 4->5: cap 81, survivors
        81,81,81,81, joiner 77 — spread 4, found by the
        operation-sequence fuzz; a join can also arrive with no cap
        overflow at all, e.g. counts 2,2,2,2,2,0), and the count
        invariant is the reference's PRIMARY semantic, so it must hold
        even when the quality threshold later skips the refine.

        Owns its trigger: returns ``(choice unchanged, 0)`` when there is
        nothing to repair.  Returns ``(repaired choice, rows moved)``.
        """
        C = self.num_consumers
        P = lags.shape[0]
        cap = -(-P // C)  # ceil: no consumer may exceed the new ceiling
        counts = np.bincount(choice[choice >= 0], minlength=C)
        has_orphans = bool((choice < 0).any())
        if (
            not has_orphans
            and counts.max() <= cap
            and counts.max() - counts.min() <= 1
        ):
            return choice, 0
        original = choice
        choice = choice.copy()
        totals = np.zeros(C, dtype=np.int64)
        sel = choice >= 0
        np.add.at(totals, choice[sel], lags[sel])
        # Release overflow (smallest lag first -> cheapest to move).
        for c in np.nonzero(counts > cap)[0]:
            rows = np.nonzero(choice == c)[0]
            release = rows[np.argsort(lags[rows])][: counts[c] - cap]
            choice[release] = -1
            counts[c] = cap
            totals[c] -= lags[release].sum()
        def least_total_of(cand: np.ndarray) -> int:
            """THE seating tie-break: least total lag among the candidate
            mask (shared by orphan seating and spread correction)."""
            return int(
                np.argmin(np.where(cand, totals, np.iinfo(np.int64).max))
            )

        # Seat orphans: largest lag first, least (count, total) open seat.
        orphans = np.nonzero(choice < 0)[0]
        for p in orphans[np.argsort(-lags[orphans])]:
            open_mask = counts < cap
            key = np.where(open_mask, counts, np.iinfo(np.int64).max)
            who = least_total_of(key == key.min())
            choice[p] = who
            counts[who] += 1
            totals[who] += lags[p]
        # Spread correction: move the heaviest-count member's smallest-lag
        # row to the lightest member until max - min <= 1.  Bounded by
        # O(C * initial spread) single-row moves.
        while counts.max() - counts.min() > 1:
            donor = int(np.argmax(counts))
            recv = least_total_of(counts == counts.min())
            rows = np.nonzero(choice == donor)[0]
            p = rows[np.argmin(lags[rows])]
            choice[p] = recv
            counts[donor] -= 1
            counts[recv] += 1
            totals[donor] -= lags[p]
            totals[recv] += lags[p]
        return choice, int((choice != original).sum())

    def export_state(self) -> Optional[np.ndarray]:
        """A copy of the previous choice vector (the host-durable snapshot
        unit), or None while cold.  The resident tensors are not exported:
        the next refine dispatch rebuilds them from this vector."""
        prev = self._prev_choice
        return None if prev is None else np.array(prev, copy=True)

    def seed_choice(self, choice: np.ndarray) -> None:
        """Warm-restart seed: adopt a host choice vector as the previous
        assignment; the resident state is left stale and the next refine
        dispatch rebuilds its tables from this vector."""
        self._prev_choice = np.ascontiguousarray(choice, dtype=np.int32)
        self._drop_resident()

    @property
    def needs_dense_resync(self) -> bool:
        """True when the next warm epoch must rebuild the device state with
        a dense upload (stale resident after seed / repair / remap)."""
        return self._prev_choice is not None and self._resident is None

    def prestack_resident(self) -> bool:
        """Rebuild the resident state from the seeded choice under a ZERO
        lag vector, off the serving path: a zero vector meets any quality
        limit before the first round, so the choice comes back unchanged
        and the next real epoch is the one the lazy rebuild would give.
        Returns True when a resident was built."""
        if self._prev_choice is None or self._resident is not None:
            return False
        P = int(self._prev_choice.shape[0])
        lags = np.zeros(P, dtype=np.int64)
        payload, _ = stream_payload(lags)
        out = _warm_fused_build(
            self._upload(payload), self._upload(self._prev_choice.astype(np.int32)),
            0.0, num_consumers=self.num_consumers, iters=self.refine_iters,
            max_pairs=min(self.num_consumers // 2, 16),
            exchange_budget=self.refine_iters, bucket=self._bucket(P),
        )
        (digest_np,) = _fetch(out[8])
        self._verify_digest(digest_np, P, 0, "prestack")
        self._adopt_resident(out[1:5], lags)
        return True

    def reset(self) -> None:
        """Drop warm state (force the next rebalance to solve cold)."""
        self._prev_choice = None
        self._drop_resident()
