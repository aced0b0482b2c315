"""Closed-loop overload control: SLO classes, shed ladder, elasticity.

A copy of ``kafka_lag_based_assignor_tpu/utils/overload.py``, whole: the
same classes, rungs, thresholds, series (``klba_shed_total{class,rung}``,
``klba_overload_rung``, ``klba_overload_pressure``), flight records and
fault point (``shed.decide``), on the port's registry, trace collector and
fault injector.  The sidecar serves many tenants through one device
pipeline; this module is the control plane in front of it: per-tenant
**SLO classes**, a registry-fed **overload detector** that walks a shed
ladder, and the **elasticity** math behind the wire ``{"method":
"recommend"}`` call — degrade batch efficiency before latency, and shed
the lowest class first.

SLO classes
-----------

Every stream carries one of three classes (config
``tpu.assignor.slo.class.<stream>``, overridable per request via the
wire ``params.slo_class``):

================  ====  ======  =============================================
class             rank  weight  meaning
================  ====  ======  =============================================
``critical``        0       4   never shed; placed first in every wave
``standard``        1       2   default; degraded only at the last rung
``best_effort``     2       1   first to degrade, then first to be rejected
================  ====  ======  =============================================

Rank orders megabatch chunk placement in the JAX package's coalescer
(which the port's sidecar does not run yet; the window scales below are
kept for it); weight scales a class's contribution to the queue-depth
pressure signal.  A per-class **deadline budget** (config
``tpu.assignor.slo.deadline.ms.<class>``) caps the request's deadline
budget below the global ``solve.timeout.ms``.

The shed ladder
---------------

:class:`OverloadController` derives a pressure score from three
registry-fed signals — an EWMA of the in-flight stream-request depth,
the windowed p99 of ``klba_span_duration_ms{span=stream.epoch}``
(bucket-delta since the previous evaluation, so one cold compile does
not poison the signal forever), and the stream breaker's state — and
maps it onto the rungs:

====  ====================  =================================================
rung  name                  action
====  ====================  =================================================
0     ``none``              admit everything, full admission window
1     ``shrink_window``     coalescer admission window scaled down
2     ``degrade_best_effort``  best_effort served ``kept_previous`` (zero
                            device work; warm state intact)
3     ``reject_best_effort``  best_effort rejected with a retry-after hint
4     ``degrade_standard``  standard also ``kept_previous``; critical still
                            solves
====  ====================  =================================================

Escalation is immediate; de-escalation steps down one rung per
``cooldown_s`` below threshold (hysteresis — a stampede must not
flap the ladder).  Every shed emits a flight record and
``klba_shed_total{class,rung}``; rung transitions set the
``klba_overload_rung`` gauge and record an ``overload_rung`` flight
record.  The fault point ``shed.decide`` fires inside
:meth:`OverloadController.admission` — the service FAILS OPEN (admits)
when the decision path itself faults, pinned by the chaos suite.

Elasticity
----------

:func:`recommend_consumers` projects a stream's backlog ``horizon_s``
ahead from its recent (time, total lag) samples and sizes the group so
the projected backlog per consumer stays at today's level::

    rec = ceil(C * (lag_now + max(0, slope) * horizon) / lag_now)

Monotone in the lag trend by construction (the acceptance gate the
bench's stampede probe pins); the current overload rung bumps the
floor to ``C + 1`` once the ladder is degrading traffic.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

from . import faults, metrics
from . import trace as trace_mod

LOGGER = logging.getLogger(__name__)

#: The SLO classes, most- to least-important.  Index = rank (placement
#: and shed order both key on it).
SLO_CLASSES = ("critical", "standard", "best_effort")

_CLASS_RANK = {c: i for i, c in enumerate(SLO_CLASSES)}

#: Default admission weights (config-overridable is deliberately NOT
#: offered — the weights only scale the depth-pressure signal, and a
#: per-deployment knob there would be unfalsifiable tuning surface).
CLASS_WEIGHTS = {"critical": 4.0, "standard": 2.0, "best_effort": 1.0}

#: Shed-ladder rungs, least to most severe (index = rung).
RUNGS = (
    "none",
    "shrink_window",
    "degrade_best_effort",
    "reject_best_effort",
    "degrade_standard",
)

#: Coalescer admission-window scale per rung — the STANDARD class's
#: table (back-compat anchor: the unlabeled ``window_scale`` fields
#: and the legacy single-scale coalescer hook read this one): rung 1
#: is "shrink the admission window" (smaller waves, lower parked
#: latency); deeper rungs keep shrinking — batch efficiency yields
#: before latency does.
_WINDOW_SCALE = (1.0, 0.5, 0.25, 0.25, 0.1)

#: Per-CLASS window tables, indexed by class
#: rank then rung: rung 1's shrink lands class-by-class — the critical
#: window stays WIDE (a critical epoch keeps its full coalescing
#: opportunity; its latency is protected by placement order and the
#: deadline triage, not by starving its batches) while best_effort
#: shrinks hardest (it is the traffic the ladder is about to degrade
#: anyway, so its waves go small first).
_WINDOW_SCALE_BY_RANK = (
    (1.0, 1.0, 0.5, 0.5, 0.25),   # critical
    _WINDOW_SCALE,                # standard
    (1.0, 0.25, 0.1, 0.1, 0.05),  # best_effort
)

#: Pressure thresholds: rung i engages at pressure >= _THRESHOLDS[i-1].
_THRESHOLDS = (1.0, 1.5, 2.5, 4.0)


def class_rank(klass: str) -> int:
    return _CLASS_RANK[klass]


def _held_window_scale(rung: int, standing: float, rank: int = 1) -> float:
    """THE takeover window-hold rule, in one place (admission decisions
    AND the operator snapshot read it): while any standing takeover
    pressure is parked, the admission window is held at rung-1 scale
    even at rung 0 — per CLASS, so the hold also leaves the critical
    window wide."""
    table = _WINDOW_SCALE_BY_RANK[rank]
    scale = table[rung]
    if standing > 0:
        return min(scale, table[1])
    return scale


def _held_window_scales(rung: int, standing: float) -> Tuple[float, ...]:
    """All three classes' held window scales, rank order."""
    return tuple(
        _held_window_scale(rung, standing, rank)
        for rank in range(len(SLO_CLASSES))
    )


#: Get-or-create cache for the shed counters (sheds happen on the
#: overloaded hot path, where a label-dict registry lookup per event is
#: the wrong cost).  Plain dict: get/set are GIL-atomic, and a racing
#: double-create just fetches the same registry child twice.
_SHED_COUNTERS: Dict[Tuple[str, str], "metrics.Counter"] = {}


def record_shed(
    klass: str,
    rung_name: str,
    served: Optional[str],
    stream_id: Optional[str] = None,
    request_id: Optional[str] = None,
    scope: Optional[Any] = None,
) -> None:
    """Account one shed event — ``klba_shed_total{class,rung}`` plus a
    flight record and a ``shed`` anomaly mark on the indicted trace
    (tail sampling ALWAYS keeps shed traces) — with ONE schema no
    matter which layer shed the request (the controller's ladder or
    the coalescer's deadline triage).  ``served`` is what the client
    got (``kept_previous`` / ``rejected``), or None when the shedding
    layer cannot know (the coalescer sheds before the submitter's
    recovery picks the answer).  ``request_id``/``scope`` are only
    needed from threads outside the request scope — the coalescer
    flusher shedding a parked submitter's row passes the submitter's
    captured scope token so the mark lands on THAT trace."""
    key = (klass, rung_name)
    counter = _SHED_COUNTERS.get(key)
    if counter is None:
        counter = _SHED_COUNTERS[key] = metrics.REGISTRY.counter(
            "klba_shed_total", {"class": klass, "rung": rung_name}
        )
    counter.inc()
    if scope is not None:
        trace_mod.mark_state(getattr(scope, "trace", None), "shed")
    else:
        trace_mod.mark("shed")
    rec: Dict[str, Any] = {
        "class": klass,
        "rung": rung_name,
        "served": served,
        "stream_id": stream_id,
    }
    if request_id is not None:
        rec["request_id"] = request_id
    if scope is not None and getattr(scope, "trace", None) is not None:
        rec.setdefault("trace_id", scope.trace.trace_id)
    metrics.FLIGHT.record("shed", rec)


class ShedReject(RuntimeError):
    """A request rejected by the shed ladder (never an internal error):
    the wire layer turns this into an error envelope carrying the class,
    the rung, and a ``retry_after_ms`` hint for the client's backoff."""

    def __init__(self, klass: str, rung: str, retry_after_ms: int):
        super().__init__(
            f"overload: {klass!r} traffic is being shed at rung {rung!r}; "
            f"retry after {retry_after_ms} ms"
        )
        self.klass = klass
        self.rung = rung
        self.retry_after_ms = retry_after_ms
        # Stamped by the service CLIENT when it rebuilds the rejection
        # from an error envelope: the shedding sidecar's trace id.
        self.trace_id: Optional[str] = None


class SloPolicy:
    """Per-stream class resolution + per-class deadline budgets.

    ``classes`` maps stream id -> class name (from
    ``tpu.assignor.slo.class.<stream>``); a wire-level override wins.
    ``deadline_s`` maps class name -> seconds; :meth:`budget_s` returns
    the TIGHTER of the class deadline and the service's global solve
    timeout (a class budget can only shrink the request budget, never
    extend past the watchdog's)."""

    def __init__(
        self,
        classes: Optional[Mapping[str, str]] = None,
        deadline_s: Optional[Mapping[str, float]] = None,
        default_class: str = "standard",
    ):
        self._classes = dict(classes or {})
        self._deadline_s = dict(deadline_s or {})
        for sid, klass in self._classes.items():
            if klass not in SLO_CLASSES:
                raise ValueError(
                    f"unknown SLO class {klass!r} for stream {sid!r}; "
                    f"valid: {list(SLO_CLASSES)}"
                )
        for klass, secs in self._deadline_s.items():
            if klass not in SLO_CLASSES:
                raise ValueError(
                    f"unknown SLO class {klass!r} in deadline map; "
                    f"valid: {list(SLO_CLASSES)}"
                )
            if not secs > 0:
                raise ValueError(
                    f"SLO deadline for {klass!r} must be > 0, got {secs}"
                )
        if default_class not in SLO_CLASSES:
            raise ValueError(f"unknown default class {default_class!r}")
        self.default_class = default_class

    def resolve(self, stream_id: Any, override: Any = None) -> str:
        """The stream's effective class: wire override > config map >
        default.  An unknown override is a client error (loud, like
        every other wire-boundary validation)."""
        if override is not None:
            if override not in SLO_CLASSES:
                raise ValueError(
                    f"unknown slo_class {override!r}; valid: "
                    f"{list(SLO_CLASSES)}"
                )
            return override
        if isinstance(stream_id, str):
            return self._classes.get(stream_id, self.default_class)
        return self.default_class

    def deadline_s(self, klass: str) -> Optional[float]:
        return self._deadline_s.get(klass)

    def budget_s(
        self, klass: str, global_timeout_s: Optional[float]
    ) -> Optional[float]:
        """The request's total deadline budget for this class."""
        d = self._deadline_s.get(klass)
        if d is None:
            return global_timeout_s
        if global_timeout_s is None:
            return d
        return min(d, global_timeout_s)


class _Decision:
    """One admission decision: what to do with this request, and the
    ladder context that produced it (snapshotted — the rung may move
    while the request runs)."""

    __slots__ = ("action", "rung", "rung_name", "retry_after_ms",
                 "window_scale", "window_scales")

    def __init__(self, action: str, rung: int, retry_after_ms: int):
        self.action = action  # "admit" | "degrade" | "reject"
        self.rung = rung
        self.rung_name = RUNGS[rung]
        self.retry_after_ms = retry_after_ms
        # window_scale stays the STANDARD class's scale (back-compat
        # reads); window_scales is the per-class (rank-ordered) triple
        # the coalescer actually applies.
        self.window_scale = _WINDOW_SCALE[rung]
        self.window_scales = tuple(
            t[rung] for t in _WINDOW_SCALE_BY_RANK
        )


class OverloadController:
    """The service-level overload detector + shed ladder (module
    docstring).  One instance per service; thread-safe; clock
    injectable so the hysteresis is testable without
    real waits.

    ``latency_budget_ms`` is the epoch-latency level treated as
    pressure 1.0 (default: half the solve timeout — permissive, so an
    unconfigured sidecar never sheds on the cold-compile epochs);
    ``depth_high`` is the weighted in-flight depth treated as pressure
    1.0.  ``eval_interval_s`` rate-limits the registry walk; between
    evaluations the cached rung serves."""

    def __init__(
        self,
        latency_budget_ms: float = 60_000.0,
        depth_high: float = 24.0,
        ewma_alpha: float = 0.3,
        cooldown_s: float = 1.0,
        eval_interval_s: float = 0.1,
        clock: Optional[Callable[[], float]] = None,
        breaker_open: Optional[Callable[[], bool]] = None,
    ):
        if not latency_budget_ms > 0:
            raise ValueError(
                f"latency_budget_ms={latency_budget_ms} must be > 0"
            )
        if not depth_high > 0:
            raise ValueError(f"depth_high={depth_high} must be > 0")
        self.latency_budget_ms = float(latency_budget_ms)
        self.depth_high = float(depth_high)
        self.ewma_alpha = float(ewma_alpha)
        self.cooldown_s = float(cooldown_s)
        self.eval_interval_s = float(eval_interval_s)
        self._clock = clock or metrics.REGISTRY.clock
        self._breaker_open = breaker_open or (lambda: False)
        self._lock = threading.Lock()
        self._ewma_depth = 0.0
        # Standing pressure (lease-aware shedding during the
        # takeover window): a constant term the
        # sidecar parks here for adopted-but-still-cold streams after
        # a takeover/restart.  Unlike the depth EWMA it does NOT decay
        # — it is released stream by stream as each recovered stream
        # serves its first (warming) epoch — and while any of it is
        # outstanding the admission window is held at rung-1 scale, so
        # a replacement serving cold streams cannot stampede itself.
        self._standing = 0.0
        self._rung = 0
        self._pressure = 0.0
        self._p99_ms: Optional[float] = None
        self._last_eval: Optional[float] = None
        self._last_step_down: float = self._clock()
        # Windowed latency signal: bucket-delta p99 of the stream.epoch
        # span since the previous evaluation (one cold compile must not
        # poison the lifetime percentile forever).
        self._epoch_hist = metrics.REGISTRY.histogram(
            "klba_span_duration_ms", {"span": "stream.epoch"}
        )
        self._hist_prev = self._epoch_hist.state()
        self._m_rung = metrics.REGISTRY.gauge("klba_overload_rung")
        self._m_pressure = metrics.REGISTRY.gauge("klba_overload_pressure")

    # -- signals -----------------------------------------------------------

    def note_depth(self, weighted_depth: float) -> None:
        """Feed the weighted in-flight depth (sum of CLASS_WEIGHTS over
        requests currently in the stream path)."""
        with self._lock:
            self._ewma_depth += self.ewma_alpha * (
                float(weighted_depth) - self._ewma_depth
            )

    def seed_recovery_depth(self, weighted_depth: float) -> None:
        """Recovery-aware ladder seed: a
        restarting sidecar knows every recovered stream will fire its
        next epoch at once — seed the depth EWMA with that stampede's
        weighted depth (never DOWNWARD: a restored snapshot may carry
        a higher live reading) and force the next admission decision
        to re-evaluate, so a restart under a live stampede
        re-escalates on the FIRST post-boot decision instead of
        waiting one evaluation interval.  If the stampede never
        materializes the EWMA decays through the normal hysteresis."""
        with self._lock:
            self._ewma_depth = max(
                self._ewma_depth, float(weighted_depth)
            )
            self._last_eval = None

    def add_standing_pressure(self, weight: float) -> None:
        """Park ``weight`` (a CLASS_WEIGHTS sum) as standing takeover
        pressure and force the next admission decision to re-evaluate
        (see the ``_standing`` comment)."""
        if weight <= 0:
            return
        with self._lock:
            self._standing += float(weight)
            self._last_eval = None

    def release_standing_pressure(self, weight: float) -> None:
        """Release ``weight`` of the parked takeover pressure (one
        adopted stream finished warming — its first epoch served, it
        was reset, or it was discarded).  Clamped at zero and forces a
        re-evaluation, so the ladder can step down through the normal
        hysteresis the moment the warm-up drains."""
        if weight <= 0:
            return
        with self._lock:
            self._standing = max(0.0, self._standing - float(weight))
            self._last_eval = None

    def standing_pressure(self) -> float:
        with self._lock:
            return self._standing

    def _windowed_p99(self) -> Optional[float]:
        """p99 of the stream.epoch observations made since the previous
        evaluation (bucket-wise delta) — None when nothing new."""
        cur = self._epoch_hist.state()
        prev, self._hist_prev = self._hist_prev, cur
        count = cur["count"] - prev["count"]
        if count <= 0:
            return None
        deltas = [a - b for a, b in zip(cur["buckets"], prev["buckets"])]
        return metrics._delta_percentile(deltas, count, 0.99)

    def _evaluate_locked(self, now: float) -> None:
        """Caller holds the lock: recompute pressure + rung (rate
        limited to ``eval_interval_s``)."""
        if (
            self._last_eval is not None
            and now - self._last_eval < self.eval_interval_s
        ):
            return
        self._last_eval = now
        p99 = self._windowed_p99()
        if p99 is not None:
            self._p99_ms = p99
        elif self._p99_ms is not None:
            # No stream.epoch completed since the last evaluation: the
            # congestion that p99 measured has drained (or the ladder
            # is rejecting everything that would refresh it) — decay
            # the stale signal so an all-shed class mix cannot pin the
            # ladder at its last reading forever (livelock: rejected
            # requests never produce new epochs).
            self._p99_ms *= 0.8
            if self._p99_ms < 1.0:
                self._p99_ms = None
        # Standing takeover pressure is a FLOOR under the depth signal,
        # not an addend: seed_recovery_depth already parks the same
        # recovered weight in the EWMA, and summing the two would read
        # every restart one rung harsher than the recovery seeding was
        # designed for.  max() keeps the ladder where the
        # seed put it while the EWMA decays, and hands over to live
        # traffic smoothly as adopted streams warm.
        depth_pressure = (
            max(self._ewma_depth, self._standing) / self.depth_high
        )
        lat_pressure = (
            (self._p99_ms / self.latency_budget_ms)
            if self._p99_ms is not None else 0.0
        )
        pressure = max(depth_pressure, lat_pressure)
        if self._breaker_open():
            pressure += 1.0
        self._pressure = pressure
        target = 0
        for i, threshold in enumerate(_THRESHOLDS):
            if pressure >= threshold:
                target = i + 1
        if target > self._rung:
            # Escalation is immediate — the ladder's whole point is to
            # act before queues melt.
            self._transition(target, now)
        elif target < self._rung:
            # De-escalate one rung per cooldown below threshold.
            if now - self._last_step_down >= self.cooldown_s:
                self._transition(self._rung - 1, now)
        self._m_pressure.set(pressure)

    def _transition(self, rung: int, now: float) -> None:
        old = self._rung
        self._rung = rung
        self._last_step_down = now
        self._m_rung.set(rung)
        metrics.FLIGHT.record(
            "overload_rung",
            {
                "from": RUNGS[old],
                "to": RUNGS[rung],
                "pressure": round(self._pressure, 3),
                "ewma_depth": round(self._ewma_depth, 3),
                "p99_ms": self._p99_ms,
            },
        )
        LOGGER.warning(
            "overload ladder %s -> %s (pressure %.2f, depth %.2f, "
            "p99 %s ms)",
            RUNGS[old], RUNGS[rung], self._pressure, self._ewma_depth,
            self._p99_ms,
        )

    # -- decisions ---------------------------------------------------------

    def admission(self, klass: str) -> _Decision:
        """Decide this request's fate under the current ladder rung.

        Fault point ``shed.decide`` fires here: the SERVICE fails open
        (admits) when the decision path faults — overload control must
        never be the thing that takes healthy traffic down."""
        faults.fire("shed.decide")
        now = self._clock()
        with self._lock:
            self._evaluate_locked(now)
            rung = self._rung
            pressure = self._pressure
            standing = self._standing
        rank = _CLASS_RANK[klass]
        action = "admit"
        if rung >= 4 and rank >= 1:
            action = "reject" if rank >= 2 else "degrade"
        elif rung >= 3 and rank >= 2:
            action = "reject"
        elif rung >= 2 and rank >= 2:
            action = "degrade"
        retry_ms = int(min(5000.0, max(100.0, self.cooldown_s * 1000.0
                                       * max(pressure, 1.0))))
        decision = _Decision(action, rung, retry_ms)
        # Takeover window: while adopted
        # streams are still warming, hold the megabatch admission
        # window at rung-1 scale even at rung 0 — smaller waves until
        # the replacement's cold streams have all served once, so the
        # post-takeover stampede trickles instead of parking whole
        # fleets behind one giant cold wave.  Applied per class: the
        # critical table's rung-1 scale is 1.0, so critical waves stay
        # full-width through both the hold and rung 1.
        decision.window_scale = _held_window_scale(rung, standing)
        decision.window_scales = _held_window_scales(rung, standing)
        return decision

    def note_shed(
        self, klass: str, rung_name: str, served: str,
        stream_id: Optional[str] = None,
    ) -> None:
        """Account one shed event: ``klba_shed_total{class,rung}`` plus
        a flight record (every shed is visible post-incident) — thin
        delegate to the module's :func:`record_shed`, the ONE schema
        every shedding layer shares."""
        record_shed(klass, rung_name, served, stream_id=stream_id)

    def rung(self) -> int:
        with self._lock:
            return self._rung

    # -- lifecycle snapshot (utils/snapshot) -------------------------------

    def export_state(self) -> Dict[str, Any]:
        """Host-durable ladder state for the lifecycle snapshot: the
        rung plus the pressure signals that produced it.  Restoring the
        rung is what keeps a restart from serving the post-deploy
        stampede at rung 0 with a zeroed detector — the ladder resumes
        where it was and de-escalates through the normal hysteresis."""
        with self._lock:
            return {
                "rung": self._rung,
                "pressure": self._pressure,
                "ewma_depth": self._ewma_depth,
                "p99_ms": self._p99_ms,
            }

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Adopt exported ladder state after a restart (clamped to the
        known rungs; malformed input is discarded whole — overload
        control fails open, same contract as the admission path).  The
        step-down clock restarts now, so de-escalation still waits a
        full ``cooldown_s`` before the first downward step."""
        try:
            rung = min(max(int(state.get("rung", 0)), 0), len(RUNGS) - 1)
            pressure = float(state.get("pressure", 0.0))
            ewma = float(state.get("ewma_depth", 0.0))
            p99 = state.get("p99_ms")
            p99_ms = float(p99) if p99 is not None else None
        except (TypeError, ValueError, AttributeError):
            LOGGER.warning(
                "discarding malformed overload snapshot", exc_info=True
            )
            return
        with self._lock:
            self._rung = rung
            self._pressure = pressure
            self._ewma_depth = ewma
            self._p99_ms = p99_ms
            self._last_step_down = self._clock()
            self._m_rung.set(rung)
            self._m_pressure.set(pressure)

    def snapshot(self) -> Dict[str, Any]:
        """The operator's view (wire ``stats`` / ``recommend``)."""
        with self._lock:
            return {
                "rung": RUNGS[self._rung],
                "rung_index": self._rung,
                "pressure": round(self._pressure, 4),
                "ewma_depth": round(self._ewma_depth, 4),
                "standing_pressure": round(self._standing, 4),
                "p99_ms": self._p99_ms,
                "window_scale": _held_window_scale(
                    self._rung, self._standing
                ),
                "window_scales": {
                    klass: _held_window_scale(
                        self._rung, self._standing, rank
                    )
                    for rank, klass in enumerate(SLO_CLASSES)
                },
                "latency_budget_ms": self.latency_budget_ms,
                "depth_high": self.depth_high,
            }


def recommend_consumers(
    samples: Sequence[Tuple[float, float]],
    consumers: int,
    partitions: int,
    horizon_s: float = 60.0,
) -> Tuple[int, float]:
    """Consumer-count recommendation from (time_s, total_lag) samples.

    Projects the backlog ``horizon_s`` ahead at the window's trend and
    sizes the group so per-consumer backlog stays at today's level:
    ``ceil(C * projected / now)``.  Monotone non-decreasing in the lag
    slope (the bench gate); clamped to ``[1, partitions]`` — more
    consumers than partitions can never help (Kafka semantics).  Fewer
    than two samples (or a zero-length window) recommend the status
    quo.  Returns ``(recommended_consumers, slope_lag_per_s)``."""
    consumers = max(int(consumers), 1)
    floor_parts = max(int(partitions), 1)
    if len(samples) < 2:
        return min(consumers, floor_parts), 0.0
    t0, l0 = samples[0]
    t1, l1 = samples[-1]
    dt = t1 - t0
    if dt <= 0:
        return min(consumers, floor_parts), 0.0
    slope = (float(l1) - float(l0)) / dt
    lag_now = max(float(l1), 1.0)
    growth = max(0.0, slope) * horizon_s / lag_now
    rec = math.ceil(consumers * (1.0 + growth))
    return min(max(rec, 1), floor_parts), slope


def recommend_payload(
    streams: Mapping[str, Dict[str, Any]],
    overload: Dict[str, Any],
    horizon_s: float = 60.0,
) -> Dict[str, Any]:
    """Assemble the wire ``recommend`` result: per-stream entries (each
    holding ``samples`` [(t, lag), ...] oldest-first, ``consumers``,
    ``partitions``, ``slo_class``) plus the overload snapshot.  Once
    the ladder is actively degrading (rung >= 2) every stream's floor
    is ``C + 1`` — the detector is saying capacity, not drift."""
    degrading = overload.get("rung_index", 0) >= 2
    out: Dict[str, Any] = {"overload": overload, "streams": {}}
    for sid, info in streams.items():
        C = int(info["consumers"])
        P = int(info["partitions"])
        rec, slope = recommend_consumers(
            info["samples"], C, P, horizon_s=horizon_s
        )
        if degrading:
            rec = min(max(rec, C + 1), max(P, 1))
        out["streams"][sid] = {
            "slo_class": info["slo_class"],
            "consumers": C,
            "partitions": P,
            "recommended_consumers": rec,
            "lag_trend_per_s": round(slope, 3),
            "total_lag": int(info["samples"][-1][1])
            if info["samples"] else 0,
            "samples": len(info["samples"]),
            "horizon_s": horizon_s,
        }
    return out
