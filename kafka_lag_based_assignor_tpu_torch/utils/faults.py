"""Deterministic fault injection for failure-domain drills.

A copy of ``kafka_lag_based_assignor_tpu/utils/faults.py``.  The hardening
of the plugin's failure domains (per-solver circuit breakers, the host
rung, bounded lag retry, the streaming engine's integrity checks) is only
trustworthy if it is *fault-tested* — so the code paths carry named fault
points and this module injects failures at them, deterministically and
reproducibly.

:data:`FAULT_POINTS` is the JAX package's set, whole, so a drill spec
valid for one package is valid for the other.  The points the port's code
fires today:

========================  =============================================
``device.solve``          entry of the accelerated solve the plugin
                          and the sidecar share
                          (:func:`..assignor.solve_accelerated`)
``device.compile``        per-group kernel dispatch, where a first-use
                          kernel build would occur
                          (:func:`..ops.dispatch.assign_group_device`)
``stream.refine``         entry of a streaming rebalance epoch
                          (:meth:`..ops.streaming.StreamingAssignor.
                          rebalance`)
``delta.diff``            the host-side lag differ (:meth:`..ops.
                          streaming.StreamingAssignor._delta_plan`) — a
                          failure falls back to the dense upload within
                          the same epoch
``delta.apply``           the delta dispatch (:meth:`..ops.streaming.
                          StreamingAssignor._dispatch_delta`) — a
                          failure re-syncs dense within the same epoch
``device.corrupt.*``      ``choice`` / ``counts`` / ``lags`` /
                          ``row_tab``: a seeded BIT-FLIP into the named
                          resident tensor as the engine adopts it
                          (:meth:`..ops.streaming.StreamingAssignor.
                          _adopt_resident`); the plan does not raise into
                          the caller — the next dispatch's digest must
                          DETECT the divergence, quarantine the engine,
                          and the epoch after heals it from host truth.
                          Use ``raise`` plans; the seed picks the flipped
                          element and bit
``lag.begin``             the ListOffsets(beginning) broker RPC (:mod:`..lag`)
``lag.end``               the ListOffsets(end) broker RPC
``lag.committed``         the OffsetFetch broker RPC
``wire.read``             the sidecar's socket read (:mod:`..service`):
                          a failure drops the connection
``shed.decide``           the overload admission decision
                          (:meth:`..utils.overload.OverloadController.
                          admission`); the sidecar fails open (admits)
========================  =============================================

The other points (``coalesce.*``, ``admit.park``, ``mesh.collective``,
``peer.*``, ``snapshot.*``, ``backend.*``, ``drain.flush``) belong to
modules the port has not taken yet: a plan for them is accepted and never
fires.

Fault modes: ``raise`` (raise :class:`FaultError`), ``hang`` (bounded
sleep of ``delay_s`` then raise — simulates a wedged transport that the
watchdog must abandon; the sleep is clamped so a drill can never wedge
the process itself), ``latency`` (sleep then proceed normally).

Zero-cost when off: production code calls :func:`fire`, which is a
single global load + ``None`` compare unless an injector was activated.

Determinism: plans fire by *call count* (``after`` skips, ``times``
bounds), and the optional ``probability`` coin uses the injector's own
seeded :class:`random.Random` — the same seed replays the same schedule,
on the same calls as the JAX package's injector.

Exact schedules (:meth:`FaultInjector.schedule`): a plan can pin firing
to exact call numbers (``at_calls``) and/or to driver-advanced epochs
(``at_epochs``, advanced via :meth:`FaultInjector.set_epoch`;
``per_epoch`` bounds firings inside each eligible epoch).  Scheduled
plans are fully deterministic: no probability coin, no hand-counted
``after`` warm-up offsets.

Activation: programmatic (``activate`` / the ``injected`` context
manager) or by environment for staging drills::

    KLBA_FAULTS="device.solve:raise:2,lag.end:latency:3:0.01"
    KLBA_FAULTS_SEED=7

Spec grammar per entry: ``point:mode[:times[:delay_s[:probability]]]``;
``times`` <= 0 means unlimited.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

from . import metrics

LOGGER = logging.getLogger(__name__)

#: Every fault point of the JAX package (see the module docstring for the
#: ones the port fires).  ``plan()`` validates against this set so a
#: typo'd drill fails loudly instead of never firing.
FAULT_POINTS = frozenset(
    {
        "device.solve",
        "device.compile",
        "stream.refine",
        "coalesce.flush",
        "coalesce.gather",
        "admit.park",
        "shed.decide",
        "delta.diff",
        "delta.apply",
        "device.corrupt.choice",
        "device.corrupt.counts",
        "device.corrupt.lags",
        "device.corrupt.row_tab",
        "mesh.collective",
        "peer.partition",
        "peer.slow_link",
        "peer.sync",
        "peer.stale_duals",
        "snapshot.write",
        "snapshot.load",
        "snapshot.cas",
        "snapshot.lease",
        "backend.partition",
        "backend.latency",
        "drain.flush",
        "lag.begin",
        "lag.end",
        "lag.committed",
        "wire.read",
    }
)

_MODES = ("raise", "hang", "latency")

# A "hang" must be bounded: the drill simulates a wedge for the watchdog
# to abandon, it must never actually wedge the process running the drill.
MAX_HANG_S = 60.0

ENV_SPEC = "KLBA_FAULTS"
ENV_SEED = "KLBA_FAULTS_SEED"


class FaultError(RuntimeError):
    """The injected failure (``raise`` and post-``hang`` modes)."""


@dataclass
class FaultPlan:
    """One point's schedule: fire on eligible calls ``after`` < n <=
    ``after + times`` (call counting starts at 1; ``times`` <= 0 means
    every call past ``after``), each firing gated by the seeded
    ``probability`` coin.

    Exact-schedule plans (:meth:`FaultInjector.schedule`) instead pin
    firing to specific call numbers (``at_calls``) and/or to driver-
    advanced trace epochs (``at_epochs`` + ``per_epoch``); those fields
    replace the probability coin entirely — a scheduled plan fires
    deterministically or not at all."""

    point: str
    mode: str = "raise"
    times: int = 1
    after: int = 0
    delay_s: float = 0.05
    probability: float = 1.0
    fired: int = 0
    at_calls: Optional[frozenset] = None
    at_epochs: Optional[frozenset] = None
    per_epoch: int = 0
    # epoch-local firing bookkeeping (``per_epoch`` accounting)
    epoch_seen: int = -1
    epoch_fired: int = 0


class FaultInjector:
    """A seeded, thread-safe schedule of named faults.

    Plans are per point; :meth:`fire` consults the active plan under a
    lock (counters stay exact across the service's worker threads) and
    sleeps, if at all, outside it.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._plans: Dict[str, FaultPlan] = {}
        self._calls: Dict[str, int] = {}
        self._epoch = 0
        self._lock = threading.Lock()

    def plan(
        self,
        point: str,
        mode: str = "raise",
        times: int = 1,
        after: int = 0,
        delay_s: float = 0.05,
        probability: float = 1.0,
    ) -> "FaultInjector":
        """Register (replace) the plan for ``point``; chainable."""
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; valid: {sorted(FAULT_POINTS)}"
            )
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r}; valid: {_MODES}")
        if not 0.0 <= probability <= 1.0:
            raise ValueError(f"probability {probability} not in [0, 1]")
        self._plans[point] = FaultPlan(
            point=point,
            mode=mode,
            times=int(times),
            after=int(after),
            delay_s=min(float(delay_s), MAX_HANG_S),
            probability=float(probability),
        )
        return self

    def schedule(
        self,
        point: str,
        mode: str = "raise",
        *,
        at_calls: Optional[Sequence[int]] = None,
        at_epochs: Optional[Sequence[int]] = None,
        per_epoch: int = 1,
        delay_s: float = 0.05,
    ) -> "FaultInjector":
        """Register an EXACT schedule for ``point``; chainable.

        Unlike :meth:`plan` (seeded probability + after/times call
        windows), a scheduled plan fires deterministically: at the
        listed call numbers (``at_calls``, 1-based — the injector's own
        per-point counter), and/or only inside the listed trace epochs
        (``at_epochs`` — the driver advances the clock via
        :meth:`set_epoch`; ``per_epoch`` bounds firings per eligible
        epoch, <= 0 = every eligible call).  With only ``at_epochs``
        given, the first ``per_epoch`` calls of each listed epoch
        fire — the scenario fleet's composer (scenarios/compose.py)
        builds its merged fault overlays exactly this way, and a soak
        can pin a phase boundary without hand-counting warm-up calls."""
        if at_calls is None and at_epochs is None:
            raise ValueError(
                "schedule() needs at_calls and/or at_epochs; use plan() "
                "for probabilistic/windowed firing"
            )
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; valid: {sorted(FAULT_POINTS)}"
            )
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r}; valid: {_MODES}")
        for name, seq in (("at_calls", at_calls), ("at_epochs", at_epochs)):
            if seq is not None and any(int(n) < 0 for n in seq):
                raise ValueError(f"{name} entries must be >= 0: {seq!r}")
        self._plans[point] = FaultPlan(
            point=point,
            mode=mode,
            times=0,  # unlimited: the schedule itself bounds firing
            delay_s=min(float(delay_s), MAX_HANG_S),
            at_calls=(
                None if at_calls is None
                else frozenset(int(n) for n in at_calls)
            ),
            at_epochs=(
                None if at_epochs is None
                else frozenset(int(n) for n in at_epochs)
            ),
            per_epoch=int(per_epoch),
        )
        return self

    def set_epoch(self, epoch: int) -> None:
        """Advance the schedule clock: ``at_epochs`` plans are eligible
        only while the driver-declared epoch is in their set."""
        with self._lock:
            self._epoch = int(epoch)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def calls(self, point: str) -> int:
        """Times ``fire`` was reached for ``point`` (fault or not)."""
        with self._lock:
            return self._calls.get(point, 0)

    def fired(self, point: str) -> int:
        """Faults actually injected at ``point``."""
        with self._lock:
            plan = self._plans.get(point)
            return plan.fired if plan is not None else 0

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Per-point ``{calls, fired}`` counters (drill observability)."""
        with self._lock:
            return {
                point: {
                    "calls": self._calls.get(point, 0),
                    "fired": plan.fired,
                }
                for point, plan in self._plans.items()
            }

    def fire(self, point: str) -> None:
        """Execute the plan for ``point`` against this call (see class
        docstring); no-op for unplanned points."""
        with self._lock:
            n = self._calls.get(point, 0) + 1
            self._calls[point] = n
            plan = self._plans.get(point)
            if plan is None or n <= plan.after:
                return
            if plan.at_epochs is not None:
                if self._epoch not in plan.at_epochs:
                    return
                if plan.per_epoch > 0:
                    if plan.epoch_seen != self._epoch:
                        plan.epoch_seen = self._epoch
                        plan.epoch_fired = 0
                    if plan.epoch_fired >= plan.per_epoch:
                        return
            if plan.at_calls is not None and n not in plan.at_calls:
                return
            if plan.times > 0 and plan.fired >= plan.times:
                return
            if plan.probability < 1.0 and (
                self._rng.random() >= plan.probability
            ):
                return
            plan.fired += 1
            if plan.at_epochs is not None and plan.per_epoch > 0:
                plan.epoch_fired += 1
            mode, delay = plan.mode, plan.delay_s
        # Registry export (utils/metrics): fault activations as a
        # queryable series.  Recorded OUTSIDE the injector lock and only
        # on the fired path — the off path stays the one global load +
        # None compare in :func:`fire` below.
        metrics.REGISTRY.counter(
            "klba_fault_fired_total", {"point": point, "mode": mode}
        ).inc()
        # Sleeps happen OUTSIDE the lock: a hang drill must wedge only
        # the faulted call, not every other fault point in the process.
        if mode == "latency":
            time.sleep(delay)
            return
        if mode == "hang":
            time.sleep(delay)
            raise FaultError(
                f"injected hang at {point!r} ({delay:.3f}s, call {n})"
            )
        raise FaultError(f"injected fault at {point!r} (call {n})")


# The active injector.  ``fire`` below is the production hook: ONE global
# load + None compare when no drill is running.
_ACTIVE: Optional[FaultInjector] = None


def fire(point: str) -> None:
    """The hook compiled into production fault points (zero-cost off)."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(point)


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def activate(injector: FaultInjector) -> FaultInjector:
    global _ACTIVE
    _ACTIVE = injector
    LOGGER.warning(
        "fault injection ACTIVE (seed=%d, plans=%s)",
        injector.seed, sorted(injector._plans),
    )
    return injector


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextmanager
def injected(injector: FaultInjector) -> Iterator[FaultInjector]:
    """Scope an injector to a block (tests, drills)."""
    activate(injector)
    try:
        yield injector
    finally:
        deactivate()


def parse_spec(spec: str, seed: int = 0) -> FaultInjector:
    """Build an injector from the ``KLBA_FAULTS`` grammar (see module
    docstring); raises ValueError on malformed entries."""
    inj = FaultInjector(seed)
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault spec {entry!r} must be "
                "'point:mode[:times[:delay_s[:probability]]]'"
            )
        point, mode = parts[0], parts[1]
        try:
            times = int(parts[2]) if len(parts) > 2 else 1
            delay_s = float(parts[3]) if len(parts) > 3 else 0.05
            probability = float(parts[4]) if len(parts) > 4 else 1.0
        except ValueError:
            raise ValueError(f"fault spec {entry!r} has non-numeric fields")
        inj.plan(
            point, mode=mode, times=times, delay_s=delay_s,
            probability=probability,
        )
    return inj


def install_from_env(
    env: Optional[Mapping[str, str]] = None,
) -> Optional[FaultInjector]:
    """Activate an injector from ``KLBA_FAULTS`` / ``KLBA_FAULTS_SEED``
    (staging drills); returns it, or None when the variable is unset.
    Called once at import so a drill needs no code change."""
    env = os.environ if env is None else env
    spec = env.get(ENV_SPEC)
    if not spec:
        return None
    seed = int(env.get(ENV_SEED, "0"))
    return activate(parse_spec(spec, seed=seed))


def fault_points() -> List[str]:
    return sorted(FAULT_POINTS)


install_from_env()
