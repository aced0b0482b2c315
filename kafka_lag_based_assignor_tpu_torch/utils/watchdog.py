"""Failure detection for accelerator calls: per-solver circuit breakers.

A copy of ``kafka_lag_based_assignor_tpu/utils/watchdog.py``.  The
reference's failure model is exception propagation (broker RPCs abort the
rebalance) — but a device can also *hang* (a wedged driver, a kernel that
never finishes, a first-use build that outlasts the deadline).  A
consumer-group rebalance must never block on the device past its
rebalance timeout, so device solves run under a watchdog: the call
executes in a daemon worker thread named ``klba-solve`` and, on timeout,
the caller falls back to the host path while the stuck call is abandoned
(threads blocked in a driver call cannot be force-killed from Python;
abandoning is the correct containment — the daemon thread dies with the
process and later calls go straight to the fallback).

PyTorch keeps the current CUDA device and stream per thread: a worker
starts on device 0 and its default stream, whatever the caller set.  The
watchdog is device-agnostic, so the callable must carry the caller's
device and stream itself (:func:`..utils.device.carry_cuda_context`, which
the plugin's solve enters on the worker).

Failure domains are tracked PER KEY (one circuit breaker per solver /
subsystem), because a wedged Sinkhorn solve says nothing about the rounds
kernel's health: one slow solver must not banish every solver for the full
cooldown.  Each breaker is a standard three-state circuit:

* **closed** — calls run under the deadline.  A timeout trips the breaker
  immediately; ``failure_threshold`` CONSECUTIVE exceptions trip it too (a
  repeatedly-raising device is as dead as a hanging one).
* **open** — calls fail fast with :class:`SolveRejected` (host fallback)
  for ``cooldown_s``; no fresh worker threads pile up behind the wedge.
* **half-open** — after the cooldown, exactly ONE caller is admitted as
  the probe; concurrent callers keep failing fast until the probe
  resolves.  Probe success closes the breaker; probe failure re-opens it
  for a fresh cooldown.

``clock`` is injectable so cooldown/half-open transitions are unit
testable without real sleeps.  Worker threads capture ``BaseException``
but re-raise only ``Exception`` through the normal path: a true
``BaseException`` (e.g. ``KeyboardInterrupt`` delivered on the worker) is
logged critically and re-raised deliberately on the caller side, so
``except Exception`` boundaries let it propagate instead of swallowing a
shutdown signal.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional, TypeVar

from . import metrics
from . import trace as trace_mod
from .observability import note_breaker_trip

LOGGER = logging.getLogger(__name__)

# Registry series (utils/metrics): completed-call latency per breaker
# key, plus timeout / fail-fast-rejection counters — the queryable
# aggregate behind every Watchdog instance.
_SOLVE_MS = "klba_solve_duration_ms"
_TIMEOUTS = "klba_solve_timeouts_total"
_REJECTED = "klba_solve_rejected_total"

T = TypeVar("T")

_UNSET = object()

# Worker-thread deadline note: Watchdog.call stamps each worker with
# (clock, abandon_at) before running the callable, so code the worker
# parks in (the megabatch coalescer's future wait) can hand downstream
# threads an answer to "has my caller already abandoned me?".
_worker_tls = threading.local()


def capture_abandon_check() -> Optional[Callable[[], bool]]:
    """Capture the calling watchdog worker's deadline as a zero-arg
    predicate: True once the caller's deadline has passed (the caller
    has certainly timed out and abandoned this thread — its result
    would be discarded).  None when the calling thread is not a watched
    worker (no deadline, nothing to abandon).  The token is safe to
    evaluate from any thread: the coalescer's flusher uses it to DROP a
    parked submission whose submitter is already gone (see
    ops/coalesce)."""
    note = getattr(_worker_tls, "deadline", None)
    if note is None:
        return None
    clock, abandon_at = note
    return lambda: clock() > abandon_at

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"


class SolveTimeout(Exception):
    """Raised when a watched call exceeds its deadline, its breaker is
    open, or its deadline budget is already exhausted."""


class SolveRejected(SolveTimeout):
    """Fail-fast subtype: the call was rejected WITHOUT running (breaker
    open, probe already in flight, or budget exhausted) — the device was
    never touched, so callers holding warm state tied to the callable
    (the streaming engines) know that state is still intact."""


class _Breaker:
    """One failure domain's state (guarded by the owning Watchdog's lock)."""

    __slots__ = (
        "state", "tripped_at", "consecutive_failures", "trips",
        "probe_in_flight",
    )

    def __init__(self):
        self.state = STATE_CLOSED
        self.tripped_at: Optional[float] = None
        self.consecutive_failures = 0
        self.trips = 0
        self.probe_in_flight = False


class Watchdog:
    """Runs callables with a deadline on abandonable daemon threads,
    with one circuit breaker per ``key`` (see module docstring).

    Deliberately NOT a ThreadPoolExecutor: the executor's atexit hook JOINS
    its workers, so a process that abandoned a hung solve would block at
    shutdown for the full hang.  A bare daemon thread dies with the process.
    """

    def __init__(
        self,
        timeout_s: Optional[float],
        cooldown_s: float = 300.0,
        failure_threshold: int = 3,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.timeout_s = timeout_s
        self.cooldown_s = cooldown_s
        self.failure_threshold = int(failure_threshold)
        self._clock = clock
        self._breakers: Dict[str, _Breaker] = {}
        self._lock = threading.Lock()

    # -- state inspection --------------------------------------------------

    def _breaker(self, key: str) -> _Breaker:
        """Caller must hold ``self._lock``."""
        br = self._breakers.get(key)
        if br is None:
            br = self._breakers[key] = _Breaker()
        return br

    def _effective_state(self, br: _Breaker) -> str:
        """THE cooldown-expiry rule, in one place (caller holds the
        lock): an OPEN breaker whose cooldown has elapsed reports
        half-open — the next call will be the probe."""
        if br.state == STATE_OPEN and (
            br.tripped_at is None
            or self._clock() - br.tripped_at >= self.cooldown_s
        ):
            return STATE_HALF_OPEN
        return br.state

    @property
    def tripped(self) -> bool:
        """True while ANY breaker is open within its cooldown."""
        with self._lock:
            return any(
                self._effective_state(br) == STATE_OPEN
                for br in self._breakers.values()
            )

    def state(self, key: str = "device") -> str:
        """The breaker's current state name (cooldown expiry applied)."""
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                return STATE_CLOSED
            return self._effective_state(br)

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-key breaker snapshot for the service ``stats`` surface."""
        with self._lock:
            return {
                key: {
                    "state": self._effective_state(br),
                    "trips": br.trips,
                    "consecutive_failures": br.consecutive_failures,
                }
                for key, br in self._breakers.items()
            }

    def reset(self) -> None:
        """Close every breaker immediately (operator action)."""
        with self._lock:
            for br in self._breakers.values():
                br.state = STATE_CLOSED
                br.tripped_at = None
                br.consecutive_failures = 0
                br.probe_in_flight = False

    # -- lifecycle snapshot (utils/snapshot; DEPLOYMENT.md "Restarts") -----

    def export_state(self) -> Dict[str, Dict[str, Any]]:
        """Host-durable view of every breaker for the lifecycle
        snapshot.  ``tripped_at`` is a monotonic instant that dies with
        the process, so an open breaker exports its REMAINING cooldown
        instead — the restored breaker resumes the remainder, not a
        fresh full cooldown (a restart must not extend a sidelining)
        and not an instant close (a restart must not reset a wedged
        device's quarantine)."""
        with self._lock:
            now = self._clock()
            out: Dict[str, Dict[str, Any]] = {}
            for key, br in self._breakers.items():
                remaining = 0.0
                if br.state == STATE_OPEN and br.tripped_at is not None:
                    remaining = max(
                        0.0, self.cooldown_s - (now - br.tripped_at)
                    )
                out[key] = {
                    "state": self._effective_state(br),
                    "cooldown_remaining_s": remaining,
                    "consecutive_failures": br.consecutive_failures,
                    "trips": br.trips,
                }
            return out

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Adopt exported breaker state after a restart: an open
        breaker resumes the remainder of its cooldown (clamped to this
        process's configured cooldown), failure/trip counters carry
        over, and the half-open probe slot is always reset (a probe
        never survives a process).  Malformed entries are discarded
        per key — a corrupt breaker record must not cost the others."""
        with self._lock:
            now = self._clock()
            for key, info in dict(state or {}).items():
                try:
                    br = self._breaker(str(key))
                    br.consecutive_failures = int(
                        info.get("consecutive_failures", 0)
                    )
                    br.trips = int(info.get("trips", 0))
                    remaining = min(
                        max(float(info.get("cooldown_remaining_s", 0.0)),
                            0.0),
                        self.cooldown_s,
                    )
                    if info.get("state") == STATE_OPEN and remaining > 0:
                        br.state = STATE_OPEN
                        br.tripped_at = now - (self.cooldown_s - remaining)
                    else:
                        br.state = STATE_CLOSED
                        br.tripped_at = None
                    br.probe_in_flight = False
                except (TypeError, ValueError, AttributeError):
                    LOGGER.warning(
                        "discarding malformed breaker snapshot for %r",
                        key, exc_info=True,
                    )

    # -- transitions (hold the lock) --------------------------------------

    def _trip(self, br: _Breaker) -> bool:
        """Returns True when this call opened the breaker.  The caller
        fires :func:`note_breaker_trip` AFTER releasing the lock — the
        trip hook dumps the flight recorder (JSON build, optional file
        write), and holding the process-wide breaker lock through that
        would stall every other thread's fail-fast admission exactly
        during an incident."""
        if br.state == STATE_OPEN:
            # A straggler admitted before the trip fails after it: one
            # incident, one trip — don't inflate the counter or refresh
            # tripped_at (that would silently extend the cooldown).
            return False
        br.state = STATE_OPEN
        br.tripped_at = self._clock()
        br.trips += 1
        br.probe_in_flight = False
        return True

    def _admit(self, key: str) -> bool:
        """Admission control; returns True when this call is the half-open
        probe.  Raises SolveTimeout to fail fast (open breaker, or probe
        already in flight)."""
        with self._lock:
            br = self._breaker(key)
            if br.state == STATE_OPEN:
                if (
                    br.tripped_at is not None
                    and self._clock() - br.tripped_at < self.cooldown_s
                ):
                    raise SolveRejected(
                        f"breaker {key!r} open; failing fast for up to "
                        f"{self.cooldown_s}s (or until reset())"
                    )
                br.state = STATE_HALF_OPEN
                br.probe_in_flight = False
            if br.state == STATE_HALF_OPEN:
                if br.probe_in_flight:
                    # THE thundering-herd fix: one probe, everyone else
                    # fails fast to the host path.
                    raise SolveRejected(
                        f"breaker {key!r} half-open; probe already in flight"
                    )
                br.probe_in_flight = True
                return True
            return False

    def _on_success(self, key: str) -> None:
        with self._lock:
            br = self._breaker(key)
            br.state = STATE_CLOSED
            br.tripped_at = None
            br.consecutive_failures = 0
            br.probe_in_flight = False

    def _on_timeout(self, key: str, probing: bool, truncated: bool) -> None:
        with self._lock:
            br = self._breaker(key)
            br.consecutive_failures += 1
            if truncated and not probing:
                # The deadline was a request's RESIDUAL budget, shorter
                # than the configured timeout: the device was never given
                # its fair window, so missing it is the request's fault —
                # recorded as a failure, but not a trip that would
                # sideline the device for every other request.  (A
                # half-open probe still re-opens: it ran and was
                # abandoned, recovered or not.)
                return
            tripped = self._trip(br)
        if tripped:
            note_breaker_trip(key)

    def _on_exception(self, key: str, probing: bool) -> None:
        tripped = False
        with self._lock:
            br = self._breaker(key)
            br.consecutive_failures += 1
            if probing:
                # A failed probe re-opens immediately — the device did not
                # recover; don't let waiters rediscover that one by one.
                tripped = self._trip(br)
            elif br.consecutive_failures >= self.failure_threshold:
                LOGGER.warning(
                    "breaker %r tripped after %d consecutive exceptions",
                    key, br.consecutive_failures,
                )
                tripped = self._trip(br)
        if tripped:
            note_breaker_trip(key)

    def trip_breaker(self, key: str) -> None:
        """External failure-domain evidence against ``key``'s breaker:
        open it NOW for a full cooldown (half-open probe recovery
        applies as usual).  Used by the resident-state scrubber
        (utils/scrub): repeated quarantines on one stream mean the
        device is corrupting state faster than the heal path restores
        it — as dead as a device that keeps raising.  A direct trip,
        deliberately NOT a consecutive-failure increment: every
        corrupt/heal cycle contains a successful healing epoch that
        would reset that counter, so threshold counting could never
        sideline exactly the repeating pattern escalation exists
        for."""
        with self._lock:
            tripped = self._trip(self._breaker(key))
        if tripped:
            note_breaker_trip(key)

    # -- the watched call --------------------------------------------------

    def call(
        self,
        fn: Callable[..., T],
        *args: Any,
        key: str = "device",
        timeout_s: Any = _UNSET,
        budget_total_s: Optional[float] = None,
        **kwargs: Any,
    ) -> T:
        """Run ``fn`` under the deadline with ``key``'s breaker.

        ``timeout_s`` overrides the configured deadline for THIS call
        (the service's per-request deadline budget shrinks it down the
        degraded-mode ladder); a non-positive override fails fast WITHOUT
        charging the breaker — an exhausted budget is the request's
        fault, not the device's.  With an effective deadline of None the
        call runs inline (watchdog disabled).

        ``budget_total_s`` is the request's INITIAL deadline budget when
        it is smaller than the configured timeout (a per-class SLO
        budget, utils/overload): the timeout-truncation test then
        compares against the request's own full window, so a first-rung
        hang under a 2 s class budget still charges the breaker instead
        of reading as a residual-ladder truncation forever.
        """
        effective = self.timeout_s if timeout_s is _UNSET else timeout_s
        if effective is None:
            return fn(*args, **kwargs)
        if effective <= 0:
            metrics.REGISTRY.counter(_REJECTED, {"key": key}).inc()
            raise SolveRejected(
                f"deadline budget exhausted before calling {key!r}"
            )
        try:
            probing = self._admit(key)
        except SolveRejected:
            metrics.REGISTRY.counter(_REJECTED, {"key": key}).inc()
            raise
        started = self._clock()
        settled = False  # an _on_* transition (or explicit release) ran
        try:
            outcome: Dict[str, Any] = {}
            done = threading.Event()
            # The caller's request scope, carried onto the worker so
            # solve-side telemetry (flight records, guardrail dump
            # triggers) keeps the request id and the one-dump-per-
            # request budget (utils/metrics.adopt_scope).
            scope = metrics.capture_scope()

            def run() -> None:
                # Deadline note for capture_abandon_check(): downstream
                # code this worker parks in can learn when the caller
                # will have abandoned it.
                _worker_tls.deadline = (self._clock, started + effective)
                try:
                    with metrics.adopt_scope(scope):
                        outcome["value"] = fn(*args, **kwargs)
                except BaseException as exc:  # noqa: BLE001 — re-raised below
                    outcome["exc"] = exc
                finally:
                    _worker_tls.deadline = None
                    done.set()

            worker = threading.Thread(
                target=run, name="klba-solve", daemon=True
            )
            worker.start()
            if not done.wait(effective):
                metrics.REGISTRY.counter(_TIMEOUTS, {"key": key}).inc()
                # An abandoned solve is an always-keep trace anomaly:
                # the caller's thread still owns the request scope
                # here (the worker only ADOPTED it).
                trace_mod.mark("timeout")
                # "Truncated" = the ladder handed the device a residual
                # budget well below the request's full window — the
                # configured timeout, or the caller's (smaller) initial
                # deadline budget when a per-class SLO budget capped it.
                # The 0.9 factor absorbs the request-validation time
                # between budget creation and rung 1 (microseconds-to-
                # ms), so a first-rung hang still trips at ~the full
                # deadline.
                window = self.timeout_s
                if budget_total_s is not None and (
                    window is None or budget_total_s < window
                ):
                    window = budget_total_s
                truncated = (
                    window is not None and effective < window * 0.9
                )
                self._on_timeout(key, probing, truncated)
                settled = True
                LOGGER.warning(
                    "%r call exceeded %.1fs (%s); abandoning it",
                    key, effective,
                    "residual budget — breaker not tripped" if truncated
                    else f"breaker open for {self.cooldown_s:.0f}s",
                )
                raise SolveTimeout(f"{key!r} call exceeded {effective}s")
            exc = outcome.get("exc")
            if not isinstance(exc, SolveRejected):
                # A shed parked for its whole class budget before the
                # rejection surfaced — observing it here would turn the
                # solver-latency p99 into park-until-shed time under
                # sustained overload, so only genuine solve attempts
                # feed the series.
                metrics.REGISTRY.histogram(_SOLVE_MS, {"key": key}).observe(
                    (self._clock() - started) * 1000.0
                )
            if exc is None:
                self._on_success(key)
                settled = True
                return outcome["value"]
            if isinstance(exc, SolveRejected):
                # A nested fail-fast rejection surfaced THROUGH the
                # worker (e.g. the coalescer shedding a parked epoch
                # whose SLO deadline expired — ops/coalesce
                # DeadlineShed): the device was never touched, so the
                # breaker must not be charged — an overload shed is the
                # request's fate, not the solver's failure.  The
                # half-open probe slot (if any) is released by the
                # not-settled finally below.
                raise exc
            if isinstance(exc, Exception):
                self._on_exception(key, probing)
                settled = True
                raise exc
            # True BaseException (KeyboardInterrupt, SystemExit) captured
            # on the worker: re-raise it DELIBERATELY on the caller thread
            # so it propagates past `except Exception` boundaries instead
            # of dying silently with the worker — but never count it
            # against the device's breaker.
            LOGGER.critical(
                "%r worker raised %s; propagating on the caller thread",
                key, type(exc).__name__,
            )
            raise exc
        finally:
            if probing and not settled:
                # The probe aborted before any state transition (e.g.
                # worker.start() failed under thread exhaustion, or a
                # BaseException) — release the half-open slot so the
                # breaker cannot wedge in 'probe already in flight'
                # fail-fast forever.
                with self._lock:
                    self._breaker(key).probe_in_flight = False
