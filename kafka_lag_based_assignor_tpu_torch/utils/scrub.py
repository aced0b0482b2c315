"""Resident-state integrity: the digest's host truths, quarantine, the
host-truth audit and the background scrubber.

A copy of ``kafka_lag_based_assignor_tpu/utils/scrub.py``: ``DIGEST_LEN``,
``CorruptStateDetected``, ``digest_failures``, ``flip_bit``,
``CORRUPT_POINTS``, ``corruption_plan``, ``record_quarantine``, the strike
constants ``ESCALATE_AFTER`` / ``FORGIVE_AFTER`` (which the sidecar's strike
accounting reads), :func:`audit_engine` and :class:`StateScrubber`.  Every
refine dispatch of the streaming engine computes a digest of the resident
state it starts from (``ops/refine.state_digest``, the K6 kernel on the
card):

====  ======================  =========================================
slot  value                   host truth it must match
====  ======================  =========================================
0     ``counts.sum()``        P — every partition owned exactly once
1     range violations        0 — no choice entry outside [-1, C)
2     ``lags.sum()``          the host lag sum (int64, wrapping)
3     |bincount(choice) -     0 — the choice vector and the counts
      counts| L1 distance     buffer tell the same story
4     row-table checksum      0 — the [C, M] table mirrors the choice
====  ======================  =========================================

A mismatch quarantines the engine (the resident state is dropped, the host
previous choice kept) and raises :class:`CorruptStateDetected`; the next
dispatch rebuilds the resident state from the host.  Every quarantine, heal
and delta resync is counted by :func:`record_quarantine`; a drill corrupts
a resident tensor through the ``device.corrupt.*`` fault points
(:func:`corruption_plan`).

**Background scrubber**: :class:`StateScrubber` round-robins idle streams
on the sidecar's ``scrub_interval_ms`` cadence, off the serving path: each
pass is deadline-budgeted, skipped while the overload ladder is at rung
>= 2, and audits a stream's whole resident state against its host mirror
(:func:`audit_engine`): the resident choice against the engine's previous
choice, the counts against its bincount, the resident lags against the host
lag mirror and the row table's segments against the choice.  A failed
audit quarantines the stream; the sidecar counts the strike.

Telemetry (the JAX package's series): ``klba_scrub_passes_total``,
``klba_scrub_streams_audited_total``, ``klba_scrub_failures_total{buffer}``
(counted by the sidecar's auditor), ``klba_scrub_skipped_total{reason}``,
``klba_scrub_duration_ms``, ``klba_scrub_last_pass_age_s`` and ``scrub``
flight records.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import faults, metrics
from . import trace as trace_mod
from .device import fetch
from .watchdog import SolveRejected

LOGGER = logging.getLogger(__name__)

#: The digest's base length; a digest that also audits the row table has a
#: fifth lane (host truth 0), and :func:`digest_failures` accepts both.
DIGEST_LEN = 4

#: The chaos fault point of each resident buffer class.
CORRUPT_POINTS = {
    "choice": "device.corrupt.choice",
    "counts": "device.corrupt.counts",
    "lags": "device.corrupt.lags",
    "row_tab": "device.corrupt.row_tab",
}

#: Quarantine outcomes (the ``klba_quarantine_total`` label values).
QUARANTINE_OUTCOMES = ("quarantined", "healed", "resynced", "escalated")

#: Quarantine strikes on ONE stream before each further failure is also
#: charged to the stream breaker (utils/watchdog.trip_breaker): a single
#: flipped bit heals silently, a device that keeps corrupting state is as
#: dead as one that keeps raising.
ESCALATE_AFTER = 2

#: Consecutive CLEAN served epochs that forgive a stream's strikes: more
#: than one, since a corrupt -> heal -> corrupt flip-flop serves a clean
#: healing epoch between every detection and must still escalate.
FORGIVE_AFTER = 3


class CorruptStateDetected(SolveRejected):
    """A resident-state integrity check failed, so the answer must NOT be
    served.  By the time this raises the engine has already quarantined
    itself (resident dropped, host previous choice intact), and the next
    epoch rebuilds the device state from host truth.  ``buffers`` names
    the buffer classes that failed (``choice`` / ``counts`` / ``lags`` /
    ``row_tab``)."""

    def __init__(self, message: str, buffers: Sequence[str]):
        super().__init__(message)
        self.buffers = list(buffers)


def digest_failures(
    digest: Any, expected_p: int, expected_lag_sum: Optional[int]
) -> List[str]:
    """Compare a dispatch's device digest against host truth; returns the
    failed buffer classes (empty = clean).  ``expected_lag_sum`` None skips
    the lag-checksum slot."""
    d = np.asarray(digest)
    fails: List[str] = []
    if int(d[0]) != int(expected_p):
        fails.append("counts")
    if int(d[1]) != 0 or int(d[3]) != 0:
        fails.append("choice")
    if expected_lag_sum is not None and int(d[2]) != int(expected_lag_sum):
        fails.append("lags")
    if d.shape[0] > DIGEST_LEN and int(d[DIGEST_LEN]) != 0:
        fails.append("row_tab")
    return fails


def flip_bit(arr: np.ndarray, seed: int, limit: Optional[int] = None):
    """One seeded single-bit flip in ``arr`` (a host copy is returned; the
    caller re-uploads it).  ``limit`` bounds the flipped index to the real
    (un-padded) prefix."""
    rng = np.random.default_rng(seed)
    out = np.array(arr, copy=True)
    flat = out.reshape(-1)
    hi = flat.size if limit is None else min(int(limit), flat.size)
    i = int(rng.integers(max(hi, 1)))
    bit = int(rng.integers(8 * out.dtype.itemsize - 1))
    flat[i] = np.bitwise_xor(
        flat[i], out.dtype.type(np.int64(1) << bit)
    )
    return out


def record_quarantine(
    buffers: Sequence[str],
    outcome: str,
    stream_id: Optional[str] = None,
    source: Optional[str] = None,
) -> None:
    """Account one quarantine-plane event with ONE schema whichever check
    detected it: ``klba_quarantine_total{buffer,outcome}`` plus a
    ``quarantine`` flight record and a ``quarantine`` anomaly mark on the
    active trace (quarantines are always-keep for the tail sampler).  Runs
    only on failure/heal paths."""
    trace_mod.mark("quarantine")
    for buffer in buffers:
        metrics.REGISTRY.counter(
            "klba_quarantine_total",
            {"buffer": buffer, "outcome": outcome},
        ).inc()
    metrics.FLIGHT.record(
        "quarantine",
        {
            "buffers": list(buffers),
            "outcome": outcome,
            "stream_id": stream_id,
            "source": source,
        },
    )


def corruption_plan(limit: Optional[int] = None) -> List[Tuple[str, int]]:
    """Consult the ``device.corrupt.*`` fault points; returns ``[(buffer,
    seed), ...]`` for each point whose plan fires at this call site (empty
    when no injector is active — the steady state pays one global load).
    The seed is derived from the injector's own seed and the point's call
    count, so the same drill schedule replays the same flips, as in the JAX
    package.  ``limit`` is folded in so two sites with different bounds
    still diverge deterministically."""
    inj = faults.active()
    if inj is None:
        return []
    plan: List[Tuple[str, int]] = []
    for buffer, point in CORRUPT_POINTS.items():
        try:
            faults.fire(point)
        except faults.FaultError:
            seed = (
                inj.seed * 1_000_003
                + inj.calls(point) * 97
                + (int(limit) if limit else 0)
            )
            plan.append((buffer, seed))
    return plan


# -- the host-truth audit ---------------------------------------------------


def audit_engine(engine) -> Tuple[bool, List[str]]:
    """Audit one streaming engine's whole resident state against its host
    mirror; returns ``(audited, failed_buffers)``.

    ``audited`` False means there was nothing to check (cold engine, stale
    resident, host state mid-repair), not a pass.  The caller holds the
    lock that serializes the engine against its epochs (the sidecar audits
    under the stream lock, idle streams only) and, on the card, has entered
    the engine's CUDA device and stream.  The resident tuple is the
    engine's ``(choice int32[B], row_tab int32[C, M], counts int32[C], lags
    int64[B])``, the order of the JAX engine's buffers, a state placed over
    the mesh (:class:`..sharded.resident.PlacedResident`), or a locked
    roster's handle into the coalescer's batch."""
    prev = getattr(engine, "_prev_choice", None)
    resident = getattr(engine, "_resident", None)
    if prev is None or resident is None:
        return False, []
    C = int(engine.num_consumers)
    P = int(prev.shape[0])
    if P == 0 or int(prev.min()) < 0 or int(prev.max()) >= C:
        # Host state mid-repair (orphans): nothing trustworthy to diff.
        return False, []
    # A locked roster's handle materializes its row (one gather a buffer;
    # the fault point ``coalesce.gather`` fires there); a state placed over
    # the mesh gathers its row shards.
    materialize = getattr(resident, "materialize", None)
    gather = getattr(resident, "gather", None)
    bufs = (materialize() if materialize is not None
            else gather() if gather is not None else resident)
    choice_d, row_tab, counts_d, lags_d = fetch(*bufs[:4])
    fails: List[str] = []
    if choice_d.shape[0] < P or not np.array_equal(choice_d[:P], prev):
        fails.append("choice")
    expected_counts = np.bincount(prev, minlength=C).astype(counts_d.dtype)
    if not np.array_equal(counts_d, expected_counts):
        fails.append("counts")
    mirror = getattr(engine, "_lag_mirror", None)
    if mirror is not None and (
        lags_d.shape[0] < P
        or not np.array_equal(lags_d[:P], mirror.astype(lags_d.dtype))
    ):
        fails.append("lags")
    # Row table: every consumer's occupied slots must name rows the host
    # choice assigns to that consumer (the warm refine's totals gather
    # through it, so a corrupt segment mis-weights the quality loop).
    M = row_tab.shape[1]
    slot_ok = np.arange(M)[None, :] < expected_counts[:, None]
    rows = row_tab[slot_ok]
    owners = np.repeat(np.arange(C), expected_counts.clip(max=M))
    if (
        rows.size != owners.size
        or np.any(rows < 0)
        or np.any(rows >= P)
        or not np.array_equal(prev[rows], owners)
    ):
        fails.append("row_tab")
    return True, fails


# -- the background scrubber ------------------------------------------------


class StateScrubber:
    """Round-robin background auditor (module docstring).

    ``targets`` returns the current audit jobs as ``(stream_id, auditor)``
    pairs; each ``auditor()`` performs ONE audit attempt and returns
    ``"audited"`` | ``"busy"`` (lock contended) | ``"skipped"`` (nothing
    to audit): the auditor owns locking, the device context and the
    quarantine, so this class stays free of engine imports.  ``suppress``
    True skips the whole pass (the sidecar wires the overload ladder's rung
    >= 2 here).  Each pass walks at most one full rotation and stops early
    when ``budget_s`` is spent."""

    def __init__(
        self,
        targets: Callable[[], List[Tuple[str, Callable[[], str]]]],
        interval_s: float,
        budget_s: float = 0.25,
        suppress: Optional[Callable[[], bool]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0")
        if budget_s <= 0:
            raise ValueError(f"budget_s={budget_s} must be > 0")
        self._targets = targets
        self.interval_s = float(interval_s)
        self.budget_s = float(budget_s)
        self._suppress = suppress or (lambda: False)
        self._clock = clock or metrics.REGISTRY.clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cursor = 0
        self.last_pass_at: Optional[float] = None
        # The last instant the scrubber made PROGRESS (audited a stream,
        # or had nothing to audit); ``stalled`` flips once that is older
        # than three intervals.
        self._started_at = self._clock()
        self.last_progress_at = self._started_at
        self.stall_after_s = 3.0 * float(interval_s)
        self._m_last_age = metrics.REGISTRY.gauge("klba_scrub_last_pass_age_s")
        self._m_passes = metrics.REGISTRY.counter("klba_scrub_passes_total")
        self._m_audited = metrics.REGISTRY.counter(
            "klba_scrub_streams_audited_total"
        )
        # Construction baselines: the series are process-wide, so stats()
        # reports this instance's deltas.
        self._base_passes = self._m_passes.value
        self._base_audited = self._m_audited.value
        self._m_skipped = {
            r: metrics.REGISTRY.counter("klba_scrub_skipped_total", {"reason": r})
            for r in ("overload", "busy", "error")
        }
        self._m_duration = metrics.REGISTRY.histogram("klba_scrub_duration_ms")

    def start(self) -> "StateScrubber":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="klba-scrub", daemon=True
            )
            self._thread.start()
        return self

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop the cadence and wait (up to ``timeout_s``) for a pass in
        progress to end, so that a closed scrubber moves no series."""
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout_s)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrub_once()
            except Exception:  # noqa: BLE001 — the auditor must survive
                LOGGER.warning("scrub pass crashed", exc_info=True)
                self._m_skipped["error"].inc()

    def scrub_once(self) -> Dict[str, int]:
        """One deadline-budgeted pass (also the drill and test entry);
        returns ``{audited, busy, suppressed}``.  Runs as a self-rooted
        ``background`` trace (root ``scrub.pass``) linked to every stream it
        audits."""
        if self._suppress():
            self._m_skipped["overload"].inc()
            return {"audited": 0, "busy": 0, "suppressed": 1}
        with metrics.request_scope(kind="background", root_name="scrub.pass"):
            return self._scrub_pass()

    def _scrub_pass(self) -> Dict[str, int]:
        started = self._clock()
        deadline = started + self.budget_s
        jobs = self._targets()
        audited = busy = attempted = 0
        n = len(jobs)
        for k in range(n):
            if self._clock() >= deadline:
                break
            sid, auditor = jobs[(self._cursor + k) % n]
            attempted += 1
            try:
                outcome = auditor()
            except Exception:  # noqa: BLE001 — one bad audit, not the pass
                LOGGER.warning("scrub audit of stream %r failed", sid,
                               exc_info=True)
                self._m_skipped["error"].inc()
                continue
            if outcome == "audited":
                audited += 1
                self._m_audited.inc()
                tr = metrics.current_trace()
                if tr is not None:
                    tr.link_stream(sid)
            elif outcome == "busy":
                busy += 1
                self._m_skipped["busy"].inc()
        if n:
            # Round-robin: the next pass resumes where the budget cut this
            # one off.
            self._cursor = (self._cursor + attempted) % n
        self.last_pass_at = self._clock()
        if audited > 0 or n == 0:
            self.last_progress_at = self.last_pass_at
        self._m_passes.inc()
        self._m_duration.observe((self.last_pass_at - started) * 1000.0)
        metrics.FLIGHT.record(
            "scrub", {"targets": n, "audited": audited, "busy": busy}
        )
        return {"audited": audited, "busy": busy, "suppressed": 0}

    def stats(self) -> Dict[str, Any]:
        """The wire ``stats.scrub`` view; reading it refreshes the
        ``klba_scrub_last_pass_age_s`` gauge.  ``stalled``: no audit
        progress for more than three intervals."""
        now = self._clock()
        last = self.last_pass_at
        age = now - (last if last is not None else self._started_at)
        self._m_last_age.set(age)
        return {
            "interval_ms": self.interval_s * 1000.0,
            "last_pass_age_s": age,
            "stalled": now - self.last_progress_at > self.stall_after_s,
            "passes": self._m_passes.value - self._base_passes,
            "streams_audited": self._m_audited.value - self._base_audited,
        }
