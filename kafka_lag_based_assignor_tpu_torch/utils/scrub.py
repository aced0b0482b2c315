"""Resident-state integrity: the digest's host truths and quarantine.

A copy of ``DIGEST_LEN``, ``CorruptStateDetected``, ``digest_failures``,
``flip_bit``, ``CORRUPT_POINTS``, ``corruption_plan``, ``record_quarantine``
and the strike constants ``ESCALATE_AFTER`` / ``FORGIVE_AFTER`` (which the
sidecar's strike accounting reads) from ``kafka_lag_based_assignor_tpu/utils/scrub.py``.  Every
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
(:func:`corruption_plan`).  The background scrubber (``StateScrubber``)
comes with the port's lifecycle slice.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from . import faults, metrics
from . import trace as trace_mod
from .watchdog import SolveRejected

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
