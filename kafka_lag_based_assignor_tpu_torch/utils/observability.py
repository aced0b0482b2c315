"""Structured observability for rebalances.

Counterpart of ``kafka_lag_based_assignor_tpu/utils/observability.py``.
The reference's observability is slf4j logging: debug config summary
(LagBasedPartitionAssignor.java:122-128), trace per-assignment decisions
(:268-275), debug per-topic totals (:280-306), warn on missing metadata
(:359).  Here the per-rebalance record is structured — per-consumer totals,
the max/mean lag-imbalance ratio (the north-star metric), count spread, and
wall/solve timings — and emitted both as a log line and as a returned
value so callers can consume it programmatically.

The build and drift counters, the breaker-trip counters, the per-topic
summaries, the decision replay and its trace lines are the JAX package's,
with the same series names.  Two differ in what they observe:

* :func:`install_compile_counter` / :func:`compile_count` count the port's
  kernel BUILDS — each fresh ``nvcc`` build of a ``csrc/*.cu``
  (:mod:`..ops._build`) and ``g++`` build of the native core
  (:mod:`..native`) — where the JAX package counts XLA compiles;
* :func:`profile_trace` runs a block under ``torch.profiler`` (CPU and,
  with a card, CUDA activities) and writes a Chrome trace into
  ``log_dir``, where the JAX package runs ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import tempfile
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from . import metrics
from . import trace as trace_mod

LOGGER = logging.getLogger("kafka_lag_based_assignor_tpu_torch")

# slf4j has a TRACE level below DEBUG (the reference logs every
# partition->consumer decision at trace, LagBasedPartitionAssignor.java:268-275);
# Python's logging does not, so register one (the same level number as the
# JAX package's).
TRACE = 5
logging.addLevelName(TRACE, "TRACE")


# --- Build observability -------------------------------------------------
#
# A fresh kernel build on the rebalance path is this system's silent
# performance cliff: ``nvcc`` takes seconds for most of the port's
# sources and about 40 s for ``rounds_scan.cu`` and ``scan_greedy.cu``.
# Two counters make it observable and assertable, under the JAX
# package's series names:
#
# * ``compile_count()`` — fresh kernel builds seen process-wide since
#   ``install_compile_counter()``.  A library already built (on disk or
#   loaded) is no build, so a steady-state loop can assert a ZERO delta.
# * ``static_drift_count()`` — value-derived kernel choices observed
#   changing per call signature (ops/dispatch.observe_pack_shift): the
#   round-scan kernel's key form moving with the input's value range.

_compile_counter_installed = [False]
_COMPILES = metrics.REGISTRY.counter("klba_compile_total")
_STATIC_DRIFT = metrics.REGISTRY.counter("klba_static_drift_total")


def install_compile_counter() -> None:
    """Idempotently start counting kernel builds into
    :func:`compile_count`.  Call once at process setup BEFORE the kernels
    of interest are built; builds that happen earlier are not counted."""
    _compile_counter_installed[0] = True


def note_kernel_build() -> None:
    """Record one fresh kernel build (called by ops/_build and native
    after a build succeeds, outside their build locks); a no-op until
    :func:`install_compile_counter`."""
    if _compile_counter_installed[0]:
        _COMPILES.inc()


def compile_count() -> int:
    """Fresh kernel builds observed since :func:`install_compile_counter`
    (0 if never installed).  Snapshot it around a steady-state loop and
    assert the delta is zero."""
    return _COMPILES.value


def note_static_drift() -> None:
    """Record one observed drift of a value-derived kernel choice (called
    by ops/dispatch.observe_pack_shift when a call signature's choice
    changes)."""
    _STATIC_DRIFT.inc()


def static_drift_count() -> int:
    return _STATIC_DRIFT.value


# --- Breaker observability -----------------------------------------------
#
# Process-wide trip counters per circuit-breaker key (utils/watchdog),
# backed by the registry's ``klba_breaker_trips_total{key=...}`` series.
# A trip is also a flight-recorder trigger (utils/metrics.FLIGHT): the
# incident's ring of recent records is dumped exactly once.

_TRIPS_NAME = "klba_breaker_trips_total"


def note_breaker_trip(key: str) -> None:
    """Record one breaker trip (called by utils/watchdog on every
    closed/half-open -> open transition).  Also an always-keep anomaly
    on the active trace — the request that tripped the breaker is
    exactly the one tail sampling must retain."""
    trace_mod.mark("breaker")
    metrics.REGISTRY.counter(_TRIPS_NAME, {"key": key}).inc()
    metrics.FLIGHT.auto_dump("breaker_trip", {"key": key})


def breaker_trip_counts() -> Dict[str, int]:
    """Per-key trips since process start (empty if none ever tripped)."""
    return {
        c.labels["key"]: c.value
        for c in metrics.REGISTRY.series(_TRIPS_NAME)
        if c.value
    }


def breaker_trip_count(key: Optional[str] = None) -> int:
    """Total trips, or one key's trips.  Read-only: querying a key that
    never tripped does NOT mint a zero-valued series into the registry."""
    return sum(
        c.value for c in metrics.REGISTRY.series(_TRIPS_NAME)
        if key is None or c.labels.get("key") == key
    )


def count_constrained_bound(lags, num_consumers: int) -> float:
    """Input-driven lower bound on max/mean lag imbalance for ANY valid
    assignment — THE normalizer for the north-star quality metric.

    Two facts force the floor: (1) the hottest partition sits on SOME
    consumer; (2) the count-primary invariant (max - min partitions <= 1,
    reference :246-249) forces that consumer to hold at least floor(P/C)
    partitions, each contributing its (non-negative) lag.  So
    ``peak >= max_lag + sum of the floor(P/C)-1 smallest other lags`` and
    ``bound = peak_min / mean_member_load``.
    """
    lags = np.asarray(lags)
    C = int(num_consumers)
    mean = lags.sum() / C if C else 0.0
    if mean <= 0:
        return 1.0
    k = max(lags.shape[0] // C - 1, 0)
    extra = np.partition(lags, k)[:k].sum() if k > 0 else 0
    return float((lags.max() + extra) / mean)


@dataclass
class RebalanceStats:
    """One rebalance's structured record."""

    num_topics: int = 0
    num_partitions: int = 0
    num_members: int = 0
    solver: str = ""
    # Device the solve ran on ("cuda", "cpu"; None for the host solver).
    device: Optional[str] = None
    wall_ms: float = 0.0
    lag_read_ms: float = 0.0
    solve_ms: float = 0.0
    # Exchange-refinement budget the solve consumed (None: the solver
    # does not refine, or "auto", or the host rung answered).
    refine_iters: Optional[int] = None
    # The host rung answered: the device solve failed, timed out or was
    # rejected by its breaker.
    fallback_used: bool = False
    # The configured solver's circuit-breaker state at response time
    # (utils/watchdog: closed | open | half_open; None = no watchdog, as
    # for the host solver) — an operator reading a fallback_used record
    # can tell a one-off failure (closed) from a sidelined device (open).
    breaker_state: Optional[str] = None
    total_lag: int = 0
    # Per-member totals across all topics (host-aggregated).
    member_total_lag: Dict[str, int] = field(default_factory=dict)
    member_partition_count: Dict[str, int] = field(default_factory=dict)
    # Per-topic breakdown: topic -> member -> {"count": n, "total_lag": L},
    # the structured analog of the reference's per-topic debug summary
    # block (LagBasedPartitionAssignor.java:280-306).
    per_topic: Dict[str, Dict[str, Dict[str, int]]] = field(
        default_factory=dict
    )
    # Count-constrained lower bound on the imbalance for this rebalance's
    # input (see count_constrained_bound) — filled by summarize_assignment.
    imbalance_bound: float = 1.0

    @property
    def max_mean_lag_imbalance(self) -> float:
        """max(member lag) / mean(member lag) — 1.0 is perfect; no valid
        assignment can score below ``imbalance_bound``."""
        lags = list(self.member_total_lag.values())
        if not lags:
            return 1.0
        mean = sum(lags) / len(lags)
        return max(lags) / mean if mean > 0 else 1.0

    @property
    def quality_ratio(self) -> float:
        """Achieved imbalance normalized to the input-driven bound — the
        north-star quality metric; 1.0 means provably optimal for the
        input."""
        return self.max_mean_lag_imbalance / max(self.imbalance_bound, 1.0)

    @property
    def count_spread(self) -> int:
        counts = list(self.member_partition_count.values())
        return (max(counts) - min(counts)) if counts else 0

    def to_json(self) -> str:
        d = asdict(self)
        d["max_mean_lag_imbalance"] = self.max_mean_lag_imbalance
        d["count_spread"] = self.count_spread
        d["quality_ratio"] = self.quality_ratio
        return json.dumps(d, sort_keys=True)


def summarize_assignment(
    stats: RebalanceStats,
    assignment: Dict[str, List],
    lag_by_tp: Dict,
) -> RebalanceStats:
    """Fill member totals from an assignment map and a TopicPartition->lag
    map, plus the input-driven imbalance bound over the ASSIGNED rows."""
    for member, tps in assignment.items():
        stats.member_partition_count[member] = len(tps)
        stats.member_total_lag[member] = sum(lag_by_tp.get(tp, 0) for tp in tps)
    if lag_by_tp and stats.num_members:
        stats.imbalance_bound = count_constrained_bound(
            np.fromiter(lag_by_tp.values(), dtype=np.int64,
                        count=len(lag_by_tp)),
            stats.num_members,
        )
    return stats


def summarize_topics(
    stats: RebalanceStats,
    assignment: Dict[str, List],
    lags: Dict[str, List],
) -> RebalanceStats:
    """Fill the per-topic member count/total-lag breakdown.

    ``lags`` maps topic -> list of TopicPartitionLag rows (the core's input);
    ``assignment`` maps member -> list of TopicPartition.  Mirrors the data
    the reference aggregates for its per-topic debug block
    (LagBasedPartitionAssignor.java:280-306), but structured.
    """
    lag_of = {
        (r.topic, r.partition): r.lag for rows in lags.values() for r in rows
    }
    for member, tps in assignment.items():
        for tp in tps:
            entry = stats.per_topic.setdefault(tp.topic, {}).setdefault(
                member, {"count": 0, "total_lag": 0}
            )
            entry["count"] += 1
            entry["total_lag"] += lag_of.get((tp.topic, tp.partition), 0)
    return stats


def replay_decisions(
    assignment: Dict[str, List], lags: Dict[str, List]
) -> Iterator[tuple]:
    """Reconstruct the per-partition decision sequence from a finished
    assignment.

    The core consumes each topic's partitions in a deterministic order (lag
    descending, partition id ascending — reference :228-235), so the decision
    sequence, including each member's running total at decision time, is
    recoverable host-side from the result alone.  That lets the trace work
    identically for the host oracle and the device kernels, without threading
    logging through jit-compiled code.

    Only meaningful for the reference-parity solvers (``rounds``/``scan``/
    ``native``/``host``), whose decisions ARE per-topic sequential greedy;
    for ``global`` (cross-topic totals) or ``sinkhorn`` (no sequential
    decisions at all) the replayed running totals would be fiction — callers
    must not trace those solvers.

    Yields ``(topic, partition, member, partition_lag, member_running_total)``
    — the exact fields of the reference's trace line (:268-275).
    """
    member_of = {
        (tp.topic, tp.partition): member
        for member, tps in assignment.items()
        for tp in tps
    }
    for topic, rows in lags.items():
        ordered = sorted(rows, key=lambda r: (-r.lag, r.partition))
        running: Dict[str, int] = {}
        for r in ordered:
            member = member_of.get((topic, r.partition))
            if member is None:  # topic had no eligible consumers
                continue
            running[member] = running.get(member, 0) + r.lag
            yield (topic, r.partition, member, r.lag, running[member])


def trace_decisions(
    assignment: Dict[str, List],
    lags: Dict[str, List],
    logger: logging.Logger = LOGGER,
) -> None:
    """Opt-in per-decision trace, reference format (:268-275)."""
    for topic, partition, member, lag, total in replay_decisions(
        assignment, lags
    ):
        logger.log(
            TRACE,
            "Assigned partition %s-%d to consumer %s.  partition_lag=%d, "
            "consumer_current_total_lag=%d",
            topic,
            partition,
            member,
            lag,
            total,
        )


def log_topic_summaries(
    stats: RebalanceStats,
    assignment: Dict[str, List],
    logger: logging.Logger = LOGGER,
) -> None:
    """Debug-level per-topic summary block, reference format (:280-306)."""
    if not logger.isEnabledFor(logging.DEBUG):
        return
    # One O(total partitions) grouping pass, then O(1) lookups per line.
    grouped: Dict[str, Dict[str, List]] = {}
    for member, tps in assignment.items():
        for tp in tps:
            grouped.setdefault(tp.topic, {}).setdefault(member, []).append(tp)
    for topic, members in stats.per_topic.items():
        lines = []
        for member, entry in members.items():
            lines.append(f"\t{member} (total_lag={entry['total_lag']})\n")
            for tp in grouped.get(topic, {}).get(member, ()):
                lines.append(f"\t\t{tp.topic}-{tp.partition}\n")
        logger.debug("Assignment for %s:\n%s", topic, "".join(lines))


def log_rebalance(stats: RebalanceStats) -> None:
    """The JAX package's INFO line, built only when INFO is on."""
    if LOGGER.isEnabledFor(logging.INFO):
        LOGGER.info("rebalance %s", stats.to_json())


@contextlib.contextmanager
def stopwatch() -> Iterator[List[float]]:
    """``with stopwatch() as t: ...`` -> ``t[0]`` is elapsed milliseconds."""
    out = [0.0]
    start = time.perf_counter()
    try:
        yield out
    finally:
        out[0] = (time.perf_counter() - start) * 1000.0


_trace_seq = itertools.count(1)


def default_trace_dir() -> str:
    """Where :func:`profile_trace` writes when the caller names no
    directory: ``klba_torch_trace`` under the process's temp directory."""
    return os.path.join(tempfile.gettempdir(), "klba_torch_trace")


@contextlib.contextmanager
def profile_trace(enabled: bool, log_dir: Optional[str] = None):
    """Optionally run a block under ``torch.profiler`` (CPU activity, and
    CUDA activity when a card is present) and write its Chrome trace
    (Perfetto-compatible) into ``log_dir`` as
    ``klba-<pid>-<n>.trace.json``.  Yields the directory, or None when
    disabled.  CUDA activity is traced process-wide, so the kernels a
    solve launches from the watchdog's worker thread land in the trace."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out_dir = log_dir or default_trace_dir()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield out_dir
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out_dir, f"klba-{os.getpid()}-{next(_trace_seq)}.trace.json"
    ))
