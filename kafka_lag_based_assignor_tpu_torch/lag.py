"""Lag acquisition (the I/O layer, L2) and the pure lag formula.

A copy of ``compute_partition_lag``, ``read_topic_partition_lags`` and
``LagRetryPolicy`` from ``kafka_lag_based_assignor_tpu/lag.py``, with its
fault points (``lag.begin`` / ``lag.end`` / ``lag.committed``), its retry
counter (``klba_lag_retries_total{rpc}``) and its ``lag.read`` client scope
and span, and the client-side delta trackers ``LagDeltaTracker`` (consecutive
lag reads become dense rows or a sparse ``lag_delta``) and
``AssignmentDeltaTracker`` (acks the held assignment epoch and rebuilds the
dense view from an ``assignment_delta`` answer), which the sidecar's
``stream_assign`` speaks.  Reference semantics reproduced exactly:

* ``compute_partition_lag`` — LagBasedPartitionAssignor.java:376-404:
  committed offset wins; otherwise ``auto.offset.reset=latest`` means lag 0
  and any other mode means the full backlog (end - begin); the result is
  clamped to >= 0 to guard failed end-offset reads.
* ``read_topic_partition_lags`` — LagBasedPartitionAssignor.java:317-365:
  per topic, consult cluster metadata; if a topic has no metadata, warn and
  skip it; otherwise batch-read beginning/end/committed offsets from the
  broker client and compute per-partition lag.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Protocol,
    Sequence,
    Set,
)

from .types import (
    Cluster,
    LagMap,
    OffsetAndMetadata,
    TopicPartition,
    TopicPartitionLag,
)
from .utils import faults, metrics

LOGGER = logging.getLogger(__name__)


@dataclass(frozen=True)
class LagRetryPolicy:
    """Opt-in bounded retry for the three lag batch RPCs.

    The DEFAULT (no policy) preserves reference abort semantics exactly:
    a broker exception propagates and fails the rebalance (SURVEY
    §2.4.9).  With a policy, each RPC is attempted up to ``attempts``
    times with deterministic exponential backoff
    (``backoff_s * multiplier**i`` — no jitter, so a drill replays the
    same schedule) before the final exception propagates.  ``sleep`` is
    injectable so tests assert the backoff sequence without real sleeps.
    """

    attempts: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts={self.attempts} must be >= 1")


def _call_with_retry(
    fn: Callable[[], Mapping], what: str, retry: Optional[LagRetryPolicy]
):
    """Run one batch RPC under the (optional) retry policy."""
    if retry is None or retry.attempts <= 1:
        return fn()
    for attempt in range(retry.attempts):
        try:
            return fn()
        except Exception:
            if attempt == retry.attempts - 1:
                raise
            metrics.REGISTRY.counter(
                "klba_lag_retries_total", {"rpc": what}
            ).inc()
            delay = retry.backoff_s * retry.multiplier**attempt
            LOGGER.warning(
                "lag RPC %s failed (attempt %d/%d); retrying in %.3fs",
                what, attempt + 1, retry.attempts, delay, exc_info=True,
            )
            retry.sleep(delay)
    raise AssertionError("unreachable")  # the loop returns or raises


class LagDeltaTracker:
    """Host-side differ for DELTA EPOCHS (service.py "Delta epochs"):
    turns consecutive per-stream lag reads into the smallest valid
    ``stream_assign`` params — a sparse ``lag_delta`` when little
    changed, full ``lags`` rows whenever a dense base must be
    (re)established — so the JVM shim (or any client that simply
    re-reads lags each epoch) benefits from sparse uploads with no
    protocol change of its own.

    Usage, once per stream per epoch::

        params = tracker.params_for(rows)      # {"lags": ...} or
                                               # {"lag_delta": ...}
        result = client.stream_assign(..., **params)
        tracker.note_result(result)            # adopt lag_epoch/resync

    The tracker sends dense until the server confirms a base
    (``stream.lag_epoch``), diffs against the last CONFIRMED rows after
    that, and falls back to dense whenever the pid set changed, more
    than ``max_fraction`` of the partitions moved (the server would
    upload dense anyway), the server answered ``resync: true``, or the
    previous request failed outright.  Fault point ``delta.diff`` fires
    inside the differ — an injected failure degrades to dense, never to
    a lost epoch."""

    def __init__(self, max_fraction: float = 0.125):
        if not 0.0 < float(max_fraction) <= 1.0:
            raise ValueError(
                f"max_fraction={max_fraction} must be in (0, 1]"
            )
        self.max_fraction = float(max_fraction)
        self._base: Optional[Dict[int, int]] = None  # pid -> lag
        self._base_epoch: Optional[int] = None
        self._pending: Optional[Dict[int, int]] = None  # awaiting confirm

    def params_for(self, rows: Sequence) -> Dict[str, Any]:
        """``rows`` is the epoch's full ``[[pid, lag], ...]`` read (any
        order).  Returns the params fragment to merge into the
        ``stream_assign`` request."""
        current = {int(p): int(lag) for p, lag in rows}
        self._pending = current
        base, epoch = self._base, self._base_epoch
        if base is None or epoch is None or set(base) != set(current):
            return {"lags": [[p, v] for p, v in current.items()]}
        try:
            faults.fire("delta.diff")
            changed = [
                (p, v) for p, v in current.items() if base[p] != v
            ]
        except Exception:  # noqa: BLE001 — dense is the safe fallback
            LOGGER.warning(
                "lag delta diff failed; sending dense", exc_info=True
            )
            return {"lags": [[p, v] for p, v in current.items()]}
        if len(changed) > self.max_fraction * max(len(current), 1):
            return {"lags": [[p, v] for p, v in current.items()]}
        return {
            "lag_delta": {
                "indices": [p for p, _ in changed],
                "values": [v for _, v in changed],
                "base_epoch": epoch,
            }
        }

    def note_result(self, result: Mapping) -> None:
        """Adopt the server's answer for the epoch last built by
        :meth:`params_for`: on success the pending read becomes the
        confirmed base at the reported ``lag_epoch``; a ``resync``
        answer (or a missing stream section) drops the base so the next
        epoch re-seeds dense."""
        stream = (result or {}).get("stream") or {}
        if stream.get("resync") or "lag_epoch" not in stream:
            self.note_failure()
            return
        self._base = self._pending or self._base
        self._base_epoch = int(stream["lag_epoch"])
        self._pending = None

    def note_failure(self) -> None:
        """The request failed (error, drop, shed without a lag_epoch):
        the server's base is unknown — send dense next epoch."""
        self._base = None
        self._base_epoch = None
        self._pending = None


class AssignmentDeltaTracker:
    """Client-side reconstructor for DELTA RESPONSES (service.py
    "Delta responses") — the downlink mirror of
    :class:`LagDeltaTracker`: acks the assignment epoch it holds so
    the server may answer with only the changed rows
    (``result.assignment_delta``), then reconstructs the dense
    assignments dict bit-exactly from its held base.

    Usage, once per stream per epoch (composes with the lag tracker —
    both stamp fields onto the same params dict)::

        params = lag_tracker.params_for(rows)
        assign_tracker.stamp(params)            # adds assign_ack
        result = client.stream_assign(..., **params)
        assignments = assign_tracker.note_result(result, members)
        lag_tracker.note_result(result)

    The tracker acks nothing until a dense answer establishes a base
    (``stream.assign_epoch``); after that every answer either applies
    a delta against the held base (the server only serves one when the
    ack matched and the roster is unchanged — the same
    monotone-epoch/ack/resync ladder as the upload path) or is a dense
    re-seed.  Any failed request drops the ack
    (:meth:`note_failure`), so the next answer is dense — resync
    semantics identical to the lag tracker's."""

    def __init__(self):
        self._epoch: Optional[int] = None
        self._owner: Optional[Dict[int, str]] = None  # pid -> member
        self._topic: Optional[str] = None

    def stamp(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Add ``assign_ack`` for the held base (no-op before the
        first confirmed dense answer); returns ``params``."""
        if self._epoch is not None and self._owner is not None:
            params["assign_ack"] = self._epoch
        return params

    def note_result(
        self, result: Mapping, members: Sequence[str]
    ) -> Dict[str, Any]:
        """Adopt one ``stream_assign`` answer and return the dense
        assignments dict (reconstructed for a delta answer, adopted
        as-is for a dense one).  ``members`` is the member list the
        request named — owner indices in a delta bind to its sorted
        order, exactly as the server's dense dict does."""
        members_sorted = sorted(str(m) for m in members)
        stream = (result or {}).get("stream") or {}
        delta = (result or {}).get("assignment_delta")
        if delta is not None:
            if (
                self._owner is None
                or delta.get("base_epoch") != self._epoch
            ):
                # The server deltas only against an acked base; a
                # mismatch here means state desynchronized (client
                # bug, crossed responses) — drop the base and demand
                # dense next epoch rather than apply onto the wrong
                # view.
                self.note_failure()
                raise ValueError(
                    "assignment_delta names a base this tracker does "
                    "not hold; re-sync next epoch"
                )
            for pid, owner in zip(delta["indices"], delta["owners"]):
                self._owner[int(pid)] = members_sorted[int(owner)]
            self._epoch = int(delta["epoch"])
            self._topic = delta.get("topic", self._topic)
            return self.assignments(members_sorted)
        assignments = (result or {}).get("assignments")
        if assignments is None:
            self.note_failure()
            raise ValueError(
                "result carries neither assignments nor "
                "assignment_delta"
            )
        owner: Dict[int, str] = {}
        topic = self._topic
        for m, rows in assignments.items():
            for t, pid in rows:
                owner[int(pid)] = str(m)
                topic = t
        self._owner = owner
        self._topic = topic
        epoch = stream.get("assign_epoch")
        # An old server (no delta-response support) never confirms an
        # epoch — the tracker then acks nothing and behaves densely.
        self._epoch = int(epoch) if epoch is not None else None
        return assignments

    def assignments(self, members_sorted: Sequence[str]) -> Dict[str, Any]:
        """The held dense view, in the server's wire shape: ascending
        pids per member (the server appends rows in ascending-pid
        order, so reconstruction matches it bit-for-bit)."""
        out: Dict[str, Any] = {m: [] for m in members_sorted}
        for pid in sorted(self._owner or {}):
            out[self._owner[pid]].append([self._topic, pid])
        return out

    def note_failure(self) -> None:
        """The request failed: the server may have advanced its epoch
        without this client seeing the answer — drop the base so the
        next answer re-seeds dense."""
        self._epoch = None
        self._owner = None


def compute_partition_lag(
    partition_metadata: Optional[OffsetAndMetadata],
    begin_offset: int,
    end_offset: int,
    auto_offset_reset_mode: str,
) -> int:
    """Pure lag formula; exact parity with reference :376-404.

    lag = max(end_offset - next_offset, 0) where next_offset is the committed
    offset if present, else end_offset when auto.offset.reset=latest
    (case-insensitive), else begin_offset (earliest / none / anything else).
    """
    if partition_metadata is not None:
        next_offset = partition_metadata.offset
    elif auto_offset_reset_mode.lower() == "latest":
        next_offset = end_offset
    else:
        # assume earliest (reference :393-396: any non-"latest" mode,
        # including "none", takes the earliest branch)
        next_offset = begin_offset
    return max(end_offset - next_offset, 0)


class MetadataConsumer(Protocol):
    """The slice of KafkaConsumer the lag reader uses (reference :339-342).

    Three blocking batch RPCs per topic: ListOffsets (begin), ListOffsets
    (end), OffsetFetch (committed).  Exceptions are deliberately NOT caught —
    a broker failure must abort the rebalance, matching reference semantics
    (SURVEY §2.4.9).
    """

    def beginning_offsets(
        self, partitions: Sequence[TopicPartition]
    ) -> Mapping[TopicPartition, int]: ...

    def end_offsets(
        self, partitions: Sequence[TopicPartition]
    ) -> Mapping[TopicPartition, int]: ...

    def committed(
        self, partitions: Set[TopicPartition]
    ) -> Mapping[TopicPartition, Optional[OffsetAndMetadata]]: ...


def read_topic_partition_lags(
    metadata_consumer: MetadataConsumer,
    cluster: Cluster,
    all_subscribed_topics: Iterable[str],
    auto_offset_reset_mode: str = "latest",
    retry: Optional[LagRetryPolicy] = None,
) -> LagMap:
    """Fetch current consumer-group lag for every partition of every topic.

    Exact behavioral parity with reference :317-365:
    * topics with null/empty cluster metadata are warned about and excluded
      from the result map entirely (:358-360);
    * missing begin/end offsets for a partition default to 0 (:350-351);
    * ``committed`` may omit partitions or map them to None — both mean "no
      committed offset" (:349).

    ``retry`` (default None = reference abort semantics) bounds transient
    broker failures per RPC — see :class:`LagRetryPolicy`.  The fault
    points ``lag.begin`` / ``lag.end`` / ``lag.committed`` sit INSIDE the
    retried callables so injection drills exercise the retry path.
    """
    topic_partition_lags: Dict[str, List[TopicPartitionLag]] = {}
    # Called under the assignor's rebalance scope the outer trace wins
    # (nested scopes flatten) and this only contributes the span; called
    # on its own it roots a client-kind trace, as in the JAX package.
    with metrics.request_scope(kind="client", root_name="lag.read"):
        with metrics.span("lag.read"):
            _read_all(
                topic_partition_lags, metadata_consumer, cluster,
                all_subscribed_topics, auto_offset_reset_mode, retry,
            )
    return topic_partition_lags


def _read_all(
    topic_partition_lags, metadata_consumer, cluster,
    all_subscribed_topics, auto_offset_reset_mode, retry,
):
    for topic in all_subscribed_topics:
        partition_info = cluster.partitions_for_topic(topic)
        if not partition_info:
            LOGGER.warning(
                "Skipping assignment for topic %s since no metadata is available",
                topic,
            )
            continue

        topic_partitions = [
            TopicPartition(p.topic, p.partition) for p in partition_info
        ]

        # The three batch RPCs — the only network boundary in the plugin.
        def _begin():
            faults.fire("lag.begin")
            return metadata_consumer.beginning_offsets(topic_partitions)

        def _end():
            faults.fire("lag.end")
            return metadata_consumer.end_offsets(topic_partitions)

        def _committed():
            faults.fire("lag.committed")
            return metadata_consumer.committed(set(topic_partitions))

        begin_offsets = _call_with_retry(_begin, "beginning_offsets", retry)
        end_offsets = _call_with_retry(_end, "end_offsets", retry)
        committed = _call_with_retry(_committed, "committed", retry)

        topic_partition_lags[topic] = [
            TopicPartitionLag(
                tp.topic,
                tp.partition,
                compute_partition_lag(
                    committed.get(tp),
                    begin_offsets.get(tp, 0),
                    end_offsets.get(tp, 0),
                    auto_offset_reset_mode,
                ),
            )
            for tp in topic_partitions
        ]
