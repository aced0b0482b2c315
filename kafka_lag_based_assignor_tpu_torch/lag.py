"""Lag acquisition (the I/O layer, L2) and the pure lag formula.

A copy of ``compute_partition_lag``, ``read_topic_partition_lags`` and
``LagRetryPolicy`` from ``kafka_lag_based_assignor_tpu/lag.py``, with its
fault points (``lag.begin`` / ``lag.end`` / ``lag.committed``), its retry
counter (``klba_lag_retries_total{rpc}``) and its ``lag.read`` client scope
and span.  ``LagDeltaTracker`` and ``AssignmentDeltaTracker`` come with the
port's sidecar slice.  Reference semantics reproduced exactly:

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
