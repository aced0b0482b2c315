"""Pad-and-mask packing of ragged multi-topic workloads for batched kernels.

A copy of ``kafka_lag_based_assignor_tpu/ops/packing.py`` (numpy only).
The reference assigns topics one at a time in a host loop
(LagBasedPartitionAssignor.java:177-184).  The device path instead batches
topics into one kernel launch, one thread block per topic.  Two facts make
this safe:

* per-topic independence — lag is never balanced across topics
  (SURVEY §2.4.3), so topics can execute concurrently;
* the rounds kernel's pre-condition (every consumer eligible for every
  partition of its topic) holds within a **group of topics whose subscriber
  sets are identical**, after re-ranking that subscriber set densely.

So packing = group topics by ``frozenset(subscribers)``, then pad each
group's topics to a shared power-of-two partition budget.  In the common
Kafka deployment every member subscribes to every topic, so there is exactly
one group and one kernel launch per rebalance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from ..types import TopicPartitionLag


def pad_bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket >= n (the JAX package's shape buckets, kept
    so that both packages solve identically padded groups)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_chunk(n: int, chunk: int = 4096) -> int:
    """Next multiple of ``chunk`` >= n: the streaming engine's padded
    refine shape on the CPU, where a power-of-two pad wastes up to ~2x sort
    work (the JAX package's bucket on its CPU backend)."""
    return max(chunk, -(-n // chunk) * chunk)


def table_rows(num_rows: int, num_consumers: int) -> int:
    """Per-consumer slot budget for the resident refine's [C, M] row
    table (:func:`.refine.build_choice_tables`): the count invariant
    ``max - min <= 1`` bounds any consumer at ``ceil(P / C)`` rows, and
    exchange moves never push a consumer past the current maximum, so
    ``ceil(P / C) + 1`` slots hold every reachable state with one slot of
    headroom."""
    C = max(int(num_consumers), 1)
    return -(-int(num_rows) // C) + 1


def pad_topic_rows(lags, partition_ids=None):
    """Pad one topic's columns to its power-of-two bucket.

    The single place the (lags, partition_ids, valid) pad-and-mask triple
    is built for per-topic solvers.  Returns (lags int64[P_pad],
    partition_ids int32[P_pad], valid bool[P_pad]).
    """
    P = len(lags)
    P_pad = pad_bucket(P)
    lags_p = np.zeros(P_pad, dtype=np.int64)
    pids_p = np.zeros(P_pad, dtype=np.int32)
    valid = np.zeros(P_pad, dtype=bool)
    lags_p[:P] = lags
    pids_p[:P] = (
        np.arange(P, dtype=np.int32) if partition_ids is None else partition_ids
    )
    valid[:P] = True
    return lags_p, pids_p, valid


@dataclass
class TopicGroup:
    """A batch of topics sharing one (deduped, rank-ordered) subscriber set.

    Array shapes: [T, P_pad] with ``valid`` masking ragged padding.
    ``members[rank]`` is the member id for kernel consumer index ``rank``
    (lexicographic order, so integer tie-breaks match string tie-breaks).
    """

    topics: List[str]
    members: List[str]
    lags: np.ndarray  # int64 [T, P_pad]
    partition_ids: np.ndarray  # int32 [T, P_pad]
    valid: np.ndarray  # bool  [T, P_pad]

    @property
    def num_consumers(self) -> int:
        return len(self.members)


def build_groups(
    partition_lag_per_topic: Mapping[str, Sequence[TopicPartitionLag]],
    consumers_by_topic: Mapping[str, Sequence[str]],
) -> List[TopicGroup]:
    """Group topics by subscriber set and pack each group into padded columns.

    Topics with no consumers or no lag rows are dropped here, mirroring the
    reference's early-return (:211-213) and getOrDefault-empty (:182) paths.
    Topic order within a group is sorted, and groups are emitted in sorted
    order of their first topic, for deterministic output.
    """
    by_subscribers: Dict[Tuple[str, ...], List[str]] = {}
    for topic in sorted(consumers_by_topic):
        members = tuple(sorted(set(consumers_by_topic[topic])))
        rows = partition_lag_per_topic.get(topic)
        if not members or not rows:
            continue
        by_subscribers.setdefault(members, []).append(topic)

    groups: List[TopicGroup] = []
    for members, topics in sorted(by_subscribers.items(), key=lambda kv: kv[1][0]):
        # Bucket BOTH dims, as the JAX package does (its jitted kernels
        # retrace only on bucket crossings).  T buckets start at 1 so the
        # flagship single-topic shape pays no batch padding.
        T = pad_bucket(len(topics), minimum=1)
        P_pad = pad_bucket(
            max(len(partition_lag_per_topic[t]) for t in topics)
        )
        lags = np.zeros((T, P_pad), dtype=np.int64)
        pids = np.zeros((T, P_pad), dtype=np.int32)
        valid = np.zeros((T, P_pad), dtype=bool)
        for ti, topic in enumerate(topics):
            rows = partition_lag_per_topic[topic]
            P = len(rows)
            lags[ti, :P] = np.fromiter((r.lag for r in rows), np.int64, count=P)
            pids[ti, :P] = np.fromiter(
                (r.partition for r in rows), np.int32, count=P
            )
            valid[ti, :P] = True
        groups.append(
            TopicGroup(
                topics=topics,
                members=list(members),
                lags=lags,
                partition_ids=pids,
                valid=valid,
            )
        )
    return groups
