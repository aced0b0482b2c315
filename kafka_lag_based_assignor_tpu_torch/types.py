"""Core value types for the PyTorch/CUDA lag-based partition assignor.

A copy of ``kafka_lag_based_assignor_tpu/types.py``: the port keeps its own
so that it never imports the JAX package.

These mirror the slice of the Kafka client object model that the reference
plugin touches (reference: LagBasedPartitionAssignor.java:28-35 imports), plus
the one value type the reference defines itself:

* ``TopicPartition``        — org.apache.kafka.common.TopicPartition
* ``TopicPartitionLag``     — LagBasedPartitionAssignor.java:431-455
* ``PartitionInfo``         — org.apache.kafka.common.PartitionInfo (topic/partition slice)
* ``OffsetAndMetadata``     — org.apache.kafka.clients.consumer.OffsetAndMetadata (offset slice)
* ``Cluster``               — org.apache.kafka.common.Cluster (partitionsForTopic slice)
* ``Subscription`` / ``GroupSubscription`` / ``Assignment`` / ``GroupAssignment``
                            — ConsumerPartitionAssignor protocol value types used by
                              assign() (LagBasedPartitionAssignor.java:138-157)

Everything here is plain host-side Python: frozen dataclasses, hashable where
the reference type is used as a map key.  No torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence


@dataclass(frozen=True, order=True)
class TopicPartition:
    """A (topic, partition) pair; hashable, usable as a dict key."""

    topic: str
    partition: int

    def __str__(self) -> str:  # matches Kafka's "topic-partition" rendering
        return f"{self.topic}-{self.partition}"


@dataclass(frozen=True)
class TopicPartitionLag:
    """A (topic, partition, lag) triple — the element type of the core's input.

    Reference: LagBasedPartitionAssignor.java:431-455.  Unlike the reference's
    mutable-list-of-objects representation, the device core consumes
    columnar tensors; this type exists for the host-side API surface and
    tests.
    """

    topic: str
    partition: int
    lag: int

    def topic_partition(self) -> TopicPartition:
        return TopicPartition(self.topic, self.partition)


@dataclass(frozen=True)
class PartitionInfo:
    """Slice of org.apache.kafka.common.PartitionInfo the assignor reads."""

    topic: str
    partition: int


@dataclass(frozen=True)
class OffsetAndMetadata:
    """Slice of OffsetAndMetadata the assignor reads (just the offset)."""

    offset: int
    metadata: str = ""


@dataclass(frozen=True)
class Cluster:
    """Slice of org.apache.kafka.common.Cluster used by the assignor.

    Only ``partitions_for_topic`` is consumed (reference :329).  Topics absent
    from ``partitions_by_topic`` return None, matching the reference's
    null-metadata branch (:358-360).
    """

    partitions_by_topic: Mapping[str, Sequence[PartitionInfo]] = field(
        default_factory=dict
    )

    def partitions_for_topic(self, topic: str) -> Optional[Sequence[PartitionInfo]]:
        return self.partitions_by_topic.get(topic)


@dataclass(frozen=True)
class Subscription:
    """A member's subscription: the topics it wants (reference :143)."""

    topics: Sequence[str]


@dataclass(frozen=True)
class GroupSubscription:
    """member id -> Subscription (reference :142)."""

    group_subscription: Mapping[str, Subscription]


@dataclass(frozen=True)
class Assignment:
    """The per-member result wrapper; the reference attaches no user data
    (reference :151-155)."""

    partitions: Sequence[TopicPartition]


@dataclass(frozen=True)
class GroupAssignment:
    """member id -> Assignment (reference :156)."""

    group_assignment: Mapping[str, Assignment]


# Convenience aliases used across the package.
LagMap = Dict[str, List[TopicPartitionLag]]  # topic -> per-partition lag rows
SubscriptionMap = Dict[str, List[str]]  # member id -> subscribed topics
AssignmentMap = Dict[str, List[TopicPartition]]  # member id -> assigned partitions
