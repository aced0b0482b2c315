"""PyTorch/CUDA port of the lag-based Kafka partition assignor.

A second package beside ``kafka_lag_based_assignor_tpu`` (the JAX/TPU
reference, which it never imports).  It runs the plugin's ``assign()`` end
to end for the ``rounds``, ``global`` and ``sinkhorn`` solvers, with the
JAX package's TPU kernels as hand-written CUDA kernels in ``csrc/``: the
greedy round scan, the dense Sinkhorn plan statistics, and the linear-OT
superblock partials and mirror-prox step.
"""

from .assignor import LagBasedPartitionAssignor
from .lag import compute_partition_lag, read_topic_partition_lags
from .models.greedy import assign_greedy, assign_greedy_global
from .models.sinkhorn import assign_sinkhorn
from .ops.dispatch import assign_device
from .ops.streaming import StreamingAssignor, StreamingStats
from .types import (
    Assignment,
    Cluster,
    GroupAssignment,
    GroupSubscription,
    OffsetAndMetadata,
    PartitionInfo,
    Subscription,
    TopicPartition,
    TopicPartitionLag,
)
from .utils.device import resolve_device

__all__ = [
    "Assignment",
    "Cluster",
    "GroupAssignment",
    "GroupSubscription",
    "LagBasedPartitionAssignor",
    "OffsetAndMetadata",
    "PartitionInfo",
    "StreamingAssignor",
    "StreamingStats",
    "Subscription",
    "TopicPartition",
    "TopicPartitionLag",
    "assign_device",
    "assign_greedy",
    "assign_greedy_global",
    "assign_sinkhorn",
    "compute_partition_lag",
    "read_topic_partition_lags",
    "resolve_device",
]
