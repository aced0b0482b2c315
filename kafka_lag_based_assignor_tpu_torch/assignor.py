"""The plugin adapter (L1): the ``ConsumerPartitionAssignor`` surface.

Counterpart of ``kafka_lag_based_assignor_tpu/assignor.py`` (its own class,
not a subclass).  Mirrors the reference's protocol contract
(LagBasedPartitionAssignor.java:83-157):

* ``configure(configs)`` — validates ``group.id``, derives metadata-consumer
  properties (auto-commit off, ``client.id=<group>.assignor``);
* ``name()`` — returns ``"lag"``, the protocol name embedded in JoinGroup
  metadata (all group members must support it);
* ``assign(cluster, group_subscription)`` — runs on the elected group
  leader: unions subscribed topics, reads lags (the only network boundary),
  solves the assignment, wraps results with no user data.

The ``rounds`` (default), ``scan``, ``global`` and ``sinkhorn`` solvers
run on ``device`` — the CUDA card unless the caller passes
``device="cpu"`` — ``native`` runs the C++ greedy core on the host and
``host`` the Python greedy.  ``rounds``, ``scan``, ``native`` and ``host``
give the reference's answer bit for bit; ``tpu.assignor.refine.iters > 0``
appends the exchange refinement to ``rounds`` and ``scan`` (the quality
mode of the default solver, no longer the reference's answer).
``sinkhorn`` is the quality solver; the process-wide ``quality.mode``
(:mod:`.ops.dispatch`) routes each of its topics to the dense or the
linear-space path.  There is no host fallback: a device error propagates
out of ``assign()``.  Every rebalance leaves a :class:`RebalanceStats`
record in ``last_stats``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Mapping, Optional

from .lag import LagRetryPolicy, MetadataConsumer, read_topic_partition_lags
from .models.greedy import assign_greedy
from .models.sinkhorn import assign_sinkhorn
from .native import assign_native
from .ops.dispatch import assign_device
from .types import (
    Assignment,
    Cluster,
    GroupAssignment,
    GroupSubscription,
    TopicPartition,
)
from .utils.config import AssignorConfig, parse_config
from .utils.device import DeviceLike, resolve_device
from .utils.observability import RebalanceStats, stopwatch, summarize_assignment

LOGGER = logging.getLogger(__name__)

MetadataConsumerFactory = Callable[[Mapping[str, Any]], MetadataConsumer]

#: Solvers this package runs on the device.
DEVICE_SOLVERS = ("rounds", "scan", "global", "sinkhorn")


class LagBasedPartitionAssignor:
    """PyTorch/CUDA drop-in for the reference assignor."""

    def __init__(
        self,
        metadata_consumer_factory: Optional[MetadataConsumerFactory] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self._config: Optional[AssignorConfig] = None
        self._metadata_consumer: Optional[MetadataConsumer] = None
        self._metadata_consumer_factory = metadata_consumer_factory
        self._lag_retry: Optional[LagRetryPolicy] = None
        self.last_stats: Optional[RebalanceStats] = None

    # -- Configurable SPI --------------------------------------------------

    def configure(self, configs: Mapping[str, Any]) -> None:
        """Reference :97-130 — fails fast if ``group.id`` is absent."""
        self._config = parse_config(configs)
        # Opt-in bounded lag-RPC retry; 0 retries = the reference's
        # broker-exception-aborts-the-rebalance semantics, untouched.
        self._lag_retry = (
            LagRetryPolicy(
                attempts=self._config.lag_retries + 1,
                backoff_s=self._config.lag_retry_backoff_s,
            )
            if self._config.lag_retries > 0
            else None
        )

    # -- ConsumerPartitionAssignor SPI ------------------------------------

    def name(self) -> str:
        """The protocol name (reference :132-135)."""
        return "lag"

    def assign(
        self, metadata: Cluster, subscriptions: GroupSubscription
    ) -> GroupAssignment:
        """The rebalance entry point; runs on the group leader
        (reference :137-157)."""
        if self._config is None:
            raise RuntimeError("configure() must be called before assign()")
        solver = self._config.solver
        stats = RebalanceStats(
            solver=solver,
            device=self.device.type if solver in DEVICE_SOLVERS else None,
            # Only solvers that consume the budget record it, as in the
            # JAX package.
            refine_iters=(
                self._config.refine_iters
                if solver in ("rounds", "scan", "sinkhorn")
                else None
            ),
        )
        with stopwatch() as wall:
            group_assignment = self._assign_inner(metadata, subscriptions, stats)
        stats.wall_ms = wall[0]
        if LOGGER.isEnabledFor(logging.DEBUG):
            LOGGER.debug("rebalance %s", stats.to_json())
        self.last_stats = stats
        return group_assignment

    def _assign_inner(
        self,
        metadata: Cluster,
        subscriptions: GroupSubscription,
        stats: RebalanceStats,
    ) -> GroupAssignment:
        # Union all members' subscribed topics (reference :140-146).
        topic_subscriptions = {
            member: list(sub.topics)
            for member, sub in subscriptions.group_subscription.items()
        }
        all_subscribed = set()
        for topics in topic_subscriptions.values():
            all_subscribed.update(topics)

        # Lag acquisition — exceptions propagate and fail the rebalance,
        # matching the reference's absence of try/catch (:339-342), unless
        # the deployment opted into the bounded retry policy.
        with stopwatch() as lag_ms:
            lags = read_topic_partition_lags(
                self._get_metadata_consumer(),
                metadata,
                all_subscribed,
                self._config.auto_offset_reset,
                retry=self._lag_retry,
            )
        stats.lag_read_ms = lag_ms[0]

        with stopwatch() as solve_ms:
            if self._config.solver == "host":
                raw = assign_greedy(lags, topic_subscriptions)
            elif self._config.solver == "native":
                raw = assign_native(lags, topic_subscriptions)
            elif self._config.solver == "sinkhorn":
                raw = assign_sinkhorn(
                    lags, topic_subscriptions,
                    iters=self._config.sinkhorn_iters,
                    refine_iters=self._config.refine_iters,
                    device=self.device,
                )
            else:
                # An explicit refine budget appends the exchange refinement
                # to the per-topic parity kernels; global + refine is
                # rejected by configure().
                raw = assign_device(
                    lags, topic_subscriptions, kernel=self._config.solver,
                    device=self.device, refine_iters=self._config.refine_iters,
                )
        stats.solve_ms = solve_ms[0]

        stats.num_topics = len(lags)
        stats.num_partitions = sum(len(v) for v in lags.values())
        stats.num_members = len(topic_subscriptions)
        lag_by_tp = {
            TopicPartition(r.topic, r.partition): r.lag
            for rows in lags.values()
            for r in rows
        }
        stats.total_lag = sum(lag_by_tp.values())
        summarize_assignment(stats, raw, lag_by_tp)
        return GroupAssignment(
            {member: Assignment(tuple(tps)) for member, tps in raw.items()}
        )

    def _get_metadata_consumer(self) -> MetadataConsumer:
        """Lazily create the shared metadata consumer (reference :322-324);
        it lives as long as the assignor and is never closed."""
        if self._metadata_consumer is None:
            if self._metadata_consumer_factory is None:
                raise RuntimeError(
                    "no metadata consumer factory configured; inject one at "
                    "construction or call set_metadata_consumer()"
                )
            self._metadata_consumer = self._metadata_consumer_factory(
                self._config.metadata_consumer_props
            )
        return self._metadata_consumer

    def set_metadata_consumer(self, consumer: MetadataConsumer) -> None:
        """Directly inject a broker client (tests, embedding runtimes)."""
        self._metadata_consumer = consumer
