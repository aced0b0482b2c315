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
linear-space path.

The fault ladder is the JAX plugin's:

* every solve but ``host`` runs under a :class:`.utils.watchdog.Watchdog`
  built from ``tpu.assignor.solve.timeout.ms`` (default 120 s; 0 runs it
  inline), ``breaker.cooldown.ms`` and ``breaker.failures``, in a worker
  thread (``klba-solve``) that enters the caller's CUDA device and stream,
  with one circuit breaker per solver;
* a solve that raises, times out or is rejected by its open breaker is
  answered by :func:`.models.greedy.host_fallback_for` — the reference
  greedy in Python, never a kernel's plain PyTorch version and never a move
  to the CPU device — when ``tpu.assignor.host.fallback`` is on, as it is
  by default: ``last_stats.fallback_used`` is True, the rung is counted in
  ``klba_ladder_rung_total{method=assign,rung=host_greedy}`` and the flight
  recorder dumps once.  With it off the error propagates out of
  ``assign()``.  Broker-RPC exceptions always propagate, as in the
  reference;
* every rebalance runs in one request scope (a client-kind trace) with the
  ``lag.read`` and ``assign.solve`` spans, observes
  ``klba_rebalance_wall_ms{solver}``, logs its :class:`RebalanceStats` at
  INFO, writes a ``rebalance`` flight record and leaves the record in
  ``last_stats``; ``tpu.assignor.profile`` wraps it in a ``torch.profiler``
  trace.

A first rebalance builds its kernels with ``nvcc`` under the same
deadline, about 40 s for the round scan's source: a ``solve.timeout.ms``
below that can time it out, trip the breaker and answer that rebalance
from the host, as a cold XLA compile does in the JAX plugin.  The build
finishes in the abandoned worker and is reused.  The configure-time
warm-up avoids this: with ``tpu.assignor.warmup.shapes`` set,
``configure()`` builds every kernel and runs the configured device solver
once at each listed shape (:func:`.warmup.warmup`), so the first
rebalance builds nothing.  ``native`` and ``host`` have no device work and
warm nothing; a failed warm-up is logged and the consumer starts anyway.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Callable, ContextManager, Mapping, Optional

from .lag import LagRetryPolicy, MetadataConsumer, read_topic_partition_lags
from .models.greedy import assign_greedy, host_fallback_for
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
from .utils import faults, metrics
from .utils.config import PARITY_SOLVERS, AssignorConfig, parse_config
from .utils.device import DeviceLike, carry_cuda_context, resolve_device
from .utils.observability import (
    TRACE,
    RebalanceStats,
    log_rebalance,
    log_topic_summaries,
    profile_trace,
    stopwatch,
    summarize_assignment,
    summarize_topics,
    trace_decisions,
)
from .utils.watchdog import Watchdog

LOGGER = logging.getLogger(__name__)

MetadataConsumerFactory = Callable[[Mapping[str, Any]], MetadataConsumer]

#: Solvers this package runs on the device.
DEVICE_SOLVERS = ("rounds", "scan", "global", "sinkhorn")


def solve_accelerated(
    solver: str,
    lags,
    topic_subscriptions,
    options: Optional[Mapping[str, Any]] = None,
    device: DeviceLike = None,
    cuda_context: Callable[[], ContextManager] = contextlib.nullcontext,
):
    """THE device solve of every solver but ``host``, which
    :func:`solve_on_ladder` runs for the plugin and the sidecar alike (the
    JAX sidecar calls the JAX plugin's static ``_solve_accelerated`` for the
    same reason).  The watchdog runs it (on its worker thread unless the
    timeout is off): the ``device.solve`` fault point first, then the
    solver inside ``cuda_context`` (the caller's CUDA device and stream, from
    :func:`.utils.device.carry_cuda_context`).  ``options`` carries
    ``sinkhorn_iters`` (default 24) and ``refine_iters`` (None = the
    reference's answer for the parity solvers, the per-path budget for
    ``sinkhorn``): the plugin's config values, or the wire's options."""
    faults.fire("device.solve")
    options = options or {}
    refine = options.get("refine_iters")
    refine = None if refine is None else int(refine)
    with cuda_context():
        if solver == "native":
            return assign_native(lags, topic_subscriptions)
        if solver == "sinkhorn":
            return assign_sinkhorn(
                lags, topic_subscriptions,
                iters=int(options.get("sinkhorn_iters", 24)),
                refine_iters=refine, device=device,
            )
        # An explicit refine budget appends the exchange refinement to the
        # per-topic parity kernels; global + refine is rejected by every
        # entry point before it reaches here.
        return assign_device(
            lags, topic_subscriptions, kernel=solver, device=device,
            refine_iters=refine,
        )


def solve_on_ladder(
    solver: str,
    lags,
    topic_subscriptions,
    stats: RebalanceStats,
    *,
    watchdog: Optional[Watchdog] = None,
    host_fallback: bool = True,
    options: Optional[Mapping[str, Any]] = None,
    device: DeviceLike = None,
    timeout_s: Optional[float] = None,
):
    """THE fault ladder of one stateless solve, shared by the plugin and
    the sidecar so the two cannot drift.  ``host`` runs the reference
    greedy.  Every other solver runs :func:`solve_accelerated` under
    ``watchdog`` (breaker key = the solver, on a worker that enters this
    thread's CUDA device and stream; inline without a watchdog), with
    ``timeout_s`` in place of the watchdog's deadline when given.  A solve
    that raises, times out or is rejected propagates when ``host_fallback``
    is off, and is otherwise answered by
    :func:`.models.greedy.host_fallback_for`.  Sets ``stats.breaker_state``
    and ``stats.fallback_used``; each caller keeps its own other stats
    fields and series."""
    if solver == "host":
        return assign_greedy(lags, topic_subscriptions)
    device = resolve_device(device)
    deadline = {} if timeout_s is None else {"timeout_s": timeout_s}
    try:
        if watchdog is None:
            return solve_accelerated(solver, lags, topic_subscriptions, options, device)
        result = watchdog.call(
            solve_accelerated, solver, lags, topic_subscriptions, options,
            device, carry_cuda_context(device), key=solver, **deadline,
        )
        stats.breaker_state = watchdog.state(solver)
        return result
    except Exception:
        if watchdog is not None:
            stats.breaker_state = watchdog.state(solver)
        if not host_fallback:
            raise
        LOGGER.warning(
            "device solver %r failed; falling back to host greedy",
            solver,
            exc_info=True,
        )
        stats.fallback_used = True
        return host_fallback_for(solver)(lags, topic_subscriptions)


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
        self._watchdog: Optional[Watchdog] = None
        self._lag_retry: Optional[LagRetryPolicy] = None
        self.last_stats: Optional[RebalanceStats] = None

    # -- Configurable SPI --------------------------------------------------

    def configure(self, configs: Mapping[str, Any]) -> None:
        """Reference :97-130 — fails fast if ``group.id`` is absent."""
        self._config = parse_config(configs)
        self._watchdog = Watchdog(
            self._config.solve_timeout_s,
            cooldown_s=self._config.breaker_cooldown_s,
            failure_threshold=self._config.breaker_failures,
        )
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
        LOGGER.debug(
            "Configured LagBasedPartitionAssignor with values:\n"
            "\tgroup.id = %s\n\tclient.id = %s\n\tsolver = %s",
            self._config.group_id,
            self._config.client_id,
            self._config.solver,
        )
        # Full derived metadata-consumer property map (reference :122-128).
        LOGGER.debug(
            "Derived metadata consumer properties:\n%s",
            "".join(
                f"\t{k} = {v}\n"
                for k, v in sorted(
                    self._config.metadata_consumer_props.items(),
                    key=lambda kv: kv[0],
                )
            ),
        )
        # Optional warm-up at consumer startup (tpu.assignor.warmup.shapes),
        # the sidecar's --warmup semantics: only the configured solver, and
        # only a device solver.  Best effort: a failing warm-up is logged
        # and never stops the consumer from starting.
        solver = self._config.solver
        if self._config.warmup_shapes and solver in DEVICE_SOLVERS:
            try:
                from .warmup import warmup

                for max_p, consumers, topics in self._config.warmup_shapes:
                    warmup(
                        max_partitions=max_p,
                        consumers=[consumers],
                        topics=[topics],
                        solvers=(solver,),
                        sinkhorn_iters=self._config.sinkhorn_iters,
                        refine_iters=self._config.refine_iters,
                        device=self.device,
                    )
            except Exception:
                LOGGER.warning(
                    "configure-time warm-up failed; continuing without it "
                    "(first rebalance may pay the kernel builds)",
                    exc_info=True,
                )
        elif self._config.warmup_shapes:
            LOGGER.info(
                "solver %r has no device executables; warmup.shapes ignored",
                self._config.solver,
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
            with profile_trace(self._config.profile):
                # The rebalance roots one client-kind trace: the lag read
                # and the solve (on its worker thread too) ride it.
                with metrics.request_scope(kind="client", root_name="client"):
                    group_assignment = self._assign_inner(
                        metadata, subscriptions, stats
                    )
        stats.wall_ms = wall[0]
        log_rebalance(stats)
        self.last_stats = stats
        # Registry + flight-recorder export: the structured record,
        # queryable after the rebalance.
        metrics.REGISTRY.histogram(
            "klba_rebalance_wall_ms", {"solver": stats.solver}
        ).observe(stats.wall_ms)
        metrics.FLIGHT.record(
            "rebalance",
            {
                "solver": stats.solver,
                "num_topics": stats.num_topics,
                "num_partitions": stats.num_partitions,
                "num_members": stats.num_members,
                "wall_ms": stats.wall_ms,
                "lag_read_ms": stats.lag_read_ms,
                "solve_ms": stats.solve_ms,
                "total_lag": stats.total_lag,
                "quality_ratio": stats.quality_ratio,
                "fallback_used": stats.fallback_used,
                "breaker_state": stats.breaker_state,
                "refine_iters": stats.refine_iters,
            },
        )
        if stats.fallback_used:
            # The ladder descended past its first rung: one incident, one
            # dump (a breaker trip in the same request already took it).
            metrics.FLIGHT.auto_dump(
                "ladder", {"method": "assign", "rung": "host_greedy"}
            )
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
            with metrics.span("assign.solve"):
                raw = self._solve(lags, topic_subscriptions, stats)
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
        # Per-topic breakdown + per-decision trace + per-topic debug
        # summary, all gated like the reference's isDebugEnabled guard
        # (:280), as in the JAX plugin.
        if LOGGER.isEnabledFor(logging.DEBUG):
            summarize_topics(stats, raw, lags)
            # The decision replay assumes per-topic sequential greedy:
            # only the parity solvers without a refine budget ('global'
            # carries totals across topics, 'sinkhorn' has no decision
            # sequence; the host rung of a parity solver is the greedy).
            refined = self._config.solver in (
                "rounds", "scan"
            ) and bool(self._config.refine_iters)
            if (
                self._config.solver in PARITY_SOLVERS
                and not refined
                and LOGGER.isEnabledFor(TRACE)
            ):
                trace_decisions(raw, lags, logger=LOGGER)
            log_topic_summaries(stats, raw, logger=LOGGER)

        return GroupAssignment(
            {member: Assignment(tuple(tps)) for member, tps in raw.items()}
        )

    def _solve(self, lags, topic_subscriptions, stats: RebalanceStats):
        # Device and native solves run under the watchdog: a wedged device
        # can HANG rather than raise, and a rebalance must never block past
        # its deadline.  The breaker key is the SOLVER, so a wedged
        # sinkhorn solve cannot banish the rounds kernel.
        options = {
            "sinkhorn_iters": self._config.sinkhorn_iters,
            "refine_iters": self._config.refine_iters,
        }
        raw = solve_on_ladder(
            self._config.solver, lags, topic_subscriptions, stats,
            watchdog=self._watchdog, host_fallback=self._config.host_fallback,
            options=options, device=self.device,
        )
        if stats.fallback_used:
            stats.refine_iters = None  # the host fallback never refines
            stats.device = None  # answered on the host
            metrics.REGISTRY.counter(
                "klba_ladder_rung_total",
                {"method": "assign", "rung": "host_greedy"},
            ).inc()
        return raw

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

    def reset_accelerator(self) -> None:
        """Clear a tripped solve watchdog so the next rebalance probes the
        device again (the trip also auto-expires after its cooldown)."""
        if self._watchdog is not None:
            self._watchdog.reset()
