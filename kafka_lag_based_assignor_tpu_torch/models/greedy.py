"""Host-side greedy LPT oracle — the reference-semantics ground truth.

A copy of ``kafka_lag_based_assignor_tpu/models/greedy.py``.  This is the
pure assignment core (layer L3 of the reference,
LagBasedPartitionAssignor.java:166-308) re-stated as a plain Python function.
It exists for three reasons:

1. **Oracle** for differential testing of the device kernels (bit-exact
   parity).
2. The ``host`` solver of the plugin adapter, and its host rung: the
   answer when a device solve fails, times out or is rejected by its
   breaker (:func:`host_fallback_for`).
3. Executable specification of the semantics the kernels must reproduce
   (SURVEY §2.4): count-primary / lag-secondary / member-id-tertiary
   selection, lag-descending / partition-id-ascending processing order,
   per-topic independence, every member present in the output.

Unlike the reference, the input lag lists are NOT mutated (SURVEY §2.4.10
calls the in-place sort an implementation wart, not a contract).

Defined domain: per-topic TOTAL lag < 2**63.  Beyond that the Java
reference's ``long`` accumulator (reference :216-219, :266) silently wraps
— as do the device kernels' int64 totals — while this oracle's Python ints
keep exact counts, so bit-parity is only meaningful (and only asserted)
inside the int64 domain.  Kafka lags are message counts; real totals sit
many orders of magnitude below the bound.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

from ..types import AssignmentMap, TopicPartition, TopicPartitionLag


def consumers_per_topic(
    subscriptions: Mapping[str, Sequence[str]],
) -> Dict[str, List[str]]:
    """Invert member->topics into topic->members (reference :410-426).

    Member order within each topic list follows the iteration order of
    ``subscriptions`` — irrelevant to the result because selection ends in a
    total order over member ids (SURVEY §2.4.2).
    """
    result: Dict[str, List[str]] = {}
    for member_id, topics in subscriptions.items():
        for topic in topics:
            result.setdefault(topic, []).append(member_id)
    return result


def assign_topic_greedy(
    assignment: AssignmentMap,
    topic: str,
    consumers: Sequence[str],
    partition_lags: Sequence[TopicPartitionLag],
    total_lag: Dict[str, int] | None = None,
) -> None:
    """Greedy LPT for one topic, appended into ``assignment`` in place.

    Exact reference semantics (:204-308): process partitions in descending
    lag (ties: ascending partition id); each partition goes to the consumer
    minimizing (assigned count, total assigned lag, member id).

    ``total_lag`` defaults to a fresh all-zero accumulator — the reference's
    topic-local ``consumerTotalLags`` (:216, SURVEY §2.4.3).  Passing a
    shared dict (updated in place) carries the lag tiebreak across calls,
    which is how :func:`assign_greedy_global` implements the cross-topic
    quality mode; count stays topic-local (primary criterion) either way.
    """
    if not consumers:
        return

    if total_lag is None:
        total_lag = {m: 0 for m in consumers}
    total_count = {m: 0 for m in consumers}

    ordered = sorted(partition_lags, key=lambda p: (-p.lag, p.partition))
    for part in ordered:
        member = min(consumers, key=lambda m: (total_count[m], total_lag[m], m))
        assignment[member].append(TopicPartition(part.topic, part.partition))
        total_lag[member] += part.lag
        total_count[member] += 1


def assign_greedy_global(
    partition_lag_per_topic: Mapping[str, Sequence[TopicPartitionLag]],
    subscriptions: Mapping[str, Sequence[str]],
) -> AssignmentMap:
    """Cross-topic global-balance quality mode — host oracle/fallback.

    Beyond-reference feature (the reference keeps ``consumerTotalLags``
    local to each topic, :216, SURVEY §2.4.3).  Selection is still
    (per-TOPIC count, total lag, member id) — so the per-topic count
    invariant max − min ≤ 1 is preserved — but the lag totals accumulate
    across all topics **within a subscriber-set group** (topics whose
    subscriber sets are identical), mirroring exactly the scope the device
    kernel's carried scan covers (:func:`..ops.rounds_kernel.assign_global_rounds`
    via :func:`..ops.packing.build_groups`).  Topics are processed in global
    sorted order with one shared accumulator per group, so per-member list
    order matches the device dispatch path bit-for-bit.
    """
    assignment: AssignmentMap = {member: [] for member in subscriptions}
    by_topic = consumers_per_topic(subscriptions)

    # Topics in global sorted order (the same append order as assign_greedy
    # and the device dispatch), with one shared lag accumulator per
    # subscriber-set group — totals only ever interact within a group, so
    # interleaving groups is equivalent to processing them separately.
    group_totals: Dict[tuple, Dict[str, int]] = {}
    for topic in sorted(by_topic):
        members = tuple(sorted(set(by_topic[topic])))
        if not members or not partition_lag_per_topic.get(topic):
            continue
        totals = group_totals.setdefault(members, {m: 0 for m in members})
        assign_topic_greedy(
            assignment,
            topic,
            members,
            partition_lag_per_topic[topic],
            total_lag=totals,
        )
    return assignment


def host_fallback_for(solver: str):
    """The host solver the plugin answers from when a device (or
    ``native``) solve fails, times out or is rejected by its breaker.

    Exactness of the fallback depends on the solver: ``global`` keeps its
    semantics exactly (:func:`assign_greedy_global` is the same algorithm
    on the host); the reference-parity solvers (``rounds``/``scan``/
    ``native``) fall back to :func:`assign_greedy`, which is bit-identical
    to them.  ``sinkhorn`` has no host equivalent — its fallback is
    :func:`assign_greedy`, a *quality downgrade* (OT-optimized balance ->
    4/3-approximation greedy) that still satisfies every invariant (count
    spread <= 1, determinism).  Callers see the downgrade via
    ``RebalanceStats.fallback_used`` plus the warning log.  Both are the
    Python reference greedy: the host rung never runs a kernel's plain
    PyTorch version and never moves the solve to the CPU device."""
    return assign_greedy_global if solver == "global" else assign_greedy


def assign_greedy(
    partition_lag_per_topic: Mapping[str, Sequence[TopicPartitionLag]],
    subscriptions: Mapping[str, Sequence[str]],
) -> AssignmentMap:
    """The pure core: (topic lags, member subscriptions) -> member assignments.

    Parity points with reference :166-188:
    * every member appears in the output, possibly with an empty list (:171-174);
    * topics missing from the lag map assign nothing (:182);
    * topics are independent — lag is never balanced across topics (§2.4.3).

    Topics are processed in sorted order for run-to-run determinism of the
    *per-member partition list order* (the reference's order depends on
    HashMap iteration; the assignment *content* is order-independent).
    """
    assignment: AssignmentMap = {member: [] for member in subscriptions}
    by_topic = consumers_per_topic(subscriptions)
    for topic in sorted(by_topic):
        assign_topic_greedy(
            assignment,
            topic,
            by_topic[topic],
            partition_lag_per_topic.get(topic, ()),
        )
    return assignment
