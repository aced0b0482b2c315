"""Test double (an in-memory broker client) and the BASELINE workloads.

``FakeBroker`` is a copy of the one in
``kafka_lag_based_assignor_tpu/testing.py``.  It implements the
:class:`..lag.MetadataConsumer` protocol, so the lag reader and the full
plugin adapter run without a broker; the tests and ``chip_smoke.py`` use it
as their workload source.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from .types import (
    Cluster,
    OffsetAndMetadata,
    PartitionInfo,
    TopicPartition,
    TopicPartitionLag,
)


@dataclass
class FakeBroker:
    """In-memory offsets store implementing the MetadataConsumer protocol.

    ``raise_on`` simulates broker RPC failures: any listed method raises,
    letting tests assert that exceptions propagate and fail the rebalance
    (reference has no try/catch around the RPCs, SURVEY §2.4.9).
    """

    begin: Dict[TopicPartition, int] = field(default_factory=dict)
    end: Dict[TopicPartition, int] = field(default_factory=dict)
    committed_offsets: Dict[TopicPartition, Optional[OffsetAndMetadata]] = field(
        default_factory=dict
    )
    raise_on: Set[str] = field(default_factory=set)
    calls: list = field(default_factory=list)

    def beginning_offsets(
        self, partitions: Sequence[TopicPartition]
    ) -> Mapping[TopicPartition, int]:
        self.calls.append("beginning_offsets")
        if "beginning_offsets" in self.raise_on:
            raise TimeoutError("simulated broker timeout (ListOffsets)")
        return {tp: self.begin.get(tp, 0) for tp in partitions}

    def end_offsets(
        self, partitions: Sequence[TopicPartition]
    ) -> Mapping[TopicPartition, int]:
        self.calls.append("end_offsets")
        if "end_offsets" in self.raise_on:
            raise TimeoutError("simulated broker timeout (ListOffsets)")
        return {tp: self.end.get(tp, 0) for tp in partitions}

    def committed(
        self, partitions: Set[TopicPartition]
    ) -> Mapping[TopicPartition, Optional[OffsetAndMetadata]]:
        self.calls.append("committed")
        if "committed" in self.raise_on:
            raise TimeoutError("simulated broker timeout (OffsetFetch)")
        return {tp: self.committed_offsets.get(tp) for tp in partitions}

    # -- builder helpers ---------------------------------------------------

    def with_partition(
        self,
        topic: str,
        partition: int,
        end: int,
        committed: Optional[int] = None,
        begin: int = 0,
    ) -> "FakeBroker":
        tp = TopicPartition(topic, partition)
        self.begin[tp] = begin
        self.end[tp] = end
        if committed is not None:
            self.committed_offsets[tp] = OffsetAndMetadata(committed)
        return self

    def cluster(self) -> Cluster:
        """A Cluster whose metadata covers every partition this broker knows."""
        topics: Dict[str, list] = {}
        for tp in self.end:
            topics.setdefault(tp.topic, []).append(
                PartitionInfo(tp.topic, tp.partition)
            )
        for infos in topics.values():
            infos.sort(key=lambda p: p.partition)
        return Cluster(topics)


# -- BASELINE workloads ----------------------------------------------------
#
# The configurations of BASELINE.json, generated from a seed the way
# bench.py generates them, so the tests and chip_smoke.py solve the same
# inputs as the JAX package's benchmark.


def zipf_lags(rng: np.random.Generator, P: int, a: float = 1.1,
              scale: int = 1000) -> np.ndarray:
    """Bounded Zipf(a) lags by inverse-power sampling (bench.py's)."""
    ranks = rng.permutation(P) + 1
    return (scale * (P / ranks) ** (1.0 / a)).astype(np.int64)


def baseline_workload(
    config: int, partitions: Optional[int] = None,
    consumers: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """(lags by topic, member ids) of BASELINE config 1, 2, 3, 4 or 5.

    1: the README case, 3 partitions (100k / 50k / 60k), 2 consumers;
    2: 1 topic, 1k partitions, 16 consumers, Zipf(1.1);
    3: 256 topics x 64 partitions, 64 consumers, uniform lag;
    4: 1 topic, 10k partitions, 512 consumers, 90 % zero lag and 10 % hot
       partitions with lags uniform in [1e5, 1e7);
    5: 1 topic, 100k partitions, 1k consumers, Zipf(1.1).
    ``partitions`` / ``consumers`` cut config 5 to size.
    """
    if config == 1:
        lags = {"t0": np.array([100_000, 50_000, 60_000], np.int64)}
        return lags, ["C0", "C1"]
    if config == 2:
        lags = {"t0": zipf_lags(np.random.default_rng(2), 1000)}
        C = 16
    elif config == 3:
        rng = np.random.default_rng(3)
        table = rng.integers(0, 1000, size=(256, 64)).astype(np.int64)
        lags = {f"t{t:03d}": table[t] for t in range(256)}
        C = 64
    elif config == 4:
        rng = np.random.default_rng(4)
        P, C = 10_000, 512
        skew = np.zeros(P, dtype=np.int64)
        hot = rng.choice(P, size=P // 10, replace=False)
        skew[hot] = rng.integers(10**5, 10**7, size=hot.size)
        lags = {"t0": skew}
    elif config == 5:
        P = 100_000 if partitions is None else partitions
        lags = {"t0": zipf_lags(np.random.default_rng(5), P)}
        C = 1000 if consumers is None else consumers
    else:
        raise ValueError(f"no BASELINE config {config} (1 to 5)")
    return lags, [f"consumer-{i:04d}" for i in range(C)]


def broker_for(lags: Mapping[str, np.ndarray]) -> FakeBroker:
    """A broker whose committed offsets sit ``lag`` behind the end."""
    broker = FakeBroker()
    for topic, arr in lags.items():
        for p, lag in enumerate(arr.tolist()):
            broker.with_partition(topic, p, end=lag, committed=0)
    return broker


def lag_rows(lags: Mapping[str, np.ndarray]) -> Dict[str, List[TopicPartitionLag]]:
    """The lag reader's output for ``lags``: topic -> per-partition rows."""
    return {
        topic: [TopicPartitionLag(topic, p, lag) for p, lag in enumerate(arr.tolist())]
        for topic, arr in lags.items()
    }


# -- the BASELINE config-5 streaming schedule -------------------------------


def stream_lags0(partitions: int = 100_000, seed: int = 5):
    """(rng, lags0): config 5's starting lags, ``zipf_lags(default_rng(5),
    100000)`` as bench.py makes them, and the generator that then drives
    :func:`stream_drift`, in the same state as bench.py's."""
    rng = np.random.default_rng(seed)
    return rng, zipf_lags(rng, partitions)


def stream_drift(rng: np.random.Generator, lags: np.ndarray, epoch: int,
                 choice: np.ndarray, num_consumers: int) -> np.ndarray:
    """One epoch of bench.py's config-5 drift (float64 lags in and out;
    the engine is given ``lags.astype(np.int64)``).  Every epoch drifts
    each lag by a lognormal(0, 0.2) factor plus uniform noise; at epoch 5
    the 100 hottest partitions drain to 2 %; from epoch 5 on the partitions
    of the consumer at the median load under ``choice`` heat up by 1.5x."""
    P = lags.shape[0]
    drift = rng.lognormal(0.0, 0.2, size=P)
    lags = lags * drift + rng.integers(0, 1000, size=P)
    if epoch == 5:
        top = np.argsort(lags)[-100:]
        lags[top] *= 0.02
    if epoch >= 5:
        totals = np.bincount(
            choice.astype(np.int64), weights=lags, minlength=num_consumers
        )
        mid = np.argsort(totals)[num_consumers // 2]
        lags[choice == mid] *= 1.5
    return lags


# -- checks shared by the restart tests and chip_smoke.py -------------------


def shed_totals_by_class() -> Dict[Optional[str], float]:
    """Current ``klba_shed_total`` value per class, summed over rungs."""
    from .utils import metrics

    out: Dict[Optional[str], float] = {}
    for counter in metrics.REGISTRY.series("klba_shed_total"):
        klass = counter.labels.get("class")
        out[klass] = out.get(klass, 0) + counter.value
    return out


def assert_valid_assignment(assignments, expect_partitions: int) -> None:
    """Count-balanced (max - min <= 1), complete, no duplicates."""
    sizes = [len(v) for v in assignments.values()]
    got = [tuple(tp) for tps in assignments.values() for tp in tps]
    assert sorted(got) == sorted(set(got)), "duplicate partitions"
    assert len(got) == expect_partitions, (len(got), expect_partitions)
    assert max(sizes) - min(sizes) <= 1, sizes


def choice_from_assignments(assignments, members, partitions: int) -> np.ndarray:
    """Decode a wire ``assignments`` dict back into the dense
    partition->consumer-index vector the engine reasons in (int32[P], -1
    for unassigned)."""
    midx = {m: j for j, m in enumerate(members)}
    choice = np.full(partitions, -1, np.int32)
    for m, tps in assignments.items():
        for _t, p in tps:
            choice[p] = midx[m]
    return choice


def moved_fraction(prev_choice, choice) -> float:
    """Fraction of partitions whose owner changed between two epochs'
    decoded choice vectors (the wire-level churn observable)."""
    prev = np.asarray(prev_choice)
    cur = np.asarray(choice)
    if prev.shape != cur.shape or prev.size == 0:
        return 1.0
    return float(np.count_nonzero(prev != cur)) / prev.size
