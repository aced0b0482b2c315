"""Structured rebalance record.

A copy of ``stopwatch``, ``RebalanceStats``, ``count_constrained_bound`` and
``summarize_assignment`` from
``kafka_lag_based_assignor_tpu/utils/observability.py``, so that
``last_stats.quality_ratio`` means the same thing in both packages.  The
per-topic breakdowns, decision traces and the metrics registry come with the
port's observability slice.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np


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
    # does not refine, or "auto").
    refine_iters: Optional[int] = None
    total_lag: int = 0
    # Per-member totals across all topics (host-aggregated).
    member_total_lag: Dict[str, int] = field(default_factory=dict)
    member_partition_count: Dict[str, int] = field(default_factory=dict)
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


@contextlib.contextmanager
def stopwatch() -> Iterator[List[float]]:
    """``with stopwatch() as t: ...`` -> ``t[0]`` is elapsed milliseconds."""
    out = [0.0]
    start = time.perf_counter()
    try:
        yield out
    finally:
        out[0] = (time.perf_counter() - start) * 1000.0
