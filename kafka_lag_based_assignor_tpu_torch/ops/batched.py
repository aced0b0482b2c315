"""Batched (one launch over a topic group) round-decomposition solve.

Counterpart of ``assign_batched_rounds`` in
``kafka_lag_based_assignor_tpu/ops/batched.py``, which vmaps the per-topic
solve.  Here the batch dimension is written out: one sort along the
partition axis of the [T, P] group and one round-scan launch with one
thread block per topic — BASELINE config 3 (256 topics x 64 partitions x 64
consumers) runs as a single launch instead of 256.  Per-topic independence
(SURVEY §2.4.3) makes the blocks independent.
"""

from __future__ import annotations

import torch

from .rounds_kernel import assign_topic_rounds


def assign_batched_rounds(
    lags: torch.Tensor,
    partition_ids: torch.Tensor,
    valid: torch.Tensor,
    num_consumers: int,
    pack_shift: int = 0,
    n_valid: int | None = None,
):
    """Rounds solve over a topic batch.

    Args: lags int64[T, P], partition_ids int32[T, P], valid bool[T, P];
    ``pack_shift`` as in :func:`..ops.scan_kernel.pack_shift_for`;
    ``n_valid`` an upper bound on any topic's valid rows.
    Returns (choice int32[T, P], counts int32[T, C], totals int64[T, C]).
    """
    if lags.dim() != 2:
        raise ValueError(f"lags must be [T, P], got {list(lags.shape)}")
    return assign_topic_rounds(
        lags, partition_ids, valid, num_consumers,
        pack_shift=pack_shift, n_valid=n_valid,
    )
