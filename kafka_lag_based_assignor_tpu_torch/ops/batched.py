"""Batched (one launch over a topic group) round-decomposition solve, and the
transfer-lean single-topic stream path.

Counterpart of ``assign_batched_rounds``, ``_narrow_choice``,
``stream_payload`` and ``assign_stream`` in
``kafka_lag_based_assignor_tpu/ops/batched.py``, which vmaps the per-topic
solve.  Here the batch dimension is written out: one sort along the
partition axis of the [T, P] group and one round-scan launch with one
thread block per topic — BASELINE config 3 (256 topics x 64 partitions x 64
consumers) runs as a single launch instead of 256.  Per-topic independence
(SURVEY §2.4.3) makes the blocks independent.
"""

from __future__ import annotations

import numpy as np
import torch

from .packing import pad_bucket
from .rounds_kernel import assign_topic_rounds
from .scan_kernel import pack_shift_for


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


def _narrow_choice(choice: torch.Tensor, num_consumers: int) -> torch.Tensor:
    """The host-facing choice: int16 when every consumer index fits."""
    if num_consumers <= 32767:
        return choice.to(torch.int16)
    return choice


def stream_payload(lags: np.ndarray):
    """The upload dtype rule of the stream paths: int32 when the lag range
    allows (half the bytes; the device widens back to int64), else int64;
    and the packed-sort shift for the padded bucket.

    Returns (payload ndarray, pack_shift int)."""
    lags = np.ascontiguousarray(lags, dtype=np.int64)
    max_lag = int(lags.max()) if lags.size else 0
    shift = pack_shift_for(max_lag, pad_bucket(lags.shape[0]) - 1)
    if 0 <= max_lag < 2**31 and (lags.size == 0 or int(lags.min()) >= 0):
        return lags.astype(np.int32), shift
    return lags, shift


def assign_stream(lags: torch.Tensor, num_consumers: int, pack_shift: int = 0):
    """Greedy solve of one dense topic (partition ids 0..P-1, all valid).

    ``lags`` is the exact-size lag vector on the solve's device (int32 or
    int64); it is padded to ``pad_bucket(P)`` and solved by
    :func:`..ops.rounds_kernel.assign_topic_rounds` over ``ceil(P / C)``
    rounds, so on the card it launches the round-scan kernel.  Returns the
    narrowed choice[P] (int16 when C <= 32767), on the same device.
    """
    P = int(lags.shape[0])
    B = pad_bucket(P)
    dev = lags.device
    lags_p = torch.zeros(B, dtype=torch.int64, device=dev)
    lags_p[:P] = lags
    pids = torch.arange(B, dtype=torch.int32, device=dev)
    valid = pids < P
    choice, _, _ = assign_topic_rounds(
        lags_p, pids, valid, num_consumers, pack_shift=pack_shift, n_valid=P
    )
    return _narrow_choice(choice[:P], num_consumers)
