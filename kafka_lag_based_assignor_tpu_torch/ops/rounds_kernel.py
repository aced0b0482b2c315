"""Greedy LPT through the exact round decomposition.

Counterpart of ``kafka_lag_based_assignor_tpu/ops/rounds_kernel.py``.

**Theorem (round decomposition of count-primary greedy LPT).**  Each
partition, in descending-lag order, goes to the consumer minimizing
(assigned count, total assigned lag, member id)
(LagBasedPartitionAssignor.java:246-259).  Count is primary and every
consumer is eligible for every partition of the topic, so the process
splits into rounds of C consecutive partitions: at the start of round r
every consumer holds r partitions, and the j-th partition of the round goes
to the consumer with the (j+1)-th smallest (total lag, member id) at the
start of the round.  A round is: sort consumers by (total, id) and match
them positionally to the round's partitions.

The rounds run in :func:`..ops.rounds_cuda.rounds_scan`: the hand-written
kernel on the card, its plain PyTorch version on the CPU.

Pre-condition: all C consumers are eligible for the topic.  The host layer
guarantees this by passing, per group of topics with identical subscriber
sets (:mod:`.packing`), only those consumers, re-ranked densely.
"""

from __future__ import annotations

import math

import torch

from .rounds_cuda import rounds_scan
from .scan_kernel import sort_partitions_with
from .sortops import bincount_sorted, unsort


def round_rows(sorted_lags, sorted_valid, C: int, n_valid: int | None):
    """Trim (or pad) the sorted last axis to ceil(L / C) whole rounds, L the
    number of rows that may be valid (``n_valid``, default all): padding
    sorts last, so valid rows form a prefix.  Returns (lags_head,
    valid_head, R, head) with head == R * C."""
    P = sorted_lags.shape[-1]
    L = P if n_valid is None else min(int(n_valid), P)
    R = -(-L // C) if L else 0
    head = R * C
    if head <= P:
        return sorted_lags[..., :head], sorted_valid[..., :head], R, head
    pad = (*sorted_lags.shape[:-1], head - P)
    return (
        torch.cat([sorted_lags, sorted_lags.new_zeros(pad)], dim=-1),
        torch.cat([sorted_valid, sorted_valid.new_zeros(pad)], dim=-1),
        R,
        head,
    )


def _rounds_scan(
    sorted_lags, sorted_valid, totals0, C: int,
    n_valid: int | None = None, carry_across_topics: bool = False,
):
    """Scan the round decomposition over sorted partitions ([P] or [T, P]).

    ``totals0`` is every topic's starting per-consumer load (zeros for
    reference semantics).  ``carry_across_topics`` runs the topics' rounds
    as one sequence with the totals carried from topic to topic.  Rows past
    the scanned prefix are padding and get choice -1.

    Returns (totals int64[..., C] — [C] when carrying — and the choice
    int32[..., P] in sorted order).
    """
    lags_h, valid_h, R, head = round_rows(sorted_lags, sorted_valid, C, n_valid)
    batch = sorted_lags.shape[:-1]
    rows = (math.prod(batch), R, C)
    P = sorted_lags.shape[-1]
    choice, totals = rounds_scan(
        lags_h.reshape(rows).contiguous(),
        valid_h.reshape(rows).to(torch.uint8).contiguous(),
        totals0.contiguous(),
        carry_across_topics,
    )
    flat = choice.reshape(*batch, head)[..., : min(head, P)]
    if head < P:
        flat = torch.cat([flat, flat.new_full((*batch, P - head), -1)], dim=-1)
    totals = totals[0] if carry_across_topics else totals.reshape(*batch, C)
    return totals, flat


def _assign_rounds(lags, partition_ids, valid, num_consumers: int,
                   pack_shift: int, n_valid: int | None,
                   carry_across_topics: bool, sort_rows: int | None = None):
    C = int(num_consumers)
    perm, sorted_lags, sorted_valid = sort_partitions_with(
        lags, partition_ids, valid, pack_shift, sort_rows
    )
    totals0 = torch.zeros((C,), dtype=torch.int64, device=lags.device)
    totals, sorted_choice = _rounds_scan(
        sorted_lags, sorted_valid, totals0, C,
        n_valid=n_valid, carry_across_topics=carry_across_topics,
    )
    # The sorted copies are dead: the linear solve's greedy start runs this
    # beside the rounding tail's [P] buffers.
    del sorted_lags, sorted_valid
    counts = bincount_sorted(sorted_choice, C)
    return unsort(perm, sorted_choice), counts, totals


def assign_topic_rounds(
    lags: torch.Tensor,
    partition_ids: torch.Tensor,
    valid: torch.Tensor,
    num_consumers: int,
    pack_shift: int = 0,
    n_valid: int | None = None,
    sort_rows: int | None = None,
):
    """Assign partitions via the round decomposition, each topic on its own.

    Args: lags int64[..., P], partition_ids int32[..., P], valid
    bool[..., P] (one topic, or a [T, P] batch of independent topics);
    ``pack_shift`` as in :func:`..ops.scan_kernel.pack_shift_for`;
    ``n_valid`` an upper bound on any topic's valid rows (the scan stops
    after ceil(n_valid / C) rounds; rows past it are padding);
    ``sort_rows`` bounds the rows one sort of a single topic's processing
    order takes at a time (:func:`.scan_kernel.sort_partitions_with`).

    Returns (choice int32[..., P] in input order, counts int32[..., C],
    totals int64[..., C]).
    """
    return _assign_rounds(
        lags, partition_ids, valid, num_consumers, pack_shift, n_valid,
        carry_across_topics=False, sort_rows=sort_rows,
    )


def assign_presorted_rounds(sorted_lags: torch.Tensor, perm: torch.Tensor,
                            num_consumers: int):
    """Round decomposition over a host-presorted dense topic: every row
    valid, the exact shape (no pad), so the scan runs the minimum
    ceil(P / C) rounds.

    Args: sorted_lags [P] in processing order (lag descending, ties by
    partition id), perm int[P] the permutation that produced it.  Returns
    (choice int32[P] in input order, counts int32[C], totals int64[C]).
    """
    P = sorted_lags.shape[0]
    C = int(num_consumers)
    dev = sorted_lags.device
    totals0 = torch.zeros((C,), dtype=torch.int64, device=dev)
    totals, sorted_choice = _rounds_scan(
        sorted_lags.to(torch.int64), torch.ones((P,), dtype=torch.bool, device=dev),
        totals0, C,
    )
    return (
        unsort(perm.to(torch.int64), sorted_choice),
        bincount_sorted(sorted_choice, C),
        totals,
    )


def assign_global_rounds(
    lags: torch.Tensor,
    partition_ids: torch.Tensor,
    valid: torch.Tensor,
    num_consumers: int,
    pack_shift: int = 0,
    n_valid: int | None = None,
):
    """Cross-topic global-balance quality mode (beyond-reference feature).

    Keeps the per-topic **count** invariant (max - min <= 1 per topic) but
    carries the lag-tiebreak totals **across topics** in topic order: the
    round theorem holds unchanged with a non-zero starting load.  The whole
    [T, P] group is one sequence of T * R rounds in one thread block.

    Args as :func:`assign_topic_rounds` on a [T, P] batch.  Returns (choice
    int32[T, P], counts int32[T, C], totals int64[C] — the single global
    vector).
    """
    return _assign_rounds(
        lags, partition_ids, valid, num_consumers, pack_shift, n_valid,
        carry_across_topics=True,
    )
