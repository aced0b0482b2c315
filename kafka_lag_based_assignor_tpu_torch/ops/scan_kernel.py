"""Processing order of a topic's partitions, and the P-step greedy scan.

Counterpart of ``pack_shift_for``, ``sort_partitions``,
``sort_partitions_with``, ``_argmin_consumer`` and ``assign_topic_scan`` in
``kafka_lag_based_assignor_tpu/ops/scan_kernel.py``.  The reference's hot
loop (LagBasedPartitionAssignor.java:237-277) processes partitions in
descending lag, ties by ascending partition id (:228-235), padding rows last,
and gives each to the consumer with the least (assigned count, total
assigned lag, member rank) (:246-259).  :func:`assign_topic_scan` states that
loop directly: P dependent steps, each a lexicographic argmin over the
consumers.  It is the always-correct reference path; the round
decomposition (:mod:`.rounds_kernel`) is the fast one and gives the same
answer.  The steps run in :func:`..ops.scan_cuda.scan_greedy`: the
hand-written kernel on the card, its plain PyTorch version on the CPU.

Conventions (shared by every kernel in :mod:`..ops`):

* consumers are dense indices ``0..C-1`` = rank in the lexicographically
  sorted member-id list, so "lowest index" == "lexicographically smallest
  member id" and integer ties reproduce the string tie-break exactly;
* ``lags`` are non-negative (the lag formula clamps, reference :400-402);
* padding rows have ``valid=False`` and are ignored;
* ``choice[i]`` is the consumer index for input row ``i`` (input order, NOT
  sorted order), ``-1`` for padding rows.
"""

from __future__ import annotations

import torch

from .sortops import unsort

_INT64_MAX = torch.iinfo(torch.int64).max
_INT32_MAX = torch.iinfo(torch.int32).max


def pack_shift_for(max_lag: int, max_pid: int) -> int:
    """Pick the pid bit-shift for a packed single-key processing-order sort,
    or 0 if the value ranges make packing unsafe.

    The packed key is ``-(lag << shift) + pid``: lag descending is the
    primary order, pid ascending breaks ties (reference :228-235) — valid
    whenever every pid fits in ``shift`` bits and ``lag << shift`` cannot
    overflow int64.  0 selects the general two-key sort.
    """
    shift = max(1, int(max_pid)).bit_length()
    if int(max_lag) < (1 << (62 - shift)):
        return shift
    return 0


def sort_partitions(
    lags: torch.Tensor,
    partition_ids: torch.Tensor,
    valid: torch.Tensor,
    pack_shift: int = 0,
) -> torch.Tensor:
    """The processing-order permutation alone (int64[..., P]): lag
    descending, partition id ascending, padding last.  The packed and the
    two-key sorts give the same permutation."""
    return sort_partitions_with(lags, partition_ids, valid, pack_shift)[0]


def sort_partitions_with(
    lags: torch.Tensor,
    partition_ids: torch.Tensor,
    valid: torch.Tensor,
    pack_shift: int = 0,
):
    """The processing-order permutation along the last axis, with the lags
    and validity gathered in that order.

    ``pack_shift`` > 0 (from :func:`pack_shift_for`) sorts one packed int64
    key; 0 runs two stable sorts, partition id then negated lag, which is
    the lexicographic (lag desc, pid asc) order.  Both are stable, so rows
    with equal keys (the padding) keep their input order, as the JAX
    package's stable ``lax.sort`` does: the permutations are identical.

    Returns (perm int64[..., P], sorted_lags, sorted_valid).
    """
    if pack_shift:
        key = torch.where(
            valid,
            -(lags << pack_shift) + partition_ids.to(torch.int64),
            _INT64_MAX,
        )
        _, perm = torch.sort(key, dim=-1, stable=True)
    else:
        neg_lag = torch.where(valid, -lags, 1)
        pid_key = torch.where(valid, partition_ids, _INT32_MAX)
        _, by_pid = torch.sort(pid_key, dim=-1, stable=True)
        _, by_lag = torch.sort(neg_lag.gather(-1, by_pid), dim=-1, stable=True)
        perm = by_pid.gather(-1, by_lag)
    return perm, lags.gather(-1, perm), valid.gather(-1, perm)


def _argmin_consumer(counts: torch.Tensor, totals: torch.Tensor,
                     eligible: torch.Tensor) -> torch.Tensor:
    """Lexicographic argmin over (count, total lag, index) of the eligible
    consumers along the last axis, as the reference's comparator
    (:246-259): least count, then least total (int64, signed), then least
    index, which the rank convention makes the least member id.  Two masked
    minima and a first-index argmax, as in the JAX package.  Returns
    int64[...]."""
    key1 = torch.where(eligible, counts, _INT32_MAX)
    mask1 = key1 == key1.min(dim=-1, keepdim=True).values
    key2 = torch.where(mask1, totals, _INT64_MAX)
    mask2 = mask1 & (key2 == key2.min(dim=-1, keepdim=True).values)
    return torch.argmax(mask2.to(torch.int32), dim=-1)  # the first True


def assign_topic_scan(
    lags: torch.Tensor,
    partition_ids: torch.Tensor,
    valid: torch.Tensor,
    num_consumers: int,
    eligible: torch.Tensor | None = None,
    pack_shift: int = 0,
):
    """Assign each topic's partitions by the P-step greedy scan.

    Args: lags int64[..., P], partition_ids int32[..., P], valid
    bool[..., P] (one topic, or a [T, P] batch of independent topics);
    ``num_consumers`` C; ``eligible`` an optional bool[C]: ineligible
    consumers never receive a partition, and with none eligible every row
    gets -1 (default: all eligible); ``pack_shift`` as in
    :func:`pack_shift_for` (either sort form gives the same order).

    Returns (choice int32[..., P] in input order with -1 on padding, counts
    int32[..., C], totals int64[..., C]).
    """
    from .scan_cuda import scan_greedy

    C = int(num_consumers)
    P = lags.shape[-1]
    batch = lags.shape[:-1]
    perm, sorted_lags, sorted_valid = sort_partitions_with(
        lags, partition_ids, valid, pack_shift
    )
    if eligible is not None:
        eligible = eligible.to(device=lags.device, dtype=torch.uint8).contiguous()
    sorted_choice, counts, totals = scan_greedy(
        sorted_lags.reshape(-1, P).contiguous(),
        sorted_valid.reshape(-1, P).to(torch.uint8).contiguous(),
        C, eligible,
    )
    return (
        unsort(perm, sorted_choice.reshape(*batch, P)),
        counts.reshape(*batch, C),
        totals.reshape(*batch, C),
    )
