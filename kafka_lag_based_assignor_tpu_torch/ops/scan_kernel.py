"""Processing order of a topic's partitions.

Counterpart of ``pack_shift_for`` and ``sort_partitions_with`` in
``kafka_lag_based_assignor_tpu/ops/scan_kernel.py``.  The reference's hot
loop (LagBasedPartitionAssignor.java:237-277) processes partitions in
descending lag, ties by ascending partition id (:228-235), padding rows last.

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
