"""Batched (one launch over a topic group) solves, their exchange
refinement, and the transfer-lean single-topic stream path.

Counterpart of ``_maybe_refine``, ``assign_batched_rounds``, ``assign_batched_scan``, ``_narrow_choice``,
``stream_payload``, ``assign_stream``, ``refine_batched`` and
``assign_stream_refined`` in ``kafka_lag_based_assignor_tpu/ops/batched.py``,
which vmaps the per-topic solve.  Here the batch dimension is written out:
one sort along the partition axis of the [T, P] group and one kernel launch
with one thread block per topic — BASELINE config 3 (256 topics x 64
partitions x 64 consumers) runs as a single launch instead of 256.
Per-topic independence (SURVEY §2.4.3) makes the blocks independent.

Refinement is routed as in the JAX package: the batched solves refine with
the oracle :func:`..ops.refine.refine_assignment` over the whole batch; the
stream path with the resident rounds (:func:`_maybe_refine`).  A budget of
0 leaves the greedy answer as it is (strict parity with the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from .packing import pad_bucket, table_rows
from .refine import build_choice_tables, refine_assignment, refine_rounds_resident
from .rounds_kernel import assign_topic_rounds
from .scan_kernel import assign_topic_scan, pack_shift_for


def _maybe_refine(lags, valid, choice, num_consumers: int, iters: int):
    """The stream path's refinement: ``iters`` resident rounds on one
    topic's greedy choice (0: the choice as it is).  The resident rounds'
    selection is bit-identical to :func:`..ops.refine.refine_assignment`'s,
    and a greedy solve's count-balanced output always fits the table."""
    if not iters:
        return choice
    row_tab, counts, totals = build_choice_tables(
        lags, valid, choice, num_consumers, table_rows(lags.shape[0], num_consumers)
    )
    return refine_rounds_resident(
        lags, choice, row_tab, counts, totals, num_consumers=num_consumers, iters=iters,
    )[0]


def assign_batched_rounds(
    lags: torch.Tensor,
    partition_ids: torch.Tensor,
    valid: torch.Tensor,
    num_consumers: int,
    pack_shift: int = 0,
    n_valid: int | None = None,
    refine_iters: int = 0,
):
    """Rounds solve over a topic batch.

    Args: lags int64[T, P], partition_ids int32[T, P], valid bool[T, P];
    ``pack_shift`` as in :func:`..ops.scan_kernel.pack_shift_for`;
    ``n_valid`` an upper bound on any topic's valid rows; ``refine_iters``
    rounds of exchange refinement after the greedy solve (0: none, strict
    parity with the reference).
    Returns (choice int32[T, P], counts int32[T, C], totals int64[T, C]).
    """
    if lags.dim() != 2:
        raise ValueError(f"lags must be [T, P], got {list(lags.shape)}")
    out = assign_topic_rounds(
        lags, partition_ids, valid, num_consumers,
        pack_shift=pack_shift, n_valid=n_valid,
    )
    if refine_iters:
        out = refine_assignment(lags, valid, out[0], num_consumers, iters=refine_iters)
    return out


def assign_batched_scan(
    lags: torch.Tensor,
    partition_ids: torch.Tensor,
    valid: torch.Tensor,
    num_consumers: int,
    pack_shift: int = 0,
    refine_iters: int = 0,
):
    """The P-step scan over a topic batch (same contract, ``refine_iters``
    included, as :func:`assign_batched_rounds`; the scan stops after each
    topic's valid rows on its own)."""
    if lags.dim() != 2:
        raise ValueError(f"lags must be [T, P], got {list(lags.shape)}")
    out = assign_topic_scan(lags, partition_ids, valid, num_consumers,
                            pack_shift=pack_shift)
    if refine_iters:
        out = refine_assignment(lags, valid, out[0], num_consumers, iters=refine_iters)
    return out


def refine_batched(lags, valid, choice, num_consumers: int, iters: int):
    """The exchange refinement of an existing batch assignment.

    Args: lags int64[T, P], valid bool[T, P], choice int32[T, P] (count
    balanced, e.g. a batched solve's).  Returns (choice int32[T, P], counts
    int32[T, C], totals int64[T, C]): each topic's count spread kept, its
    max/mean lag imbalance tightened; each topic stops on its own, as the
    JAX package's vmapped while-loop does."""
    return refine_assignment(lags, valid, choice, num_consumers, iters=iters)


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


def assign_stream(lags: torch.Tensor, num_consumers: int, pack_shift: int = 0,
                  refine_iters: int = 0):
    """Greedy solve of one dense topic (partition ids 0..P-1, all valid).

    ``lags`` is the exact-size lag vector on the solve's device (int32 or
    int64); it is padded to ``pad_bucket(P)`` and solved by
    :func:`..ops.rounds_kernel.assign_topic_rounds` over ``ceil(P / C)``
    rounds, so on the card it launches the round-scan kernel; then
    ``refine_iters`` resident refine rounds (:func:`_maybe_refine`, 0: none).
    Returns the narrowed choice[P] (int16 when C <= 32767), on the same
    device.
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
    choice = _maybe_refine(lags_p, valid, choice, num_consumers, refine_iters)
    return _narrow_choice(choice[:P], num_consumers)


def assign_stream_refined(lags: torch.Tensor, num_consumers: int,
                          refine_iters: int = 64):
    """The quality variant of :func:`assign_stream`: the greedy round scan,
    then ``refine_iters`` resident refine rounds.  The count invariant is
    the greedy one; the max/mean imbalance is tightened, so the answer is
    not the reference's (the default solver's opt-in quality mode).
    Returns the narrowed choice[P]."""
    return assign_stream(lags, num_consumers, refine_iters=int(refine_iters))
