"""Batched (one launch over a topic group) solves, their exchange
refinement, and the transfer-lean single-topic stream path.

Counterpart of ``_maybe_refine``, ``assign_batched_rounds``, ``assign_batched_scan``, ``_narrow_choice``,
``stream_payload``, ``assign_stream``, ``refine_batched``,
``assign_stream_refined``, ``_stream_presorted``, ``totals_rank_bits_for``,
``_dense_batch_inputs``, ``assign_stream_batch`` and
``assign_stream_global`` in ``kafka_lag_based_assignor_tpu/ops/batched.py``,
which vmaps the per-topic solve.  Here the batch dimension is written out:
one sort along the partition axis of the [T, P] group and one kernel launch
with one thread block per topic — BASELINE config 3 (256 topics x 64
partitions x 64 consumers) runs as a single launch instead of 256.
Per-topic independence (SURVEY §2.4.3) makes the blocks independent.

The dense one-shot paths (:func:`assign_stream_batch`,
:func:`assign_stream_global`) take the [T, P] lag matrix alone and launch
the round-scan kernel once: one block per topic, or the global mode's one
block with the totals carried across topics.  Where the JAX package probes
its Pallas kernels and falls back to XLA, the port has no probe: the kernel
launches or raises, and inputs outside its limits raise ``ValueError`` on
both devices (:func:`..ops.rounds_cuda.rounds_scan`).

Refinement is routed as in the JAX package: the batched solves refine with
the oracle :func:`..ops.refine.refine_assignment` over the whole batch; the
stream path with the resident rounds (:func:`_maybe_refine`).  A budget of
0 leaves the greedy answer as it is (strict parity with the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .packing import pad_bucket, table_rows
from .refine import build_choice_tables, refine_assignment, refine_rounds_resident
from .rounds_kernel import (
    assign_global_rounds,
    assign_presorted_rounds,
    assign_topic_rounds,
)
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
    lag_range: tuple | None = None,
):
    """The P-step scan over a topic batch (same contract, ``refine_iters``
    included, as :func:`assign_batched_rounds`; the scan stops after each
    topic's valid rows on its own; ``lag_range`` as
    :func:`..ops.scan_cuda.scan_greedy` takes it)."""
    if lags.dim() != 2:
        raise ValueError(f"lags must be [T, P], got {list(lags.shape)}")
    out = assign_topic_scan(lags, partition_ids, valid, num_consumers,
                            pack_shift=pack_shift, lag_range=lag_range)
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


def stream_payload(lags: np.ndarray, partition_axis: int = 0):
    """The upload dtype rule of the stream paths: int32 when the lag range
    allows (half the bytes; the device widens back to int64), else int64;
    and the packed-sort shift for the padded bucket of the partition axis
    (``partition_axis=1`` for a dense [T, P] batch).

    Returns (payload ndarray, pack_shift int)."""
    lags = np.ascontiguousarray(lags, dtype=np.int64)
    max_lag = int(lags.max()) if lags.size else 0
    shift = pack_shift_for(max_lag, pad_bucket(lags.shape[partition_axis]) - 1)
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


def _stream_presorted(lags: torch.Tensor, perm: torch.Tensor, num_consumers: int,
                      refine_iters: int = 0):
    """The host-presorted exact-shape path of one dense topic: the round
    scan over ``lags[perm]`` (``perm`` the processing order, lag descending
    and ties by partition id) with the minimum rounds, then ``refine_iters``
    resident refine rounds.  Returns the narrowed choice[P]."""
    P = int(lags.shape[0])
    choice, _, _ = assign_presorted_rounds(lags[perm.long()], perm, num_consumers)
    valid = torch.ones((P,), dtype=torch.bool, device=lags.device)
    choice = _maybe_refine(lags.to(torch.int64), valid, choice, num_consumers,
                           refine_iters)
    return _narrow_choice(choice, num_consumers)


def totals_rank_bits_for(lags: np.ndarray, num_consumers: int) -> int:
    """The JAX package's packed-round-body rule: the rank field width
    max(1, bit_length(C - 1)) when every lag is >= 0 and the largest row
    sum (f64, it cannot wrap) is below 2^(61 - width), else 0.  The kernel
    takes its key form by the same rule from its own inputs
    (:func:`..ops.rounds_cuda.packed_rank_bits`); this is the host's view of
    it for a [..., P] lag array."""
    rb = max(1, (int(num_consumers) - 1).bit_length())
    arr = np.asarray(lags)
    if arr.size == 0:
        return rb
    total = float(arr.sum(axis=-1, dtype=np.float64).max())
    if int(arr.min()) >= 0 and total < float(1 << (61 - rb)):
        return rb
    return 0


def _dense_batch_inputs(lags: torch.Tensor):
    """The dense [T, P] batch's device inputs: the partition axis padded to
    its pow2 bucket (int64), dense partition ids and the real-row mask.
    Returns (lags_p, pids, valid, P)."""
    T, P = lags.shape
    B = pad_bucket(P)
    dev = lags.device
    lags_p = torch.zeros((T, B), dtype=torch.int64, device=dev)
    lags_p[:, :P] = lags
    pids = torch.arange(B, dtype=torch.int32, device=dev).expand(T, B).contiguous()
    return lags_p, pids, pids < P, P


def _dense_payload(lags: np.ndarray, device: DeviceLike):
    """(payload on the device, pack shift): the [T, P] upload of a dense
    batch, int32 when the range allows."""
    dev = resolve_device(device)
    lags = np.asarray(lags)
    if lags.ndim != 2:
        raise ValueError(f"lags must be [T, P], got {list(lags.shape)}")
    payload, shift = stream_payload(lags, partition_axis=1)
    return torch.from_numpy(payload).to(dev), shift


def assign_stream_batch(lags, num_consumers: int, device: DeviceLike = None):
    """The dense topic-batch path (BASELINE config 3's shape): every topic
    has partitions 0..P-1, all valid, so only the exact [T, P] lag matrix
    is uploaded (int32 when the range allows).  One round-scan launch, a
    block per topic.  Same answer as :func:`assign_batched_rounds` with
    dense ids and an all-true mask.

    ``lags`` is a numpy [T, P] array, uploaded to ``device`` (default the
    card).  Returns the narrowed choice[T, P] (int16 when C <= 32767) on
    that device."""
    payload, shift = _dense_payload(lags, device)
    lags_p, pids, valid, P = _dense_batch_inputs(payload)
    choice, _, _ = assign_topic_rounds(
        lags_p, pids, valid, num_consumers, pack_shift=shift, n_valid=P
    )
    return _narrow_choice(choice[:, :P], num_consumers)


def assign_stream_global(lags, num_consumers: int, device: DeviceLike = None):
    """The dense batch path of the cross-topic ``global`` mode: the [T, P]
    lag matrix alone goes up, and one round-scan launch runs every topic's
    rounds in topic order with the totals carried across topics.  Same
    answer as :func:`..ops.rounds_kernel.assign_global_rounds` with dense
    ids and an all-true mask.

    ``lags`` as :func:`assign_stream_batch` takes it.  Returns (the
    narrowed choice[T, P], totals int64[C])."""
    payload, shift = _dense_payload(lags, device)
    lags_p, pids, valid, P = _dense_batch_inputs(payload)
    choice, _, totals = assign_global_rounds(
        lags_p, pids, valid, num_consumers, pack_shift=shift, n_valid=P
    )
    return _narrow_choice(choice[:, :P], num_consumers), totals
