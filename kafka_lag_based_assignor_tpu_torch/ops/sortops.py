"""Permutation inversion, per-consumer counts and sums, segmented argmin,
co-sorts and lexicographic sorts.

Counterpart of ``sort_with``, ``unsort``, ``_boundaries``,
``bincount_sorted``, ``segment_sum`` and ``segment_argmin_first`` in
``kafka_lag_based_assignor_tpu/ops/sortops.py``.  The JAX package re-states
these as sorts because XLA:TPU serialises dynamic scatters; on the card a
scatter and a histogram are the direct, cheap form, so that is what these
are.  :func:`lexsort` stands in for ``lax.sort(..., num_keys=k)``, which
torch has no single call for.
"""

from __future__ import annotations

import math

import torch


def sort_with(keys: torch.Tensor, *payloads: torch.Tensor):
    """Stable co-sort along the last axis: the payloads ride the sort of
    ``keys`` (``lax.sort((keys, *payloads), num_keys=1)``).  Returns
    (sorted_keys, *sorted_payloads)."""
    skeys, perm = torch.sort(keys, dim=-1, stable=True)
    return (skeys, *(p.gather(-1, perm) for p in payloads))


def unsort(perm: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    """``out[..., perm[..., i]] = sorted_vals[..., i]``: values in sorted
    order back to input row order."""
    return torch.empty_like(sorted_vals).scatter_(-1, perm, sorted_vals)


def _boundaries(sorted_vals: torch.Tensor, num_segments: int) -> torch.Tensor:
    """First index of each segment id 0..S in the sorted 1-D ``sorted_vals``
    (the last one is the end sentinel): ``searchsorted`` with S+1 queries.
    Returns int32[S + 1]."""
    q = torch.arange(int(num_segments) + 1, dtype=sorted_vals.dtype,
                     device=sorted_vals.device)
    return torch.searchsorted(sorted_vals, q).to(torch.int32)


def bincount_sorted(vals: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Histogram of ``vals`` over bins 0..S-1 along the last axis.

    Out-of-range values (the -1 padding markers) are not counted.  Returns
    int32[..., S].
    """
    S = int(num_segments)
    lead = vals.shape[:-1]
    n = math.prod(lead)
    in_range = (vals >= 0) & (vals < S)
    offsets = torch.arange(n, device=vals.device).reshape(*lead, 1) * S
    flat = (vals.to(torch.int64) + offsets)[in_range]
    counts = torch.bincount(flat, minlength=n * S)
    return counts.reshape(*lead, S).to(torch.int32)


def segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``vals`` per segment id along the last axis; ``seg`` entries
    outside 0..S-1 are excluded.  Integer sums are exact under any order
    (the JAX package's sort + cumsum gives the same values).  Returns
    vals-dtype[..., S]."""
    S = int(num_segments)
    in_range = (seg >= 0) & (seg < S)
    out = torch.zeros((*vals.shape[:-1], S + 1), dtype=vals.dtype, device=vals.device)
    idx = torch.where(in_range, seg.to(torch.int64), S)
    out.scatter_add_(-1, idx, torch.where(in_range, vals, 0))
    return out[..., :S]


def segment_argmin_first(score: torch.Tensor, seg: torch.Tensor,
                         num_segments: int, P: int):
    """Exact segmented argmin along the last axis: per segment id 0..S-1
    the least ``score`` and the FIRST row index attaining it.

    One rule on every device: the JAX package's CPU branch (a scatter-min
    of the score, then a scatter-min of the indices that hit it).  Its
    accelerator branch sorts a key whose score is quantized, and may pick
    another of several near-minimal candidates; the port follows the CPU
    branch because the tests hold it against JAX on the CPU, and because
    the resident refine (:func:`.refine.refine_rounds_resident`) is
    bit-identical to these semantics, as in the JAX package.

    ``seg`` entries that are negative or above S, and those equal to S,
    are discarded.  Returns (least score score-dtype[..., S], winner index
    int32[..., S]; index P and the dtype's max for an empty segment).
    """
    S = int(num_segments)
    big = torch.iinfo(score.dtype).max
    lead = score.shape[:-1]
    seg_safe = torch.where((seg < 0) | (seg > S), S, seg).to(torch.int64)
    minv = torch.full((*lead, S + 1), big, dtype=score.dtype, device=score.device)
    minv.scatter_reduce_(-1, seg_safe, score, reduce="amin")
    hit = (score == minv.gather(-1, seg_safe)) & (seg_safe < S)
    arange = torch.arange(score.shape[-1], dtype=torch.int32, device=score.device)
    cand = torch.where(hit, arange, int(P))
    idx = torch.full((*lead, S + 1), int(P), dtype=torch.int32, device=score.device)
    idx.scatter_reduce_(-1, seg_safe, cand, reduce="amin")
    return minv[..., :S], idx[..., :S]


def lexsort(*keys: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The permutation that sorts along ``dim`` by ``keys[0]``, ties by
    ``keys[1]``, and so on, remaining ties in index order: what the stable
    ``lax.sort(..., num_keys=len(keys))`` does.  One stable sort per key,
    last key first."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key.gather(dim, perm)
        order = torch.sort(k, dim=dim, stable=True).indices
        perm = order if perm is None else perm.gather(dim, order)
    return perm
