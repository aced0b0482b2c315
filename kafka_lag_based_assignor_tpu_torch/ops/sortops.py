"""Permutation inversion, per-consumer counts and sums, lexicographic sorts.

Counterpart of ``unsort``, ``bincount_sorted`` and ``segment_sum`` in
``kafka_lag_based_assignor_tpu/ops/sortops.py``.  The JAX package re-states
these as sorts because XLA:TPU serialises dynamic scatters; on the card a
scatter and a histogram are the direct, cheap form, so that is what these
are.  :func:`lexsort` stands in for ``lax.sort(..., num_keys=k)``, which
torch has no single call for.
"""

from __future__ import annotations

import math

import torch


def unsort(perm: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    """``out[..., perm[..., i]] = sorted_vals[..., i]``: values in sorted
    order back to input row order."""
    return torch.empty_like(sorted_vals).scatter_(-1, perm, sorted_vals)


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
    """Sum the 1-D ``vals`` per segment id; ``seg`` entries outside
    0..S-1 are excluded.  Integer sums are exact under any order (the
    JAX package's sort + cumsum gives the same values).  Returns
    vals-dtype[S]."""
    S = int(num_segments)
    in_range = (seg >= 0) & (seg < S)
    out = torch.zeros(S + 1, dtype=vals.dtype, device=vals.device)
    idx = torch.where(in_range, seg.to(torch.int64), S)
    out.index_add_(0, idx, torch.where(in_range, vals, 0))
    return out[:S]


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
