"""Permutation inversion and per-consumer counts.

Counterpart of ``unsort`` and ``bincount_sorted`` in
``kafka_lag_based_assignor_tpu/ops/sortops.py``.  The JAX package re-states
these as sorts because XLA:TPU serialises dynamic scatters; on the card a
scatter and a histogram are the direct, cheap form, so that is what these
are.  Both work along the last axis of a batch.
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
