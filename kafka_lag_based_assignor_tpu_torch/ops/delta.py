"""Changed-assignment extraction: the O(changed) readback of a warm epoch.

Counterpart of ``kafka_lag_based_assignor_tpu/ops/delta.py``.  A warm
refine with an exchange budget moves at most ``2 * exchange_budget`` entries
of the choice vector, and the host already holds the entry state (the
engine's previous choice; every host-side edit drops the resident state and
takes the dense path).  So the device compacts the changed entries into a
fixed-width ``[K]`` (index, value) tail and the host fetches that instead of
the dense ``[P]`` vector:

- :func:`readback_k` — the padded width ``K``, a pure function of
  ``(exchange_budget, P)``;
- :func:`compact_changed` — the device epilogue: entry vs exit choice over
  the live ``[:P]`` prefix, compacted to ``K`` entries;
- :func:`apply_assignment_delta` — the host inverse, reproducing the dense
  readback bit for bit.

The true changed count rides along; a count past ``K`` (possible only off
the budgeted bulk path) makes the host fetch the dense narrow vector, which
the dispatch returns anyway.
"""

from __future__ import annotations

import numpy as np
import torch

# Smallest compaction width (the upload ladder's DELTA_MIN_K).
RB_MIN_K = 16

# Per-entry device->host cost bound: int32 index + int32 value (the worst
# case for the delta side), against an int16 dense vector (the best case
# for the dense side), so the decision never keys on the narrow dtype.
_RB_ENTRY_BYTES_MAX = 4 + 4
_RB_DENSE_BYTES_MIN = 2


def _pow2_ceil(n: int) -> int:
    k = RB_MIN_K
    while k < n:
        k <<= 1
    return k


def readback_k(exchange_budget: int, P: int) -> int:
    """Padded compaction width for a warm dispatch, or 0 to keep the dense
    readback: the pow2 ceiling of ``2 * exchange_budget`` (at least
    ``RB_MIN_K``); 0 when the budget is unbounded (``exchange_budget <=
    0``: cold chains) or the padded tail would not beat the dense transfer
    (``K * 8 >= P * 2``)."""
    if exchange_budget <= 0 or P <= 0:
        return 0
    k = _pow2_ceil(max(2 * int(exchange_budget), RB_MIN_K))
    if k * _RB_ENTRY_BYTES_MAX >= P * _RB_DENSE_BYTES_MIN:
        return 0
    return k


def compact_changed(entry_choice, exit_choice, narrow, P: int, K: int):
    """The readback compaction over the live ``[:P]`` prefix.

    Returns ``(d_idx int32[K], d_vals narrow-dtype[K], d_n int32)``: the
    first K changed indices in ascending order, their exit values, and the
    TRUE changed count (may exceed K — the host checks).  Padding entries
    are ``(0, narrow[0])``, index 0's real exit value, as in the JAX
    package's ``jnp.nonzero(size=K, fill_value=0)``.  A prefix sum gives
    each changed row its slot, with no host read; rows past slot K land on
    a drop slot that is cut off.
    """
    changed = entry_choice[:P] != exit_choice[:P]
    pos = torch.cumsum(changed, dim=0) - 1
    dest = torch.where(changed & (pos < K), pos, K)
    slots = torch.zeros(K + 1, dtype=torch.int64, device=changed.device)
    slots.scatter_(0, dest, torch.arange(P, device=changed.device))
    d_idx = slots[:K].to(torch.int32)
    return d_idx, narrow[slots[:K]], changed.sum(dtype=torch.int32)


def apply_assignment_delta(
    base: np.ndarray, idx: np.ndarray, vals: np.ndarray, n: int
) -> np.ndarray:
    """Host inverse of :func:`compact_changed`: scatter the first ``n``
    fetched entries onto a copy of the host's previous dense view."""
    out = np.ascontiguousarray(base, dtype=np.int32).copy()
    n = int(n)
    if n:
        out[np.asarray(idx[:n], dtype=np.int64)] = np.asarray(
            vals[:n]
        ).astype(np.int32)
    return out
