"""The state carried across from the JAX package.

The assignor has no learned weights: its state is the columnar solve input.
:func:`group_tensors` turns a packed topic group — the numpy ``lags``
int64[T, P], ``partition_ids`` int32[T, P] and ``valid`` bool[T, P] of a
``TopicGroup`` of either package — into the port's device tensors.  It is
duck-typed: it reads those three attributes, or takes the three arrays
directly, and imports nothing of the JAX package.

The quality solvers carry float state as well: :func:`duals_from_numpy`
takes the (A, B) duals of either package and :func:`dedup_from_numpy` the
deduplicated lag weights of ``models.sinkhorn._dedup_weights``, so the same
solver state can be fed to both packages.  The streaming engine's state is
its resident 4-tuple: :func:`resident_from_numpy` takes it from either
package as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.device import DeviceLike, resolve_device


def group_tensors(lags, partition_ids=None, valid=None, device: DeviceLike = None):
    """(lags int64, partition_ids int32, valid bool) tensors on ``device``.

    ``lags`` is either the lag array (then ``partition_ids`` and ``valid``
    are required) or any object with ``lags``, ``partition_ids`` and
    ``valid`` attributes, such as a ``TopicGroup``.
    """
    if partition_ids is None and valid is None:
        lags, partition_ids, valid = lags.lags, lags.partition_ids, lags.valid
    if partition_ids is None or valid is None:
        raise ValueError("pass lags, partition_ids and valid, or one group")
    dev = resolve_device(device)
    arrays = (
        np.ascontiguousarray(lags, dtype=np.int64),
        np.ascontiguousarray(partition_ids, dtype=np.int32),
        np.ascontiguousarray(valid, dtype=np.bool_),
    )
    if not arrays[0].shape == arrays[1].shape == arrays[2].shape:
        raise ValueError(
            "lags, partition_ids and valid must share one shape, got "
            f"{[a.shape for a in arrays]}"
        )
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def _float32_tensors(arrays, device: DeviceLike):
    dev = resolve_device(device)
    out = tuple(np.ascontiguousarray(a, dtype=np.float32) for a in arrays)
    if any(a.ndim != 1 or a.shape != out[0].shape for a in out):
        raise ValueError(
            f"expected 1-D arrays of one length, got {[a.shape for a in out]}"
        )
    return tuple(torch.from_numpy(a).to(dev) for a in out)


def duals_from_numpy(A, B, device: DeviceLike = None):
    """The (A, B) duals of the implicit plan, float32[C] each, as tensors
    on ``device``."""
    return _float32_tensors((A, B), device)


def dedup_from_numpy(ws_u, count_u, wsum_u, device: DeviceLike = None):
    """The deduplicated lag weights (ws_u, count_u, wsum_u), float32[U]
    each, as tensors on ``device``."""
    return _float32_tensors((ws_u, count_u, wsum_u), device)


def resident_from_numpy(choice_p, row_tab, counts, lags_p, device: DeviceLike = None):
    """A streaming engine's resident state (choice int32[B], row_tab
    int32[C, M], counts int32[C], lags int64[B]) as tensors on ``device``,
    in the order ``ops.streaming.StreamingAssignor`` keeps it."""
    dev = resolve_device(device)
    # Copies: the engine owns its resident tensors.
    arrays = (
        np.array(choice_p, dtype=np.int32),
        np.array(row_tab, dtype=np.int32),
        np.array(counts, dtype=np.int32),
        np.array(lags_p, dtype=np.int64),
    )
    B = arrays[0].shape[0]
    C = arrays[2].shape[0]
    if (arrays[0].ndim != 1 or arrays[3].shape != (B,) or arrays[1].ndim != 2
            or arrays[1].shape[0] != C):
        raise ValueError(
            "expected choice[B], row_tab[C, M], counts[C] and lags[B], got "
            f"{[a.shape for a in arrays]}"
        )
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)
