"""Resident-state integrity: the digest's host truths and quarantine.

A copy of ``DIGEST_LEN``, ``CorruptStateDetected``, ``digest_failures`` and
``flip_bit`` from ``kafka_lag_based_assignor_tpu/utils/scrub.py``.  Every
refine dispatch of the streaming engine computes a digest of the resident
state it starts from (``ops/refine.state_digest``, the K6 kernel on the
card):

====  ======================  =========================================
slot  value                   host truth it must match
====  ======================  =========================================
0     ``counts.sum()``        P — every partition owned exactly once
1     range violations        0 — no choice entry outside [-1, C)
2     ``lags.sum()``          the host lag sum (int64, wrapping)
3     |bincount(choice) -     0 — the choice vector and the counts
      counts| L1 distance     buffer tell the same story
4     row-table checksum      0 — the [C, M] table mirrors the choice
====  ======================  =========================================

A mismatch quarantines the engine (the resident state is dropped, the host
previous choice kept) and raises :class:`CorruptStateDetected`; the next
dispatch rebuilds the resident state from the host.  The background
scrubber, the quarantine metrics and the corruption fault points come with
the port's observability slice.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from .watchdog import SolveRejected

#: The digest's base length; a digest that also audits the row table has a
#: fifth lane (host truth 0), and :func:`digest_failures` accepts both.
DIGEST_LEN = 4


class CorruptStateDetected(SolveRejected):
    """A resident-state integrity check failed, so the answer must NOT be
    served.  By the time this raises the engine has already quarantined
    itself (resident dropped, host previous choice intact), and the next
    epoch rebuilds the device state from host truth.  ``buffers`` names
    the buffer classes that failed (``choice`` / ``counts`` / ``lags`` /
    ``row_tab``)."""

    def __init__(self, message: str, buffers: Sequence[str]):
        super().__init__(message)
        self.buffers = list(buffers)


def digest_failures(
    digest: Any, expected_p: int, expected_lag_sum: Optional[int]
) -> List[str]:
    """Compare a dispatch's device digest against host truth; returns the
    failed buffer classes (empty = clean).  ``expected_lag_sum`` None skips
    the lag-checksum slot."""
    d = np.asarray(digest)
    fails: List[str] = []
    if int(d[0]) != int(expected_p):
        fails.append("counts")
    if int(d[1]) != 0 or int(d[3]) != 0:
        fails.append("choice")
    if expected_lag_sum is not None and int(d[2]) != int(expected_lag_sum):
        fails.append("lags")
    if d.shape[0] > DIGEST_LEN and int(d[DIGEST_LEN]) != 0:
        fails.append("row_tab")
    return fails


def flip_bit(arr: np.ndarray, seed: int, limit: Optional[int] = None):
    """One seeded single-bit flip in ``arr`` (a host copy is returned; the
    caller re-uploads it).  ``limit`` bounds the flipped index to the real
    (un-padded) prefix."""
    rng = np.random.default_rng(seed)
    out = np.array(arr, copy=True)
    flat = out.reshape(-1)
    hi = flat.size if limit is None else min(int(limit), flat.size)
    i = int(rng.integers(max(hi, 1)))
    bit = int(rng.integers(8 * out.dtype.itemsize - 1))
    flat[i] = np.bitwise_xor(
        flat[i], out.dtype.type(np.int64(1) << bit)
    )
    return out
