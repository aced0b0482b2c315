"""Solve-failure exception classes.

A copy of ``SolveTimeout`` and ``SolveRejected`` from
``kafka_lag_based_assignor_tpu/utils/watchdog.py``.  The watchdog and the
breaker that raise them come with the port's fault ladder; the streaming
engine's integrity check already raises a subtype
(:class:`..utils.scrub.CorruptStateDetected`).
"""

from __future__ import annotations


class SolveTimeout(Exception):
    """Raised when a watched call exceeds its deadline, its breaker is
    open, or its deadline budget is already exhausted."""


class SolveRejected(SolveTimeout):
    """Fail-fast subtype: the call was rejected WITHOUT running (breaker
    open, probe already in flight, or budget exhausted) — the device was
    never touched, so callers holding warm state tied to the callable
    (the streaming engines) know that state is still intact."""
