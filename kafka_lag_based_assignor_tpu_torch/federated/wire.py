"""THE audited serializer for peer-bound federation payloads.

Counterpart of ``kafka_lag_based_assignor_tpu/federated/wire.py``, the same
whitelists and audits: a payload encodes to the same bytes in both packages,
so a port sidecar and a JAX sidecar peer over one wire.

Privacy is the federation's load-bearing contract: a ``peer_sync``
exchange may carry consumer-axis (C-dimensional) aggregates and
scalars, NEVER the partition-axis lag vector — raw lags do not leave
the cluster that observed them.  That guarantee is only auditable if
every peer-bound payload is constructed in ONE place, so lint rule
L019 confines construction to this module: requests are built by
:func:`sync_request`, responses by :func:`sync_response` /
:func:`sync_reject`, and both run :func:`_check_payload` — a
WHITELIST walk (unknown keys are a bug, not a pass-through) that also
bounds every numeric list to the declared consumer count, so a
P-length lag vector cannot ride out even under an allowed key.

:func:`assert_lag_free` is the on-wire audit the bench gate and the
chaos suite run against captured payload bytes: no window of the raw
lag vector may appear serialized anywhere in the payload.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

#: The peer-coordination wire method (service dispatch + L019 anchor).
PEER_SYNC_METHOD = "peer_sync"

#: Protocol version: a peer answering a different version is dropped
#: (counted), never half-parsed.
PROTOCOL_VERSION = 1

#: Whitelisted payload keys per direction.  ``duals``/``marginals`` are
#: dicts of C-bounded f32 lists; everything else is a scalar/string.
_REQUEST_KEYS = frozenset(
    {
        "version", "peer_id", "epoch", "fence_token", "round",
        "num_consumers", "scale", "phase", "duals", "traceparent",
    }
)
_RESPONSE_KEYS = frozenset(
    {
        "version", "peer_id", "epoch", "fence_token", "round",
        "num_consumers", "marginals", "total_lag", "n_valid",
        "rejected", "capacity",
    }
)
_DUALS_KEYS = frozenset({"A", "B"})
_MARGINAL_KEYS = frozenset({"load", "colsum"})

#: Reject reasons a peer may answer instead of marginals.
REJECT_REASONS = (
    "stale_epoch", "fenced", "unavailable", "mismatch", "version",
)


class PayloadViolation(ValueError):
    """A peer-bound payload failed the whitelist/shape audit — raised at
    CONSTRUCTION time, so a privacy-violating payload can never reach a
    socket."""


def _check_vector(key: str, value: Any, C: int) -> List[float]:
    if not isinstance(value, (list, np.ndarray)):
        raise PayloadViolation(f"{key} must be a numeric list")
    out = [float(v) for v in np.asarray(value, dtype=np.float64)]
    if len(out) != C:
        # THE shape audit: every vector on the peer wire lives on the
        # consumer axis.  A partition-axis vector (P >> C in every real
        # deployment, and never equal to the declared C here) cannot be
        # smuggled under an allowed key.
        raise PayloadViolation(
            f"{key} has length {len(out)}, expected the declared "
            f"num_consumers {C} — partition-axis data may not ride the "
            "peer wire"
        )
    return out


def _check_payload(
    payload: Dict[str, Any], allowed: frozenset, C: int
) -> None:
    unknown = set(payload) - allowed
    if unknown:
        raise PayloadViolation(
            f"peer payload carries non-whitelisted keys {sorted(unknown)}"
        )
    tp = payload.get("traceparent")
    if tp is not None:
        # Trace context rides the peer wire as ONE fixed-length scalar
        # string (W3C traceparent) — length-checked and re-parsed here
        # so the tracing plane cannot become a covert channel for
        # anything wider than two ids and a flag byte.
        from ..utils import trace as trace_mod

        if (
            not isinstance(tp, str)
            or len(tp) != trace_mod.TRACEPARENT_LEN
            or trace_mod.parse_traceparent(tp) is None
        ):
            raise PayloadViolation(
                "traceparent must be a single W3C traceparent scalar "
                f"({trace_mod.TRACEPARENT_LEN} chars)"
            )
    duals = payload.get("duals")
    if duals is not None:
        if set(duals) - _DUALS_KEYS:
            raise PayloadViolation("duals may carry only A/B")
        for key in _DUALS_KEYS:
            payload["duals"][key] = _check_vector(f"duals.{key}",
                                                  duals[key], C)
    marginals = payload.get("marginals")
    if marginals is not None:
        if set(marginals) - _MARGINAL_KEYS:
            raise PayloadViolation("marginals may carry only load/colsum")
        for key in _MARGINAL_KEYS:
            payload["marginals"][key] = _check_vector(
                f"marginals.{key}", marginals[key], C
            )
    capacity = payload.get("capacity")
    if capacity is not None:
        # The weighted-shard capacity vector rides the SAME consumer-
        # axis shape audit as the marginals: C-bounded, so a
        # partition-axis vector cannot smuggle out under this key —
        # and every entry must be a finite positive weight (a NaN or
        # negative capacity would poison the summed global count
        # marginal; the initiator re-checks with the same rule).
        vec = _check_vector("capacity", capacity, C)
        if not capacity_usable(vec):
            raise PayloadViolation(
                "capacity entries must be finite and > 0"
            )
        payload["capacity"] = vec


def capacity_usable(vec) -> bool:
    """True when ``vec`` is a usable capacity weight vector: every
    entry finite and strictly positive.  Shared by the construction
    audit above and the INITIATOR's consumption of a peer's hello
    response (a hostile/buggy peer's NaN or negative entry must never
    reach the summed count marginal)."""
    arr = np.asarray(vec, dtype=np.float64)
    return bool(np.all(np.isfinite(arr)) and np.all(arr > 0))


def sync_request(
    peer_id: str,
    epoch: int,
    round_index: int,
    num_consumers: int,
    scale: float,
    duals_a: Optional[Any] = None,
    duals_b: Optional[Any] = None,
    fence_token: Optional[int] = None,
    phase: str = "exchange",
    traceparent: Optional[str] = None,
) -> Dict[str, Any]:
    """Build (and audit) one ``peer_sync`` request's params.

    ``phase`` is ``"hello"`` for the handshake round (no duals yet —
    the response's ``total_lag``/``n_valid`` scalars fix the shared
    scale), ``"exchange"`` for a marginal round under the carried
    duals, or ``"gossip"`` for the SAME marginal round issued by the
    background dual-gossip daemon (identical payload shape and audit —
    consumer-axis duals only, lag-free — the distinct phase tag exists
    so captures and peers can tell the planes apart).  ``traceparent``
    (optional) carries the initiator's W3C trace context so both
    sidecars' segments of a federated assign reconstruct as one trace;
    it is audited as a fixed-length scalar by :func:`_check_payload`."""
    if phase not in ("hello", "exchange", "gossip"):
        raise PayloadViolation(f"unknown phase {phase!r}")
    params: Dict[str, Any] = {
        "version": PROTOCOL_VERSION,
        "peer_id": str(peer_id),
        "epoch": int(epoch),
        "round": int(round_index),
        "num_consumers": int(num_consumers),
        "scale": float(scale),
        "phase": phase,
    }
    if fence_token is not None:
        params["fence_token"] = int(fence_token)
    if duals_a is not None:
        params["duals"] = {"A": duals_a, "B": duals_b}
    if traceparent is not None:
        params["traceparent"] = str(traceparent)
    _check_payload(params, _REQUEST_KEYS, int(num_consumers))
    return params


def sync_response(
    peer_id: str,
    epoch: int,
    round_index: int,
    num_consumers: int,
    total_lag: int,
    n_valid: int,
    load: Optional[Any] = None,
    colsum: Optional[Any] = None,
    fence_token: Optional[int] = None,
    capacity: Optional[Any] = None,
) -> Dict[str, Any]:
    """Build (and audit) one ``peer_sync`` response body: the peer's
    marginal contribution (exchange phase) or just its handshake
    scalars (hello phase — ``load``/``colsum`` None).  ``capacity``
    (hello phase, optional) is this shard's per-consumer capacity
    weight vector — the weighted-shard count marginal's raw material
    (ROADMAP federated (c)); consumer-axis bounded like every vector
    on this wire."""
    body: Dict[str, Any] = {
        "version": PROTOCOL_VERSION,
        "peer_id": str(peer_id),
        "epoch": int(epoch),
        "round": int(round_index),
        "num_consumers": int(num_consumers),
        "total_lag": int(total_lag),
        "n_valid": int(n_valid),
    }
    if fence_token is not None:
        body["fence_token"] = int(fence_token)
    if load is not None:
        body["marginals"] = {"load": load, "colsum": colsum}
    if capacity is not None:
        body["capacity"] = capacity
    _check_payload(body, _RESPONSE_KEYS, int(num_consumers))
    return body


def sync_reject(
    peer_id: str, reason: str, epoch: int, num_consumers: int
) -> Dict[str, Any]:
    """A structured peer-side rejection (stale epoch, fenced token,
    no registered shard, roster mismatch): the initiator DROPS this
    peer's contribution for the round and counts it — rejected state
    is never averaged in."""
    if reason not in REJECT_REASONS:
        raise PayloadViolation(f"unknown reject reason {reason!r}")
    body = {
        "version": PROTOCOL_VERSION,
        "peer_id": str(peer_id),
        "epoch": int(epoch),
        "num_consumers": int(num_consumers),
        "rejected": reason,
    }
    _check_payload(body, _RESPONSE_KEYS, int(num_consumers))
    return body


def encode(payload: Dict[str, Any]) -> bytes:
    """Serialize one audited payload (the capture point the bench's
    on-wire audit reads)."""
    return json.dumps(payload).encode()


def assert_lag_free(payload: bytes, lags, window: int = 3) -> None:
    """The on-wire audit: no ``window`` consecutive raw lag values may
    appear serialized (as a JSON fragment, any of the idiomatic
    spellings) anywhere in ``payload``.  Raises AssertionError with the
    offending fragment; used by the bench gate and the chaos suite
    against captured ``peer_sync`` bytes."""
    text = payload.decode(errors="replace")
    rows = [int(v) for v in np.asarray(lags).reshape(-1)]
    for i in range(max(0, len(rows) - window + 1)):
        chunk = rows[i: i + window]
        for sep in (", ", ","):
            frag = sep.join(str(v) for v in chunk)
            if frag in text:
                raise AssertionError(
                    f"peer payload leaks raw lag window {chunk} "
                    f"(fragment {frag!r})"
                )
