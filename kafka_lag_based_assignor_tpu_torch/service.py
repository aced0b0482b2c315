"""Sidecar service: the plugin boundary as a wire API, on the port.

Counterpart of ``kafka_lag_based_assignor_tpu/service.py``, speaking its
wire byte for byte.  The JVM-side ``partition.assignment.strategy`` plugin
(``jvm/``) keeps the group bookkeeping and the offset/lag RPCs and sends
the resulting ``(partition lags, subscriptions)`` to this co-located
process, which runs the solve on the CUDA card and returns the
member->partitions map.  The wire is unchanged, so the JVM shim needs no
change.

Protocol: newline-delimited JSON over TCP.  Request::

    {"id": 1, "method": "assign",
     "params": {"topics":        {"t0": [[0, 100000], [1, 50000]]},
                "subscriptions": {"C0": ["t0"], "C1": ["t0"]},
                "solver":        "rounds"}}          # optional

Response::

    {"id": 1, "request_id": "req-...", "trace_id": "...",
     "result": {"assignments": {"C0": [["t0", 0]], ...}, "stats": {...},
                "options": {...}}}
    {"id": 1, "request_id": ..., "trace_id": ..., "error": {"message": ...}}

Methods served:

* ``ping`` -> ``"pong"``; ``stats`` -> the counters since start, the
  breakers, the overload ladder, the quality plane and the active fault
  drill; ``metrics`` -> the registry as JSON and Prometheus text plus the
  flight recorder (``params.view`` trims it to one); ``trace`` -> the tail
  sampler's kept traces;
* ``assign`` -> one stateless solve with any solver (``rounds``, ``scan``,
  ``global`` and ``sinkhorn`` on the card, ``native`` and ``host`` on the
  host), under the per-solver watchdog with the host greedy as its degraded
  rung;
* ``stream_assign`` -> one epoch of a warm per-stream engine
  (:class:`..ops.streaming.StreamingAssignor`): still-balanced epochs are
  no-ops, drifted ones pay one bounded refine, membership changes remap by
  member NAME, a changed partition-id set re-solves cold.  Delta epochs
  (``params.lag_delta`` with a ``base_epoch``; a stale or gapped base
  answers ``stream.resync: true`` with the previous assignment), delta
  responses (``params.assign_ack`` -> ``result.assignment_delta``) and
  zlib-encoded lag payloads and answers (``params.encoding`` /
  ``params.accept_encoding``) are the JAX service's.  The degraded-mode
  ladder is warm engine -> cold device (a fresh engine) -> host snake,
  reported as ``stream.degraded_rung``; a poisoned stream's next epoch
  warm-restarts from the last answered choice;
* ``stream_reset``, ``stream_flight`` (one stream's own flight ring) and
  ``recommend`` (a per-stream consumer-count recommendation from the lag
  trend and the overload state);
* ``drain`` -> a graceful drain (below), answered at once with the
  lifecycle state.

Every stream request first passes the overload admission
(:mod:`.utils.overload`): its SLO class (config
``tpu.assignor.slo.class.<stream>``, wire ``params.slo_class``), the shed
ladder's decision (a ``best_effort`` reject answers an error envelope with
a structured ``shed`` object; a degrade serves the previous assignment),
and the weighted in-flight depth.  ``metrics_port`` serves the Prometheus
exposition over plain HTTP (``GET /metrics``, :mod:`.utils.metrics_http`).

Lifecycle (the JAX service's): ``start()`` boots in one sequence under the
lifecycle lock: it takes the snapshot's writer lease (fenced backends),
recovers the streams of the last snapshot (``_recover``: each stream's
engine seeded with its choice; breaker and overload state restored), with
``recovery_prestack`` rebuilds their resident state off the serving path,
runs the warm-up of ``warmup_shapes`` and, with ``recovery_warmup``, of
the recovered shapes (:mod:`.warmup`), then starts the snapshot writer,
the resident-state scrubber (:class:`.utils.scrub.StateScrubber`), the
metrics listener and the accept loop.  ``drain`` (or SIGTERM) stops
admissions with a structured :class:`DrainReject`, waits for in-flight
requests up to ``drain_timeout_s``, writes the final snapshot, releases
the writer lease and closes the listener; the next boot on the same
snapshot recovers from it.  A recovered stream's first epoch is paced
(``resync_max_inflight`` concurrent dense rebuilds) and reports
``warm_restart``; a drifted roster discards its state.  The snapshot
format is the JAX package's byte for byte (:mod:`.utils.snapshot`), so
either package recovers from the other's file.  ``stats.lifecycle`` and
``stats.scrub`` answer as the JAX service's.

Megabatch coalescing (:mod:`.ops.coalesce`, the JAX service's): with
``coalesce_max_batch`` > 1 (default 32) and more than one live stream,
every warm epoch's resident refine parks on the coalescer
(:meth:`.ops.streaming.StreamingAssignor.submit_epoch`) and runs batched
with the concurrent streams' epochs of the same shape; a lone stream keeps
the inline path.  The overload controller's per-class window scales shrink
its admission window, the drain flushes its waves, ``stats.coalesce``
reports its rosters (absent when coalescing is off, as in the JAX
service), and the warm-up drives its waves.

Device mesh (:mod:`.sharded`): ``mesh_devices`` ("off" default, "auto" or
a device count), ``mesh_solve_min_rows`` and ``mesh_shape`` build one
:class:`.sharded.mesh.MeshManager`, configured and activated at
:meth:`AssignorService.start` and deactivated at :meth:`AssignorService.stop`.
A ``stream_assign`` whose partition count reaches the floor runs its cold
epoch P-sharded (``stream.sharded_solve: true``), and ``stats.mesh`` is the
manager's status.  At or above the floor a stream's resident state is
placed over the mesh's "p" axis between epochs, and the coalescer places
locked rosters on the streams (or 2-D) mesh (:mod:`.sharded.resident`,
:mod:`.sharded.megabatch`): bytes move, answers do not.

Federation (:mod:`.federated`): ``federation_self_id`` and
``federation_peers`` make this sidecar one shard of a federated group.  It
answers ``peer_sync`` over its registered local lag shard, ``federation``
with the coordinator's status, and ``federated_assign`` by converging the
global duals with every peer inside the request's deadline budget (rung
``global``), else the last-good duals (``last_good_global``), else the
single-cluster ``rounds`` solve (``local_only``, K1 on the card).  The wire
is the JAX sidecar's, so a port sidecar peers with a JAX one.

Device: every solve and every stream engine runs on ``device`` (default
the CUDA card; :func:`.utils.device.resolve_device` raises without one, and
the tests pass ``device="cpu"``).  Each request is served on its handler
thread; the solve runs in a ``klba-solve`` watchdog worker that enters that
thread's CUDA device and stream (:func:`.utils.device.carry_cuda_context`).
The service never moves a solve to the CPU: with ``host_fallback=False`` a
kernel fault fails the request.  ``stats.device`` in an ``assign`` answer
names the device the solve ran on (None for the host solvers and the host
rung), the one key the JAX service's answer lacks.  The sidecar also times
its solve in the ``assign.solve`` span, as the plugin does.

Wire limits: a request line may be at most ``MAX_LINE_BYTES`` (16 MiB);
longer lines are answered with an error and drained without buffering.
``params.options`` accepts only ``sinkhorn_iters`` (int, 1..4096) and
``refine_iters`` (int, 0..65536), quantized to a power of two
(``sinkhorn_iters`` up, ``refine_iters`` down) and echoed in the answer's
``options``.

Run it::

    python -m kafka_lag_based_assignor_tpu_torch.service --device cuda 127.0.0.1 7531
"""

from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .assignor import DEVICE_SOLVERS, solve_on_ladder
from .ops.dispatch import quality_status, set_quality_mode, set_quality_tile
from .ops.dispatch import normalize_quality_mode
from .ops.coalesce import DeadlineShed
from .ops.streaming import StreamingAssignor, StreamingStats
from .types import TopicPartitionLag
from .utils import faults, metrics
from .utils import scrub as scrub_lib
from .utils import trace as trace_mod
from .utils.config import VALID_SOLVERS, validate_quality_tile
from .utils.device import DeviceLike, carry_cuda_context, resolve_device
from .utils.observability import (
    RebalanceStats,
    count_constrained_bound,
    install_compile_counter,
    summarize_assignment,
)
from .utils.overload import (
    CLASS_WEIGHTS,
    SLO_CLASSES,
    OverloadController,
    ShedReject,
    SloPolicy,
    class_rank,
    recommend_payload,
    record_shed,
)
from .utils.watchdog import SolveRejected, Watchdog

LOGGER = logging.getLogger(__name__)

# Upper bound on one request line.  A 100k-partition assign request with
# 7-digit lags serializes to ~2 MB; 16 MiB leaves headroom while keeping a
# malformed client from streaming an unbounded "line" into memory.
MAX_LINE_BYTES = 16 * 1024 * 1024

# params.options whitelist: (min, max) per key.  In-range values are
# QUANTIZED to a power of two (0 stays 0), so a client cycling values gets
# at most ~log2(max) distinct budgets.  ``sinkhorn_iters`` is a quality
# floor and rounds UP; ``refine_iters`` is the exchange budget whose
# contract is "churn bounded by 2x this value" and rounds DOWN.  The
# effective values are echoed in the answer's ``options`` field.
_OPTION_BOUNDS = {"sinkhorn_iters": (1, 4096), "refine_iters": (0, 65536)}
_OPTION_ROUNDS_UP = {"sinkhorn_iters": True, "refine_iters": False}

# Live warm-state cap for stream_assign.
MAX_STREAMS = 64

# Per-stream flight-recorder ring size (64 streams x 64 records).
STREAM_FLIGHT_CAPACITY = 64

# Wire methods, as metric label values: anything else is labeled
# "unknown", so a client cannot mint unbounded label cardinality.  The
# JAX service's set, whole.
_KNOWN_METHODS = frozenset(
    {
        "ping", "stats", "metrics", "assign", "stream_assign",
        "stream_reset", "stream_flight", "recommend", "drain",
        "peer_sync", "federation", "federated_assign", "trace",
    }
)

# Wire encodings for the dense lag payload: ``params.encoding`` "zlib" =
# base64(zlib(JSON rows)).  An unknown encoding is a structured error
# naming the supported set so the client can fall back to plain JSON.
_LAG_ENCODINGS = ("zlib",)

# Per-stream lag-trend window for ``recommend``: (time, total_lag) samples.
STREAM_HISTORY = 64

# Lifecycle states, as the ``klba_lifecycle_state`` gauge's values.
_LIFECYCLE_STATES = ("serving", "draining", "stopped")

# The takeover-warming TTL: a recovered stream that never sends its first
# post-boot epoch stops holding the overload controller's standing pressure
# after this long.
TAKEOVER_WARMING_TTL_S = 300.0

# Per-process instance sequence for lease owner ids: two services in one
# process (restart drills) must be told apart by the fencing protocol.
_OWNER_SEQ = iter(range(1, 1 << 30))


def _counter_total(name: str) -> int:
    """Sum of every series registered under ``name`` — the registry view
    behind the service ``stats`` counters."""
    return sum(c.value for c in metrics.REGISTRY.series(name))


class _DeadlineBudget:
    """Per-request deadline: the degraded-mode ladder's rungs share ONE
    budget (``solve_timeout_s`` total), so the remaining budget shrinks
    down the ladder.  ``clock`` is injectable."""

    def __init__(
        self,
        total_s: Optional[float],
        clock: Callable[[], float] = time.monotonic,
    ):
        self.total_s = total_s
        self._clock = clock
        self._start = clock()

    def remaining(self) -> Optional[float]:
        """Seconds left (may be <= 0: the watchdog then fails fast without
        charging the breaker); None = no deadline configured."""
        if self.total_s is None:
            return None
        return self.total_s - (self._clock() - self._start)

    def consumed_ms(self) -> float:
        """Milliseconds spent since the budget was minted."""
        return (self._clock() - self._start) * 1000.0


def _quantize_pow2(value: int, up: bool) -> int:
    if value == 0:
        return 0
    if up:
        return 1 << (value - 1).bit_length()
    return 1 << (value.bit_length() - 1)


def _validate_options(options: Any) -> Dict[str, int]:
    if not isinstance(options, dict):
        raise ValueError("params.options must be a JSON object")
    out: Dict[str, int] = {}
    for key, value in options.items():
        bounds = _OPTION_BOUNDS.get(key)
        if bounds is None:
            raise ValueError(
                f"unknown option {key!r}; valid: {sorted(_OPTION_BOUNDS)}"
            )
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"option {key} must be an integer, got {value!r}")
        lo, hi = bounds
        if not lo <= value <= hi:
            raise ValueError(
                f"option {key}={value} out of range [{lo}, {hi}]"
            )
        out[key] = _quantize_pow2(value, _OPTION_ROUNDS_UP[key])
    return out


def _validate_stream_options(options: Any) -> Dict[str, Any]:
    """Stream options: ``refine_iters`` gets the stateless path's
    validation and pow2-down quantization; ``guardrail`` /
    ``refine_threshold`` are host-side floats in [1, 1000] or null."""
    if not isinstance(options, dict):
        raise ValueError("params.options must be a JSON object")
    out: Dict[str, Any] = {}
    for key, value in options.items():
        if key == "refine_iters":
            out.update(_validate_options({key: value}))
        elif key in ("guardrail", "refine_threshold"):
            if value is None:
                out[key] = None
                continue
            if isinstance(value, bool) or not isinstance(
                value, (int, float)
            ):
                raise ValueError(f"option {key} must be a number or null")
            if not 1.0 <= float(value) <= 1000.0:
                raise ValueError(
                    f"option {key}={value} out of range [1.0, 1000.0]"
                )
            out[key] = float(value)
        else:
            raise ValueError(
                f"unknown stream option {key!r}; valid: "
                "['guardrail', 'refine_iters', 'refine_threshold']"
            )
    return out


def _host_choice_stats(choice, lags, C: int, prev, cold_start: bool):
    """StreamingStats for a host-side choice vector (the snake and
    kept-previous rungs share this evaluation)."""
    stats = StreamingStats(cold_start=cold_start)
    totals = np.bincount(choice, weights=lags.astype(np.float64),
                         minlength=C)
    mean = totals.mean()
    stats.max_mean_imbalance = float(totals.max() / mean) if mean else 1.0
    stats.imbalance_bound = count_constrained_bound(lags, C)
    counts = np.bincount(choice, minlength=C)
    stats.count_spread = int(counts.max() - counts.min())
    if prev is not None and prev.shape[0] == choice.shape[0]:
        stats.churn = int((choice != prev).sum())
    return stats


def _snake_fallback(lags, C: int, prev):
    """Emergency host-side assignment when the device solve fails or times
    out mid-stream: partitions in descending-lag order dealt boustrophedon
    (round r even -> slot j, odd -> C-1-j), count spread <= 1.  Returns
    (choice int32[P], StreamingStats-shaped stats)."""
    P = lags.shape[0]
    ranks = np.empty(P, np.int64)
    ranks[np.argsort(-lags, kind="stable")] = np.arange(P)
    r, j = np.divmod(ranks, C)
    choice = np.where(r % 2 == 0, j, C - 1 - j).astype(np.int32)
    return choice, _host_choice_stats(choice, lags, C, prev, cold_start=True)


def _parse_lag_delta(delta: Any):
    """Type-validate ``params.lag_delta``; returns (pids int64[n], values
    int64[n], base_epoch).  Whether the delta can APPLY is decided against
    the stream's stored base under its lock."""
    if not isinstance(delta, dict):
        raise ValueError("params.lag_delta must be a JSON object")
    idx = delta.get("indices")
    vals = delta.get("values")
    base = delta.get("base_epoch")
    if not isinstance(idx, list) or not isinstance(vals, list):
        raise ValueError(
            "params.lag_delta.indices/values must be lists"
        )
    if len(idx) != len(vals):
        raise ValueError(
            "params.lag_delta.indices and values differ in length"
        )
    if isinstance(base, bool) or not isinstance(base, int) or base < 0:
        raise ValueError(
            "params.lag_delta.base_epoch must be a non-negative integer"
        )
    d_pids = np.fromiter((int(p) for p in idx), np.int64, count=len(idx))
    d_vals = np.fromiter((int(v) for v in vals), np.int64, count=len(vals))
    if d_vals.size and int(d_vals.min()) < 0:
        raise ValueError("params.lag_delta contains negative lag values")
    if np.unique(d_pids).size != d_pids.size:
        raise ValueError(
            "params.lag_delta.indices contains duplicate partition ids"
        )
    return d_pids, d_vals, base


def _parse_assign_ack(params: Dict[str, Any]) -> Optional[int]:
    """Type-validate ``params.assign_ack``: the assignment epoch whose dense
    view the client holds, opting this request into a delta answer."""
    ack = params.get("assign_ack")
    if ack is None:
        return None
    if isinstance(ack, bool) or not isinstance(ack, int) or ack < 0:
        raise ValueError(
            "params.assign_ack must be a non-negative integer"
        )
    return ack


def _parse_accept_encoding(params: Dict[str, Any]) -> Optional[str]:
    """Type-validate ``params.accept_encoding`` (compressed DENSE answers:
    ``assignments_encoded`` as base64(zlib(JSON)))."""
    enc = params.get("accept_encoding")
    if enc is None:
        return None
    if enc not in _LAG_ENCODINGS:
        raise ValueError(
            f"unknown accept_encoding {enc!r}; supported: "
            f"{list(_LAG_ENCODINGS)}"
        )
    return enc


def _decode_wire_lags(params: Dict[str, Any]):
    """Resolve ``params.lags`` honoring ``params.encoding``; returns the
    plain ``[[pid, lag], ...]`` rows.  ``encoding: "zlib"`` bytes are
    counted both ways in ``klba_wire_lag_bytes_total{encoding}``; the
    inflate is bounded by ``MAX_LINE_BYTES``."""
    rows = params.get("lags")
    enc = params.get("encoding")
    if enc is None or rows in (None, []):
        return rows or []
    if enc not in _LAG_ENCODINGS:
        raise ValueError(
            f"unknown encoding {enc!r}; supported: "
            f"{list(_LAG_ENCODINGS)} — resend params.lags as plain JSON"
        )
    if not isinstance(rows, str):
        raise ValueError(
            "params.lags must be a base64 string when params.encoding "
            "is set"
        )
    import base64
    import zlib

    try:
        blob = base64.b64decode(rows.encode("ascii"), validate=True)
    except (ValueError, UnicodeEncodeError) as exc:
        raise ValueError(f"params.lags is not valid base64: {exc}")
    d = zlib.decompressobj()
    try:
        plain = d.decompress(blob, MAX_LINE_BYTES + 1)
    except zlib.error as exc:
        raise ValueError(f"params.lags failed to decompress: {exc}")
    if len(plain) > MAX_LINE_BYTES or d.unconsumed_tail:
        raise ValueError(
            f"decoded lag payload exceeds {MAX_LINE_BYTES} bytes"
        )
    metrics.REGISTRY.counter(
        "klba_wire_lag_bytes_total", {"encoding": "zlib"}
    ).inc(len(blob))
    metrics.REGISTRY.counter(
        "klba_wire_lag_bytes_total", {"encoding": "plain"}
    ).inc(len(plain))
    decoded = json.loads(plain)
    if not isinstance(decoded, list):
        raise ValueError("decoded params.lags must be a JSON list")
    return decoded


def encode_lags_zlib(rows) -> str:
    """Client half of the ``encoding: "zlib"`` wire shape (the JVM shim
    mirrors this): base64(zlib(JSON rows))."""
    import base64
    import zlib

    return base64.b64encode(
        zlib.compress(json.dumps(rows).encode())
    ).decode("ascii")


def _encode_dense_assignments(
    assignments, resp_enc: Optional[str]
) -> Dict[str, Any]:
    """Wrap a dense assignments dict for the wire, honoring the client's
    ``accept_encoding``; both sizes feed
    ``klba_wire_assign_bytes_total{encoding}``."""
    if resp_enc != "zlib":
        return {"assignments": assignments}
    plain = json.dumps(assignments)
    encoded = encode_lags_zlib(assignments)
    metrics.REGISTRY.counter(
        "klba_wire_assign_bytes_total", {"encoding": "plain"}
    ).inc(len(plain))
    metrics.REGISTRY.counter(
        "klba_wire_assign_bytes_total", {"encoding": "zlib"}
    ).inc(len(encoded))
    return {
        "assignments_encoded": encoded,
        "assignments_encoding": "zlib",
    }


def decode_wire_assignments(result: Dict[str, Any]) -> Dict[str, Any]:
    """Client half of the dense-answer encoding: inflate
    ``assignments_encoded`` back into a plain ``assignments`` key (bounded
    like :func:`_decode_wire_lags`).  Results without it pass through."""
    blob = result.get("assignments_encoded")
    if blob is None:
        return result
    enc = result.get("assignments_encoding")
    if enc not in _LAG_ENCODINGS:
        raise ValueError(f"unknown assignments_encoding {enc!r}")
    import base64
    import zlib

    raw = base64.b64decode(blob.encode("ascii"), validate=True)
    d = zlib.decompressobj()
    plain = d.decompress(raw, MAX_LINE_BYTES + 1)
    if len(plain) > MAX_LINE_BYTES or d.unconsumed_tail:
        raise ValueError(
            f"decoded assignments exceed {MAX_LINE_BYTES} bytes"
        )
    out = dict(result)
    out.pop("assignments_encoded")
    out.pop("assignments_encoding")
    out["assignments"] = json.loads(plain)
    return out


def _parse_lag_rows(rows):
    """THE dense-lag row validation: non-empty, no negative lags, no
    duplicate pids.  Returns ``(pids_sorted int64[P], lags int64[P])`` in
    ascending-pid order (the row order warm state is keyed on)."""
    if not rows:
        raise ValueError("params.lags must be a non-empty list")
    pids = np.fromiter(
        (int(p) for p, _ in rows), np.int64, count=len(rows)
    )
    lags_in = np.fromiter(
        (int(lag) for _, lag in rows), np.int64, count=len(rows)
    )
    if lags_in.size and int(lags_in.min()) < 0:
        raise ValueError("params.lags contains negative lag values")
    order = np.argsort(pids, kind="stable")
    pids_sorted = pids[order]
    lags = lags_in[order]
    if pids_sorted.size and (np.diff(pids_sorted) == 0).any():
        raise ValueError("params.lags contains duplicate partition ids")
    return pids_sorted, lags


def _serve_previous(prev, lags, C: int):
    """The kept-previous answer: the stream's last served choice plus
    host-computed stats for it (zero churn, no device work).  Callers check
    :func:`_keepable` first."""
    return prev, _host_choice_stats(prev, lags, C, prev, cold_start=False)


def _keepable(prev, P: int, C: int) -> bool:
    """True when the previous choice is directly servable for this epoch:
    complete, in range, and count-balanced for the current member set."""
    if prev is None or prev.shape[0] != P or P == 0:
        return False
    if int(prev.min()) < 0 or int(prev.max()) >= C:
        return False
    counts = np.bincount(prev, minlength=C)
    return int(counts.max() - counts.min()) <= 1


class DrainReject(ShedReject):
    """A request rejected because the sidecar is draining: the wire shape of
    an overload shed (class, rung ``"draining"``, ``retry_after_ms``), so
    clients reuse one backoff path; the hint means "retry another
    instance"."""

    def __init__(self, klass: str, retry_after_ms: int):
        RuntimeError.__init__(
            self,
            f"draining: new {klass!r} work is not admitted; retry "
            f"another instance after {retry_after_ms} ms",
        )
        self.klass = klass
        self.rung = "draining"
        self.retry_after_ms = retry_after_ms


class _Stream:
    """Warm per-stream solver state."""

    def __init__(self):
        self.lock = threading.Lock()
        self.engine: Optional[StreamingAssignor] = None
        self.members: List[str] = []
        self.pids = None  # np.int64[P], sorted — the row order contract
        self.flight: Optional[metrics.FlightRecorder] = None
        self.klass = "standard"  # effective SLO class of the last epoch
        # True between snapshot recovery and the stream's first post-restart
        # epoch, which re-validates the roster: a drifted membership or pid
        # set discards this stream's recovered state (a cold start).
        self.recovered = False
        # (time_s, total_lag) per served epoch — the recommend window.
        self.history = deque(maxlen=STREAM_HISTORY)
        # Delta-epoch wire state: the last accepted full lag vector (in
        # st.pids order) and its monotone epoch, the base a lag_delta
        # applies to.  Dies with the stream (poison/reset), so a client's
        # next delta answers resync and re-seeds it dense.
        self.lag_epoch = 0
        self.last_lags = None
        # Assignment-delta wire state: the last SERVED dense answer
        # (members, pids, choice) and its monotone epoch.
        self.assign_epoch = 0
        self.last_served = None
        # Resident-state quarantine strikes (utils/scrub): forgiven only
        # after FORGIVE_AFTER consecutive clean epochs; at ESCALATE_AFTER
        # the stream breaker is tripped.
        self.scrub_strikes = 0
        self.clean_epochs = 0


def _stream_ring() -> metrics.FlightRecorder:
    """One stream's private flight ring: small and in memory only."""
    return metrics.FlightRecorder(
        capacity=STREAM_FLIGHT_CAPACITY, dump_dir=""
    )


def _fresh_engine(
    C: int,
    flight: metrics.FlightRecorder,
    delta_opts: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
    mesh_backend: Any = None,
) -> StreamingAssignor:
    """THE service-default engine construction (guardrail ON at 1.25,
    unlike the library default, plus the stream's flight ring, the
    service's delta-epoch knobs, its device and ITS mesh backend — explicit,
    so a mesh-off sidecar's engines never adopt a co-resident instance's
    activated mesh): every site that makes an engine (first epoch, the
    ladder's cold rung) goes through here."""
    return StreamingAssignor(
        num_consumers=C, imbalance_guardrail=1.25, flight=flight,
        mesh_backend=mesh_backend, device=device, **(delta_opts or {}),
    )


def _apply_stream_opts(engine, opts: Dict[str, Any]) -> None:
    """Apply validated stream options to a LIVE engine — the one update
    block every epoch (and every ladder rung) uses."""
    if "refine_iters" in opts:
        engine.refine_iters = opts["refine_iters"]
    if "guardrail" in opts:
        engine.imbalance_guardrail = opts["guardrail"]
    if "refine_threshold" in opts:
        engine.refine_threshold = opts["refine_threshold"]


def _in_context(cuda_context, fn):
    """``fn`` run inside ``cuda_context`` — the watchdog worker's entry into
    the handler thread's CUDA device and stream."""
    def run(*args, **kwargs):
        with cuda_context():
            return fn(*args, **kwargs)
    return run


def _solve(
    topics, subscriptions, solver, watchdog=None, host_fallback=True,
    options=None, deadline=None, device: DeviceLike = None,
):
    """One stateless ``assign``: rows validated (no negative lag), the
    device solve under the watchdog (breaker key = the solver, deadline =
    the request's remaining budget) with the host greedy as its rung, then
    the :class:`RebalanceStats` record."""
    def _row(topic, pid, lag):
        lag = int(lag)
        if lag < 0:
            raise ValueError("params.topics contains negative lag values")
        return TopicPartitionLag(topic, int(pid), lag)

    lag_map = {
        topic: [_row(topic, pid, lag) for pid, lag in rows]
        for topic, rows in topics.items()
    }
    if solver == "global" and (options or {}).get("refine_iters"):
        # A client error at the wire boundary, before the ladder could
        # answer an unrefined assignment with the option echoed as applied.
        raise ValueError(
            "options.refine_iters is per-topic and not valid with "
            "solver 'global'"
        )
    subs = {m: list(ts) for m, ts in subscriptions.items()}
    device = resolve_device(device)
    stats = RebalanceStats(
        solver=solver,
        num_topics=len(lag_map),
        num_partitions=sum(len(v) for v in lag_map.values()),
        num_members=len(subs),
    )
    with metrics.span("assign.solve"):
        raw = solve_on_ladder(
            solver, lag_map, subs, stats, watchdog=watchdog,
            host_fallback=host_fallback, options=options, device=device,
            timeout_s=None if deadline is None else deadline.remaining(),
        )
    answered_here = not stats.fallback_used
    stats.device = (
        device.type if solver in DEVICE_SOLVERS and answered_here else None
    )
    stats.refine_iters = (
        (options or {}).get("refine_iters")
        if solver in ("rounds", "scan", "sinkhorn") and answered_here
        else None
    )
    lag_by_tp = {
        (r.topic, r.partition): r.lag for rows in lag_map.values() for r in rows
    }
    stats.total_lag = sum(lag_by_tp.values())
    summarize_assignment(
        stats, raw, {tp: lag_by_tp.get((tp.topic, tp.partition), 0)
                     for tps in raw.values() for tp in tps}
    )
    assignments = {
        m: [[tp.topic, tp.partition] for tp in tps] for m, tps in raw.items()
    }
    return assignments, stats


class _ResyncPacer:
    """Post-restart resync pacing: a restart wave's first epochs all need a
    dense rebuild of their resident state, and this caps how many run at
    once.  Excess epochs wait their turn, bounded by the request's own
    budget; on timeout the epoch proceeds unpaced (fail-open).  Each wait is
    counted in ``klba_resync_paced_total``."""

    def __init__(
        self,
        max_inflight: int,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_inflight <= 0:
            raise ValueError(f"max_inflight={max_inflight} must be > 0")
        self.max_inflight = int(max_inflight)
        self._cond = threading.Condition()
        self._active = 0
        self._clock = clock
        # High-water mark of concurrent paced rebuilds (<= max_inflight).
        self.high_water = 0
        self._m_paced = metrics.REGISTRY.counter("klba_resync_paced_total")

    def acquire(self, timeout_s: Optional[float]) -> bool:
        """Take a rebuild slot; True when one was taken (the caller must
        :meth:`release`), False when the wait timed out and the caller
        proceeds unpaced."""
        deadline = self._clock() + (
            min(timeout_s, 30.0) if timeout_s is not None else 30.0
        )
        with self._cond:
            if self._active >= self.max_inflight:
                self._m_paced.inc()
                while self._active >= self.max_inflight:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return False  # fail open: dispatch unpaced
                    self._cond.wait(min(remaining, 0.05))
            self._active += 1
            if self._active > self.high_water:
                self.high_water = self._active
            return True

    def release(self) -> None:
        with self._cond:
            self._active -= 1
            self._cond.notify()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        app = self.server.app  # type: ignore[attr-defined]
        while True:
            # Bounded read: an oversized "line" surfaces as a chunk with no
            # trailing newline instead of an unbounded buffer.
            line = self.rfile.readline(MAX_LINE_BYTES + 1)
            if not line:
                break
            try:
                # Fault point: a failed socket read surfaces as a dropped
                # connection (the client's reconnect-once policy recovers).
                faults.fire("wire.read")
            except faults.FaultError:
                LOGGER.warning("injected wire.read fault; dropping connection")
                break
            if len(line) > MAX_LINE_BYTES and not line.endswith(b"\n"):
                response = app.reject_oversized()
                self.wfile.write(response + b"\n")
                self.wfile.flush()
                if not self._drain_line():
                    break
                continue
            line = line.strip()
            if not line:
                continue
            response = app.handle_line(line)
            self.wfile.write(response + b"\n")
            self.wfile.flush()

    def _drain_line(self) -> bool:
        """Discard the rest of an oversized line in bounded chunks;
        returns False on EOF."""
        while True:
            chunk = self.rfile.readline(MAX_LINE_BYTES)
            if not chunk:
                return False
            if chunk.endswith(b"\n"):
                return True


class AssignorService:
    """The request processor + TCP front end."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        # The plugin's default (utils/config): room for a first request's
        # kernel builds (about 40 s for the round scan's source).
        solve_timeout_s: Optional[float] = 120.0,
        host_fallback: bool = True,
        # Circuit-breaker policy (utils/watchdog): per-solver breakers.
        breaker_cooldown_s: float = 300.0,
        breaker_failures: int = 3,
        # Megabatch coalescer (ops/coalesce): the admission window and the
        # per-shape batch cap (<= 1 disables coalescing; a lone live stream
        # bypasses it either way), the waves before a roster locks, and the
        # readback pipeline (False: strict serial).
        coalesce_window_ms: float = 0.5,
        coalesce_max_batch: int = 32,
        coalesce_lock_waves: int = 1,
        coalesce_pipeline: bool = True,
        # Delta epochs (ops/streaming): sparse lag uploads onto the
        # device-resident lag buffer when at most max_fraction of the
        # partitions changed, a pow2 K ladder of delta_buckets rungs, and
        # the per-stream adaptive cutoff.
        delta_enabled: bool = True,
        delta_max_fraction: float = 0.125,
        delta_buckets: int = 6,
        delta_adaptive: bool = True,
        # Multi-device sharding (sharded/): the mesh spec discovered and
        # validated ONCE at start() — "off" (default), "auto" or a device
        # count — the partition floor of the P-sharded solve, and the (S, D)
        # ("streams", "p") factorization.  A degrade (lost device, a
        # mesh.collective fault, a sharded dispatch failing) falls back to
        # the single-device backend process-wide.
        mesh_devices: Any = "off",
        mesh_solve_min_rows: int = 65536,
        mesh_shape: Any = "off",
        # Quality-mode plane (ops/dispatch): dense Sinkhorn vs the
        # linear-space path, and the linear mode's tile; installed
        # process-wide at start().
        quality_mode: str = "auto",
        quality_tile: int = 1024,
        # Opt-in plain-HTTP /metrics listener (0 = ephemeral port).
        metrics_port: Optional[int] = None,
        # SLO classes + overload control (utils/overload).
        slo_classes: Optional[Dict[str, str]] = None,
        slo_deadline_s: Optional[Dict[str, float]] = None,
        overload_latency_budget_ms: float = 0.0,
        overload_depth_high: float = 24.0,
        overload_cooldown_s: float = 1.0,
        # (max_partitions, num_consumers[, topics]) shapes warmed in
        # start() before the accept loop (:mod:`.warmup`), for the solvers
        # in ``warmup_solvers``: the first request at a warmed shape builds
        # no kernel.
        warmup_shapes: Optional[List[Tuple[int, int]]] = None,
        warmup_solvers: Tuple[str, ...] = (
            "rounds", "stream", "global", "sinkhorn",
        ),
        # Lifecycle snapshots + graceful drain (utils/snapshot).
        # ``snapshot_path`` names the snapshot (None disables snapshots and
        # recovery); the interval is the periodic cadence (churn writes
        # early, debounced); max_age is the boot-time staleness guard;
        # drain_timeout bounds the drain's wait for in-flight work.
        snapshot_path: Optional[str] = None,
        snapshot_interval_s: float = 30.0,
        snapshot_max_age_s: float = 900.0,
        drain_timeout_s: float = 10.0,
        # Cross-host hand-off: "file" (the local file), or the
        # object-store-shaped "memory" / "object" backends with versioned
        # CAS.  A lease ttl > 0 engages epoch fencing: boot acquires the
        # writer lease (waiting up to lease_wait, 0 = 2x ttl + 1 s), every
        # save carries its token, and a fenced-off predecessor's writes
        # are rejected.  A failed acquisition serves with writes denied.
        snapshot_backend: str = "file",
        snapshot_lease_ttl_s: float = 0.0,
        snapshot_lease_wait_s: float = 0.0,
        # At most this many concurrent post-restart dense rebuilds; excess
        # epochs wait their turn (klba_resync_paced_total).  <= 0 disables.
        resync_max_inflight: int = 8,
        # Rebuild each recovered stream's resident state at boot, off the
        # serving path (StreamingAssignor.prestack_resident).
        recovery_prestack: bool = False,
        # The resident-state scrubber's cadence (utils/scrub): idle streams'
        # resident tensors audited against their host mirrors, the lock
        # taken non-blocking, the pass skipped at overload rung >= 2; a
        # failed audit quarantines the stream.  <= 0 disables.
        scrub_interval_ms: float = 30_000.0,
        # Federated multi-cluster assignment (federated/): this sidecar's
        # stable peer id and its peers ("id=host:port,..." or PeerSpec
        # list).  With both set it answers peer_sync over its local lag
        # shard and serves federated_assign by synchronized dual-exchange
        # rounds inside the request's budget; only consumer-axis duals and
        # marginals cross the wire.  Per-peer breakers ride the service
        # watchdog (keys peer:<id>); an incomplete round degrades to the
        # last-good duals, then local-only, bounded by
        # federation_max_staleness_s.  federation_gossip_interval_s > 0
        # keeps the duals warm in the background; federation_capacity is
        # this cluster's per-consumer capacity weights (None: uniform).
        federation_self_id: Optional[str] = None,
        federation_peers: Any = None,
        federation_rounds: int = 16,
        federation_sync_timeout_s: float = 2.0,
        federation_max_staleness_s: float = 300.0,
        federation_gossip_interval_s: float = 0.0,
        federation_capacity: Optional[List[float]] = None,
        # False skips the warm-up of the recovered shapes in start() (tests
        # that assert recovery without paying the warm-up).
        recovery_warmup: bool = True,
        # Uptime/budget clock (injectable, monotonic).
        clock: Callable[[], float] = time.monotonic,
        # The device every solve and engine runs on (default the card).
        device: DeviceLike = None,
    ):
        # The device and the knobs are validated BEFORE the socket is
        # bound: a bad knob fails the boot loudly, not every request.
        self.device = resolve_device(device)
        if not 0.0 < float(delta_max_fraction) <= 1.0:
            raise ValueError(
                f"delta_max_fraction={delta_max_fraction} must be in "
                "(0, 1]"
            )
        if int(delta_buckets) < 0:
            raise ValueError(
                f"delta_buckets={delta_buckets} must be >= 0"
            )
        from .utils.snapshot import BACKEND_KINDS

        if snapshot_backend not in BACKEND_KINDS:
            raise ValueError(
                f"snapshot_backend={snapshot_backend!r} invalid; "
                f"choose one of {list(BACKEND_KINDS)}"
            )
        if float(snapshot_lease_ttl_s) < 0:
            raise ValueError(
                f"snapshot_lease_ttl_s={snapshot_lease_ttl_s} must be "
                ">= 0"
            )
        self._quality_mode = normalize_quality_mode(quality_mode)
        self._quality_tile = validate_quality_tile(quality_tile)
        self._slo = SloPolicy(
            classes=slo_classes, deadline_s=slo_deadline_s
        )
        self._watchdog = Watchdog(
            solve_timeout_s,
            cooldown_s=breaker_cooldown_s,
            failure_threshold=breaker_failures,
        )
        self._overload = OverloadController(
            latency_budget_ms=(
                overload_latency_budget_ms if overload_latency_budget_ms > 0
                else (solve_timeout_s or 120.0) * 500.0
            ),
            depth_high=overload_depth_high,
            cooldown_s=overload_cooldown_s,
            breaker_open=lambda: self._watchdog.state("stream") == "open",
        )
        self._tcp = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True
        )
        self._tcp.daemon_threads = True
        self._tcp.app = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._host_fallback = host_fallback
        self._streams: Dict[str, _Stream] = {}
        self._streams_lock = threading.Lock()
        # Last-answered choice per POISONED stream: the next epoch
        # warm-restarts from what the clients run.  Bounded by MAX_STREAMS;
        # consumed on use or stream_reset.
        self._snapshots: Dict[str, Tuple] = {}
        from .ops.streaming import delta_k_ladder

        ladder = delta_k_ladder(delta_buckets) if delta_enabled else []
        # The device and stream the scrubber's reads and the coalescer's
        # waves run on: those of the thread that builds the service.
        self._cuda_context = carry_cuda_context(self.device)
        # The mesh manager: built here (cheap and inert), discovered and
        # activated in start() (never per request).  None when "off".
        from .sharded.mesh import MeshManager, _parse_spec

        self._mesh = (
            MeshManager(devices=mesh_devices,
                        solve_min_rows=int(mesh_solve_min_rows), shape=mesh_shape)
            if _parse_spec(mesh_devices) != "off" else None
        )
        if int(coalesce_max_batch) > 1:
            from .ops.coalesce import MegabatchCoalescer

            self._coalescer = MegabatchCoalescer(
                window_s=max(float(coalesce_window_ms), 0.0) / 1000.0,
                max_batch=int(coalesce_max_batch),
                lock_waves=int(coalesce_lock_waves),
                pipeline=bool(coalesce_pipeline),
                delta_k=ladder[-1] if ladder else 0,
                mesh_manager=self._mesh,
                device=self.device,
                cuda_context=self._cuda_context,
            )
        else:
            self._coalescer = None
        self._delta_opts = {
            "delta_enabled": bool(delta_enabled),
            "delta_max_fraction": float(delta_max_fraction),
            "delta_buckets": int(delta_buckets),
            "delta_adaptive": bool(delta_adaptive),
        }
        self._metrics_port = metrics_port
        self._metrics_http = None
        # Weighted in-flight stream-request depth (the controller's queue
        # signal), under its own leaf lock.
        self._inflight_lock = threading.Lock()
        self._inflight_weight = 0.0
        # The wire ``stats`` counters are a DELTA VIEW over the registry
        # series, baselined at construction (the registry is process-wide).
        self._stats_base = {
            "requests_served": _counter_total("klba_requests_total"),
            "errors": _counter_total("klba_request_errors_total"),
            "fallbacks": _counter_total("klba_fallbacks_total"),
        }
        self._clock = clock
        self._started = clock()
        # Normalize (P, C) -> (P, C, topics=1).
        self._warmup_shapes = [
            (s[0], s[1], s[2] if len(s) > 2 else 1)
            for s in (warmup_shapes or [])
        ]
        self._warmup_solvers = tuple(warmup_solvers)
        # What the warm-up drives: 0 delta rungs when delta mode is off.
        self._warm_delta_buckets = int(delta_buckets) if delta_enabled else 0
        # Lifecycle: the serving/draining/stopped state (read on every
        # admission as a plain attribute, written under the lifecycle
        # lock), the snapshot store and writer, the drain bookkeeping.
        self._lifecycle = "serving"
        self._lifecycle_lock = threading.Lock()
        self._listener_closed = False
        self._drain_timeout_s = float(drain_timeout_s)
        self._drain_thread: Optional[threading.Thread] = None
        self._stopped_event = threading.Event()
        self._active_cond = threading.Condition()
        self._active_requests = 0
        self._last_recovery: Optional[Dict[str, Any]] = None
        # (P, C) of the recovered streams, warmed in start() off the
        # serving path; appended only during boot recovery (at most
        # MAX_STREAMS).
        self._recovery_shapes: List[Tuple[int, int]] = []
        self._snapshot_max_age_s = float(snapshot_max_age_s)
        self._recovery_warmup = bool(recovery_warmup)
        self._m_lifecycle = metrics.REGISTRY.gauge("klba_lifecycle_state")
        self._m_lifecycle.set(0)
        # The boot-time lease handshake's outcome (stats lifecycle.handoff).
        self._last_handoff: Optional[Dict[str, Any]] = None
        self._lease_wait_s = (
            float(snapshot_lease_wait_s)
            if snapshot_lease_wait_s > 0
            else float(snapshot_lease_ttl_s) * 2.0 + 1.0
        )
        self._recovery_prestack = bool(recovery_prestack)
        # Takeover warming: each recovered stream's class weight, parked as
        # the overload controller's standing pressure until its first
        # post-boot epoch is served (or it is reset, discarded or poisoned,
        # or the TTL passes).  Guarded by _streams_lock.
        self._takeover_warming: Dict[str, float] = {}
        self._takeover_deadline: Optional[float] = None
        if scrub_interval_ms and float(scrub_interval_ms) > 0:
            self._scrubber = scrub_lib.StateScrubber(
                targets=self._scrub_targets,
                interval_s=float(scrub_interval_ms) / 1000.0,
                suppress=lambda: self._overload.rung() >= 2,
            )
        else:
            self._scrubber = None
        self._resync_pacer = (
            _ResyncPacer(int(resync_max_inflight), clock=clock)
            if int(resync_max_inflight) > 0 else None
        )
        if snapshot_path:
            from .utils.snapshot import (
                SnapshotStore,
                SnapshotWriter,
                build_backend,
            )

            self._snapshot_store = SnapshotStore(
                backend=build_backend(snapshot_backend, snapshot_path)
            )
            if snapshot_lease_ttl_s > 0:
                # Unique per INSTANCE: two services in one process must be
                # told apart by the fencing protocol.
                owner = (
                    f"{socket.gethostname()}:{os.getpid()}:"
                    f"{next(_OWNER_SEQ)}"
                )
                self._snapshot_store.attach_lease(
                    owner, float(snapshot_lease_ttl_s)
                )
            self._snapshot_writer = SnapshotWriter(
                self._snapshot_store,
                self._snapshot_sections,
                interval_s=float(snapshot_interval_s),
            )
        else:
            self._snapshot_store = None
            self._snapshot_writer = None
        # Federated peer coordination (federated/peers), built only when
        # configured.  The per-peer breakers live on the service watchdog,
        # so stats.breakers shows sidelined peers beside sidelined solvers;
        # the fencing token is the snapshot writer lease's, read lazily.
        if federation_self_id:
            from .federated import FederationCoordinator, parse_peer_specs

            specs = federation_peers or []
            if isinstance(specs, str):
                specs = parse_peer_specs(specs)
            self._federation = FederationCoordinator(
                self_id=str(federation_self_id),
                peers=list(specs),
                watchdog=self._watchdog,
                max_rounds=int(federation_rounds),
                sync_timeout_s=float(federation_sync_timeout_s),
                max_staleness_s=float(federation_max_staleness_s),
                fence_token=self._federation_fence_token,
                clock=clock,
                capacity=federation_capacity,
                gossip_interval_s=float(federation_gossip_interval_s),
                device=self.device,
            )
        else:
            if federation_peers:
                raise ValueError("federation_peers requires federation_self_id")
            self._federation = None

    @property
    def requests_served(self) -> int:
        """Wire requests answered since THIS service was constructed (a
        registry view; with two services alive in one process each also
        counts the other's traffic)."""
        return (
            _counter_total("klba_requests_total")
            - self._stats_base["requests_served"]
        )

    @property
    def errors(self) -> int:
        return (
            _counter_total("klba_request_errors_total")
            - self._stats_base["errors"]
        )

    @property
    def fallbacks(self) -> int:
        """Answers given by a host-side fallback rung."""
        return (
            _counter_total("klba_fallbacks_total")
            - self._stats_base["fallbacks"]
        )

    @classmethod
    def from_config(
        cls,
        configs,
        host: str = "127.0.0.1",
        port: int = 0,
        **overrides,
    ) -> "AssignorService":
        """Build a sidecar from a Kafka-style consumer config map, reading
        the keys this sidecar serves (utils/config.parse_config):
        ``solve.timeout.ms``, ``host.fallback``, ``breaker.*``,
        ``coalesce.*``, ``delta.*``, ``mesh.*``, ``quality.*``,
        ``slo.class.<stream>`` /
        ``slo.deadline.ms.<class>`` / ``overload.*``, ``metrics.port``,
        ``snapshot.*`` / ``drain.timeout.ms``, ``resync.max.inflight``,
        ``recovery.prestack``, ``scrub.interval.ms`` and ``warmup.shapes``.
        Explicit ``overrides`` win (``device``, or a test pinning
        ``metrics_port=0``)."""
        from .utils.config import parse_config

        cfg = parse_config(configs)
        kwargs = {
            "solve_timeout_s": cfg.solve_timeout_s,
            "host_fallback": cfg.host_fallback,
            "breaker_cooldown_s": cfg.breaker_cooldown_s,
            "breaker_failures": cfg.breaker_failures,
            "coalesce_window_ms": cfg.coalesce_window_s * 1000.0,
            "coalesce_max_batch": cfg.coalesce_max_batch,
            "coalesce_lock_waves": cfg.coalesce_lock_waves,
            "coalesce_pipeline": cfg.coalesce_pipeline,
            "delta_enabled": cfg.delta_enabled,
            "delta_max_fraction": cfg.delta_max_fraction,
            "delta_buckets": cfg.delta_buckets,
            "delta_adaptive": cfg.delta_adaptive,
            "mesh_devices": cfg.mesh_devices,
            "mesh_solve_min_rows": cfg.mesh_solve_min_rows,
            "mesh_shape": cfg.mesh_shape,
            "quality_mode": cfg.quality_mode,
            "quality_tile": cfg.quality_tile,
            "metrics_port": cfg.metrics_port,
            "slo_classes": cfg.slo_classes,
            "slo_deadline_s": cfg.slo_deadline_s,
            "overload_latency_budget_ms": cfg.overload_latency_budget_ms,
            "overload_depth_high": cfg.overload_depth_high,
            "snapshot_path": cfg.snapshot_path,
            "snapshot_interval_s": cfg.snapshot_interval_s,
            "snapshot_max_age_s": cfg.snapshot_max_age_s,
            "drain_timeout_s": cfg.drain_timeout_s,
            "snapshot_backend": cfg.snapshot_backend,
            "snapshot_lease_ttl_s": cfg.snapshot_lease_ttl_s,
            "snapshot_lease_wait_s": cfg.snapshot_lease_wait_s,
            "resync_max_inflight": cfg.resync_max_inflight,
            "recovery_prestack": cfg.recovery_prestack,
            "scrub_interval_ms": cfg.scrub_interval_s * 1000.0,
            "federation_self_id": cfg.federation_self_id,
            "federation_peers": cfg.federation_peers or None,
            "federation_rounds": cfg.federation_rounds,
            "federation_sync_timeout_s": cfg.federation_sync_timeout_s,
            "federation_max_staleness_s": cfg.federation_max_staleness_s,
            "federation_gossip_interval_s": cfg.federation_gossip_interval_s,
            "federation_capacity": cfg.federation_capacity,
            "warmup_shapes": cfg.warmup_shapes or None,
        }
        kwargs.update(overrides)
        return cls(host, port, **kwargs)

    @property
    def address(self) -> Tuple[str, int]:
        return self._tcp.server_address  # type: ignore[return-value]

    # -- request processing ------------------------------------------------

    def reject_oversized(self) -> bytes:
        metrics.REGISTRY.counter(
            "klba_request_errors_total", {"method": "oversized"}
        ).inc()
        LOGGER.warning("rejected oversized request line (> %d bytes)",
                       MAX_LINE_BYTES)
        return json.dumps(
            {
                "id": None,
                "request_id": metrics.mint_request_id(),
                "error": {
                    "message": f"request line exceeds {MAX_LINE_BYTES} bytes"
                },
            }
        ).encode()

    def handle_line(self, line: bytes) -> bytes:
        """One wire request: a request scope (adopting the caller's
        ``traceparent``), a ``wire.<method>`` span,
        ``klba_requests_total`` / ``klba_request_errors_total`` and the
        deadline-budget consumption.  Counted in flight for the drain,
        which waits for the count to reach zero."""
        with self._active_cond:
            self._active_requests += 1
        try:
            return self._handle_line_counted(line)
        finally:
            with self._active_cond:
                self._active_requests -= 1
                self._active_cond.notify_all()

    def _handle_line_counted(self, line: bytes) -> bytes:
        # Parse BEFORE opening the scope: the trace context rides the line
        # (top-level ``traceparent``, or inside ``params``).
        req: Dict[str, Any] = {}
        parse_error: Optional[Exception] = None
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                req, parse_error = {}, TypeError(
                    f"request must be a JSON object, got "
                    f"{type(req).__name__}"
                )
        except Exception as exc:  # noqa: BLE001 — answered in-scope below
            parse_error = exc
        traceparent = req.get("traceparent")
        if traceparent is None:
            params = req.get("params")
            if isinstance(params, dict):
                traceparent = params.get("traceparent")
        with metrics.request_scope(traceparent=traceparent) as rid:
            trace_id = metrics.current_trace_id()
            req_id = req.get("id")
            label = "unknown"
            try:
                if parse_error is not None:
                    raise parse_error
                method = req.get("method")
                if method in _KNOWN_METHODS:
                    label = method
                with metrics.span(f"wire.{label}"):
                    result, budget = self._dispatch(method, req)
                metrics.REGISTRY.counter(
                    "klba_requests_total", {"method": label}
                ).inc()
                if budget is not None and budget.total_s is not None:
                    metrics.REGISTRY.histogram(
                        "klba_deadline_budget_consumed_ms",
                        {"method": label},
                    ).observe(budget.consumed_ms())
                return json.dumps(
                    {
                        "id": req_id, "request_id": rid,
                        "trace_id": trace_id, "result": result,
                    }
                ).encode()
            except ShedReject as exc:
                # An overload shed is a DECISION, not a failure: counted as
                # a served request and answered as a structured error.
                metrics.REGISTRY.counter(
                    "klba_requests_total", {"method": label}
                ).inc()
                LOGGER.warning("request shed: %s", exc)
                return json.dumps(
                    {
                        "id": req_id,
                        "request_id": rid,
                        "trace_id": trace_id,
                        "error": {
                            "message": str(exc),
                            "shed": {
                                "class": exc.klass,
                                "rung": exc.rung,
                                "retry_after_ms": exc.retry_after_ms,
                            },
                        },
                    }
                ).encode()
            except Exception as exc:  # noqa: BLE001 — wire boundary
                trace_mod.mark("error")
                metrics.REGISTRY.counter(
                    "klba_request_errors_total", {"method": label}
                ).inc()
                LOGGER.warning("service request failed", exc_info=True)
                return json.dumps(
                    {
                        "id": req_id,
                        "request_id": rid,
                        "trace_id": trace_id,
                        "error": {"message": str(exc)},
                    }
                ).encode()

    def _dispatch(
        self, method: Any, req: Dict[str, Any]
    ) -> Tuple[Any, Optional[_DeadlineBudget]]:
        """Route one parsed request; returns (result, deadline budget)."""
        handler = {
            "ping": self._ping,
            "stats": self._stats,
            "metrics": self._metrics,
            "trace": self._trace,
            "assign": self._assign,
            "stream_assign": self._stream_assign_request,
            "stream_reset": self._stream_reset,
            "recommend": self._recommend,
            "stream_flight": self._stream_flight,
            "drain": self._drain,
            "peer_sync": self._peer_sync,
            "federation": self._federation_status,
            "federated_assign": self._federated_assign_request,
        }.get(method) if isinstance(method, str) else None
        if handler is None:
            raise ValueError(f"unknown method {method!r}")
        return handler(req.get("params") or {})

    def _ping(self, params):
        return "pong", None

    def _drain(self, params):
        # Graceful drain over the wire (SIGTERM's path): answered at once
        # with the lifecycle state; the drain runs on its own thread, so
        # this connection gets its reply before the listener goes away.
        initiated = self.begin_drain()
        return {"state": self._lifecycle, "initiated": initiated}, None

    def _stats(self, params):
        result: Dict[str, Any] = {
            "requests_served": self.requests_served,
            "errors": self.errors,
            "fallbacks": self.fallbacks,
            "uptime_s": self._clock() - self._started,
        }
        with self._streams_lock:
            result["live_streams"] = len(self._streams)
            result["poisoned_snapshots"] = len(self._snapshots)
        # Per-solver circuit-breaker states + trip counters.
        result["breakers"] = self._watchdog.stats()
        # The shed ladder's position + pressure signals.
        result["overload"] = self._overload.snapshot()
        if self._coalescer is not None:
            # Roster tracking: locked rosters and the hit / re-stack /
            # invalidation / dead-row counters.
            result["coalesce"] = self._coalescer.stats()
        result["federation"] = (
            self._federation.status() if self._federation is not None else None
        )
        # The device mesh; None when mesh_devices is "off".
        result["mesh"] = self._mesh.status() if self._mesh is not None else None
        # Lifecycle: serving/draining/stopped, the snapshot store, the last
        # recovery, the writer lease and the boot's hand-off.
        result["lifecycle"] = self.lifecycle_stats()
        # The scrubber's coverage and quarantine counts; None when off.
        result["scrub"] = self.scrub_stats()
        result["quality"] = quality_status(self.device)
        # The active fault drill's seed + per-point {calls, fired}.
        inj = faults.active()
        result["faults"] = (
            None if inj is None
            else {
                "seed": inj.seed,
                "epoch": inj.epoch,
                "points": inj.snapshot(),
            }
        )
        return result, None

    def _metrics(self, params):
        # The registry both ways (structured JSON, Prometheus text) plus
        # the flight recorder; ``params.view`` trims to one section.
        view = params.get("view")
        if view not in (None, "json", "prometheus", "flight"):
            raise ValueError(
                f"unknown metrics view {view!r}; valid: "
                "['flight', 'json', 'prometheus']"
            )
        result: Dict[str, Any] = {}
        if view in (None, "json", "prometheus"):
            snap = metrics.REGISTRY.snapshot()
            if view in (None, "json"):
                result["json"] = snap
            if view in (None, "prometheus"):
                result["prometheus"] = metrics.REGISTRY.prometheus(snap)
        if view in (None, "flight"):
            last = metrics.FLIGHT.last_dump()
            result["flight"] = {
                "records": len(metrics.FLIGHT.records()),
                "dumps": metrics.FLIGHT.dump_count(),
                "last_dump_reason": last["reason"] if last else None,
                "last_dump": last,
            }
        return result, None

    def _trace(self, params):
        # The tail sampler's view: retention stats plus kept traces,
        # narrowed by ``params.trace_id`` and capped by ``params.limit``.
        want = params.get("trace_id")
        if want is not None and not isinstance(want, str):
            raise ValueError(
                f"trace_id must be a string, got "
                f"{type(want).__name__}"
            )
        limit = params.get("limit", 8)
        limit = None if limit is None else int(limit)
        coll = trace_mod.COLLECTOR
        return {
            "stats": coll.stats(),
            "traces": coll.traces(trace_id=want, limit=limit),
        }, None

    def _assign(self, params):
        self._reject_if_draining("standard")
        solver = params.get("solver", "rounds")
        if solver not in VALID_SOLVERS:
            raise ValueError(
                f"unknown solver {solver!r}; valid: {list(VALID_SOLVERS)}"
            )
        options = _validate_options(params.get("options") or {})
        budget = _DeadlineBudget(
            self._watchdog.timeout_s, clock=self._clock
        )
        assignments, stats = _solve(
            params.get("topics") or {},
            params.get("subscriptions") or {},
            solver,
            watchdog=self._watchdog,
            host_fallback=self._host_fallback,
            options=options,
            deadline=budget,
            device=self.device,
        )
        rung = "host_greedy" if stats.fallback_used else "none"
        metrics.REGISTRY.counter(
            "klba_ladder_rung_total", {"method": "assign", "rung": rung}
        ).inc()
        metrics.FLIGHT.record(
            "wire_assign",
            {
                "solver": solver,
                "rung": rung,
                "num_partitions": stats.num_partitions,
                "num_members": stats.num_members,
                "total_lag": stats.total_lag,
                "quality_ratio": stats.quality_ratio,
                "fallback_used": stats.fallback_used,
                "breaker_state": stats.breaker_state,
            },
        )
        if stats.fallback_used:
            metrics.REGISTRY.counter(
                "klba_fallbacks_total", {"method": "assign"}
            ).inc()
            trace_mod.mark("ladder")
            metrics.FLIGHT.auto_dump(
                "ladder",
                {"method": "assign", "rung": rung, "solver": solver},
            )
        return {
            "assignments": assignments,
            "stats": json.loads(stats.to_json()),
            # Effective (quantized) option values actually used.
            "options": options,
        }, budget

    # -- federated assignment (federated/) ---------------------------------

    def _peer_sync(self, params):
        """A peer's dual-exchange round over this sidecar's registered local
        lag shard; every answer is built by the audited ``federated/wire``
        serializer (consumer-axis aggregates only, never raw lags)."""
        if self._federation is None:
            raise ValueError("federation is not configured on this sidecar")
        return self._federation.serve_sync(params), None

    def _federation_status(self, params):
        """The operator surface: peer links (breaker, last outcome, the
        epoch / fence ledger), the rung and the last-good cache's age."""
        if self._federation is None:
            return {"enabled": False}, None
        out = self._federation.status()
        out["enabled"] = True
        return out, None

    def _federated_assign_request(self, params):
        klass = self._slo.resolve(None, params.get("slo_class"))
        self._reject_if_draining(klass)
        budget = _DeadlineBudget(
            self._slo.budget_s(klass, self._watchdog.timeout_s),
            clock=self._clock,
        )
        result = self._federated_assign(params, budget, klass)
        rung = result["federation"]["rung"]
        metrics.REGISTRY.counter(
            "klba_ladder_rung_total",
            {"method": "federated_assign", "rung": rung},
        ).inc()
        if rung != "global":
            trace_mod.mark("ladder")
            metrics.FLIGHT.auto_dump(
                "ladder", {"method": "federated_assign", "rung": rung},
            )
        return result, budget

    def _federation_fence_token(self) -> Optional[int]:
        """The fencing token stamped on peer-bound payloads: the snapshot
        writer lease's token when fencing is on, else None (one token fences
        a replaced instance's snapshot writes and its peer syncs)."""
        store = self._snapshot_store
        if store is None or not store.fencing_enabled:
            return None
        return store.lease_token

    def _federated_assign(
        self, params: Dict[str, Any], budget: _DeadlineBudget, klass: str
    ) -> Dict[str, Any]:
        """One federated epoch: register the local shard, run the exchange
        rounds inside the remaining budget and serve the LOCAL shard's slice
        of the converged global assignment, or degrade down the federation
        ladder to the single-cluster stateless ``rounds`` solve.  The request
        rides the overload admission and in-flight depth of
        ``stream_assign``."""
        if self._federation is None:
            raise ValueError("federation is not configured on this sidecar")
        topic = params.get("topic", "t0")
        members = params.get("members") or []
        if not isinstance(members, list) or not members:
            raise ValueError("params.members must be a non-empty list")
        members_sorted = sorted(str(m) for m in members)
        if len(set(members_sorted)) != len(members_sorted):
            raise ValueError("params.members contains duplicates")
        C = len(members_sorted)
        rows = _decode_wire_lags(params)
        pids_sorted, lags = _parse_lag_rows(rows)
        resp_enc = _parse_accept_encoding(params)

        # A degrade decision skips the peer rounds: local-only is the cheap
        # answer (a stateless solve has no previous choice to keep).
        decision = self._admit_solve_work(klass)
        force_local = False
        if decision is not None and decision.action == "degrade":
            self._overload.note_shed(klass, decision.rung_name, "local_only")
            force_local = True

        with self._inflight(klass):
            if force_local:
                fed = {
                    "rung": "local_only", "choice": None, "rounds": 0,
                    "peers_ok": 0, "staleness_s": None, "converged": False,
                }
            else:
                fed = self._federation.assign(lags, C, budget.remaining)
            if fed["choice"] is not None:
                choice = fed["choice"]
                s = _host_choice_stats(choice, lags, C, None, cold_start=True)
                pids_l = pids_sorted.tolist()
                assignments: Dict[str, List[List[Any]]] = {m: [] for m in members_sorted}
                for row, consumer in enumerate(list(choice)):
                    assignments[members_sorted[int(consumer)]].append(
                        [topic, pids_l[row]])
                stats_out = {
                    "max_mean_imbalance": s.max_mean_imbalance,
                    "imbalance_bound": s.imbalance_bound,
                    "quality_ratio": s.quality_ratio,
                    "count_spread": s.count_spread,
                }
            else:
                # Rung local_only: the single-cluster behavior, unchanged —
                # the stateless rounds solve (K1 on the card) with the host
                # greedy as its rung, inside what is left of the SAME budget.
                rows_plain = [[int(p), int(v)] for p, v in zip(pids_sorted, lags)]
                assignments, rb_stats = _solve(
                    {topic: rows_plain},
                    {m: [topic] for m in members_sorted},
                    "rounds",
                    watchdog=self._watchdog,
                    host_fallback=self._host_fallback,
                    deadline=budget,
                    device=self.device,
                )
                stats_out = json.loads(rb_stats.to_json())
            fed_out = {
                "rung": fed["rung"],
                "rounds": fed["rounds"],
                "converged": fed["converged"],
                "peers_ok": fed["peers_ok"],
                "staleness_s": fed["staleness_s"],
                # True when the gossip daemon's warm duals served this
                # assign in one local round (no synchronous peer RTT).
                "warm_cache": bool(fed.get("warm_cache", False)),
                "epoch": self._federation.local_epoch,
            }
            metrics.FLIGHT.record(
                "federation_assign",
                {
                    "rung": fed["rung"],
                    "rounds": fed["rounds"],
                    "converged": fed["converged"],
                    "num_partitions": int(lags.shape[0]),
                    "num_members": C,
                    "slo_class": klass,
                },
            )
            return {
                **_encode_dense_assignments(assignments, resp_enc),
                "federation": fed_out,
                "stats": stats_out,
            }

    def _stream_assign_request(self, params):
        # SLO class: wire override > config map > "standard"; the class's
        # deadline budget (if configured) caps this request's budget.
        klass = self._slo.resolve(
            params.get("stream_id"), params.get("slo_class")
        )
        self._reject_if_draining(klass)
        budget = _DeadlineBudget(
            self._slo.budget_s(klass, self._watchdog.timeout_s),
            clock=self._clock,
        )
        result = self._stream_assign(params, budget, klass)
        s = result["stream"]
        rung = s["degraded_rung"]
        metrics.REGISTRY.counter(
            "klba_ladder_rung_total",
            {"method": "stream_assign", "rung": rung},
        ).inc()
        if s["fallback_used"]:
            metrics.REGISTRY.counter(
                "klba_fallbacks_total", {"method": "stream_assign"}
            ).inc()
        metrics.FLIGHT.record(
            "wire_stream",
            {
                "rung": rung,
                "cold_start": s["cold_start"],
                "refined": s["refined"],
                "guardrail_tripped": s["guardrail_tripped"],
                "churn": s["churn"],
                "quality_ratio": s["quality_ratio"],
                "warm_restart": s["warm_restart"],
                "fallback_used": s["fallback_used"],
                "slo_class": s["slo_class"],
                "shed": s["shed"],
            },
        )
        if rung != "none":
            # Past the first ladder rung: a flight-recorder incident.
            trace_mod.mark("ladder")
            metrics.FLIGHT.auto_dump(
                "ladder", {"method": "stream_assign", "rung": rung}
            )
        return result, budget

    def _stream_reset(self, params):
        sid = params.get("stream_id")
        with self._streams_lock:
            dropped = self._streams.pop(sid, None) is not None
            self._snapshots.pop(sid, None)
        if dropped:
            self._mark_churn()
            self._release_takeover(sid)
        return {"dropped": dropped}, None

    def _recommend(self, params):
        # The elasticity loop: per-stream consumer-count recommendations
        # from the lag-trend windows, plus the overload state;
        # params.stream_id narrows to one stream.
        only = params.get("stream_id")
        horizon = params.get("horizon_s", 60.0)
        if isinstance(horizon, bool) or not isinstance(
            horizon, (int, float)
        ) or not 1.0 <= float(horizon) <= 86400.0:
            raise ValueError(
                "params.horizon_s must be a number in [1, 86400]"
            )
        with self._streams_lock:
            items = list(self._streams.items())
        streams: Dict[str, Any] = {}
        for sid, st in items:
            if only is not None and sid != only:
                continue
            # A monitoring read without the stream lock (the history deque
            # appends are GIL-atomic).
            samples = list(st.history)
            streams[sid] = {
                "slo_class": st.klass,
                "consumers": len(st.members),
                "partitions": (
                    int(st.pids.shape[0]) if st.pids is not None else 0
                ),
                "samples": samples,
            }
        return recommend_payload(
            streams, self._overload.snapshot(),
            horizon_s=float(horizon),
        ), None

    def _stream_flight(self, params):
        # One stream's private flight ring, dumped (and optionally cleared).
        sid = params.get("stream_id")
        with self._streams_lock:
            st = self._streams.get(sid)
            ring = st.flight if st is not None else None
        if ring is None:
            raise ValueError(f"unknown stream {sid!r}")
        records = ring.snapshot()  # redacted copies, oldest first
        cleared = bool(params.get("clear", False))
        if cleared:
            ring.clear()
        return {
            "stream_id": sid,
            "records": records,
            "cleared": cleared,
        }, None

    def _stream_assign(
        self,
        params: Dict[str, Any],
        budget: Optional[_DeadlineBudget] = None,
        klass: str = "standard",
    ) -> Dict[str, Any]:
        if budget is None:
            budget = _DeadlineBudget(self._watchdog.timeout_s)

        sid = params.get("stream_id")
        if not isinstance(sid, str) or not sid:
            raise ValueError("params.stream_id must be a non-empty string")
        topic = params.get("topic", "t0")
        rows = _decode_wire_lags(params)
        delta_params = params.get("lag_delta")
        members = params.get("members") or []
        if not isinstance(members, list) or not members:
            raise ValueError("params.members must be a non-empty list")
        members_sorted = sorted(str(m) for m in members)
        if len(set(members_sorted)) != len(members_sorted):
            raise ValueError("params.members contains duplicates")
        C = len(members_sorted)
        opts = _validate_stream_options(params.get("options") or {})
        ack = _parse_assign_ack(params)
        resp_enc = _parse_accept_encoding(params)

        if delta_params is not None and rows:
            raise ValueError(
                "params.lags and params.lag_delta are mutually exclusive"
            )
        if delta_params is not None:
            # Type validation only: the delta applies against the stream's
            # stored base under its lock, inside the admitted path.
            delta = _parse_lag_delta(delta_params)
            lags = None
            pids_sorted = None
        else:
            delta = None
            pids_sorted, lags = _parse_lag_rows(rows)

        # Overload admission decides this request's fate BEFORE any stream
        # state is touched.
        decision = self._admit_solve_work(klass, stream_id=sid)

        with self._inflight(klass):
            return self._stream_assign_admitted(
                budget, klass, decision,
                sid, topic, lags, pids_sorted, members_sorted, C, opts,
                delta=delta, ack=ack, resp_enc=resp_enc,
            )

    @contextmanager
    def _inflight(self, klass: str):
        """The weighted in-flight depth bracket: add this request's class
        weight, feed the controller the new depth, and ALWAYS release."""
        weight = CLASS_WEIGHTS.get(klass, 1.0)
        with self._inflight_lock:
            self._inflight_weight += weight
            depth = self._inflight_weight
        self._overload.note_depth(depth)
        try:
            yield
        finally:
            with self._inflight_lock:
                self._inflight_weight -= weight

    def _admit_solve_work(
        self, klass: str, stream_id: Optional[str] = None
    ):
        """THE overload admission: feed the CURRENT in-flight depth before
        deciding (so an all-shed class mix cannot freeze the depth EWMA at
        its peak), decide FAIL-OPEN (the ``shed.decide`` fault point or a
        controller bug must never take healthy traffic down), and raise
        the structured reject.  Returns the decision (None when the
        decision path failed open)."""
        with self._inflight_lock:
            depth_now = self._inflight_weight
        self._overload.note_depth(depth_now)
        self._expire_takeover_warming()
        decision = None
        try:
            decision = self._overload.admission(klass)
        except Exception:
            LOGGER.warning(
                "overload admission decision failed; failing open "
                "(admit)", exc_info=True,
            )
        if decision is not None and self._coalescer is not None:
            # Rung 1 and up shrink the admission window per class:
            # best_effort waves first, the critical window last.
            self._coalescer.set_window_scales(decision.window_scales)
        if decision is not None and decision.action == "reject":
            self._overload.note_shed(
                klass, decision.rung_name, "rejected",
                stream_id=stream_id,
            )
            raise ShedReject(
                klass, decision.rung_name, decision.retry_after_ms
            )
        return decision

    def _acquire_stream(self, sid: str) -> Tuple[_Stream, bool]:
        """The stream's state, created when absent (at most MAX_STREAMS),
        with its lock HELD; ``created`` says whether this request made it.
        A stream poisoned or reset while this request waited on its lock is
        re-validated under the lock and the loop starts over."""
        created = False
        while True:
            with self._streams_lock:
                st = self._streams.get(sid)
                if st is None:
                    if len(self._streams) >= MAX_STREAMS:
                        raise ValueError(
                            f"too many live streams (max {MAX_STREAMS}); "
                            "stream_reset unused ones"
                        )
                    st = self._streams[sid] = _Stream()
                    created = True
            st.lock.acquire()
            with self._streams_lock:
                if self._streams.get(sid) is st:
                    return st, created
            st.lock.release()

    def _stream_assign_admitted(
        self, budget, klass, decision,
        sid, topic, lags, pids_sorted, members_sorted, C, opts,
        delta=None, ack=None, resp_enc=None,
    ) -> Dict[str, Any]:
        """The admitted remainder of a stream_assign: stream state, the
        solve (or the degrade rung's kept_previous), the ladder."""
        st, created = self._acquire_stream(sid)
        if created:
            # Roster churn: a new tenant reaches the snapshot ahead of the
            # periodic cadence (debounced).
            self._mark_churn()
        try:
            warm_restart = False
            if delta is not None:
                # Apply the sparse delta against the stored base.  Any
                # reason it cannot apply forces a dense RE-SYNC: the
                # previous assignment is served with ``resync: true`` when
                # servable, else the request errors asking for full lags.
                resolved = self._apply_wire_delta(st, delta)
                if isinstance(resolved, str):
                    return self._resync(st, created, sid, resolved, topic,
                                        members_sorted, C, opts, klass,
                                        ack, resp_enc)
                lags, pids_sorted = resolved
            if st.engine is None:
                st.flight = _stream_ring()
                st.engine = _fresh_engine(C, st.flight, self._delta_opts,
                                          self.device, self._mesh)
                st.members = members_sorted
                # Poisoned-stream recovery: if the last epoch for this sid
                # died on the snake rung, warm-restart from what the
                # clients were handed, unless the roster moved on.
                with self._streams_lock:
                    snap = self._snapshots.pop(sid, None)
                if snap is not None:
                    snap_members, snap_pids, snap_choice = snap
                    if snap_members == members_sorted and np.array_equal(
                        snap_pids, pids_sorted
                    ):
                        st.engine.seed_choice(snap_choice)
                        st.pids = snap_pids
                        warm_restart = True
            elif st.recovered and (
                st.members != members_sorted
                or st.pids is None
                or st.pids.shape[0] != pids_sorted.shape[0]
                or not np.array_equal(st.pids, pids_sorted)
            ):
                # Recovered-stream drift guard: the snapshot predates
                # whatever moved this roster, so its state is discarded
                # (a cold start on an engine sized for the NEW roster);
                # every other recovered stream keeps its seed.
                LOGGER.warning(
                    "recovered stream %r arrived with a drifted roster; "
                    "discarding its snapshot state (cold start)", sid,
                )
                st.engine = _fresh_engine(C, st.flight, self._delta_opts,
                                          self.device, self._mesh)
                st.members = members_sorted
                st.pids = None
                metrics.REGISTRY.counter(
                    "klba_recovery_streams_total",
                    {"outcome": "discarded_drift"},
                ).inc()
                self._mark_churn()
            elif st.members != members_sorted:
                # Membership change: remap by NAME so survivors keep their
                # partitions (the engine's repair pass re-seats orphans).
                new_rank = {m: i for i, m in enumerate(members_sorted)}
                old_to_new = np.fromiter(
                    (new_rank.get(m, -1) for m in st.members),
                    np.int32, count=len(st.members),
                )
                st.engine.remap_members(old_to_new, C)
                st.members = members_sorted
                self._mark_churn()
            # A different partition-id set at the SAME count would misbind
            # warm rows to new pids: force a cold solve (a count change
            # already does, through the engine's shape check).
            if st.pids is not None and not np.array_equal(
                st.pids, pids_sorted
            ):
                st.engine.reset()
            st.pids = pids_sorted
            if st.recovered:
                # The first post-restart epoch on intact recovered state
                # reports a warm restart; its takeover share is released
                # only once the epoch has run (in _solve_epoch).
                warm_restart = st.engine._prev_choice is not None
                st.recovered = False
            _apply_stream_opts(st.engine, opts)

            prev = st.engine._prev_choice
            if (
                decision is not None
                and decision.action == "degrade"
                and _keepable(prev, lags.shape[0], C)
            ):
                # Shed ladder (degrade rung): serve the PREVIOUS assignment
                # (zero churn, no device work); not a fallback.  A stream
                # with nothing servable is admitted instead.
                choice, s = _serve_previous(prev, lags, C)
                self._overload.note_shed(
                    klass, decision.rung_name, "kept_previous",
                    stream_id=sid,
                )
                shed_info = {
                    "rung": decision.rung_name,
                    "served": "kept_previous",
                }
                self._note_epoch(st, klass, lags)
                a_delta, a_epoch = self._note_assignment(
                    st, ack, topic, members_sorted, pids_sorted, choice
                )
                return self._stream_result(
                    topic, members_sorted, pids_sorted, choice, s,
                    fallback_used=False, degraded_rung="none",
                    warm_restart=warm_restart, opts=opts, klass=klass,
                    shed=shed_info, lag_epoch=st.lag_epoch,
                    assign_delta=a_delta, assign_epoch=a_epoch,
                    resp_enc=resp_enc,
                )
            # Resync pacing: an epoch that must rebuild its resident state
            # with a dense upload (the post-restart first epoch, a
            # churn-invalidated resident) takes one of the bounded slots.
            paced = (
                self._resync_pacer is not None
                and st.engine.needs_dense_resync
                and self._resync_pacer.acquire(budget.remaining())
            )
            try:
                choice, s, degraded_rung, fallback_used, shed_info = self._solve_epoch(
                    sid, st, lags, C, opts, prev, budget, members_sorted,
                    pids_sorted, klass,
                )
            finally:
                if paced:
                    self._resync_pacer.release()
            # Advance the delta bases UNDER the stream lock: a concurrent
            # delta or ack validates against them inside this same lock.
            self._note_epoch(st, klass, lags)
            lag_epoch_out = st.lag_epoch
            a_delta, a_epoch = self._note_assignment(
                st, ack, topic, members_sorted, pids_sorted, choice
            )
        finally:
            st.lock.release()

        return self._stream_result(
            topic, members_sorted, pids_sorted, choice, s,
            fallback_used=fallback_used, degraded_rung=degraded_rung,
            warm_restart=warm_restart, opts=opts, klass=klass,
            shed=shed_info, lag_epoch=lag_epoch_out,
            assign_delta=a_delta, assign_epoch=a_epoch,
            resp_enc=resp_enc,
        )

    def _resync(self, st, created, sid, reason, topic, members_sorted, C,
                opts, klass, ack, resp_enc):
        """A delta that cannot apply (caller holds ``st.lock``): serve the
        previous assignment with ``resync: true`` when it is servable for
        the UNCHANGED roster, else raise asking for full lags."""
        trace_mod.mark("resync")
        metrics.REGISTRY.counter(
            "klba_delta_epochs_total", {"outcome": "resync"}
        ).inc()
        base = st.last_lags
        prev = st.engine._prev_choice if st.engine is not None else None
        servable = (
            prev is not None
            and st.members == members_sorted
            and st.pids is not None
            and st.pids.shape[0] == prev.shape[0]
            and _keepable(prev, prev.shape[0], C)
        )
        if not servable:
            if created and st.engine is None:
                # Don't leave an engine-less husk holding a MAX_STREAMS
                # slot: this stream was minted by a delta that cannot seed.
                with self._streams_lock:
                    if self._streams.get(sid) is st:
                        self._streams.pop(sid)
            raise ValueError(
                f"params.lag_delta cannot apply ({reason}); resync: "
                "resend full params.lags"
            )
        LOGGER.warning(
            "stream %r lag_delta forced a resync (%s); serving the "
            "previous assignment", sid, reason,
        )
        stats_lags = (
            base if base is not None
            else np.zeros(prev.shape[0], dtype=np.int64)
        )
        choice, s = _serve_previous(prev, stats_lags, C)
        a_delta, a_epoch = self._note_assignment(
            st, ack, topic, members_sorted, st.pids, choice
        )
        return self._stream_result(
            topic, members_sorted, st.pids, choice, s,
            fallback_used=False, degraded_rung="none",
            warm_restart=False, opts=opts, klass=klass,
            shed=None, lag_epoch=st.lag_epoch, resync=True,
            assign_delta=a_delta, assign_epoch=a_epoch,
            resp_enc=resp_enc,
        )

    def _solve_epoch(self, sid, st, lags, C, opts, prev, budget,
                     members_sorted, pids_sorted, klass="standard"):
        """Ladder rung 1, the warm engine under the stream breaker with the
        request's REMAINING budget, and the rungs below it.  ``klass`` is the
        request's SLO class (the coalesced submission's placement).  Returns
        ``(choice, stats, degraded_rung, fallback_used, shed)``, ``shed`` the
        response's shed object of a deadline shed (else None)."""
        # With more than one live stream the warm dispatch parks on the
        # coalescer; a lone stream keeps the inline path.
        coalescer = self._coalescer
        if coalescer is not None:
            with self._streams_lock:
                if len(self._streams) <= 1:
                    coalescer = None
        try:
            if coalescer is not None:
                # The submission's deadline: the request's remaining budget
                # on the coalescer's (registry) clock.
                rem = budget.remaining()
                choice = self._watchdog.call(
                    _in_context(carry_cuda_context(self.device),
                                st.engine.submit_epoch),
                    lags, coalescer, key="stream", timeout_s=rem,
                    budget_total_s=budget.total_s, slo_class=klass,
                    rank=class_rank(klass),
                    deadline_at=(metrics.REGISTRY.clock() + rem
                                 if rem is not None else None),
                )
            else:
                choice = self._watchdog.call(
                    _in_context(carry_cuda_context(self.device),
                                st.engine.rebalance),
                    lags, key="stream", timeout_s=budget.remaining(),
                    budget_total_s=budget.total_s,
                )
            # A recovered stream's warming dispatch succeeded: its takeover
            # share is released (one empty-dict check in steady state).
            if self._takeover_warming:
                self._release_takeover(sid)
            # Strike forgiveness: only a RUN of clean epochs clears the
            # quarantine strikes.
            st.clean_epochs += 1
            if (
                st.scrub_strikes
                and st.clean_epochs >= scrub_lib.FORGIVE_AFTER
            ):
                st.scrub_strikes = 0
            return choice, st.engine.last_stats, "none", False, None
        except SolveRejected as rej:
            # FAIL-FAST rejection (breaker open, budget spent, or a failed
            # integrity check): the warm engine is still valid (a
            # quarantined one heals on its next epoch), so degrade
            # host-side for this request only: the previous assignment
            # when servable, else the snake, seeded into the engine.  A
            # DeadlineShed (the row's class budget expired while parked on
            # the coalescer) is a shed, not a failure: with a servable
            # previous assignment it is answered as a shed (the coalescer
            # already counted klba_shed_total), outside the fallback and
            # ladder accounting.
            if isinstance(rej, scrub_lib.CorruptStateDetected):
                self._note_quarantine(sid, st, rej.buffers)
            deadline_shed = isinstance(rej, DeadlineShed)
            if deadline_shed and _keepable(prev, lags.shape[0], C):
                choice, s = _serve_previous(prev, lags, C)
                return choice, s, "none", False, {
                    "rung": "admit_deadline", "served": "kept_previous"}
            if not self._host_fallback:
                raise
            LOGGER.warning(
                "stream %r solve rejected without running; keeping warm "
                "state and answering host-side", sid, exc_info=True,
            )
            if _keepable(prev, lags.shape[0], C):
                choice, s = _serve_previous(prev, lags, C)
                rung = "kept_previous"
            else:
                choice, s = _snake_fallback(lags, C, prev)
                st.engine.seed_choice(np.asarray(choice))
                rung = "host_snake"
            shed = ({"rung": "admit_deadline", "served": rung}
                    if deadline_shed else None)
            return choice, s, rung, True, shed
        except Exception:
            # An abandoned watchdog worker may STILL be running the
            # engine's rebalance and mutate its warm state later: the
            # stream is POISONED (dropped) so no future epoch touches the
            # orphaned engine, and the answer descends the ladder within
            # what is left of the SAME budget.
            with self._streams_lock:
                self._streams.pop(sid, None)
            self._mark_churn()
            self._release_takeover(sid)
            if not self._host_fallback:
                raise
            LOGGER.warning(
                "stream %r warm solve failed; poisoning state and "
                "descending the degraded-mode ladder",
                sid, exc_info=True,
            )
            return (*self._stream_degraded(
                sid, lags, C, opts, prev, budget, members_sorted,
                pids_sorted,
            ), None)

    def _note_epoch(self, st: _Stream, klass: str, lags) -> None:
        """Record one served epoch's (time, total lag) sample and class,
        and advance the stream's delta base: ``lags`` becomes the vector a
        ``lag_delta`` naming the NEW ``lag_epoch`` applies to.  Caller
        holds ``st.lock``."""
        st.klass = klass
        st.history.append(
            (self._clock(), int(lags.sum(dtype="int64")))
        )
        st.last_lags = lags
        st.lag_epoch += 1

    def _note_assignment(
        self, st: _Stream, ack, topic, members_sorted, pids_sorted,
        choice,
    ):
        """Advance the stream's assignment-delta base and decide this
        answer's encoding (caller holds ``st.lock``).  The delta is served
        only when the client's ack names the CURRENT epoch AND the roster
        is unchanged; every other case answers dense, which re-seeds the
        client's base.  Outcomes: ``klba_assign_delta_epochs_total``.
        Returns ``(assignment_delta or None, new assign_epoch)``."""
        choice = np.asarray(choice, dtype=np.int32)
        pids = np.asarray(pids_sorted, dtype=np.int64)
        prev = st.last_served
        delta_out = None
        if ack is not None:
            servable = (
                prev is not None
                and ack == st.assign_epoch
                and prev[0] == list(members_sorted)
                and prev[1].shape == pids.shape
                and np.array_equal(prev[1], pids)
                and prev[2].shape == choice.shape
            )
            if servable:
                changed = np.flatnonzero(prev[2] != choice)
                delta_out = {
                    "base_epoch": st.assign_epoch,
                    "epoch": st.assign_epoch + 1,
                    "topic": topic,
                    "indices": pids[changed].tolist(),
                    # Owner = index into the sorted member list the client
                    # sent (stable: served only on an unchanged roster).
                    "owners": choice[changed].tolist(),
                }
                outcome = "applied"
            elif prev is None or ack != st.assign_epoch:
                outcome = "resync"
            else:
                outcome = "fallback"
            metrics.REGISTRY.counter(
                "klba_assign_delta_epochs_total", {"outcome": outcome}
            ).inc()
        st.assign_epoch += 1
        st.last_served = (
            list(members_sorted), pids.copy(), choice.copy()
        )
        return delta_out, st.assign_epoch

    def _apply_wire_delta(self, st: _Stream, delta):
        """Apply a parsed ``lag_delta`` to the stream's stored base (caller
        holds ``st.lock``).  Returns ``(lags, pids_sorted)``, or a REASON
        string when the delta cannot apply and the stream must re-sync."""
        d_pids, d_vals, base = delta
        if st.last_lags is None or st.pids is None:
            return "no dense base held for this stream"
        if base != st.lag_epoch:
            return (
                f"base_epoch {base} does not match the stream's "
                f"current lag_epoch {st.lag_epoch}"
            )
        pos = np.searchsorted(st.pids, d_pids)
        pos = np.clip(pos, 0, max(st.pids.shape[0] - 1, 0))
        if d_pids.size and not np.array_equal(st.pids[pos], d_pids):
            return "delta names partition ids outside the stream's set"
        lags = st.last_lags.copy()
        lags[pos] = d_vals
        return lags, st.pids

    def _stream_result(
        self, topic, members_sorted, pids_sorted, choice, s, *,
        fallback_used: bool, degraded_rung: str, warm_restart: bool,
        opts: Dict[str, Any], klass: str,
        shed: Optional[Dict[str, Any]],
        lag_epoch: int = 0, resync: bool = False,
        assign_delta: Optional[Dict[str, Any]] = None,
        assign_epoch: int = 0,
        resp_enc: Optional[str] = None,
    ) -> Dict[str, Any]:
        if assign_delta is not None:
            # Delta answer: only the changed rows cross the wire; the O(P)
            # dense dict is never built.
            out: Dict[str, Any] = {"assignment_delta": assign_delta}
        else:
            choice_l = np.asarray(choice).tolist()
            pids_l = pids_sorted.tolist()
            assignments: Dict[str, List[List[Any]]] = {
                m: [] for m in members_sorted
            }
            for row, consumer in enumerate(choice_l):
                assignments[members_sorted[consumer]].append(
                    [topic, pids_l[row]]
                )
            out = _encode_dense_assignments(assignments, resp_enc)
        return {
            **out,
            "stream": {
                "cold_start": s.cold_start,
                "refined": s.refined,
                "guardrail_tripped": s.guardrail_tripped,
                "churn": s.churn,
                "repaired_rows": s.repaired_rows,
                "max_mean_imbalance": s.max_mean_imbalance,
                "imbalance_bound": s.imbalance_bound,
                "quality_ratio": s.quality_ratio,
                "count_spread": s.count_spread,
                "fallback_used": fallback_used,
                # none (warm engine) | kept_previous | cold_device |
                # host_snake, and whether this epoch warm-restarted from a
                # poisoned-stream snapshot.
                "degraded_rung": degraded_rung,
                "warm_restart": warm_restart,
                # The request's effective class and, when the shed ladder
                # degraded it, which rung shed it and what was served.
                "slo_class": klass,
                "shed": shed,
                # The monotone base a lag_delta must name, and whether
                # THIS answer demands a dense re-send.
                "lag_epoch": lag_epoch,
                "resync": resync,
                # The epoch a client's next assign_ack names.
                "assign_epoch": assign_epoch,
                "delta_effective_fraction": s.delta_effective_fraction,
                "sharded_solve": s.sharded_solve,
            },
            "options": opts,
        }

    def _stream_degraded(
        self, sid, lags, C, opts, prev, budget, members_sorted, pids_sorted
    ):
        """Rungs 2-3 of the ladder after the warm engine was poisoned: a
        COLD solve on a FRESH engine within the remaining budget, then the
        host snake.  Returns ``(choice, stats, degraded_rung,
        fallback_used)``."""
        ring = _stream_ring()
        fresh = _fresh_engine(C, ring, self._delta_opts, self.device, self._mesh)
        _apply_stream_opts(fresh, opts)
        try:
            choice = self._watchdog.call(
                _in_context(carry_cuda_context(self.device),
                            fresh.rebalance),
                lags, key="stream", timeout_s=budget.remaining(),
            )
        except Exception:
            # Rung 3: the snake answers from the host, and the choice the
            # clients now run is SNAPSHOTTED for the next epoch's warm
            # restart.
            LOGGER.warning(
                "stream %r cold retry failed; answering with host snake",
                sid, exc_info=True,
            )
            choice, s = _snake_fallback(lags, C, prev)
            with self._streams_lock:
                if len(self._snapshots) >= MAX_STREAMS:
                    self._snapshots.pop(next(iter(self._snapshots)))
                self._snapshots[sid] = (
                    list(members_sorted),
                    pids_sorted.copy(),
                    np.asarray(choice, dtype=np.int32),
                )
            self._mark_churn()
            return choice, s, "host_snake", True
        # The cold rung recovered: install the fresh engine as the stream's
        # new warm state (unless a concurrent request re-registered it).
        with self._streams_lock:
            if sid not in self._streams and len(self._streams) < MAX_STREAMS:
                nst = _Stream()
                nst.engine = fresh
                nst.flight = ring
                nst.members = list(members_sorted)
                nst.pids = pids_sorted
                self._streams[sid] = nst
        self._mark_churn()
        return choice, fresh.last_stats, "cold_device", False

    def _note_quarantine(
        self, sid: str, st: _Stream, buffers: List[str]
    ) -> None:
        """Strike accounting for one quarantined stream (caller holds
        ``st.lock``): at ESCALATE_AFTER strikes the stream breaker trips —
        a single flipped bit heals silently, a device corrupting state
        faster than the heal path restores it is sidelined."""
        st.clean_epochs = 0
        st.scrub_strikes += 1
        if st.scrub_strikes >= scrub_lib.ESCALATE_AFTER:
            # A direct trip: the healing epoch between strikes succeeds
            # and would reset a consecutive-failure count.
            self._watchdog.trip_breaker("stream")
            scrub_lib.record_quarantine(
                buffers, "escalated", stream_id=sid, source="strikes"
            )

    # -- resident-state scrubbing (utils/scrub) ----------------------------

    def _scrub_targets(self) -> List[Tuple[str, Callable[[], str]]]:
        """The scrubber's audit jobs, one per live stream."""
        with self._streams_lock:
            items = list(self._streams.items())
        return [
            (sid, lambda sid=sid, st=st: self._audit_stream(sid, st))
            for sid, st in items
        ]

    def _audit_stream(self, sid: str, st: _Stream) -> str:
        """One audit: the stream lock taken NON-blocking (idle streams only:
        the scrubber never parks behind a serving epoch), the resident state
        read on the service's CUDA device and stream and diffed against the
        host mirror, and a quarantine on a mismatch."""
        if not st.lock.acquire(blocking=False):
            return "busy"
        try:
            with self._streams_lock:
                if self._streams.get(sid) is not st:
                    return "skipped"  # reset or poisoned while queued
            if st.engine is None:
                return "skipped"
            with self._cuda_context():
                audited, fails = scrub_lib.audit_engine(st.engine)
            if not audited:
                return "skipped"
            if fails:
                for buffer in fails:
                    metrics.REGISTRY.counter(
                        "klba_scrub_failures_total", {"buffer": buffer}
                    ).inc()
                LOGGER.warning(
                    "scrub audit of stream %r FAILED (%s); quarantining",
                    sid, ",".join(fails),
                )
                st.engine.quarantine_resident(fails, source="scrub")
                self._note_quarantine(sid, st, fails)
            return "audited"
        finally:
            st.lock.release()

    def scrub_stats(self) -> Optional[Dict[str, Any]]:
        """The wire ``stats.scrub`` section; None with the scrubber off.
        ``wedged``: no audit progress for three intervals while streams are
        live."""
        if self._scrubber is None:
            return None
        out = self._scrubber.stats()
        with self._streams_lock:
            items = list(self._streams.items())
        out["wedged"] = bool(out.get("stalled")) and bool(items)
        out["quarantined_streams"] = sum(
            1 for _sid, st in items
            if st.engine is not None and st.engine.quarantined
        )
        return out

    # -- takeover warming --------------------------------------------------

    def _release_takeover(self, sid: Any) -> None:
        """One recovered stream finished warming (first post-boot epoch
        served, reset, discarded or poisoned): release its share of the
        standing pressure."""
        with self._streams_lock:
            weight = self._takeover_warming.pop(sid, None)
        if weight:
            self._overload.release_standing_pressure(weight)

    def _expire_takeover_warming(self) -> None:
        """TTL backstop, checked on the admission path: shares whose streams
        never came back are released together."""
        if not self._takeover_warming or (
            self._takeover_deadline is None
            or self._clock() < self._takeover_deadline
        ):
            return
        with self._streams_lock:
            stale, self._takeover_warming = dict(self._takeover_warming), {}
        total = sum(stale.values())
        if total:
            LOGGER.warning(
                "takeover warm-up TTL expired with %d stream(s) never seen "
                "(%s); releasing their standing pressure",
                len(stale), sorted(stale),
            )
            self._overload.release_standing_pressure(total)

    # -- lifecycle ---------------------------------------------------------

    def _set_lifecycle(self, state: str) -> None:
        with self._lifecycle_lock:
            self._lifecycle = state
        self._m_lifecycle.set(_LIFECYCLE_STATES.index(state))

    def _mark_churn(self) -> None:
        """Roster churn (a stream joined, left or was poisoned, a membership
        moved): nudge the snapshot writer ahead of its cadence."""
        if self._snapshot_writer is not None:
            self._snapshot_writer.mark_churn()

    def _reject_if_draining(self, klass: str) -> None:
        """The drain's admission stop: new solve work gets a structured
        reject (rung ``"draining"``) with a retry hint sized to the drain
        window.  Observability methods stay served."""
        if self._lifecycle == "serving":
            return
        retry_ms = int(
            min(60_000.0, max(500.0, self._drain_timeout_s * 1000.0))
        )
        record_shed(klass, "draining", "rejected")
        raise DrainReject(klass, retry_ms)

    def _snapshot_sections(self) -> Dict[str, Any]:
        """Every host-recoverable section: per stream ``{members, pids,
        choice, slo_class, history}``, the breakers, the overload rung.
        History times are stored as ages at the write (the monotonic clock
        dies with the process).  A stream mid-epoch (lock contended for half
        a second) is skipped this cadence."""
        with self._streams_lock:
            items = list(self._streams.items())
        now = self._clock()
        streams: Dict[str, Any] = {}
        for sid, st in items:
            if not st.lock.acquire(timeout=0.5):
                continue  # mid-epoch; the next cadence catches it
            try:
                if st.engine is None or st.pids is None:
                    continue
                choice = st.engine.export_state()
                if choice is None or choice.shape[0] != st.pids.shape[0]:
                    continue
                P = int(st.pids.shape[0])
                dense = bool(np.array_equal(st.pids, np.arange(P)))
                streams[sid] = {
                    "members": list(st.members),
                    # A dense pid set (the common case) compacts to its count.
                    "pids": P if dense else [int(p) for p in st.pids],
                    "choice": [int(c) for c in choice],
                    "slo_class": st.klass,
                    "history": [
                        [max(0.0, now - t), int(lag)]
                        for t, lag in list(st.history)
                    ],
                }
            finally:
                st.lock.release()
        sections = {
            "streams": streams,
            "breakers": self._watchdog.export_state(),
            "overload": self._overload.export_state(),
        }
        if self._federation is not None:
            # The monotone local epoch, the per-peer ledger and the last-good
            # duals survive a restart, fenced like every other section.
            sections["federation"] = self._federation.export_state()
        return sections

    def snapshot_now(self) -> Dict[str, Any]:
        """One synchronous snapshot write (operator action, drills);
        ``{"ok": False, "error": "snapshots disabled"}`` without a path."""
        if self._snapshot_writer is None:
            return {"ok": False, "error": "snapshots disabled"}
        return self._snapshot_writer.write_now()

    def _final_snapshot(self) -> None:
        """The drain's final write.  A live stream the collector had to skip
        (a solve the drain timed out on) carries its record forward from
        the previous snapshot instead of vanishing from the file."""
        try:
            sections = self._snapshot_sections()
            with self._streams_lock:
                live = set(self._streams)
            missing = live - set(sections.get("streams") or {})
            if missing:
                prev = self._snapshot_store.load()
                prev_streams = (
                    prev.sections.get("streams") or {}
                    if prev.sections else {}
                )
                carried = 0
                for sid in missing:
                    body = prev_streams.get(sid)
                    if body is not None:
                        sections["streams"][sid] = body
                        carried += 1
                LOGGER.warning(
                    "final snapshot: %d stream(s) still lock-held at drain "
                    "timeout; carried %d forward from the previous snapshot",
                    len(missing), carried,
                )
            self._snapshot_store.save(sections)
        except Exception:  # noqa: BLE001 — the drain must complete
            LOGGER.warning(
                "final snapshot collection failed; skipping the write",
                exc_info=True,
            )

    def lifecycle_stats(self) -> Dict[str, Any]:
        """The wire ``stats.lifecycle`` section."""
        store = self._snapshot_store
        return {
            "state": self._lifecycle,
            "snapshot": store.stats() if store is not None else None,
            "recovery": self._last_recovery,
            "lease": store.lease_stats() if store is not None else None,
            "handoff": self._last_handoff,
        }

    def _acquire_writer_lease(self) -> None:
        """The boot side of the takeover protocol: acquire the fenced writer
        lease (fencing on) and record the hand-off.  Never raises; a failed
        acquisition serves with snapshot writes denied."""
        store = self._snapshot_store
        if store is None or not store.fencing_enabled:
            return
        res = store.acquire_lease(wait_s=self._lease_wait_s)
        mode = (
            "fresh" if res.get("previous_holder") is None
            else "takeover_crash" if res.get("previous_expired")
            else "takeover_drain"
        )
        self._last_handoff = {
            "acquired": bool(res.get("ok")),
            "mode": mode,
            "token": res.get("token"),
            "waited_ms": res.get("waited_ms"),
            "previous_holder": res.get("previous_holder"),
            "error": res.get("error"),
        }
        metrics.FLIGHT.record(
            "lifecycle", {"event": "handoff", **self._last_handoff}
        )
        LOGGER.warning(
            "writer lease %s (mode=%s, token=%s, waited %.0f ms, previous "
            "holder %r)",
            "acquired" if res.get("ok") else "NOT acquired", mode,
            res.get("token"), res.get("waited_ms") or 0.0,
            res.get("previous_holder"),
        )

    def _prestack_recovered(self) -> None:
        """Rebuild each recovered stream's resident state from its seeded
        choice (a zero-lag table build: the choice unchanged), off the
        serving path.  Best effort per stream: a failed pre-stack leaves the
        stream on the inline dense rebuild it would have taken anyway."""
        with self._streams_lock:
            items = list(self._streams.items())
        built = 0
        for sid, st in items:
            if not st.lock.acquire(timeout=5.0):
                continue
            try:
                if st.recovered and st.engine is not None:
                    if st.engine.prestack_resident():
                        built += 1
            except Exception:  # noqa: BLE001 — per-stream best effort
                LOGGER.warning(
                    "pre-stack of recovered stream %r failed; it will "
                    "rebuild inline on its first epoch", sid, exc_info=True,
                )
            finally:
                st.lock.release()
        if built:
            metrics.REGISTRY.counter("klba_recovery_prestacked_total").inc(built)
            if self._last_recovery is not None:
                self._last_recovery["streams_prestacked"] = built
        LOGGER.info("pre-stacked %d/%d recovered stream(s)", built, len(items))

    def _recover(self) -> None:
        """Boot-time warm-restart recovery (before the warm-up and the
        accept loop): load the snapshot fail-open, restore the breaker and
        overload state, and seed one engine per stream.  Never raises; the
        worst outcome is a counted cold start."""
        t0 = metrics.REGISTRY.clock()
        load = self._snapshot_store.load()
        info: Dict[str, Any] = {
            "outcome": load.outcome,
            "age_s": load.age_s,
            "sections_skipped": list(load.skipped),
            "streams_recovered": 0,
            "streams_discarded": 0,
        }
        stale = (
            load.age_s is not None and load.age_s > self._snapshot_max_age_s
        )
        if stale and load.outcome in ("ok", "partial"):
            # Rosters and lag trends older than the max age are
            # misinformation: cold start, loudly.
            LOGGER.warning(
                "snapshot is %.0fs old (> max age %.0fs); rehydrating "
                "nothing", load.age_s, self._snapshot_max_age_s,
            )
            info["outcome"] = "stale"
        elif load.sections:
            breakers = load.sections.get("breakers")
            if breakers is not None:
                self._watchdog.restore_state(breakers)
            overload = load.sections.get("overload")
            if overload is not None:
                self._overload.restore_state(overload)
            federation = load.sections.get("federation")
            if federation is not None and self._federation is not None:
                self._federation.restore_state(federation)
            recovered, discarded, weight = self._rehydrate_streams(
                load.sections.get("streams") or {}
            )
            info["streams_recovered"] = recovered
            info["streams_discarded"] = discarded
            if recovered:
                # The recovered streams will all send their next epoch at
                # once: seed the depth EWMA with that weight now, and park
                # it as standing pressure until each stream has warmed.
                self._overload.seed_recovery_depth(weight)
                info["seeded_depth"] = weight
                self._overload.add_standing_pressure(weight)
                self._takeover_deadline = self._clock() + TAKEOVER_WARMING_TTL_S
                info["standing_pressure"] = weight
        info["duration_ms"] = (metrics.REGISTRY.clock() - t0) * 1000.0
        self._last_recovery = info
        metrics.REGISTRY.gauge("klba_recovery_duration_ms").set(
            info["duration_ms"]
        )
        metrics.FLIGHT.record("lifecycle", {"event": "recovery", **info})
        LOGGER.info(
            "recovery: outcome=%s streams_recovered=%d discarded=%d in "
            "%.1f ms", info["outcome"], info["streams_recovered"],
            info["streams_discarded"], info["duration_ms"],
        )

    def _rehydrate_streams(self, bodies: Dict[str, Any]) -> Tuple[int, int, float]:
        """Seed one engine per snapshot stream; a malformed or unservable
        record is discarded alone (counted).  Returns ``(recovered,
        discarded, weighted_depth)``, the weight summed over the recovered
        streams' classes."""
        recovered = discarded = 0
        weight = 0.0
        m_rec = metrics.REGISTRY.counter(
            "klba_recovery_streams_total", {"outcome": "recovered"}
        )
        m_disc = metrics.REGISTRY.counter(
            "klba_recovery_streams_total", {"outcome": "discarded"}
        )
        now = self._clock()
        for sid, body in dict(bodies).items():
            try:
                members = sorted(str(m) for m in body["members"])
                if not members or len(set(members)) != len(members):
                    raise ValueError("bad member roster")
                C = len(members)
                pids_raw = body["pids"]
                pids = (
                    np.arange(int(pids_raw), dtype=np.int64)
                    if isinstance(pids_raw, int)
                    else np.asarray([int(p) for p in pids_raw], dtype=np.int64)
                )
                choice = np.asarray(
                    [int(c) for c in body["choice"]], dtype=np.int32
                )
                if (
                    choice.shape[0] != pids.shape[0]
                    or not _keepable(choice, choice.shape[0], C)
                ):
                    raise ValueError("choice not servable for roster")
                klass = body.get("slo_class", "standard")
                if klass not in SLO_CLASSES:
                    klass = "standard"
                st = _Stream()
                st.flight = _stream_ring()
                st.engine = _fresh_engine(C, st.flight, self._delta_opts,
                                          self.device, self._mesh)
                # The recovery contract: the first warm epoch is the one an
                # engine seeded with the SAME choice gives (seed_choice
                # leaves the resident state stale; both sides rebuild it
                # from this host vector).
                st.engine.seed_choice(choice)
                st.members = members
                st.pids = pids
                st.klass = klass
                st.recovered = True
                for age, lag in body.get("history") or []:
                    st.history.append((now - float(age), int(lag)))
                with self._streams_lock:
                    if len(self._streams) >= MAX_STREAMS:
                        raise ValueError("stream cap reached")
                    self._streams[str(sid)] = st
                    self._takeover_warming[str(sid)] = (
                        CLASS_WEIGHTS.get(klass, 1.0)
                    )
                self._recovery_shapes.append((int(pids.shape[0]), C))
                recovered += 1
                weight += CLASS_WEIGHTS.get(klass, 1.0)
                m_rec.inc()
            except Exception:  # noqa: BLE001 — discard THIS stream only
                LOGGER.warning(
                    "discarding unrecoverable snapshot stream %r", sid,
                    exc_info=True,
                )
                discarded += 1
                m_disc.inc()
        return recovered, discarded, weight

    def begin_drain(self) -> bool:
        """Start a graceful drain (idempotent): stop admissions, then, on
        the drain thread, wait out in-flight requests, write the final
        snapshot and close the listener.  False when already draining or
        stopped."""
        with self._lifecycle_lock:
            if self._lifecycle != "serving":
                return False
            self._lifecycle = "draining"
        self._m_lifecycle.set(_LIFECYCLE_STATES.index("draining"))
        if self._snapshot_writer is not None:
            # Stop the cadence; the drain worker owns the final write.
            self._snapshot_writer.close()
        metrics.FLIGHT.record("lifecycle", {"event": "drain"})
        LOGGER.warning(
            "drain initiated: admissions stopped, flushing in-flight work "
            "(timeout %.1fs)", self._drain_timeout_s,
        )
        self._drain_thread = threading.Thread(
            target=self._drain_worker, name="klba-drain", daemon=True
        )
        self._drain_thread.start()
        return True

    def _drain_worker(self) -> None:
        deadline = self._clock() + self._drain_timeout_s
        # 1. In-flight requests finish, or the timeout fires (a solve in
        #    the watchdog's worker is abandoned by its own deadline).
        with self._active_cond:
            while self._active_requests > 0:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    LOGGER.warning(
                        "drain timeout with %d request(s) in flight; "
                        "proceeding", self._active_requests,
                    )
                    break
                self._active_cond.wait(min(0.05, remaining))
        # 2. The coalescer's parked waves and their readbacks flush, so no
        #    future is abandoned mid-wave.  Fault point drain.flush fires
        #    inside; a failure is logged and the drain goes on.
        if self._coalescer is not None:
            try:
                if not self._coalescer.drain(
                    timeout_s=max(0.0, deadline - self._clock())
                ):
                    LOGGER.warning("coalescer did not quiesce within the "
                                   "drain window; proceeding")
            except Exception:  # noqa: BLE001 — the drain must complete
                LOGGER.warning("coalescer drain failed; proceeding with the "
                               "final snapshot", exc_info=True)
        # 3. The final snapshot, then the lease released, so a replacement
        #    adopts at once (a crash never releases: the TTL fences it).
        if self._snapshot_writer is not None:
            self._final_snapshot()
        if self._snapshot_store is not None:
            self._snapshot_store.release_lease()
        # 4. The listener and the coalescer close; the process may exit.
        self._close_listener()
        self._set_lifecycle("stopped")
        metrics.FLIGHT.record("lifecycle", {"event": "drained"})
        LOGGER.warning("drain complete: listener closed")
        self._stopped_event.set()

    def start(self) -> "AssignorService":
        # Process-wide telemetry hooks BEFORE the warm-up: the compile
        # counter sees the builds of interest, and request-thread log lines
        # carry the request id.
        install_compile_counter()
        metrics.install_log_request_ids()
        # Quality-plane knobs installed process-wide before the warm-up,
        # whose quality jobs route through them.
        set_quality_mode(self._quality_mode)
        set_quality_tile(self._quality_tile)
        if self._mesh is not None:
            # Mesh discovery once, before the warm-up (which warms the
            # sharded cold solve with the manager active); a spec the
            # visible devices cannot satisfy degrades to single-device here.
            from .sharded import mesh as mesh_mod

            self._mesh.configure()
            mesh_mod.activate(self._mesh)
        if self._snapshot_store is not None:
            # The takeover handshake first (the fencing epoch turns over
            # before the state is read), then recovery, whose streams give
            # the warm-up below their shapes.
            self._acquire_writer_lease()
            self._recover()
            if self._recovery_prestack:
                self._prestack_recovered()
        # With coalescing on, the warm-up also drives one multi-stream wave
        # set per batch bucket, so the first coalesced waves build nothing.
        coalesce_batch = (
            self._coalescer.max_batch if self._coalescer is not None else 1
        )
        if self._warmup_shapes:
            # Connections arriving meanwhile queue in the TCP backlog.
            from .warmup import warmup

            for max_p, consumers, topics in self._warmup_shapes:
                warmup(
                    max_partitions=max_p,
                    consumers=[consumers],
                    topics=[topics],
                    solvers=self._warmup_solvers,
                    coalesce_max_batch=coalesce_batch,
                    delta_buckets=self._warm_delta_buckets,
                    mesh_manager=self._mesh,
                    device=self.device,
                )
        if self._recovery_shapes and self._recovery_warmup:
            # The stream engine's jobs at the recovered shapes.
            from .warmup import warmup

            for max_p, consumers in sorted(set(self._recovery_shapes)):
                warmup(
                    max_partitions=max_p,
                    consumers=[consumers],
                    solvers=("stream",),
                    coalesce_max_batch=coalesce_batch,
                    delta_buckets=self._warm_delta_buckets,
                    mesh_manager=self._mesh,
                    device=self.device,
                )
        # The serving surfaces come up under the lifecycle lock: a drain or
        # stop that raced the recovery or warm-up has closed the socket,
        # and _close_listener flips ``_listener_closed`` under this lock.
        with self._lifecycle_lock:
            if self._lifecycle != "serving" or self._listener_closed:
                LOGGER.warning(
                    "start() aborted: drain/stop arrived before serving; "
                    "not opening the listener"
                )
                return self
            if self._snapshot_writer is not None:
                self._snapshot_writer.start()
            if self._scrubber is not None:
                self._scrubber.start()
            if self._metrics_port is not None:
                from .utils.metrics_http import MetricsHTTPServer

                self._metrics_http = MetricsHTTPServer(
                    self.address[0], self._metrics_port
                ).start()
            self._thread = threading.Thread(
                target=self._tcp.serve_forever, name="klba-service",
                daemon=True,
            )
            self._thread.start()
        LOGGER.info("assignor service listening on %s:%d", *self.address)
        return self

    @property
    def metrics_address(self) -> Optional[Tuple[str, int]]:
        """(host, port) of the HTTP /metrics listener, None if disabled or
        not started."""
        if self._metrics_http is None:
            return None
        return self._metrics_http.address

    def _close_listener(self) -> None:
        """Close the accept loop, the scrubber and the metrics listener
        (once).  In-flight requests on open connections finish on their
        daemon handler threads."""
        with self._lifecycle_lock:
            if self._listener_closed:
                return
            self._listener_closed = True
        if self._thread is not None:
            self._tcp.shutdown()
            self._thread.join()
        self._tcp.server_close()
        if self._scrubber is not None:
            self._scrubber.close()
        if self._coalescer is not None:
            self._coalescer.close(timeout_s=10.0)
        if self._metrics_http is not None:
            self._metrics_http.stop()
            self._metrics_http = None
        if self._federation is not None:
            self._federation.close()

    def stop(self) -> None:
        """Stop at once, without a drain: no admission wind-down and no
        final snapshot (the file holds what the cadence last wrote: the
        crash-equivalent the restart drills rely on).  Idempotent; a no-op
        after a completed drain."""
        if self._snapshot_writer is not None:
            self._snapshot_writer.close()
        self._close_listener()
        if self._mesh is not None:
            # Uninstall OUR manager only: a replacement's stays.
            from .sharded import mesh as mesh_mod

            mesh_mod.deactivate(self._mesh)
        self._set_lifecycle("stopped")
        self._stopped_event.set()

    def wait_stopped(self, timeout_s: Optional[float] = None) -> bool:
        """Block until a drain or :meth:`stop` finished; True when it did."""
        return self._stopped_event.wait(timeout_s)

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT drain gracefully (main thread only, a Python
        signal-handler constraint); a second signal during the drain stops
        at once, without the final snapshot."""
        import signal

        def _handler(signum, frame):
            LOGGER.warning("signal %d: draining", signum)
            if not self.begin_drain():
                LOGGER.warning("signal %d during drain: forcing stop", signum)
                threading.Thread(target=self.stop, name="klba-stop",
                                 daemon=True).start()

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _handler)

    def __enter__(self) -> "AssignorService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class AssignorServiceClient:
    """Blocking line-protocol client (what the JVM plugin side
    implements)."""

    # Methods the reconnect-once policy must NOT auto-resend: they mutate
    # server-side warm state, so a request that timed out mid-response may
    # already have been applied.
    NON_IDEMPOTENT_METHODS = frozenset({"stream_assign"})

    def __init__(self, host: str, port: int, timeout_s: float = 60.0):
        self._host = host
        self._port = port
        self._timeout_s = timeout_s
        self._next_id = 0
        self._lock = threading.Lock()
        # Reconnect-once events: a timeout or drop mid-request leaves the
        # socket in an undefined state, so it is rebuilt, never reused.
        self.reconnects = 0
        # Trace id echoed by the LAST response envelope.
        self.last_trace_id: Optional[str] = None
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout_s
        )
        self._file = self._sock.makefile("rwb")

    def _close_quietly(self) -> None:
        for close in (self._file.close, self._sock.close):
            try:
                close()
            except OSError:
                pass  # already torn down — the rebuild is the point

    def _round_trip(self, payload: bytes) -> bytes:
        self._file.write(payload)
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError("service closed the connection")
        return line

    def request(self, method: str, params: Optional[Dict] = None) -> Any:
        # Echo the caller's causal context so the sidecar's segment joins
        # the caller's trace.
        traceparent = metrics.current_traceparent()
        with self._lock:
            self._next_id += 1
            req = {"id": self._next_id, "method": method}
            if params is not None:
                req["params"] = params
            if traceparent is not None:
                req["traceparent"] = traceparent
            payload = json.dumps(req).encode() + b"\n"
            if self._file.closed:
                # A previous reconnect died inside _connect(): rebuild
                # before sending (does not consume this request's retry).
                self._connect()
                self.reconnects += 1
            try:
                line = self._round_trip(payload)
            except OSError as exc:
                # Close and reconnect ONCE; resend only idempotent methods.
                LOGGER.warning(
                    "request failed (%s: %s); reconnecting once",
                    type(exc).__name__, exc,
                )
                self._close_quietly()
                self._connect()
                self.reconnects += 1
                if method in self.NON_IDEMPOTENT_METHODS:
                    raise ConnectionError(
                        f"connection failed mid-{method}; the request may "
                        "or may not have been applied server-side — not "
                        "resending a non-idempotent method (the connection "
                        "has been rebuilt for subsequent requests)"
                    ) from exc
                line = self._round_trip(payload)
        resp = json.loads(line)
        self.last_trace_id = resp.get("trace_id")
        if "error" in resp:
            shed = resp["error"].get("shed")
            if shed is not None:
                # The typed rejection, so callers back off from fields.
                exc = ShedReject(
                    shed["class"], shed["rung"],
                    int(shed["retry_after_ms"]),
                )
                exc.trace_id = resp.get("trace_id")
                raise exc
            raise RuntimeError(resp["error"]["message"])
        result = resp["result"]
        if isinstance(result, dict) and "assignments_encoded" in result:
            result = decode_wire_assignments(result)
        return result

    def ping(self) -> bool:
        return self.request("ping") == "pong"

    def assign(
        self,
        topics: Dict[str, List[Tuple[int, int]]],
        subscriptions: Dict[str, List[str]],
        solver: str = "rounds",
    ) -> Dict[str, List[Tuple[str, int]]]:
        result = self.request(
            "assign",
            {
                "topics": topics,
                "subscriptions": subscriptions,
                "solver": solver,
            },
        )
        return {
            m: [(t, int(p)) for t, p in tps]
            for m, tps in result["assignments"].items()
        }

    def stream_assign(
        self,
        stream_id: str,
        topic: str,
        lags: Optional[List[Tuple[int, int]]],
        members: List[str],
        options: Optional[Dict[str, Any]] = None,
        lag_delta: Optional[Dict[str, Any]] = None,
        encoding: Optional[str] = None,
    ) -> Dict[str, Any]:
        """One warm-start epoch; returns the raw result dict.  Pass
        ``lag_delta`` (and ``lags=None``) for a sparse delta epoch
        (:class:`..lag.LagDeltaTracker` produces both shapes).
        ``encoding="zlib"`` compresses a DENSE lag payload; a server that
        does not know the encoding answers an error and the request falls
        back to plain JSON."""
        params: Dict[str, Any] = {
            "stream_id": stream_id,
            "topic": topic,
            "members": members,
        }
        if lags is not None:
            if encoding == "zlib":
                params["lags"] = encode_lags_zlib(lags)
                params["encoding"] = "zlib"
            else:
                params["lags"] = lags
        if lag_delta is not None:
            params["lag_delta"] = lag_delta
        if options is not None:
            params["options"] = options
        try:
            return self.request("stream_assign", params)
        except ShedReject:
            # The server's decision, not an encoding problem.
            raise
        except RuntimeError:
            if params.get("encoding") is None:
                raise
            params.pop("encoding")
            params["lags"] = lags
            return self.request("stream_assign", params)

    def federated_assign(
        self,
        topic: str,
        lags: List[Tuple[int, int]],
        members: List[str],
        slo_class: Optional[str] = None,
    ) -> Dict[str, Any]:
        """One federated epoch: the server converges a global assignment
        with its peers and answers its LOCAL shard's slice; the
        ``federation`` section reports the rung actually served."""
        params: Dict[str, Any] = {
            "topic": topic, "lags": lags, "members": members,
        }
        if slo_class is not None:
            params["slo_class"] = slo_class
        return self.request("federated_assign", params)

    def federation(self) -> Dict[str, Any]:
        """The federation operator surface (peer links, rung, cache)."""
        return self.request("federation")

    def stream_reset(self, stream_id: str) -> bool:
        return self.request("stream_reset", {"stream_id": stream_id})[
            "dropped"
        ]

    def close(self) -> None:
        self._file.close()
        self._sock.close()

    def __enter__(self) -> "AssignorServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def main() -> None:
    """``python -m kafka_lag_based_assignor_tpu_torch.service [host] [port]
    [--device cuda|cpu] [--warmup P:C[:T][,...]] [--metrics-port PORT]
    [--no-delta] [--delta-max-fraction FRAC] [--delta-buckets N]
    [--snapshot-path FILE] [--snapshot-interval-ms MS]
    [--snapshot-max-age-ms MS] [--drain-timeout-ms MS]
    [--snapshot-backend KIND] [--snapshot-lease-ttl-ms MS]
    [--snapshot-lease-wait-ms MS] [--resync-max-inflight N]
    [--scrub-interval-ms MS] [--recovery-prestack]
    [--federation-self-id ID] [--federation-peers ID=HOST:PORT,...]
    [--federation-rounds N] [--federation-sync-timeout-ms MS]
    [--federation-max-staleness-ms MS] [--federation-gossip-interval-ms MS]
    [--federation-capacity W,W,...]
    [--mesh-devices SPEC] [--mesh-solve-min-rows N] [--mesh-shape SxD]
    [--quality-mode MODE] [--quality-tile ROWS]`` — the JAX CLI's flags
    for the knobs this sidecar serves.  ``--warmup`` builds every kernel
    and runs the default device solvers at the listed shapes before the
    service answers.  SIGTERM/SIGINT drain gracefully.  Unknown flags are
    an error."""
    import argparse

    logging.basicConfig(level=logging.INFO)

    def warmup_spec(text: str):
        from .utils.config import parse_warmup_shapes

        try:
            return parse_warmup_shapes(text)
        except ValueError as exc:
            raise argparse.ArgumentTypeError(str(exc))

    parser = argparse.ArgumentParser(
        prog="kafka_lag_based_assignor_tpu_torch.service",
        description="CUDA assignor sidecar (newline-JSON over TCP)",
    )
    parser.add_argument("host", nargs="?", default="127.0.0.1")
    parser.add_argument("port", nargs="?", type=int, default=7531)
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where every solve runs (default cuda; raises without a card)",
    )
    parser.add_argument(
        "--warmup", type=warmup_spec, default=None,
        metavar="P:C[:T][,P:C[:T]...]",
        help="build the kernels and run the device solvers at these "
             "(max_partitions:num_consumers[:topics]) shapes before serving",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="serve the Prometheus text exposition over plain HTTP on "
             "this port (GET /metrics); omit to disable",
    )
    parser.add_argument(
        "--no-delta", action="store_true",
        help="disable delta epochs (sparse lag updates onto the "
             "device-resident lag buffer; every upload stays dense)",
    )
    parser.add_argument(
        "--delta-max-fraction", type=float, default=0.125,
        metavar="FRAC",
        help="changed-partition fraction above which a warm epoch "
             "uploads dense instead of a delta (default 0.125)",
    )
    parser.add_argument(
        "--delta-buckets", type=int, default=6, metavar="N",
        help="pow2 K-ladder rungs for delta uploads (16..16<<N-1; "
             "default 6)",
    )
    parser.add_argument(
        "--snapshot-path", default=None, metavar="FILE",
        help="crash-safe lifecycle snapshot file (atomic writes); "
             "enables warm-restart recovery at boot; omit to disable",
    )
    parser.add_argument(
        "--snapshot-interval-ms", type=float, default=30_000.0,
        metavar="MS",
        help="periodic snapshot cadence (churn writes happen sooner; "
             "default 30000)",
    )
    parser.add_argument(
        "--snapshot-max-age-ms", type=float, default=900_000.0,
        metavar="MS",
        help="boot-time staleness guard: an older snapshot rehydrates "
             "nothing (default 900000)",
    )
    parser.add_argument(
        "--drain-timeout-ms", type=float, default=10_000.0, metavar="MS",
        help="graceful-drain window for in-flight requests (default 10000)",
    )
    parser.add_argument(
        "--snapshot-backend", default="file",
        choices=["file", "memory", "object"], metavar="KIND",
        help="where the snapshot lives: 'file' (per-instance local "
             "file), 'memory', or 'object' (object-store-shaped, "
             "versioned CAS; the path is then the store directory)",
    )
    parser.add_argument(
        "--snapshot-lease-ttl-ms", type=float, default=0.0,
        metavar="MS",
        help="epoch-fenced writer lease TTL; > 0 engages fencing "
             "(boot acquires the lease, saves carry its token, a "
             "fenced-off predecessor's writes are rejected); 0 "
             "disables (default)",
    )
    parser.add_argument(
        "--snapshot-lease-wait-ms", type=float, default=0.0,
        metavar="MS",
        help="how long boot waits for a crashed predecessor's lease "
             "to expire before serving WITHOUT it (writes denied); "
             "0 = auto (2x ttl + 1s)",
    )
    parser.add_argument(
        "--resync-max-inflight", type=int, default=8, metavar="N",
        help="cap on concurrent post-restart dense resync rebuilds "
             "(excess epochs wait, counted klba_resync_paced_total); "
             "0 disables pacing (default 8)",
    )
    parser.add_argument(
        "--scrub-interval-ms", type=float, default=30_000.0,
        metavar="MS",
        help="resident-state scrubber cadence (background audit of "
             "device buffers against host truth; quarantine and heal on "
             "a mismatch); <= 0 disables (default 30000)",
    )
    parser.add_argument(
        "--federation-self-id", default=None, metavar="ID",
        help="this sidecar's stable federation peer id (enables the "
             "federated assignment plane)",
    )
    parser.add_argument(
        "--federation-peers", default=None, metavar="ID=HOST:PORT,...",
        help="peer sidecars for federated assignment "
             "('id=host:port,id=host:port'); requires --federation-self-id",
    )
    parser.add_argument(
        "--federation-rounds", type=int, default=16, metavar="N",
        help="max dual-exchange rounds per federated_assign (default 16)",
    )
    parser.add_argument(
        "--federation-sync-timeout-ms", type=float, default=2_000.0,
        metavar="MS",
        help="per-peer sync RPC deadline (also bounded by the request "
             "budget; default 2000)",
    )
    parser.add_argument(
        "--federation-max-staleness-ms", type=float, default=300_000.0,
        metavar="MS",
        help="how old the last-good-global dual cache may be and still "
             "serve the middle federation rung (default 300000)",
    )
    parser.add_argument(
        "--federation-gossip-interval-ms", type=float, default=0.0,
        metavar="MS",
        help="cadence of the background dual-gossip daemon (0 = off; > 0 "
             "serves federated_assign from the warm dual cache in one "
             "local round)",
    )
    parser.add_argument(
        "--federation-capacity", default=None, metavar="W,W,...",
        help="this cluster's per-consumer capacity weight vector "
             "(comma-separated positive floats) for the weighted federated "
             "count marginal; unset = uniform",
    )
    parser.add_argument(
        "--recovery-prestack", action="store_true",
        help="rebuild the recovered streams' resident state at boot, "
             "off the serving path",
    )
    parser.add_argument(
        "--mesh-devices", default="off", metavar="SPEC",
        help="device mesh for the sharded backends: 'off' (default, "
             "single-device), 'auto' (all visible devices, or the "
             "KLBA_VIRTUAL_SHARDS virtual shards), or a device count; "
             "discovered and validated once at start",
    )
    parser.add_argument(
        "--mesh-solve-min-rows", type=int, default=65536, metavar="N",
        help="partition floor below which the P-sharded solve backend "
             "is not selected (default 65536)",
    )
    parser.add_argument(
        "--mesh-shape", default="off", metavar="SxD",
        help="cross-axis ('streams','p') factorization of the mesh "
             "pool: 'off' (default, 1-D rungs), 'auto' or 'SxD'; faults "
             "degrade 2-D -> streams -> p -> single",
    )
    parser.add_argument(
        "--quality-mode", default="auto",
        choices=("sinkhorn", "linear", "auto"),
        help="quality-solve routing: dense sinkhorn, the linear-space "
             "O(P + C) mirror-prox path, or auto (linear at scale; "
             "default)",
    )
    parser.add_argument(
        "--quality-tile", type=int, default=1024, metavar="ROWS",
        help="linear quality mode's streamed tile size in rows (pow2; "
             "default 1024)",
    )
    opts = parser.parse_args()
    federation_capacity = (
        [float(v) for v in opts.federation_capacity.split(",")]
        if opts.federation_capacity else None
    )
    service = AssignorService(
        opts.host, opts.port, device=opts.device,
        warmup_shapes=opts.warmup,
        metrics_port=opts.metrics_port,
        delta_enabled=not opts.no_delta,
        delta_max_fraction=opts.delta_max_fraction,
        delta_buckets=opts.delta_buckets,
        snapshot_path=opts.snapshot_path,
        snapshot_interval_s=max(opts.snapshot_interval_ms, 1.0) / 1000.0,
        snapshot_max_age_s=max(opts.snapshot_max_age_ms, 1.0) / 1000.0,
        drain_timeout_s=max(opts.drain_timeout_ms, 0.0) / 1000.0,
        snapshot_backend=opts.snapshot_backend,
        snapshot_lease_ttl_s=max(opts.snapshot_lease_ttl_ms, 0.0) / 1000.0,
        snapshot_lease_wait_s=max(opts.snapshot_lease_wait_ms, 0.0) / 1000.0,
        resync_max_inflight=opts.resync_max_inflight,
        recovery_prestack=opts.recovery_prestack,
        scrub_interval_ms=opts.scrub_interval_ms,
        federation_self_id=opts.federation_self_id,
        federation_peers=opts.federation_peers,
        federation_rounds=opts.federation_rounds,
        # No silent clamp: a non-positive timeout fails the boot (the
        # coordinator validates), as the config key does.
        federation_sync_timeout_s=opts.federation_sync_timeout_ms / 1000.0,
        federation_max_staleness_s=max(
            opts.federation_max_staleness_ms, 0.0) / 1000.0,
        federation_gossip_interval_s=max(
            opts.federation_gossip_interval_ms, 0.0) / 1000.0,
        federation_capacity=federation_capacity,
        mesh_devices=opts.mesh_devices,
        mesh_solve_min_rows=opts.mesh_solve_min_rows,
        mesh_shape=opts.mesh_shape,
        quality_mode=opts.quality_mode,
        quality_tile=opts.quality_tile,
    )
    # SIGTERM/SIGINT drain: admissions stop with a structured retry-after
    # reject, the final snapshot lands, the listener closes.
    service.install_signal_handlers()
    service.start()
    print(f"listening on {service.address[0]}:{service.address[1]}", flush=True)
    service.wait_stopped()


if __name__ == "__main__":
    main()
