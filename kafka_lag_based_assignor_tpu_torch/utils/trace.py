"""Causal tracing: W3C-style context, span trees, tail sampling.

A copy of ``kafka_lag_based_assignor_tpu/utils/trace.py``: the same ids,
the same ``traceparent`` format, the same sampling rule and the same span
and anomaly vocabularies, so a trace that crosses a process of each package
is one trace, and a drill reads the same in both.  It is the causal layer
on top of :mod:`.metrics`: trace ids minted where a request enters, a
parent/child span tree (``metrics._Span`` records carry their parent when
the scope holds a :class:`TraceState`), propagation across threads, and
anomaly-biased tail retention.

**Context format** — W3C ``traceparent``: ``00-<32 hex trace_id>-
<16 hex span_id>-01`` (55 chars, version 00, sampled flag fixed at 01;
:func:`parse_traceparent` is strict and returns None on ANY deviation).
Span ids are minted as ``(40 random process bits | 24-bit counter)`` so two
processes joined into ONE trace (shared trace_id) cannot collide on span
ids.

**Propagation** — a caller sends ``traceparent`` and the callee adopts it;
``capture_scope``/``adopt_scope`` carry the SAME :class:`TraceState` onto
the watchdog's solve worker (worker spans parent under the capture point's
innermost open span).  Background work runs self-rooted traces linked to
the streams it touches.

**Tail sampling** — retention decides at trace END (tail), biased by
anomaly marks: a trace that shed, descended the ladder, tripped a breaker,
quarantined, resynced, timed out a solve, or blew the latency threshold is
ALWAYS kept; healthy traces keep at ``sample_rate`` via a deterministic
hash of the trace id (``int(trace_id[:16], 16) / 2**64 < rate``) —
deterministic so a cross-process trace's segments make the SAME decision
in every process, and so tests can pin keep/drop by choosing ids.  Kept
traces live in a bounded in-memory ring, and anomalous ones additionally
rotate to ``KLBA_TRACE_DIR`` JSON files under the flight-dump discipline
(``trace-<seq % keep_files>.json``, min interval between disk writes).

Known limit, by design: sampling is per-process, so a HEALTHY remote
segment of a locally-anomalous trace is only kept when the shared-id hash
admits it (or the remote marked its own anomaly).  Run with
``sample_rate=1.0`` when drilling cross-process reconstruction.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import random
import threading
from typing import Any, Dict, List, Optional, Tuple

LOGGER = logging.getLogger(__name__)

ENV_TRACE_DIR = "KLBA_TRACE_DIR"
ENV_TRACE_SAMPLE = "KLBA_TRACE_SAMPLE"
ENV_TRACE_LATENCY_MS = "KLBA_TRACE_LATENCY_MS"

#: ``00-<32 hex>-<16 hex>-01``
TRACEPARENT_LEN = 55

#: Every anomaly kind :func:`mark` accepts — the always-keep triggers.
ANOMALY_KINDS = frozenset({
    "shed",        # overload admission rejected / deadline-shed a row
    "ladder",      # served from a degraded rung (stream or federated)
    "breaker",     # a solver/peer circuit breaker tripped
    "quarantine",  # integrity digest quarantined resident state
    "resync",      # delta-protocol epoch resync
    "timeout",     # watchdog abandoned a wedged solve
    "latency",     # root duration blew the configured threshold
    "guardrail",   # solve guardrail auto-dump fired
    "error",       # request died with an unhandled error
})

#: The registered span-name catalog — every LITERAL ``span("...")``
#: name in package code must appear here (the JAX package's analyzer
#: enforces it there), so a renamed or ad-hoc span cannot silently drift
#: out of dashboards.  The catalog is the JAX package's, whole: it names
#: spans of modules the port has not taken yet.  Scope ROOT names (minted by
#: ``request_scope``/``begin_scope``, not ``span()``) are registered
#: too so the trace view renders from one vocabulary.
SPAN_CATALOG = frozenset({
    # request plane
    "assign.solve",
    "lag.read",
    # streaming engine
    "stream.epoch",
    "stream.cold_solve",
    "stream.sharded_solve",
    "stream.linear_solve",
    "stream.h2d",
    "stream.h2d_delta",
    "stream.refine",
    # coalescer
    "coalesce.window",
    "coalesce.upload",
    "coalesce.dispatch",
    "coalesce.readback",
    # sharded backend
    "sharded.solve",
    "sharded.refine",
    "sharded.linear_duals",
    # federation
    "federation.assign",
    "federation.round",
    "federation.sync",
    "federation.gossip",
    # scope roots
    "request",
    "client",
    "coalesce.wave",
    "scrub.pass",
    "snapshot.write",
})


# --- id minting ----------------------------------------------------------

# 40 random bits fixed per process + a 24-bit counter: unique within a
# process by the counter, across processes by the prefix — two sidecars
# sharing one trace_id (the whole point of propagation) must not mint
# colliding span ids.  The counter is an itertools.count, not a locked
# cell: next() is a single C-level call (GIL-atomic), and this runs
# once per span on serving paths inside the <1% epoch budget.
_SPAN_PREFIX = int.from_bytes(os.urandom(5), "big") << 24
_span_seq = itertools.count(1)

# Trace-id entropy comes from a process-local Mersenne generator, not
# os.urandom: ids need uniqueness and an unbiased sampling hash, not
# cryptographic strength, and getrandbits is one GIL-atomic C call
# where urandom is a syscall — this runs once per wire request inside
# the <1% epoch budget.  Reseeded after fork so sidecar children never
# replay the parent's id stream.
_trace_rng = random.Random(os.urandom(32))


def _reseed_trace_rng() -> None:
    global _trace_rng
    _trace_rng = random.Random(os.urandom(32))


if hasattr(os, "register_at_fork"):  # pragma: no branch
    os.register_at_fork(after_in_child=_reseed_trace_rng)


def mint_trace_id() -> str:
    return format(_trace_rng.getrandbits(128), "032x")


def mint_span_id() -> str:
    return format(_SPAN_PREFIX | (next(_span_seq) & 0xFFFFFF), "016x")


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: Any) -> Optional[Tuple[str, str]]:
    """Strict parse -> ``(trace_id, span_id)`` or None.  Anything off —
    wrong type, wrong length, wrong version, non-hex, all-zero ids — is
    rejected, never guessed at: this is the validator the federated
    wire whitelist and the service edge both trust."""
    if not isinstance(value, str) or len(value) != TRACEPARENT_LEN:
        return None
    parts = value.split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if version != "00" or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if len(flags) != 2:
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def keep_decision(trace_id: str, sample_rate: float) -> bool:
    """The deterministic healthy-trace sampling rule (module
    docstring): shared by every process segment of a trace."""
    if sample_rate >= 1.0:
        return True
    if sample_rate <= 0.0:
        return False
    try:
        frac = int(trace_id[:16], 16) / 2.0 ** 64
    except ValueError:
        return False
    return frac < sample_rate


# --- per-trace state -----------------------------------------------------

#: Hard per-trace bounds: a runaway scope (a span leak in a
#: loop, a wave linking an unbounded submitter set) cannot grow one
#: trace without limit — overflow drops the OLDEST entries, keeping
#: the tail that explains how the trace ENDED.
_MAX_SPANS_PER_TRACE = 512
_MAX_LINKS_PER_TRACE = 256


class TraceState:
    """One trace's accumulating state, shared by every thread a scope
    is adopted onto.  Mutation is GIL-atomic by construction — list
    appends/extends and set adds only — because watchdog workers and
    the request thread write concurrently (same reasoning as the
    metrics dump-dedup cell).

    Construction is on the per-request hot path (every wire request
    roots one of these inside the <1% epoch budget), so everything
    deferrable is deferred: the root span id and the span/link/anomaly
    containers materialize on first use, and the tail-sampling hash is
    cached from the raw id bytes at mint instead of re-parsing hex at
    finish.  Span RECORDS defer too — metrics spans carry their parent
    by reference and :func:`_resolve_span_ids` mints real ids only for
    traces the collector actually keeps."""

    __slots__ = (
        "trace_id", "_root_span_id", "remote_parent_id", "kind",
        "root_name", "request_id", "spans", "links", "anomalies",
        "device_ms", "_keep_frac",
    )

    def __init__(
        self,
        kind: str = "request",
        root_name: Optional[str] = None,
        request_id: Optional[str] = None,
        traceparent: Optional[str] = None,
    ):
        # None fast path: the common case (a locally-rooted trace)
        # must not pay the strict parser on every scope.
        parsed = (
            parse_traceparent(traceparent)
            if traceparent is not None else None
        )
        if parsed is not None:
            # Remote join: adopt the caller's trace id; our root span
            # parents under THEIR sending span.  The sampling hash is
            # computed lazily off the hex id if this segment finishes
            # healthy (keep_frac).
            self.trace_id, self.remote_parent_id = parsed
            self._keep_frac: Optional[float] = None
        else:
            # The high 64 bits ARE the sampling hash (hex chars 0..15),
            # so the keep fraction is cached straight off the integer —
            # no re-parse at finish.
            bits = _trace_rng.getrandbits(128)
            self.trace_id = format(bits, "032x")
            self.remote_parent_id = None
            self._keep_frac = (bits >> 64) / 2.0 ** 64
        self._root_span_id: Optional[str] = None
        self.kind = kind
        self.root_name = root_name or kind
        self.request_id = request_id
        self.spans: Optional[List[Dict[str, Any]]] = None
        self.links: Optional[List[Dict[str, Any]]] = None
        self.anomalies: Optional[set] = None
        self.device_ms = 0.0

    @property
    def root_span_id(self) -> str:
        """The root span's id, minted on first use (link sites, the
        outbound traceparent, and kept-trace payloads reach it; a
        dropped healthy trace never does)."""
        sid = self._root_span_id
        if sid is None:
            sid = self._root_span_id = mint_span_id()
        return sid

    def keep_frac(self) -> float:
        """The deterministic sampling hash (module docstring), cached.
        Matches :func:`keep_decision` exactly; a non-hex id (impossible
        for minted ids, parse-rejected for adopted ones) reads as 1.0 —
        never sampled in."""
        frac = self._keep_frac
        if frac is None:
            try:
                frac = int(self.trace_id[:16], 16) / 2.0 ** 64
            except ValueError:
                frac = 1.0
            self._keep_frac = frac
        return frac

    def mark(self, kind: str) -> None:
        anomalies = self.anomalies
        if anomalies is None:
            anomalies = self.anomalies = set()
        anomalies.add(kind)

    def link(self, trace_id: str, span_id: Optional[str] = None,
             relation: str = "") -> None:
        """Cross-trace edge (coalescer wave <-> submitting requests)."""
        entry: Dict[str, Any] = {"trace_id": trace_id}
        if span_id is not None:
            entry["span_id"] = span_id
        if relation:
            entry["relation"] = relation
        links = self.links
        if links is None:
            links = self.links = []
        links.append(entry)
        del links[: -_MAX_LINKS_PER_TRACE]

    def link_stream(self, stream_id: str) -> None:
        """Background traces (scrubber, snapshots) name the streams
        they touched — the operator pivot from a stream incident to the
        background activity around it."""
        links = self.links
        if links is None:
            links = self.links = []
        links.append({"stream_id": str(stream_id)})
        del links[: -_MAX_LINKS_PER_TRACE]

    def absorb(self, spans: List[Dict[str, Any]],
               device_ms: float = 0.0) -> None:
        """Fold one thread's completed spans (and its device time) in —
        called exactly once per scope teardown per thread."""
        if spans:
            mine = self.spans
            if mine is None:
                mine = self.spans = []
            mine.extend(spans)
            del mine[: -_MAX_SPANS_PER_TRACE]
        if device_ms:
            self.device_ms += device_ms

    def traceparent(self, span_id: Optional[str] = None) -> str:
        return format_traceparent(
            self.trace_id, span_id or self.root_span_id
        )


def _resolve_span_ids(state: TraceState) -> None:
    """Mint the real span ids for a KEPT trace's records — deferred
    from the hot path so a dropped trace never pays for id minting.
    Records carry their parent by REFERENCE (``_parent_rec``, attached
    at span enter); children exit (and so are listed) before their
    parents, so ids are assigned in one pass and parents resolved in a
    second.  A parent record that never completed (a watchdog worker's
    adoption point abandoned while still open) still gets an id minted
    onto it here, so :func:`join_trace` reports it as exactly the
    missing parent it is."""
    spans = state.spans
    if not spans:
        return
    root_id = state.root_span_id
    for rec in spans:
        if "span_id" not in rec:
            rec["span_id"] = mint_span_id()
    for rec in spans:
        parent = rec.pop("_parent_rec", None)
        if "parent_id" in rec:
            continue
        if parent is None:
            rec["parent_id"] = root_id
        else:
            sid = parent.get("span_id")
            if sid is None:
                sid = parent["span_id"] = mint_span_id()
            rec["parent_id"] = sid


# --- collector (tail sampler + ring + rotated dumps) ---------------------

class TraceCollector:
    """Tail-samples finished traces (module docstring).  ``finish`` is
    the single decision point: always-keep on any anomaly mark, else
    the deterministic ``sample_rate`` hash; kept traces enter a bounded
    ring, anomalous ones additionally rotate to ``dump_dir`` JSON under
    the flight-recorder disk discipline."""

    def __init__(
        self,
        capacity: int = 256,
        sample_rate: Optional[float] = None,
        latency_threshold_ms: Optional[float] = None,
        dump_dir: Optional[str] = None,
        keep_files: int = 64,
        disk_min_interval_s: float = 30.0,
    ):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = capacity
        if sample_rate is None:
            sample_rate = float(
                os.environ.get(ENV_TRACE_SAMPLE, "0.01")
            )
        self.sample_rate = sample_rate
        if latency_threshold_ms is None:
            raw = os.environ.get(ENV_TRACE_LATENCY_MS)
            latency_threshold_ms = float(raw) if raw else None
        self.latency_threshold_ms = latency_threshold_ms
        self.dump_dir = (
            dump_dir if dump_dir is not None
            else os.environ.get(ENV_TRACE_DIR)
        )
        self.keep_files = max(1, int(keep_files))
        self.disk_min_interval_s = disk_min_interval_s
        self._lock = threading.Lock()
        self._kept: List[Dict[str, Any]] = []
        self._counts = {
            "kept_anomalous": 0, "kept_sampled": 0, "dropped": 0,
        }
        self._dump_seq = 0
        self._last_disk_dump: Optional[float] = None
        self.last_anomalous_trace_id: Optional[str] = None
        # Per-outcome counter children, resolved once (the registry
        # lookup builds and hashes a label tuple — too heavy to pay on
        # every finish inside the <1% epoch budget).
        self._m_outcome: Dict[str, Any] = {}

    def fast_drop(self, state: TraceState) -> bool:
        """True = the trace was DROPPED and counted, and the caller may
        skip duration math, span absorption, and :meth:`finish`
        entirely.  A healthy trace's fate is sealed at mint (the
        sampling hash is deterministic), so the per-request teardown —
        the dominant outcome at production sample rates, priced inside
        the <1% epoch budget — pays only this decision and two counter
        bumps.  Bails to the full path whenever the outcome could still
        change: an anomaly already marked, a latency threshold armed
        (needs the duration), or a sampled-in hash."""
        if state.anomalies is not None or self.latency_threshold_ms is not None:
            return False
        frac = state._keep_frac
        if frac is None:
            frac = state.keep_frac()
        rate = self.sample_rate
        if rate >= 1.0 or frac < rate:
            return False
        ctr = self._m_outcome.get("dropped")
        if ctr is None:
            from . import metrics  # lazy: metrics imports this module

            ctr = self._m_outcome["dropped"] = metrics.REGISTRY.counter(
                "klba_trace_total", {"outcome": "dropped"}
            )
        ctr.inc()
        # GIL-relaxed increment, deliberately outside self._lock: two
        # request threads dropping in the same preemption window can
        # lose a count, at ~1e-4 odds, on the one stat where drift is
        # harmless (the registry counter above stays lock-exact, and
        # kept counts keep the locked path in finish).
        self._counts["dropped"] += 1
        return True

    def finish(
        self,
        state: TraceState,
        duration_ms: float,
        spans: Optional[List[Dict[str, Any]]] = None,
        device_ms: float = 0.0,
    ) -> str:
        """Close out one trace; returns the retention outcome
        (``kept_anomalous`` / ``kept_sampled`` / ``dropped``).

        ``spans``/``device_ms`` are the finishing thread's own tail,
        passed here instead of pre-absorbed so the DROPPED path skips
        the absorb (and the deferred span-id minting) entirely —
        decide first, pay only for kept traces."""
        if (
            self.latency_threshold_ms is not None
            and duration_ms > self.latency_threshold_ms
        ):
            state.mark("latency")
        if state.anomalies:
            outcome = "kept_anomalous"
        else:
            rate = self.sample_rate
            if rate >= 1.0 or (rate > 0.0 and state.keep_frac() < rate):
                outcome = "kept_sampled"
            else:
                outcome = "dropped"
        ctr = self._m_outcome.get(outcome)
        if ctr is None:
            from . import metrics  # lazy: metrics imports this module

            ctr = self._m_outcome[outcome] = metrics.REGISTRY.counter(
                "klba_trace_total", {"outcome": outcome}
            )
        ctr.inc()
        if outcome == "dropped":
            with self._lock:
                self._counts["dropped"] += 1
            return outcome
        from . import metrics  # lazy: metrics imports this module

        if spans or device_ms:
            state.absorb(spans or (), device_ms)
        _resolve_span_ids(state)
        trace = {
            "trace_id": state.trace_id,
            "kind": state.kind,
            "request_id": state.request_id,
            "outcome": outcome,
            "duration_ms": duration_ms,
            "root": {
                "name": state.root_name,
                "span_id": state.root_span_id,
                "parent_id": state.remote_parent_id,
                "start_ms": 0.0,
                "duration_ms": duration_ms,
                "device_ms": state.device_ms,
            },
            "spans": list(state.spans or ()),
            "links": list(state.links or ()),
            "anomalies": sorted(state.anomalies or ()),
        }
        write_file = False
        now = metrics.REGISTRY.clock()
        with self._lock:
            self._counts[outcome] += 1
            self._kept.append(trace)
            del self._kept[: -self.capacity]
            if outcome == "kept_anomalous":
                self.last_anomalous_trace_id = state.trace_id
                self._dump_seq += 1
                seq = self._dump_seq
                write_file = bool(self.dump_dir) and (
                    self._last_disk_dump is None
                    or now - self._last_disk_dump
                    >= self.disk_min_interval_s
                )
                if write_file:
                    self._last_disk_dump = now
        if write_file:
            self._write_dump(trace, seq)
        return outcome

    def _write_dump(self, trace: Dict[str, Any], seq: int) -> None:
        try:
            # Same durable-write rule as flight dumps: tmp + rename.
            # Imported lazily, as in the JAX package.
            from .snapshot import atomic_write_bytes

            path = os.path.join(
                self.dump_dir, f"trace-{seq % self.keep_files}.json"
            )
            atomic_write_bytes(
                path,
                json.dumps(
                    trace, indent=2, sort_keys=True
                ).encode("utf-8"),
            )
        except OSError:
            LOGGER.warning(
                "trace dump to %s failed", self.dump_dir, exc_info=True
            )

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "kept_anomalous": self._counts["kept_anomalous"],
                "kept_sampled": self._counts["kept_sampled"],
                "dropped": self._counts["dropped"],
                "retained": len(self._kept),
                "sample_rate": self.sample_rate,
                "latency_threshold_ms": self.latency_threshold_ms,
                "last_anomalous_trace_id": self.last_anomalous_trace_id,
            }

    def traces(self, trace_id: Optional[str] = None,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Kept traces, oldest first; a cross-process trace replayed
        in-process yields MULTIPLE entries for one id (one per scope)."""
        with self._lock:
            out = [
                t for t in self._kept
                if trace_id is None or t["trace_id"] == trace_id
            ]
        if limit is not None:
            out = out[-limit:] if limit > 0 else []
        return out

    def kept_ids(self) -> List[str]:
        with self._lock:
            return [t["trace_id"] for t in self._kept]

    def clear(self) -> None:
        """Drop retained traces + counters (test bracketing)."""
        with self._lock:
            self._kept = []
            for k in self._counts:
                self._counts[k] = 0
            self.last_anomalous_trace_id = None


COLLECTOR = TraceCollector()


def collector() -> TraceCollector:
    return COLLECTOR


def mark(kind: str) -> None:
    """Stamp an anomaly on the calling thread's active trace (no-op
    outside a scope).  ``kind`` must be a registered
    :data:`ANOMALY_KINDS` member — an unknown kind is a programming
    error worth failing loudly in tests, but production marking sites
    run on serving paths, so it logs and drops instead of raising."""
    if kind not in ANOMALY_KINDS:
        LOGGER.warning("unknown trace anomaly kind %r dropped", kind)
        return
    from . import metrics  # lazy: metrics imports this module

    state = metrics.current_trace()
    if state is not None:
        state.mark(kind)


def mark_state(state: Optional[TraceState], kind: str) -> None:
    """Mark a trace by TOKEN — for anomaly sites running off-thread
    from the trace they indict (the coalescer flusher shedding a
    submitter's row)."""
    if state is None or kind not in ANOMALY_KINDS:
        return
    state.mark(kind)


# --- cross-process reconstruction ----------------------------------------

def join_trace(entries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Reconstruct ONE causal tree from every kept entry of a trace id
    (local + remote segments).  Returns a verdict dict:
    ``complete`` iff all entries share one id, exactly one segment is
    the origin (no remote parent), and every ``parent_id`` resolves
    within the union of spans."""
    ids = {e.get("trace_id") for e in entries}
    spans: Dict[str, Dict[str, Any]] = {}
    origins = []
    for e in entries:
        root = e.get("root") or {}
        if root.get("span_id"):
            spans[root["span_id"]] = root
        if root.get("parent_id") is None:
            origins.append(e)
        for s in e.get("spans", []):
            if s.get("span_id"):
                spans[s["span_id"]] = s
    missing = sorted({
        s["parent_id"] for s in spans.values()
        if s.get("parent_id") is not None
        and s["parent_id"] not in spans
    })
    return {
        "trace_id": next(iter(ids)) if len(ids) == 1 else None,
        "segments": len(entries),
        "origins": len(origins),
        "spans": len(spans),
        "missing_parents": missing,
        "complete": (
            len(entries) >= 1 and len(ids) == 1
            and len(origins) == 1 and not missing
        ),
    }
