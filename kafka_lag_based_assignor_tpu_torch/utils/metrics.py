"""Unified metrics: registry, request-scoped spans, flight recorder.

A copy of ``kafka_lag_based_assignor_tpu/utils/metrics.py``: the same
series names, the same bucket rule, the same snapshot and Prometheus text,
so a dashboard or an alert written for one package reads the other.  This
module is the ONE process-wide home for time-series telemetry;
:mod:`.observability` keeps its function signatures as thin views over the
registry.

Three layers:

**Registry** — thread-safe counters, gauges, and fixed-bucket log2
histograms, addressed by ``(name, labels)``.  Every series' storage (the
bucket array, the running count/sum) is preallocated at first
registration, a record is integer adds under the series' own lock, and
callers on warm loops pre-bind the series object once
(``registry.histogram(...)`` returns the same child for the same
name+labels forever).  Histogram buckets are log2: bucket ``i`` holds
values in ``(2^(i-1), 2^i]`` (bucket 0 holds ``v <= 1``), so recording
needs no search — the index is ``(v - 1).bit_length()`` for integers — and
percentile estimates are bucket upper edges clamped to the observed
min/max.  Export is a JSON snapshot or the Prometheus text exposition.

**Spans** — ``with span("stream.refine"):`` records the block's duration
into ``klba_span_duration_ms{span=...}`` and, when a request scope is
active on the thread, appends a (name, parent, start, duration) entry to
the request's timeline.  A rebalance runs in one request scope
(``request_scope``); :class:`RequestIdLogFilter` tags package log lines
emitted on the request thread with its id.

**Flight recorder** — a bounded ring of the last N rebalance /
stream-epoch records (stats only — assignment payloads are redacted) that
auto-dumps to JSON whenever a breaker trips, a guardrail fires, or a
request descends past the first ladder rung, so a degraded production
incident is debuggable after the fact without trace-level logging.  At
most one auto-dump per request scope: the first trigger wins (a breaker
trip and the ladder descent it causes are ONE incident).  Dumps go to
``KLBA_FLIGHT_DIR`` when it is set.

Clock discipline: every duration here flows through the module clock
(``perf_counter`` by default, injectable for tests).
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from . import trace as trace_mod

LOGGER = logging.getLogger(__name__)

# 40 log2 buckets: the last upper edge is 2^39 (~17 years in ms, ~5.5e11
# in raw units) — everything beyond clamps into the final bucket.
NBUCKETS = 40

_LabelsKey = Tuple[Tuple[str, str], ...]


def bucket_index(value: float) -> int:
    """The log2 bucket rule, shared by recording and tests: bucket 0
    holds ``v <= 1`` (including 0 and negatives, which durations and
    counts never produce anyway); bucket ``i`` holds ``(2^(i-1), 2^i]``.
    Exact at integer powers of two: ``2^k`` lands in bucket k,
    ``2^k + 1`` in bucket k+1."""
    if value <= 1:
        return 0
    if isinstance(value, int):
        idx = (value - 1).bit_length()
    else:
        # frexp is exact: v = m * 2^e with 0.5 <= m < 1, so the upper-
        # edge-inclusive bucket is e-1 exactly at powers of two (m=0.5).
        m, e = math.frexp(value)
        idx = e - 1 if m == 0.5 else e
    return idx if idx < NBUCKETS else NBUCKETS - 1


class Counter:
    """Monotonic counter series."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-value series."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket log2 histogram series (see :func:`bucket_index`)."""

    __slots__ = (
        "name", "labels", "_lock", "_buckets", "_count", "_sum",
        "_min", "_max",
    )

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._buckets = [0] * NBUCKETS  # preallocated: zero-alloc observe
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        idx = bucket_index(value)
        with self._lock:
            self._buckets[idx] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """Deterministic estimate: the upper edge (``2^i``) of the bucket
        holding the q-quantile observation, clamped to the observed
        [min, max] — never reports a value outside what was recorded."""
        with self._lock:
            if self._count == 0:
                return None
            rank = max(1, math.ceil(q * self._count))
            acc = 0
            for i, c in enumerate(self._buckets):
                acc += c
                if acc >= rank:
                    edge = float(1 << i)
                    return min(max(edge, self._min), self._max)
            return self._max  # unreachable; defensive

    def state(self) -> Dict[str, Any]:
        """Raw series state (buckets included) — the snapshot/delta unit."""
        with self._lock:
            return {
                "buckets": list(self._buckets),
                "count": self._count,
                "sum": self._sum,
                "min": None if self._count == 0 else self._min,
                "max": None if self._count == 0 else self._max,
            }


class Registry:
    """Process-wide, thread-safe home of every metric series.

    ``counter`` / ``gauge`` / ``histogram`` are get-or-create: the same
    (name, labels) always returns the same child object, so hot paths
    pre-bind once and record lock-cheap forever after.  A name is bound
    to exactly one metric type; rebinding is a bug and raises."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._lock = threading.Lock()
        self._types: Dict[str, str] = {}
        self._children: Dict[Tuple[str, _LabelsKey], Any] = {}
        self.clock = clock

    def _child(self, kind: str, cls, name: str,
               labels: Optional[Dict[str, str]]):
        labels = {k: str(v) for k, v in (labels or {}).items()}
        key = (name, tuple(sorted(labels.items())))
        child = self._children.get(key)  # GIL-safe fast path, no lock
        if child is not None:
            if not isinstance(child, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(child).__name__.lower()}"
                )
            return child
        with self._lock:
            child = self._children.get(key)
            if child is None:
                bound = self._types.setdefault(name, kind)
                if bound != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {bound}"
                    )
                child = self._children[key] = cls(name, labels)
        return child

    def counter(self, name: str,
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._child("counter", Counter, name, labels)

    def gauge(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._child("gauge", Gauge, name, labels)

    def histogram(self, name: str,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._child("histogram", Histogram, name, labels)

    def series(self, name: str) -> List[Any]:
        """Every child registered under ``name`` (label-sorted order)."""
        with self._lock:
            return [
                child for (n, _), child in sorted(
                    self._children.items(), key=lambda kv: kv[0]
                ) if n == name
            ]

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able full state: per name, its type and every series
        (labels + value, histograms with buckets and p50/p99)."""
        with self._lock:
            items = sorted(self._children.items(), key=lambda kv: kv[0])
            types = dict(self._types)
        out: Dict[str, Any] = {}
        for (name, _), child in items:
            entry = out.setdefault(
                name, {"type": types[name], "series": []}
            )
            if isinstance(child, Histogram):
                st = child.state()
                st["p50"] = child.percentile(0.50)
                st["p99"] = child.percentile(0.99)
                entry["series"].append({"labels": child.labels, **st})
            else:
                entry["series"].append(
                    {"labels": child.labels, "value": child.value}
                )
        return out

    def prometheus(self, snap: Optional[Dict[str, Any]] = None) -> str:
        """The Prometheus text exposition (version 0.0.4): ``# TYPE``
        headers, cumulative ``_bucket{le=...}`` series ending at
        ``+Inf``, ``_sum``/``_count`` per histogram series.  Pass an
        existing :meth:`snapshot` to render both views from ONE registry
        walk (the wire ``metrics`` method does)."""
        def fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
            parts = [
                f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
            ]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines: List[str] = []
        if snap is None:
            snap = self.snapshot()
        for name, entry in snap.items():
            lines.append(f"# TYPE {name} {entry['type']}")
            for s in entry["series"]:
                labels = s["labels"]
                if entry["type"] != "histogram":
                    value = s["value"]
                    lines.append(f"{name}{fmt_labels(labels)} {value}")
                    continue
                acc = 0
                for i, c in enumerate(s["buckets"]):
                    if c == 0 and i != NBUCKETS - 1:
                        # skip empty interior buckets; cumulative values
                        # stay correct and the exposition stays readable
                        continue
                    acc = sum(s["buckets"][: i + 1])
                    le = fmt_labels(labels, f'le="{1 << i}"')
                    lines.append(f"{name}_bucket{le} {acc}")
                inf = fmt_labels(labels, 'le="+Inf"')
                lines.append(f"{name}_bucket{inf} {s['count']}")
                lines.append(f"{name}_sum{fmt_labels(labels)} {s['sum']}")
                lines.append(
                    f"{name}_count{fmt_labels(labels)} {s['count']}"
                )
        return "\n".join(lines) + "\n"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def histogram_deltas(
    before: Dict[str, Any], after: Dict[str, Any]
) -> Dict[str, Any]:
    """Per-series p50/p99/count of the OBSERVATIONS MADE BETWEEN two
    :meth:`Registry.snapshot` calls (bucket-wise subtraction) — how a
    caller reads percentiles of one run without resetting the
    process-wide registry.  Series with no new observations are
    omitted."""
    out: Dict[str, Any] = {}
    for name, entry in after.items():
        if entry["type"] != "histogram":
            continue
        prior = {
            _series_key(s): s
            for s in before.get(name, {}).get("series", [])
        }
        for s in entry["series"]:
            b = prior.get(_series_key(s))
            buckets = list(s["buckets"])
            count, total = s["count"], s["sum"]
            if b is not None:
                buckets = [x - y for x, y in zip(buckets, b["buckets"])]
                count -= b["count"]
                total -= b["sum"]
            if count <= 0:
                continue
            key = name + "".join(
                f"{{{k}={v}}}" for k, v in sorted(s["labels"].items())
            )
            out[key] = {
                "count": count,
                "sum": total,
                "p50": _delta_percentile(buckets, count, 0.50),
                "p99": _delta_percentile(buckets, count, 0.99),
            }
    return out


def _series_key(s: Dict[str, Any]) -> _LabelsKey:
    return tuple(sorted(s["labels"].items()))


def _delta_percentile(buckets: List[int], count: int, q: float) -> float:
    rank = max(1, math.ceil(q * count))
    acc = 0
    for i, c in enumerate(buckets):
        acc += c
        if acc >= rank:
            return float(1 << i)
    return float(1 << (NBUCKETS - 1))


# --- the process-wide registry ------------------------------------------

REGISTRY = Registry()


def registry() -> Registry:
    return REGISTRY


# --- request scopes + spans ---------------------------------------------

_tls = threading.local()
# itertools.count, not a locked cell: next() is one C-level call
# (GIL-atomic) and a request id is minted per wire request inside the
# <1% epoch budget.
_req_seq = itertools.count(1)


class _RequestCtx:
    __slots__ = (
        "request_id", "spans", "stack", "start", "dumped_cell",
        "trace", "adopt_parent_rec", "device_ms",
    )

    def __init__(
        self,
        request_id: str,
        start: float,
        dumped_cell: Optional[List[bool]] = None,
        trace: Optional[trace_mod.TraceState] = None,
        adopt_parent_rec: Optional[Dict[str, Any]] = None,
    ):
        self.request_id = request_id
        self.spans: List[Dict[str, Any]] = []
        # Open-span stack of span RECORD dicts (innermost last): spans
        # read their parent's name/span_id off the top, device phases
        # accumulate device_ms onto every open record.
        self.stack: List[Dict[str, Any]] = []
        self.start = start
        # One-auto-dump-per-request state, a shared CELL rather than a
        # plain bool: a scope adopted onto a worker thread
        # (:func:`adopt_scope`) shares the cell with its parent, so the
        # incident budget spans both threads.
        self.dumped_cell = (
            dumped_cell if dumped_cell is not None else [False]
        )
        # The trace this scope feeds (shared ACROSS threads by
        # adopt_scope — TraceState mutation is GIL-atomic by design)
        # and, on adopted worker scopes, the capture point's innermost
        # open span RECORD: the worker's spans parent under it (by
        # reference — ids are minted only if the trace is kept).
        self.trace = trace
        self.adopt_parent_rec = adopt_parent_rec
        # This THREAD's device-phase time; folded into the trace at
        # scope teardown (per-thread so concurrent phases never race a
        # float read-modify-write).
        self.device_ms = 0.0


def mint_request_id() -> str:
    return f"req-{os.getpid()}-{next(_req_seq)}"


def current_request_id() -> Optional[str]:
    ctx = getattr(_tls, "ctx", None)
    return ctx.request_id if ctx is not None else None


def current_timeline() -> List[Dict[str, Any]]:
    """The active request's COMPLETED spans so far (empty outside a
    scope)."""
    ctx = getattr(_tls, "ctx", None)
    return list(ctx.spans) if ctx is not None else []


def current_open_spans() -> List[str]:
    """The active request's still-open span NAMES, outermost first —
    at incident time (a dump) this names the phase the request died in."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return []
    return [rec["name"] for rec in ctx.stack]


def current_trace() -> Optional[trace_mod.TraceState]:
    """The active scope's trace state (None outside a traced scope)."""
    ctx = getattr(_tls, "ctx", None)
    return ctx.trace if ctx is not None else None


def current_trace_id() -> Optional[str]:
    tr = current_trace()
    return tr.trace_id if tr is not None else None


def current_traceparent() -> Optional[str]:
    """The W3C context an OUTBOUND hop should carry: the active trace
    id plus the innermost open span's id (falling back to the adopted
    parent, then the trace root) — so the remote segment parents under
    the span that made the call."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None or ctx.trace is None:
        return None
    stack = ctx.stack
    rec = stack[-1] if stack else ctx.adopt_parent_rec
    if rec is None:
        return ctx.trace.traceparent()
    # Span ids are minted lazily (kept traces only) — an outbound hop
    # forces the id here so the remote segment has a real parent.
    sid = rec.get("span_id")
    if sid is None:
        sid = rec["span_id"] = trace_mod.mint_span_id()
    return ctx.trace.traceparent(sid)


def _teardown_ctx(ctx: _RequestCtx, finish: bool) -> None:
    """Fold one thread's spans/device time into the shared trace; the
    scope that OWNS the trace (request_scope / finish_scope) also runs
    the tail-sampling decision."""
    tr = ctx.trace
    if tr is None:
        return
    if finish:
        # Decide-first: a mint-doomed healthy trace (the dominant
        # outcome at production sample rates) exits via fast_drop
        # without duration math, span absorption, or span-id minting;
        # only kept/undecided traces pay the full finish.
        coll = trace_mod.COLLECTOR
        if coll.fast_drop(tr):
            return
        duration_ms = (REGISTRY.clock() - ctx.start) * 1000.0
        coll.finish(
            tr, duration_ms, spans=ctx.spans, device_ms=ctx.device_ms
        )
    else:
        tr.absorb(ctx.spans, ctx.device_ms)


class _RequestScope:
    """The :func:`request_scope` context manager, hand-rolled for the
    same reason as :class:`_Span`: the ``@contextmanager`` generator
    protocol costs ~2x per enter/exit, and the service opens one of
    these per wire request inside the <1% epoch budget."""

    __slots__ = ("_request_id", "_traceparent", "_kind", "_root_name",
                 "_ctx")

    def __init__(
        self,
        request_id: Optional[str],
        traceparent: Optional[str],
        kind: str,
        root_name: Optional[str],
    ):
        self._request_id = request_id
        self._traceparent = traceparent
        self._kind = kind
        self._root_name = root_name

    def __enter__(self) -> str:
        outer = getattr(_tls, "ctx", None)
        if outer is not None:
            # Nested scope: flatten — the outermost wins, and __exit__
            # must not tear down a ctx it does not own.
            self._ctx = None
            return outer.request_id
        rid = self._request_id or mint_request_id()
        # Positional calls: this pair runs per wire request inside the
        # <1% epoch budget, and CPython kwargs cost a dict build.
        ctx = self._ctx = _RequestCtx(
            rid, REGISTRY.clock(), None,
            trace_mod.TraceState(
                self._kind, self._root_name, rid, self._traceparent
            ),
        )
        _tls.ctx = ctx
        return rid

    def __exit__(self, *exc: Any) -> bool:
        ctx = self._ctx
        if ctx is not None:
            _tls.ctx = None
            _teardown_ctx(ctx, finish=True)
        return False


def request_scope(
    request_id: Optional[str] = None,
    traceparent: Optional[str] = None,
    kind: str = "request",
    root_name: Optional[str] = None,
) -> _RequestScope:
    """Scope a wire request: mints (or adopts) a request id, roots a
    trace (adopting ``traceparent``'s trace id when the caller sent a
    valid one — the cross-process join), carries the span timeline, and
    bounds the one-auto-dump-per-request rule.  ``kind``/``root_name``
    name self-rooted non-wire traces (``background`` scrubber passes
    and snapshot writes, ``client`` lag reads).  Nested scopes are
    flattened: the outermost wins.  Scope exit runs the tail-sampling
    retention decision on the finished trace."""
    return _RequestScope(request_id, traceparent, kind, root_name)


def capture_scope() -> Optional[_RequestCtx]:
    """Opaque token of the calling thread's active request scope (None
    outside one) — hand it to a worker thread for :func:`adopt_scope`."""
    return getattr(_tls, "ctx", None)


@contextmanager
def adopt_scope(token: Optional[_RequestCtx]) -> Iterator[Optional[str]]:
    """Join a captured request scope from ANOTHER thread (the watchdog
    runs solves on abandonable workers; without this, engine-side flight
    records would lose the request id and engine-side auto-dump triggers
    would bypass the one-dump-per-request cap).  The worker gets its OWN
    span timeline — the parent may abandon the worker and dump while it
    still runs, so sharing the parent's mutable span list would race —
    but shares the request id, the dump-dedup cell, and the TRACE: the
    worker's spans parent under the capture point's innermost open span
    and land in the same tree.  The adopting side never finishes the
    trace — the owning scope's exit does."""
    if token is None or getattr(_tls, "ctx", None) is not None:
        yield current_request_id()
        return
    adopt_parent = None
    if token.trace is not None:
        # Best-effort snapshot: the capturing thread is normally parked
        # in watchdog.call, but an abandoning parent may already be
        # unwinding its stack — a copy keeps the read safe either way.
        # The adoption point is the capture's innermost open span
        # RECORD (ids stay lazy until the trace is kept).
        stack = list(token.stack)
        adopt_parent = stack[-1] if stack else token.adopt_parent_rec
    ctx = _RequestCtx(
        token.request_id, REGISTRY.clock(),
        dumped_cell=token.dumped_cell,
        trace=token.trace,
        adopt_parent_rec=adopt_parent,
    )
    _tls.ctx = ctx
    try:
        yield ctx.request_id
    finally:
        _tls.ctx = None
        _teardown_ctx(ctx, finish=False)


def begin_scope(
    kind: str = "wave",
    root_name: Optional[str] = None,
    request_id: Optional[str] = None,
) -> _RequestCtx:
    """Mint a scope token WITHOUT installing it on any thread — the
    coalescer's unit of work is a wave that spans the flusher thread
    (dispatch) and a readback worker, with no single ``with`` block
    covering both.  Each participating thread joins via
    :func:`adopt_scope`; :func:`finish_scope` closes the trace exactly
    once when the wave's last act (the readback) completes."""
    rid = request_id or mint_request_id()
    return _RequestCtx(
        rid, REGISTRY.clock(),
        trace=trace_mod.TraceState(
            kind=kind, root_name=root_name, request_id=rid,
        ),
    )


def finish_scope(token: Optional[_RequestCtx]) -> None:
    """Run the retention decision for a :func:`begin_scope` token (the
    token's own span list is empty — every participating thread already
    absorbed its spans at ``adopt_scope`` exit)."""
    if token is not None:
        _teardown_ctx(token, finish=True)


# Per-name cache of the span-duration histogram children: the span
# enter/exit pair sits inside the warm no-op epoch's <1% overhead
# budget, so the label-dict build + sorted-tuple hash of a registry
# lookup is paid once per span name, not once per epoch.
_span_hists: Dict[str, Histogram] = {}


def _span_hist(name: str) -> Histogram:
    h = _span_hists.get(name)
    if h is None:
        h = _span_hists[name] = REGISTRY.histogram(
            "klba_span_duration_ms", {"span": name}
        )
    return h


class _Span:
    """``with span("stream.refine") as rec:`` — times the block into
    ``klba_span_duration_ms{span=name}`` and the request timeline.
    Inside a request scope ``rec`` is the timeline record
    (``duration_ms`` filled at exit; callers may attach extra stats-only
    fields); outside one it is None — only the histogram is fed, and the
    timeline dict is never built (the warm bench loop runs scope-free
    inside the <1% epoch budget).  A hand-rolled context manager, not
    ``@contextmanager``: the generator protocol costs ~2x as much per
    enter/exit and this runs per warm epoch."""

    __slots__ = ("name", "rec", "_start", "_ctx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Optional[Dict[str, Any]]:
        ctx = getattr(_tls, "ctx", None)
        self._ctx = ctx
        if ctx is not None:
            parent = ctx.stack[-1] if ctx.stack else None
            rec = self.rec = {
                "name": self.name,
                "parent": parent["name"] if parent is not None else None,
                "duration_ms": 0.0,
            }
            if ctx.trace is not None:
                # The causal tree, deferred: the parent travels by
                # REFERENCE (innermost open span, else the thread's
                # adoption point, else None = the trace root) and real
                # ids are minted only if the trace is KEPT
                # (trace._resolve_span_ids) — a dropped healthy trace
                # never pays for id minting on the warm path.
                rec["_parent_rec"] = (
                    parent if parent is not None else ctx.adopt_parent_rec
                )
            ctx.stack.append(rec)
        else:
            self.rec = None
        self._start = REGISTRY.clock()
        return self.rec

    def __exit__(self, *exc) -> bool:
        dur = (REGISTRY.clock() - self._start) * 1000.0
        ctx = self._ctx
        if ctx is not None:
            rec = self.rec
            rec["duration_ms"] = dur
            ctx.stack.pop()
            rec["start_ms"] = (self._start - ctx.start) * 1000.0
            ctx.spans.append(rec)
        _span_hist(self.name).observe(dur)
        return False


def span(name: str) -> _Span:
    return _Span(name)


# Per-phase device timing for the kernel plane (the linear-OT solve's
# h2d / duals / rounding and the streaming refine readback).  Same
# cached-child pattern as the span histograms — these wrap device
# dispatches on serving paths.
_device_phase_hists: Dict[str, Histogram] = {}


def _device_phase_hist(phase: str) -> Histogram:
    h = _device_phase_hists.get(phase)
    if h is None:
        h = _device_phase_hists[phase] = REGISTRY.histogram(
            "klba_device_phase_ms", {"phase": phase}
        )
    return h


class _DevicePhase:
    """``with device_phase("duals"):`` — wall-clock the enclosed DEVICE
    work into ``klba_device_phase_ms{phase=...}``.

    PyTorch launches on the card are asynchronous, so the phase times the
    device work only if the block ends with that work complete.  The port
    keeps this contract at every call site in one of two ways: the block
    ends in a host read of the work's result (``.cpu()``, ``.tolist()``,
    ``bool()`` of a device scalar — a read on the launching stream waits
    for everything enqueued before it), or the phase is given the device,
    ``device_phase("h2d", sync=device)``, and calls
    ``torch.cuda.synchronize(device)`` before it reads the clock.  On the
    CPU both are no-ops beyond the read.  Phases: ``h2d`` (host-to-device
    transfer of the solve inputs), ``duals`` (the mirror-prox loop),
    ``rounding`` (the rounding/refine portfolio with its readback),
    ``refine`` (the streaming refine step INCLUDING its digest readback).
    Inside a traced scope the phase additionally accumulates ``device_ms``
    onto every OPEN span record, so epoch spans carry ``{host_ms:
    duration_ms, device_ms}``."""

    __slots__ = ("phase", "_start", "_ctx", "_sync")

    def __init__(self, phase: str, sync=None):
        self.phase = phase
        self._sync = sync

    def __enter__(self) -> "_DevicePhase":
        self._ctx = getattr(_tls, "ctx", None)
        self._start = REGISTRY.clock()
        return self

    def __exit__(self, *exc) -> bool:
        sync = self._sync
        if sync is not None and getattr(sync, "type", None) == "cuda":
            import torch

            torch.cuda.synchronize(sync)
        dur = (REGISTRY.clock() - self._start) * 1000.0
        ctx = self._ctx
        if ctx is not None:
            for rec in ctx.stack:
                rec["device_ms"] = rec.get("device_ms", 0.0) + dur
            ctx.device_ms += dur
        _device_phase_hist(self.phase).observe(dur)
        return False


def device_phase(phase: str, sync=None) -> _DevicePhase:
    """See :class:`_DevicePhase`; ``sync`` is a ``torch.device`` to
    synchronize before the phase reads the clock (None: the block ends in
    a host read of its own)."""
    return _DevicePhase(phase, sync)


class RequestIdLogFilter(logging.Filter):
    """Echo the active request id on log lines: attach to a HANDLER you
    own and every record emitted on a request thread grows a
    `` request_id=...`` suffix plus a ``request_id`` attribute for
    structured formatters."""

    def filter(self, record: logging.LogRecord) -> bool:
        _tag_record(record)
        return True


def _tag_record(
    record: logging.LogRecord,
    prefix: str = "kafka_lag_based_assignor_tpu_torch",
) -> logging.LogRecord:
    rid = current_request_id()
    # Outside a scope of this package, a ``request_id`` another factory in
    # the chain already set (the JAX package's, in a process that runs
    # both) stays: the factories of both packages compose in either order.
    if rid is not None or not hasattr(record, "request_id"):
        record.request_id = rid or "-"
    if (
        rid is not None
        and record.name.startswith(prefix)
        and "request_id=" not in str(record.msg)
    ):
        # Appending AFTER the %-format string is safe: the original
        # placeholders still line up with record.args.
        record.msg = f"{record.msg} request_id={rid}"
    return record


_factory_installed = [False]


def install_log_request_ids(
    logger_name: str = "kafka_lag_based_assignor_tpu_torch",
) -> None:
    """Idempotently tag every PACKAGE log record with the active request
    id.  Installed as a log-record factory, not a logger filter: logger
    filters are not inherited by child loggers (``...tpu.service`` et
    al. would bypass a filter on the package root), while the factory
    sees every record at creation.  Non-package records only gain the
    ``request_id`` attribute, their message is untouched."""
    if _factory_installed[0]:
        return
    old_factory = logging.getLogRecordFactory()

    def factory(*args, **kwargs):
        return _tag_record(old_factory(*args, **kwargs), logger_name)

    logging.setLogRecordFactory(factory)
    _factory_installed[0] = True


# --- flight recorder -----------------------------------------------------

ENV_FLIGHT_DIR = "KLBA_FLIGHT_DIR"

# Guards the one-auto-dump-per-request test-and-set (the dedup cell is
# shared across threads by adopt_scope).
_dedup_lock = threading.Lock()

#: Keys stripped from flight records: dumps are stats-only — assignment
#: payloads and member/topic identities never leave the process this way.
_REDACTED_KEYS = frozenset(
    {"assignments", "assignment", "members", "subscriptions",
     "member_total_lag", "member_partition_count", "per_topic", "topics"}
)


def _redact(obj: Any) -> Any:
    if isinstance(obj, dict):
        if _REDACTED_KEYS.isdisjoint(obj) and not any(
            isinstance(v, (dict, list, tuple)) or k.startswith("_")
            for k, v in obj.items()
        ):
            # Flat, clean dict (the per-epoch hot case): nothing to
            # strip, no copy.  The recorder takes ownership of records,
            # so aliasing the caller's dict is safe by contract.
            return obj
        # Underscore keys are in-process plumbing (a span record's
        # ``_parent_rec`` reference), never export material.
        return {
            k: _redact(v) for k, v in obj.items()
            if k not in _REDACTED_KEYS and not k.startswith("_")
        }
    if isinstance(obj, (list, tuple)):
        return [_redact(v) for v in obj]
    return obj


class FlightRecorder:
    """Bounded ring of the last N rebalance / stream-epoch records with
    trigger-driven JSON dumps (see the module docstring).

    ``dump_dir`` (default from ``KLBA_FLIGHT_DIR``, unset = in-memory
    only) receives dump files; the last ``keep_dumps`` dumps are also
    retained in memory for tests and the wire ``metrics`` method.  Disk
    usage is bounded two ways — a sustained outage (breaker open, every
    request descending the ladder) must not fill the log volume:
    filenames rotate modulo ``keep_files`` (``flight-<seq % K>.json``;
    the payload's ``dump_seq`` disambiguates), and at most one FILE is
    written per ``disk_min_interval_s`` (skipped dumps stay in memory
    and in the ``klba_flight_dumps_total`` counter)."""

    def __init__(
        self,
        capacity: int = 256,
        dump_dir: Optional[str] = None,
        keep_dumps: int = 8,
        registry_: Optional[Registry] = None,
        keep_files: int = 64,
        disk_min_interval_s: float = 30.0,
    ):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = capacity
        self.dump_dir = (
            dump_dir if dump_dir is not None
            else os.environ.get(ENV_FLIGHT_DIR)
        )
        self.keep_dumps = keep_dumps
        self.keep_files = max(1, int(keep_files))
        self.disk_min_interval_s = disk_min_interval_s
        self._registry = registry_ or REGISTRY
        self._ring: List[Optional[Dict[str, Any]]] = [None] * capacity
        self._idx = 0
        self._total = 0
        self._lock = threading.Lock()
        self._dump_seq = 0
        self._last_disk_dump: Optional[float] = None
        self.dumps: List[Dict[str, Any]] = []

    def record(self, kind: str, rec: Dict[str, Any]) -> None:
        """Append one record; O(1), ring-bounded.  The recorder takes
        ownership of ``rec`` (it is annotated in place, no copy).
        Redaction happens at DUMP time, not here — recording runs once
        per warm epoch inside the <1% overhead budget, dumping runs once
        per incident."""
        rec["kind"] = kind
        ctx = getattr(_tls, "ctx", None)
        if ctx is not None:
            if "request_id" not in rec:
                rec["request_id"] = ctx.request_id
            # Satellite of the tracing plane: every flight record made
            # inside a traced scope names its trace, so an incident
            # dump links straight to the kept trace.
            if ctx.trace is not None and "trace_id" not in rec:
                rec["trace_id"] = ctx.trace.trace_id
        with self._lock:
            rec["seq"] = self._total
            self._ring[self._idx] = rec
            self._idx = (self._idx + 1) % self.capacity
            self._total += 1

    def records(self) -> List[Dict[str, Any]]:
        """Retained records, oldest first."""
        with self._lock:
            tail = self._ring[self._idx:] + self._ring[: self._idx]
            return [r for r in tail if r is not None]

    def snapshot(self) -> List[Dict[str, Any]]:
        """REDACTED copies of the retained records, oldest first — the
        wire dump unit for the per-stream rings (stats only leave the
        process, same rule as :meth:`dump`; copies, so the live ring
        dicts are never handed out)."""
        return [_redact(dict(r)) for r in self.records()]

    def clear(self) -> None:
        """Drop the retained records (operator action after a dump).
        ``seq`` numbering stays monotonic so post-clear records are
        orderable against an earlier dump."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._idx = 0

    def auto_dump(self, reason: str,
                  detail: Optional[Dict[str, Any]] = None) -> bool:
        """Trigger hook (breaker trip / guardrail / ladder descent): at
        most ONE dump per request scope — a trip and the fallback it
        causes are one incident.  Returns True when a dump was written."""
        ctx = getattr(_tls, "ctx", None)
        if ctx is not None:
            # Locked test-and-set: the cell is shared with watchdog
            # worker threads (adopt_scope), and an abandoned worker's
            # guardrail trigger can race the parent's ladder trigger —
            # one incident must stay one dump even then.
            with _dedup_lock:
                if ctx.dumped_cell[0]:
                    return False
                ctx.dumped_cell[0] = True
        self.dump(reason, detail)
        return True

    def dump(self, reason: str,
             detail: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Unconditional dump (operator action / trigger hook)."""
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        payload = {
            "reason": reason,
            "dump_seq": seq,
            "request_id": current_request_id(),
            "trace_id": current_trace_id(),
            "in_flight_spans": _redact(current_timeline()),
            "open_spans": current_open_spans(),
            "detail": _redact(detail) if detail else None,
            # Redacted HERE (stats only leave the process), so the hot
            # per-epoch record path stays copy-free.
            "records": [_redact(r) for r in self.records()],
        }
        now = self._registry.clock()
        with self._lock:
            self.dumps.append(payload)
            del self.dumps[: -self.keep_dumps]
            write_file = bool(self.dump_dir) and (
                self._last_disk_dump is None
                or now - self._last_disk_dump >= self.disk_min_interval_s
            )
            if write_file:
                self._last_disk_dump = now
        self._registry.counter(
            "klba_flight_dumps_total", {"reason": reason}
        ).inc()
        if write_file:
            try:
                # Durable writes go through the atomic helper (tmp +
                # rename): an incident dump racing a crash must never
                # leave a torn file for the post-mortem.  Imported
                # lazily, as in the JAX package.
                from .snapshot import atomic_write_bytes

                path = os.path.join(
                    self.dump_dir,
                    f"flight-{seq % self.keep_files}.json",
                )
                atomic_write_bytes(
                    path,
                    json.dumps(
                        payload, indent=2, sort_keys=True
                    ).encode("utf-8"),
                )
            except OSError:
                LOGGER.warning(
                    "flight-recorder dump to %s failed", self.dump_dir,
                    exc_info=True,
                )
        LOGGER.warning(
            "flight-recorder dump #%d (reason=%s, records=%d)",
            seq, reason, len(payload["records"]),
        )
        return payload

    def dump_count(self) -> int:
        with self._lock:
            return self._dump_seq

    def last_dump(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self.dumps[-1] if self.dumps else None


FLIGHT = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return FLIGHT
