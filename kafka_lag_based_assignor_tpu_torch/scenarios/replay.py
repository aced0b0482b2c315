"""The replay engine: drive a real sidecar through a trace, wire-level.

Everything goes over the line protocol against a real
:class:`..service.AssignorService` on an ephemeral port — never
engine-internal calls — so a scenario exercises the whole serving
stack: admission, SLO classes, the coalescer, the degraded-mode
ladder, the integrity plane, snapshot recovery.  The engine advances
the fault injector's epoch clock (``set_epoch``) in lockstep with the
trace, so composed fault planes land exactly where the scenario
declared them.

Per epoch x stream the record captures the degradation observables the
envelopes gate on: wire validity (``testing.assert_valid_assignment``),
engine-reported churn + quality ratio, the ladder rung served, sheds
(typed ``ShedReject`` with class/rung), warm restarts, resyncs, and
latency; per epoch the kernel-build delta (``nvcc`` / ``g++`` builds,
``utils.observability.compile_count``) is attributed to the trace's
phase tag (the zero-steady-build gate: 0 on the CPU by construction, the
real gate on the card).  The decoded choice vector is kept per record so
replay twins can be compared bit-exactly.

Every sidecar a replay boots runs on ``device`` (None = the card; the
tests pass ``"cpu"``).  A sidecar asked for a mesh
(``service_kwargs["mesh_devices"]``) takes its devices from the virtual
shards in force; :func:`mesh_shards` sets :data:`MESH_SHARDS` of them on
``device`` where none are.

Mid-trace crash/restart: ``crash_epoch=k`` snapshots at the k-1/k
boundary, stops the service with NO drain (crash-equivalent — the
round-12 lifecycle contract), boots a fresh service on the same
snapshot path, and drives the remaining epochs through recovery.  The
bit-exactness contract (bench config8) says the recovered epochs must
match an uninterrupted twin exactly; :func:`twin_mismatches` counts
the divergences for the envelope.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..service import AssignorService, AssignorServiceClient
from ..sharded import mesh as mesh_mod
from ..testing import (
    assert_valid_assignment,
    choice_from_assignments,
    shed_totals_by_class,
)
from ..utils import faults, metrics
from ..utils import trace as trace_mod
from ..utils.device import DeviceLike, resolve_device
from ..utils.observability import compile_count, install_compile_counter
from ..utils.overload import ShedReject

from .traces import Trace

#: Virtual shards a mesh scenario gets when none are set: the 8 host
#: devices the JAX package's scenarios run on.
MESH_SHARDS = 8


@dataclass
class EpochRecord:
    """One stream's outcome at one trace epoch."""

    epoch: int
    phase: str
    stream_id: str
    slo_class: str
    ok: bool = False
    valid: bool = False
    shed: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    rung: str = "none"
    warm_restart: bool = False
    resync: bool = False
    churn: Optional[float] = None
    quality_ratio: Optional[float] = None
    latency_ms: Optional[float] = None
    choice: Optional[np.ndarray] = None
    trace_id: Optional[str] = None


@dataclass
class ReplayResult:
    """Everything the envelope evaluator and the CI artifact need."""

    trace_name: str
    seed: int
    trace_sha256: str
    records: List[EpochRecord] = field(default_factory=list)
    compiles_by_phase: Dict[str, int] = field(default_factory=dict)
    sheds_by_class: Dict[str, float] = field(default_factory=dict)
    faults_snapshot: Dict[str, Dict[str, int]] = field(default_factory=dict)
    quarantines: int = 0
    corruptions_planted: int = 0
    restarted_at: Optional[int] = None
    recovery: Dict[str, Any] = field(default_factory=dict)
    wall_s: float = 0.0
    twin_mismatches: Optional[int] = None
    trace_stats: Dict[str, Any] = field(default_factory=dict)
    kept_trace_ids: List[str] = field(default_factory=list)
    #: ``"from->to" -> count`` deltas of the mesh manager's
    #: ``klba_mesh_degrade_total`` transitions during this replay —
    #: what the cross-axis envelopes gate against the documented
    #: ladder order.
    mesh_degrades: Dict[str, int] = field(default_factory=dict)

    def choices(self) -> Dict[Tuple[int, str], bytes]:
        """(epoch, stream) -> choice bytes, for twin comparison."""
        return {
            (r.epoch, r.stream_id): r.choice.tobytes()
            for r in self.records if r.choice is not None
        }


def _counter_sum(name: str) -> float:
    return sum(c.value for c in metrics.REGISTRY.series(name))


def _mesh_degrade_totals() -> Dict[str, float]:
    """``"from->to" -> value`` for every mesh degrade-transition
    series currently in the registry."""
    return {
        f"{c.labels.get('from')}->{c.labels.get('to')}": c.value
        for c in metrics.REGISTRY.series("klba_mesh_degrade_total")
    }


def _quarantine_total() -> float:
    return sum(
        c.value for c in metrics.REGISTRY.series("klba_quarantine_total")
        if c.labels.get("outcome") == "quarantined"
    )


def _corruptions_planted(inj: Optional[faults.FaultInjector]) -> int:
    if inj is None:
        return 0
    return sum(
        inj.fired(p) for p in faults.FAULT_POINTS
        if p.startswith("device.corrupt.")
    )


@contextlib.contextmanager
def mesh_shards(service_kwargs: Dict[str, Any], device: DeviceLike):
    """:data:`MESH_SHARDS` virtual shards of ``device`` for the body when
    ``service_kwargs`` ask for a mesh and no shards are set (the card has
    one device); none are left set after."""
    wants = service_kwargs.get("mesh_devices", "off") not in (
        None, "", "off", "0", 0, False,
    )
    if not wants or mesh_mod.virtual_shards() is not None:
        yield
        return
    mesh_mod.set_virtual_shards(MESH_SHARDS, resolve_device(device))
    try:
        yield
    finally:
        mesh_mod.set_virtual_shards(None)


def replay(
    trace: Trace,
    *,
    injector: Optional[faults.FaultInjector] = None,
    service_kwargs: Optional[Dict[str, Any]] = None,
    crash_epoch: Optional[int] = None,
    parallel: bool = False,
    client_timeout_s: float = 300.0,
    tune: Optional[Callable[[AssignorService], None]] = None,
    epoch_sleep_s: float = 0.0,
    trace_sample_rate: float = 0.125,
    request_options: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
) -> ReplayResult:
    """Run one trace against a fresh sidecar; see the module docstring.

    ``service_kwargs`` override the scenario defaults (warm-up shapes
    are derived from the trace unless given).  ``parallel`` drives each
    epoch's streams concurrently (one client per stream — the overload
    scenarios' stampede shape); serial driving (the default) keeps the
    request order, and therefore the warm-state evolution, fully
    deterministic for bit-exact twin comparisons.  ``tune`` runs
    against each freshly started service (including the post-crash
    one) for knobs with no constructor surface — e.g. pinning the
    overload controller's eval interval to zero for a stampede.
    ``service_kwargs["snapshot_path"] = "auto"`` allocates a temp
    snapshot file (scenarios that exercise snapshot-write fault
    planes without a crash).  ``epoch_sleep_s`` paces epochs apart —
    time-based background planes (the periodic snapshot writer) need
    wall time to fire at all on a CPU-fast trace.  ``trace_sample_rate``
    pins the tail sampler's healthy-trace rate for the run (anomalous
    traces are always kept regardless); the per-record ``trace_id`` plus
    ``ReplayResult.trace_stats``/``kept_trace_ids`` deltas are what the
    retention envelope gates on.  ``device`` is every booted sidecar's
    (None = the card, which raises without one)."""
    install_compile_counter()
    kwargs: Dict[str, Any] = dict(service_kwargs or {})
    kwargs["device"] = device
    if kwargs.get("snapshot_path") == "auto" or (
        crash_epoch is not None and "snapshot_path" not in kwargs
    ):
        snap_dir = tempfile.mkdtemp(prefix="klba-scenario-")
        kwargs["snapshot_path"] = os.path.join(snap_dir, "snapshot.json")
        kwargs.setdefault("snapshot_interval_s", 3600.0)
    if "warmup_shapes" not in kwargs:
        kwargs["warmup_shapes"] = [
            (trace.partitions, c) for c in trace.consumer_counts
        ]

    result = ReplayResult(
        trace_name=trace.name, seed=trace.seed,
        trace_sha256=trace.digest(),
    )
    shed_before = shed_totals_by_class()
    quarantine_before = _quarantine_total()
    mesh_before = _mesh_degrade_totals()
    # The sidecar runs in-process, so the global trace collector sees
    # this replay's traces; pin the healthy sample rate, widen the ring
    # past any plausible scenario volume (retention must be judged on
    # the FULL run, not the ring tail), and bracket by deltas.
    coll = trace_mod.collector()
    trace_prev = (coll.sample_rate, coll.capacity)
    coll.sample_rate = float(trace_sample_rate)
    coll.capacity = max(coll.capacity, 8192)
    trace_counts_before = coll.stats()
    kept_before = set(coll.kept_ids())

    svc = AssignorService(port=0, **kwargs).start()
    if tune is not None:
        tune(svc)
    clients: Dict[str, AssignorServiceClient] = {}
    pool = (
        cf.ThreadPoolExecutor(max_workers=max(2, len(trace.stream_ids)))
        if parallel else None
    )

    def client_for(sid: str) -> AssignorServiceClient:
        # Serial mode shares one connection (strict request ordering);
        # parallel mode gives each stream its own (the stampede shape).
        key = sid if parallel else "__shared__"
        cl = clients.get(key)
        if cl is None:
            cl = AssignorServiceClient(
                *svc.address, timeout_s=client_timeout_s
            )
            clients[key] = cl
        return cl

    def close_clients() -> None:
        for cl in clients.values():
            cl.close()
        clients.clear()

    def drive_one(se, epoch: int, phase: str) -> EpochRecord:
        rec = EpochRecord(
            epoch=epoch, phase=phase, stream_id=se.stream_id,
            slo_class=se.slo_class,
        )
        params = {
            "stream_id": se.stream_id,
            "topic": se.topic,
            "members": list(se.members),
            "lags": [[i, v] for i, v in enumerate(se.lags)],
            "slo_class": se.slo_class,
        }
        if request_options is not None:
            # Scenario-pinned wire options on every request (e.g.
            # ``refine_threshold: null`` forces a warm dispatch every
            # epoch for deterministic coalescer wave membership).
            params["options"] = dict(request_options)
        cl = client_for(se.stream_id)
        t0 = time.perf_counter()
        try:
            r = cl.request("stream_assign", params)
        except ShedReject as exc:
            rec.shed = {
                "class": exc.klass, "rung": exc.rung,
                "retry_after_ms": exc.retry_after_ms,
            }
            rec.trace_id = getattr(exc, "trace_id", None)
            return rec
        except (ConnectionError, RuntimeError) as exc:
            rec.error = f"{type(exc).__name__}: {exc}"
            return rec
        rec.trace_id = cl.last_trace_id
        rec.latency_ms = (time.perf_counter() - t0) * 1000.0
        rec.ok = True
        s = r["stream"]
        rec.rung = s["degraded_rung"]
        rec.warm_restart = bool(s["warm_restart"])
        rec.resync = bool(s.get("resync", False))
        # The engine reports churn as a moved-partition COUNT;
        # envelopes gate on the fraction so bounds survive trace
        # resizing.
        churn = s.get("churn")
        rec.churn = (
            None if churn is None else float(churn) / max(1, len(se.lags))
        )
        rec.quality_ratio = s.get("quality_ratio")
        if s.get("shed") is not None:
            # Served degraded with a shed note (coalescer triage).
            rec.shed = dict(s["shed"])
        try:
            assert_valid_assignment(r["assignments"], len(se.lags))
            rec.valid = True
        except AssertionError:
            rec.valid = False
        rec.choice = choice_from_assignments(
            r["assignments"], list(se.members), len(se.lags)
        )
        return rec

    if injector is not None:
        faults.activate(injector)
    started = time.perf_counter()
    try:
        for ev in trace.epochs:
            if crash_epoch is not None and ev.index == crash_epoch:
                # Crash-equivalent restart at the epoch boundary: the
                # periodic snapshot is all that survives — no drain,
                # no final snapshot (the round-12 lifecycle contract).
                assert svc.snapshot_now()["ok"]
                close_clients()
                svc.stop()
                svc = AssignorService(port=0, **kwargs).start()
                if tune is not None:
                    tune(svc)
                result.restarted_at = ev.index
                result.recovery = dict(svc._last_recovery or {})
            if injector is not None:
                injector.set_epoch(ev.index)
            compiles_before = compile_count()
            if parallel and len(ev.streams) > 1:
                recs = list(pool.map(
                    lambda se, _e=ev: drive_one(se, _e.index, _e.phase),
                    ev.streams,
                ))
            else:
                recs = [
                    drive_one(se, ev.index, ev.phase)
                    for se in ev.streams
                ]
            result.records.extend(recs)
            delta = compile_count() - compiles_before
            result.compiles_by_phase[ev.phase] = (
                result.compiles_by_phase.get(ev.phase, 0) + delta
            )
            if epoch_sleep_s > 0:
                time.sleep(epoch_sleep_s)
    finally:
        result.wall_s = time.perf_counter() - started
        if injector is not None:
            faults.deactivate()
            result.faults_snapshot = injector.snapshot()
            result.corruptions_planted = _corruptions_planted(injector)
        close_clients()
        if pool is not None:
            pool.shutdown(wait=True)
        svc.stop()
        after = coll.stats()
        result.trace_stats = {
            k: int(after[k]) - int(trace_counts_before[k])
            for k in ("kept_anomalous", "kept_sampled", "dropped")
        }
        result.trace_stats["sample_rate"] = float(trace_sample_rate)
        result.kept_trace_ids = [
            t for t in coll.kept_ids() if t not in kept_before
        ]
        coll.sample_rate, coll.capacity = trace_prev

    result.sheds_by_class = {
        str(k): v - shed_before.get(k, 0)
        for k, v in shed_totals_by_class().items()
        if v - shed_before.get(k, 0) > 0
    }
    result.quarantines = int(_quarantine_total() - quarantine_before)
    result.mesh_degrades = {
        k: int(v - mesh_before.get(k, 0))
        for k, v in _mesh_degrade_totals().items()
        if v - mesh_before.get(k, 0) > 0
    }
    return result


def twin_mismatches(
    faulted: ReplayResult, clean: ReplayResult,
    from_epoch: int = 0,
) -> int:
    """Count (epoch, stream) cells where the two replays' decoded
    choices differ, from ``from_epoch`` on.  A cell present in one
    replay but not the other (a shed or error on either side) counts
    as a mismatch — a fault that silently ate an epoch is a
    divergence, not a skip."""
    a, b = faulted.choices(), clean.choices()
    keys = {k for k in (set(a) | set(b)) if k[0] >= from_epoch}
    return sum(1 for k in keys if a.get(k) != b.get(k))
