"""The trace plane of the port, twin by twin with ``tests/test_trace.py``.

Each test of ``tests/test_trace.py`` runs here on the port's modules: the
context mint and parse contract (``TestTraceparent``; the strict-parse
rejects are cases of ``tests/test_torch_metrics.py::
test_parse_traceparent_matches_jax``), the deterministic tail sampler
(``TestKeepDecision``, ``TestCollector``), the span tree, scope adoption on
raw threads and in the port's ``Watchdog``, the port coalescer's wave
links (and the flush-fault fallback that mints no wave), a degraded
two-sidecar ``federated_assign`` joined into ONE trace, the scrubber's
self-rooted background trace and the wire's trace surfaces, every sidecar
the port's ``AssignorService(device="cpu")``.

Across the packages: the degraded ``federated_assign`` with one JAX
sidecar and one port sidecar, each way round: ``join_trace`` over the kept
segments of both collectors (each package keeps its own) rebuilds one
complete trace of >= 2 segments, whose origin is kept as anomalous.
"""

import json
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import service as jax_service  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import trace as jax_trace  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.service import (  # noqa: E402
    AssignorService,
    AssignorServiceClient,
)
from kafka_lag_based_assignor_tpu_torch.utils import faults  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import metrics as m  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import trace as trace_mod  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils.watchdog import Watchdog  # noqa: E402

C = 4
MEMBERS = [f"m{i}" for i in range(C)]


def _shard(seed, p=64):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 1_000_000, size=p).astype(np.int64)


def _rows(lags):
    return [[int(i), int(v)] for i, v in enumerate(lags)]


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _settled(coll, trace_id, want=1, deadline_s=10.0):
    """Poll the collector until ``want`` segments of ``trace_id`` land."""
    t0 = time.monotonic()
    while True:
        got = coll.traces(trace_id=trace_id)
        if len(got) >= want or time.monotonic() - t0 > deadline_s:
            return got
        time.sleep(0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the sidecars' threads each run torch ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def coll(monkeypatch):
    """A fresh keep-everything collector swapped in for the port's module
    global (metrics resolves ``trace_mod.COLLECTOR`` at each finish)."""
    fresh = trace_mod.TraceCollector(sample_rate=1.0)
    monkeypatch.setattr(trace_mod, "COLLECTOR", fresh)
    return fresh


@pytest.fixture(autouse=True)
def _no_faults():
    faults.deactivate()
    jax_faults.deactivate()
    yield
    faults.deactivate()
    jax_faults.deactivate()


# -- context format --------------------------------------------------------


class TestTraceparent:
    def test_round_trip(self):
        tid = trace_mod.mint_trace_id()
        sid = trace_mod.mint_span_id()
        tp = trace_mod.format_traceparent(tid, sid)
        assert len(tp) == trace_mod.TRACEPARENT_LEN == jax_trace.TRACEPARENT_LEN
        assert trace_mod.parse_traceparent(tp) == (tid, sid)
        assert jax_trace.parse_traceparent(tp) == (tid, sid)

    def test_span_ids_unique_16_hex(self):
        ids = {trace_mod.mint_span_id() for _ in range(200)}
        assert len(ids) == 200
        for sid in ids:
            assert len(sid) == 16
            int(sid, 16)

    def test_state_adopts_remote_context(self):
        tp = trace_mod.format_traceparent("ab" * 16, "cd" * 8)
        st = trace_mod.TraceState(traceparent=tp)
        assert st.trace_id == "ab" * 16
        assert st.remote_parent_id == "cd" * 8

    def test_state_mints_fresh_on_invalid_context(self):
        st = trace_mod.TraceState(traceparent="garbage")
        assert st.remote_parent_id is None
        assert len(st.trace_id) == 32


# -- deterministic tail sampling -------------------------------------------


LOW_ID = "0" * 31 + "1"
HIGH_ID = "f" * 32


class TestKeepDecision:
    def test_rate_extremes(self):
        tid = trace_mod.mint_trace_id()
        assert trace_mod.keep_decision(tid, 1.0)
        assert not trace_mod.keep_decision(tid, 0.0)

    def test_biased_ids_pin_the_hash(self):
        assert trace_mod.keep_decision(LOW_ID, 1e-6)
        assert not trace_mod.keep_decision(HIGH_ID, 0.999)

    def test_deterministic(self):
        tid = trace_mod.mint_trace_id()
        first = trace_mod.keep_decision(tid, 0.5)
        assert all(
            trace_mod.keep_decision(tid, 0.5) == first for _ in range(10)
        )

    def test_non_hex_id_never_kept(self):
        assert not trace_mod.keep_decision("not-hex", 0.99)


def _state(trace_id=None, anomaly=None):
    tp = (
        trace_mod.format_traceparent(trace_id, "ab" * 8)
        if trace_id is not None else None
    )
    st = trace_mod.TraceState(traceparent=tp)
    if anomaly:
        st.mark(anomaly)
    return st


class TestCollector:
    def test_anomaly_always_kept_at_rate_zero(self):
        c = trace_mod.TraceCollector(sample_rate=0.0)
        st = _state(anomaly="shed")
        assert c.finish(st, 1.0) == "kept_anomalous"
        kept = c.traces(trace_id=st.trace_id)
        assert kept and kept[0]["anomalies"] == ["shed"]
        assert c.last_anomalous_trace_id == st.trace_id

    def test_healthy_respects_rate(self):
        c = trace_mod.TraceCollector(sample_rate=0.5)
        assert c.finish(_state(LOW_ID), 1.0) == "kept_sampled"
        assert c.finish(_state(HIGH_ID), 1.0) == "dropped"
        stats = c.stats()
        assert stats["kept_sampled"] == 1
        assert stats["dropped"] == 1
        assert stats["retained"] == 1

    def test_retention_counter_increments(self):
        before = m.REGISTRY.counter(
            "klba_trace_total", {"outcome": "kept_anomalous"}
        ).value
        trace_mod.TraceCollector(sample_rate=0.0).finish(
            _state(anomaly="breaker"), 1.0
        )
        after = m.REGISTRY.counter(
            "klba_trace_total", {"outcome": "kept_anomalous"}
        ).value
        assert after == before + 1

    def test_ring_capacity_bounds_retention(self):
        c = trace_mod.TraceCollector(capacity=4, sample_rate=1.0)
        for _ in range(10):
            c.finish(_state(), 1.0)
        assert len(c.traces()) == 4
        assert c.stats()["retained"] == 4

    def test_traces_limit_zero_is_empty(self):
        c = trace_mod.TraceCollector(sample_rate=1.0)
        c.finish(_state(), 1.0)
        assert c.traces(limit=0) == []
        assert len(c.traces(limit=1)) == 1

    def test_latency_threshold_marks_anomalous(self):
        c = trace_mod.TraceCollector(
            sample_rate=0.0, latency_threshold_ms=5.0
        )
        assert c.finish(_state(), 10.0) == "kept_anomalous"
        assert c.traces()[0]["anomalies"] == ["latency"]
        assert c.finish(_state(HIGH_ID), 1.0) == "dropped"

    def test_unknown_mark_kind_drops_without_raise(self, coll):
        with m.request_scope():
            trace_mod.mark("bogus-kind")
            assert not m.current_trace().anomalies
        trace_mod.mark_state(None, "shed")

    def test_mark_state_by_token(self):
        st = _state()
        trace_mod.mark_state(st, "shed")
        trace_mod.mark_state(st, "not-a-kind")
        assert st.anomalies == {"shed"}

    def test_dump_rotation_bounded(self, tmp_path):
        c = trace_mod.TraceCollector(
            sample_rate=0.0, dump_dir=str(tmp_path),
            keep_files=2, disk_min_interval_s=0.0,
        )
        for _ in range(5):
            c.finish(_state(anomaly="quarantine"), 1.0)
        names = sorted(os.listdir(tmp_path))
        assert names == ["trace-0.json", "trace-1.json"]
        payload = json.loads((tmp_path / "trace-1.json").read_text())
        assert payload["anomalies"] == ["quarantine"]
        assert len(payload["trace_id"]) == 32

    def test_disk_min_interval_throttles(self, tmp_path):
        c = trace_mod.TraceCollector(
            sample_rate=0.0, dump_dir=str(tmp_path),
            keep_files=8, disk_min_interval_s=3600.0,
        )
        for _ in range(3):
            c.finish(_state(anomaly="resync"), 1.0)
        assert len(os.listdir(tmp_path)) == 1
        assert c.stats()["kept_anomalous"] == 3

    def test_clear_resets(self):
        c = trace_mod.TraceCollector(sample_rate=1.0)
        c.finish(_state(anomaly="error"), 1.0)
        c.clear()
        assert c.traces() == []
        assert c.kept_ids() == []
        assert c.stats()["kept_anomalous"] == 0
        assert c.stats()["last_anomalous_trace_id"] is None


# -- span tree -------------------------------------------------------------


class TestSpanTree:
    def test_nested_spans_carry_parent_child_ids(self, coll):
        with m.request_scope(kind="client", root_name="client") as rid:
            tid = m.current_trace_id()
            with m.span("stream.epoch"):
                with m.span("stream.refine"):
                    pass
        (entry,) = coll.traces(trace_id=tid)
        assert entry["request_id"] == rid
        assert entry["outcome"] == "kept_sampled"
        root = entry["root"]
        assert root["name"] == "client"
        assert root["parent_id"] is None
        spans = {s["name"]: s for s in entry["spans"]}
        epoch, refine = spans["stream.epoch"], spans["stream.refine"]
        assert epoch["parent_id"] == root["span_id"]
        assert refine["parent_id"] == epoch["span_id"]
        assert refine["span_id"] != epoch["span_id"]
        verdict = trace_mod.join_trace([entry])
        assert verdict["complete"] and verdict["spans"] == 3
        assert jax_trace.join_trace([entry]) == verdict

    def test_device_phase_feeds_open_spans(self, coll):
        with m.request_scope():
            tid = m.current_trace_id()
            with m.span("stream.epoch"):
                with m.device_phase("h2d"):
                    time.sleep(0.002)
        (entry,) = coll.traces(trace_id=tid)
        (epoch,) = entry["spans"]
        assert epoch["device_ms"] > 0.0
        assert entry["root"]["device_ms"] > 0.0
        assert epoch["device_ms"] <= epoch["duration_ms"] + 1.0

    def test_span_outside_scope_is_histogram_only(self):
        with m.span("stream.epoch") as rec:
            assert rec is None

    def test_current_traceparent_names_innermost_span(self, coll):
        assert m.current_traceparent() is None
        with m.request_scope():
            tr = m.current_trace()
            assert m.current_traceparent() == tr.traceparent()
            with m.span("stream.epoch") as rec:
                assert m.current_traceparent() == tr.traceparent(
                    rec["span_id"]
                )


# -- scope adoption (watchdog workers, coalescer waves) --------------------


class TestScopeAdoption:
    def test_raw_thread_adoption_joins_the_tree(self, coll):
        seen = {}
        with m.request_scope():
            tid = m.current_trace_id()
            with m.span("stream.epoch"):
                token = m.capture_scope()

                def worker():
                    with m.adopt_scope(token):
                        seen["tid"] = m.current_trace_id()
                        with m.span("stream.refine"):
                            pass

                t = threading.Thread(target=worker)
                t.start()
                t.join()
        assert seen["tid"] == tid
        (entry,) = coll.traces(trace_id=tid)
        spans = {s["name"]: s for s in entry["spans"]}
        assert spans["stream.refine"]["parent_id"] == (
            spans["stream.epoch"]["span_id"]
        )
        assert trace_mod.join_trace([entry])["complete"]

    def test_adopt_is_noop_on_a_thread_with_a_scope(self, coll):
        other = m.begin_scope(kind="wave")
        with m.request_scope():
            tid = m.current_trace_id()
            with m.adopt_scope(other):
                assert m.current_trace_id() == tid
        m.finish_scope(other)

    def test_watchdog_call_carries_the_trace(self, coll):
        wd = Watchdog(timeout_s=30.0)
        seen = {}
        with m.request_scope():
            tid = m.current_trace_id()
            with m.span("stream.epoch"):

                def job():
                    seen["tid"] = m.current_trace_id()
                    with m.span("stream.refine"):
                        pass
                    return 7

                assert wd.call(job) == 7
        assert seen["tid"] == tid
        (entry,) = coll.traces(trace_id=tid)
        spans = {s["name"]: s for s in entry["spans"]}
        assert spans["stream.refine"]["parent_id"] == (
            spans["stream.epoch"]["span_id"]
        )

    def test_begin_finish_scope_roots_a_wave_trace(self, coll):
        wave = m.begin_scope(kind="wave", root_name="coalesce.wave")
        with m.adopt_scope(wave):
            with m.span("coalesce.dispatch"):
                pass
        m.finish_scope(wave)
        (entry,) = coll.traces(trace_id=wave.trace.trace_id)
        assert entry["kind"] == "wave"
        assert entry["root"]["name"] == "coalesce.wave"
        assert [s["name"] for s in entry["spans"]] == ["coalesce.dispatch"]


# -- coalescer wave fan-in links -------------------------------------------


W = 2  # concurrent submitters


@pytest.fixture()
def wave_service():
    with AssignorService(
        port=0,
        coalesce_max_batch=W,
        coalesce_window_ms=500.0,
        device="cpu",
    ) as svc:
        clients = [
            AssignorServiceClient(*svc.address, timeout_s=120.0)
            for _ in range(W)
        ]
        yield svc, clients
        for c in clients:
            c.close()


def _wave_round(clients, rng):
    lags = [rng.integers(1, 1_000_000, size=64) for _ in range(W)]
    with ThreadPoolExecutor(max_workers=W) as ex:
        futs = [
            ex.submit(
                clients[i].stream_assign,
                f"wl{i}", "t", _rows(lags[i]), MEMBERS,
            )
            for i in range(W)
        ]
        return [f.result() for f in futs]


class TestWaveLinks:
    def test_wave_links_requests_bidirectionally(self, coll, wave_service):
        _svc, clients = wave_service
        rng = np.random.default_rng(11)
        _wave_round(clients, rng)  # cold solves
        _wave_round(clients, rng)  # warm: the megabatch path settles
        _wave_round(clients, rng)  # measured
        for c in clients:
            tid = c.last_trace_id
            entries = _settled(coll, tid)
            assert entries, tid
            wave_ids = {
                ln["trace_id"]
                for e in entries for ln in e["links"]
                if ln.get("relation") == "wave"
            }
            assert wave_ids, entries
            for wid in wave_ids:
                wave_entries = _settled(coll, wid)
                assert wave_entries, wid
                assert wave_entries[0]["kind"] == "wave"
                back = {
                    ln["trace_id"]
                    for e in wave_entries for ln in e["links"]
                    if ln.get("relation") == "request"
                }
                assert tid in back

    def test_flush_fault_fallback_mints_no_wave(self, coll, wave_service):
        _svc, clients = wave_service
        rng = np.random.default_rng(12)
        _wave_round(clients, rng)  # cold solves, fault-free
        inj = faults.FaultInjector(3).plan("coalesce.flush", times=1)
        with faults.injected(inj):
            results = _wave_round(clients, rng)
        for r in results:
            assert r["assignments"]  # the isolation re-dispatch served it
        assert inj.fired("coalesce.flush")
        for c in clients:
            entries = _settled(coll, c.last_trace_id)
            assert entries, c.last_trace_id
            assert not any(
                ln.get("relation") == "wave"
                for e in entries for ln in e["links"]
            )


# -- cross-process federated reconstruction --------------------------------

FED_KNOBS = dict(coalesce_max_batch=1, scrub_interval_ms=0, breaker_failures=2,
                 breaker_cooldown_s=0.5, federation_rounds=8,
                 federation_sync_timeout_s=60.0)


def degraded_federated_trace(kinds, colls, fault_modules):
    """Two sidecars of ``kinds`` ("port" or "jax") federated with each
    other; both shards registered and the dual cache warmed, then sidecar
    0's ``federated_assign`` under a ``peer.partition`` injected after the
    hello in each package.  Returns (its rung, the trace's kept segments
    from every collector in ``colls``, the verdict of ``join_trace``)."""
    ports = _free_ports(2)
    ids = ("ta", "tb")
    svcs, clients = [], []
    try:
        for i, kind in enumerate(kinds):
            j = 1 - i
            cls = AssignorService if kind == "port" else jax_service.AssignorService
            extra = {"device": "cpu"} if kind == "port" else {}
            svcs.append(cls(
                port=ports[i], federation_self_id=ids[i],
                federation_peers=f"{ids[j]}=127.0.0.1:{ports[j]}",
                **FED_KNOBS, **extra,
            ).start())
        clients = [
            (AssignorServiceClient if kind == "port"
             else jax_service.AssignorServiceClient)("127.0.0.1", p, timeout_s=180.0)
            for kind, p in zip(kinds, ports)
        ]
        shards = (_shard(41, 128), _shard(42, 128))

        def fed(i):
            return clients[i].federated_assign("t0", _rows(shards[i]), MEMBERS)

        for _ in range(2):  # register both shards + warm the cache
            fed(0)
            fed(1)
        injectors = [mod.FaultInjector(17).plan("peer.partition", times=0, after=1)
                     for mod in fault_modules]
        for mod, inj in zip(fault_modules, injectors):
            mod.activate(inj)
        try:
            r = fed(0)
        finally:
            for mod in fault_modules:
                mod.deactivate()
        tid = clients[0].last_trace_id
        assert tid
        verdict, entries = None, []
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            entries = [e for c in colls for e in c.traces(trace_id=tid)]
            if len(entries) >= 2:
                verdict = trace_mod.join_trace(entries)
                if verdict["complete"]:
                    break
            time.sleep(0.02)
        return r["federation"]["rung"], entries, verdict
    finally:
        for c in clients:
            c.close()
        for s in svcs:
            s.stop()


def check_joined(rung, entries, verdict):
    assert rung in ("last_good_global", "local_only"), rung
    assert verdict is not None and verdict["complete"], (verdict, entries)
    assert verdict["segments"] >= 2
    origins = [e for e in entries if e["root"]["parent_id"] is None]
    assert len(origins) == 1
    assert "ladder" in origins[0]["anomalies"]
    assert origins[0]["outcome"] == "kept_anomalous"
    remote = [e for e in entries if e["root"]["parent_id"] is not None]
    assert remote  # the peer parented under the caller's span


class TestFederatedJoin:
    def test_degraded_two_sidecar_assign_is_one_trace(self, coll):
        """A partition injected AFTER the hello round (``after=1``: the
        context crosses, then the exchange dies) degrades the initiator
        down the ladder while the peer has already recorded its joined
        segment; the two segments rebuild ONE complete trace."""
        check_joined(*degraded_federated_trace(("port", "port"), [coll], [faults]))

    @pytest.mark.parametrize("kinds", [("port", "jax"), ("jax", "port")],
                             ids=["port-initiates", "jax-initiates"])
    def test_mixed_packages_join_one_trace(self, coll, monkeypatch, kinds):
        jax_coll = jax_trace.TraceCollector(sample_rate=1.0)
        monkeypatch.setattr(jax_trace, "COLLECTOR", jax_coll)
        rung, entries, verdict = degraded_federated_trace(
            kinds, [coll, jax_coll], [faults, jax_faults])
        check_joined(rung, entries, verdict)
        # One segment in each package's collector; the JAX join agrees.
        assert coll.traces(trace_id=entries[0]["trace_id"])
        assert jax_coll.traces(trace_id=entries[0]["trace_id"])
        assert jax_trace.join_trace(entries) == verdict


# -- background traces (scrubber) ------------------------------------------


class TestBackgroundTraces:
    def test_scrub_pass_is_self_rooted_and_stream_linked(self, coll):
        with AssignorService(
            port=0, coalesce_max_batch=1, scrub_interval_ms=3600_000,
            device="cpu",
        ) as svc:
            with AssignorServiceClient(*svc.address) as c:
                c.stream_assign("sc0", "t", _rows(_shard(7)), MEMBERS)
            counts = svc._scrubber.scrub_once()
        assert counts["audited"] >= 1
        bg = [
            t for t in coll.traces()
            if t["kind"] == "background"
            and t["root"]["name"] == "scrub.pass"
        ]
        assert bg
        assert {"stream_id": "sc0"} in bg[-1]["links"]

    def test_background_scope_yields_to_an_outer_trace(self, coll):
        with m.request_scope() as rid:
            with m.request_scope(
                kind="background", root_name="scrub.pass"
            ) as inner_rid:
                assert inner_rid == rid
            tid = m.current_trace_id()
        (entry,) = coll.traces(trace_id=tid)
        assert entry["kind"] == "request"


# -- wire surfaces ---------------------------------------------------------


class TestWireSurfaces:
    def test_trace_view_echo_and_flight_stamping(self, coll):
        with AssignorService(
            port=0, coalesce_max_batch=1, scrub_interval_ms=0, device="cpu",
        ) as svc:
            with AssignorServiceClient(*svc.address) as c:
                c.stream_assign("wv0", "t", _rows(_shard(9)), MEMBERS)
                tid = c.last_trace_id
                assert isinstance(tid, str) and len(tid) == 32
                assert _settled(coll, tid), tid
                resp = c.request("trace", {"trace_id": tid})
                assert resp["stats"]["sample_rate"] == 1.0
                assert resp["traces"]
                assert all(
                    t["trace_id"] == tid for t in resp["traces"]
                )
                assert resp["traces"][0]["root"]["name"] == "request"
                empty = c.request(
                    "trace", {"trace_id": tid, "limit": 0}
                )
                assert empty["traces"] == []
                flight = c.request("stream_flight", {"stream_id": "wv0"})
                assert flight["records"]
                assert any(
                    rec.get("trace_id") == tid
                    for rec in flight["records"]
                )

    def test_client_scope_joins_the_sidecar_segment(self, coll):
        with AssignorService(
            port=0, coalesce_max_batch=1, scrub_interval_ms=0, device="cpu",
        ) as svc:
            with AssignorServiceClient(*svc.address) as c:
                with m.request_scope(
                    kind="client", root_name="client"
                ):
                    ctid = m.current_trace_id()
                    with m.span("lag.read"):
                        c.stream_assign(
                            "cj0", "t", _rows(_shard(13)), MEMBERS
                        )
                    # the sidecar adopted the wire context instead of
                    # rooting a fresh trace
                    assert c.last_trace_id == ctid
        entries = _settled(coll, ctid, want=2)
        verdict = trace_mod.join_trace(entries)
        assert verdict["complete"] and verdict["segments"] >= 2
        remote = [
            e for e in entries if e["root"]["parent_id"] is not None
        ]
        assert remote and remote[0]["kind"] == "request"

    def test_trace_view_rejects_non_string_id(self, coll):
        with AssignorService(
            port=0, coalesce_max_batch=1, scrub_interval_ms=0, device="cpu",
        ) as svc:
            with AssignorServiceClient(*svc.address) as c:
                with pytest.raises(RuntimeError, match="trace_id"):
                    c.request("trace", {"trace_id": 7})
