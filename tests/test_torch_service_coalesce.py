"""The port's sidecar with the megabatch coalescer, on the CPU.

* twin sidecars (``test_torch_service.Twin``) with ``coalesce_max_batch`` >
  1 on BOTH sides: four streams send their epochs concurrently, each wave
  flushing full (the window is a minute, so no flush depends on the load
  of the host); every ``stream_assign`` answer is equal after dropping ids
  and times, ``stats.coalesce`` moves alike (its counters as deltas, the
  registries being process-wide) and so do both registries' counter
  series, ``klba_coalesce_*`` among them.  A lone live stream bypasses the
  coalescer in both;
* the service-level cases of ``tests/test_coalesce.py`` on the port's
  sidecar: single-stream bypass, multi-stream routing, ``stream_flight``,
  the registry view of ``stats``, ``stats.coalesce`` (absent with
  coalescing off), the ``/metrics`` listener, the knobs and
  ``from_config``;
* ``warmup(coalesce_max_batch=4)`` on the CPU: its megabatch waves run, lock
  a roster and apply a stacked delta wave; at ``coalesce_max_batch=2`` its
  rows equal the JAX warm-up's.
"""

import http.client
import json
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import warmup as jax_warmup  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import service, warmup  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils.config import parse_config  # noqa: E402
from test_torch_service import Twin, normalized, rows  # noqa: E402

STREAMS = 4
OPTS = {"guardrail": None, "refine_threshold": None, "refine_iters": 16}


def batch_count(metrics_module):
    return metrics_module.REGISTRY.histogram("klba_coalesce_batch_size").state()["count"]


def wave(svc, requests):
    """Send ``requests`` (one per stream) to ``svc`` at once, one connection
    each; returns the replies in order."""
    out = [None] * len(requests)

    def run(i):
        with socket.create_connection(svc.address) as s:
            f = s.makefile("rwb")
            f.write(json.dumps(requests[i]).encode() + b"\n")
            f.flush()
            out[i] = json.loads(f.readline())

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300.0)
        assert not t.is_alive(), "a coalesced stream request did not complete"
    return out


def same_wave(pair, requests):
    """One concurrent wave to each twin; equal normalized answers."""
    got_jax = wave(pair.jax, requests)
    got_port = wave(pair.port, requests)
    for a, b in zip(got_jax, got_port):
        assert "error" not in b, b
        assert normalized(b, "stream_assign") == normalized(a, "stream_assign")
    return got_port


def stream_request(sid, lags, rid=1):
    return {"id": rid, "method": "stream_assign",
            "params": {"stream_id": f"s{sid}", "topic": "t0", "lags": rows(lags),
                       "members": ["A", "B", "C", "D"], "options": OPTS}}


def coalesce_stats(pair):
    out = []
    for f in pair.files:
        f.write(b'{"id": 1, "method": "stats"}\n')
        f.flush()
        out.append(json.loads(f.readline())["result"].get("coalesce"))
    return out


@pytest.fixture()
def pair():
    p = Twin(coalesce_max_batch=STREAMS, coalesce_window_ms=60_000.0)
    try:
        yield p
    finally:
        p.close()


def test_twin_sidecars_coalesce_alike(pair):
    """Cold epochs inline, then warm waves of four streams through both
    coalescers: the re-stack that locks the roster, locked dense waves and
    a locked delta wave (every stream's lags barely moved)."""
    rng = np.random.default_rng(77)
    P = 300
    lags = [rng.integers(10**5, 10**7, P) for _ in range(STREAMS)]
    same_wave(pair, [stream_request(i, lags[i]) for i in range(STREAMS)])
    before = coalesce_stats(pair)
    hist0 = (batch_count(jax_metrics), batch_count(metrics))
    for step in range(4):
        if step == 3:
            lags = [lg.copy() for lg in lags]
            for lg in lags:
                lg[:5] += 11
        else:
            lags = [rng.integers(10**5, 10**7, P) for _ in range(STREAMS)]
        replies = same_wave(pair, [stream_request(i, lags[i], rid=step)
                                   for i in range(STREAMS)])
        for r in replies:
            s = r["result"]["stream"]
            assert s["refined"] and s["degraded_rung"] == "none"
    after = coalesce_stats(pair)
    assert after[1]["locked_rosters"] == after[0]["locked_rosters"] == 1
    deltas = [{k: a[k] - b[k] for k in a if k != "locked_rosters"}
              for a, b in zip(after, before)]
    assert deltas[1] == deltas[0]
    assert deltas[1]["restack_flushes"] == 1 and deltas[1]["roster_hits"] == 3
    assert (batch_count(jax_metrics) - hist0[0], batch_count(metrics) - hist0[1]) == (4, 4)
    series = pair.series_moved_alike()
    assert series[("klba_coalesce_flushes_total", (("path", "megabatch"),))] == 4
    assert series[("klba_delta_epochs_total", (("outcome", "applied"),))] >= STREAMS


def test_twin_lone_stream_bypasses_the_coalescer(pair):
    rng = np.random.default_rng(78)
    hist0 = (batch_count(jax_metrics), batch_count(metrics))
    for step in range(3):
        got = pair.same("stream_assign", stream_request(0, rng.integers(1, 10**6, 64),
                                                        rid=step)["params"])
        assert got["result"]["stream"]["degraded_rung"] == "none"
    assert (batch_count(jax_metrics), batch_count(metrics)) == hist0
    pair.series_moved_alike()


# -- the service-level cases of tests/test_coalesce.py ---------------------


@pytest.fixture()
def svc():
    with service.AssignorService(port=0, device="cpu", coalesce_window_ms=50.0,
                                 scrub_interval_ms=0) as s:
        yield s


def _client(s):
    return service.AssignorServiceClient(*s.address)


def _rows(arr):
    return [[i, int(v)] for i, v in enumerate(arr)]


def _hot_drift(result, lags, member):
    out = np.asarray(lags).copy()
    for _t, p in result["assignments"][member]:
        out[p] *= 3
    return out


def test_service_single_stream_bypasses_coalescer(svc):
    rng = np.random.default_rng(50)
    lags = rng.integers(10**6, 10**8, 256).astype(np.int64)
    with _client(svc) as c:
        r = c.stream_assign("only", "t0", _rows(lags), ["A", "B"],
                            options={"refine_iters": 16})
        before = batch_count(metrics)
        r = c.stream_assign("only", "t0", _rows(_hot_drift(r, lags, "A")), ["A", "B"],
                            options={"refine_iters": 16})
        assert r["stream"]["refined"] and r["stream"]["degraded_rung"] == "none"
        assert batch_count(metrics) == before


def test_service_multi_stream_routes_through_coalescer(svc):
    rng = np.random.default_rng(51)
    lags = rng.integers(10**6, 10**8, 256).astype(np.int64)
    opts = {"refine_iters": 16}
    with _client(svc) as c0, _client(svc) as c1:
        r0 = c0.stream_assign("s0", "t0", _rows(lags), ["A", "B"], options=opts)
        r1 = c1.stream_assign("s1", "t0", _rows(lags), ["A", "B"], options=opts)
        before = batch_count(metrics)
        drift = [_hot_drift(r0, lags, "A"), _hot_drift(r1, lags, "B")]
        results = [None, None]

        def run(i, cli):
            results[i] = cli.stream_assign(f"s{i}", "t0", _rows(drift[i]), ["A", "B"],
                                           options=opts)

        threads = [threading.Thread(target=run, args=(i, cli))
                   for i, cli in enumerate((c0, c1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
            assert not t.is_alive()
        for r in results:
            assert r["stream"]["degraded_rung"] == "none"
            assert not r["stream"]["fallback_used"]
            sizes = sorted(len(v) for v in r["assignments"].values())
            assert sum(sizes) == 256 and sizes[-1] - sizes[0] <= 1
        assert batch_count(metrics) > before


def test_service_stream_flight_dump_and_clear(svc):
    rng = np.random.default_rng(52)
    lags = rng.integers(10**3, 10**6, 64).astype(np.int64)
    with _client(svc) as c:
        c.stream_assign("fl", "t0", _rows(lags), ["A", "B"])
        c.stream_assign("fl", "t0", _rows(lags), ["A", "B"])
        dump = c.request("stream_flight", {"stream_id": "fl"})
        assert dump["stream_id"] == "fl" and len(dump["records"]) == 2
        assert all(r["kind"] == "stream_epoch" for r in dump["records"])
        assert all("assignments" not in r for r in dump["records"])
        assert c.request("stream_flight", {"stream_id": "fl", "clear": True})["cleared"]
        assert c.request("stream_flight", {"stream_id": "fl"})["records"] == []
        c.stream_assign("fl", "t0", _rows(lags), ["A", "B"])
        again = c.request("stream_flight", {"stream_id": "fl"})
        assert len(again["records"]) == 1 and again["records"][0]["seq"] == 2
        with pytest.raises(RuntimeError, match="unknown stream"):
            c.request("stream_flight", {"stream_id": "nope"})


def test_service_stats_is_registry_view(svc):
    with _client(svc) as c:
        c.ping()
        total = metrics.REGISTRY.series("klba_requests_total")
        before = sum(ch.value for ch in total)
        c.ping()
        after = sum(ch.value for ch in metrics.REGISTRY.series("klba_requests_total"))
        stats = c.request("stats")
    assert after == before + 1
    assert stats["requests_served"] >= 2
    assert svc.requests_served == stats["requests_served"] + 1
    assert svc.errors == stats["errors"]
    assert svc.fallbacks == stats["fallbacks"] == 0


def test_service_stats_exposes_coalesce_roster_tracking(svc):
    with _client(svc) as c:
        co = c.request("stats")["coalesce"]
    assert set(co) == {"locked_rosters", "stream_sharded_rosters", "roster_hits",
                       "restack_flushes", "roster_invalidations", "dead_rows_dropped"}
    assert all(isinstance(v, int) for v in co.values())
    with service.AssignorService(port=0, device="cpu", coalesce_max_batch=1,
                                 scrub_interval_ms=0) as svc2:
        with _client(svc2) as c2:
            assert "coalesce" not in c2.request("stats")


def test_metrics_http_listener_serves_exposition():
    metrics.REGISTRY.counter("klba_requests_total", {"method": "ping"})
    with service.AssignorService(port=0, device="cpu", metrics_port=0,
                                 scrub_interval_ms=0) as s:
        host, port = s.metrics_address
        conn = http.client.HTTPConnection(host, port, timeout=10)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            body = resp.read().decode()
            assert resp.status == 200
            assert resp.getheader("Content-Type").startswith("text/plain; version=0.0.4")
            assert "# TYPE klba_requests_total counter" in body
            conn.request("GET", "/healthz")
            ok = conn.getresponse()
            assert ok.status == 200 and ok.read() == b"ok\n"
            conn.request("GET", "/bogus")
            missing = conn.getresponse()
            assert missing.status == 404
            missing.read()
        finally:
            conn.close()
    assert s.metrics_address is None


def test_coalesce_config_knobs_parse():
    cfg = parse_config({
        "group.id": "g",
        "tpu.assignor.coalesce.window.ms": "2.5",
        "tpu.assignor.coalesce.max_batch": "8",
        "tpu.assignor.coalesce.roster.lock.waves": "3",
        "tpu.assignor.coalesce.pipeline": "false",
        "tpu.assignor.metrics.port": "9109",
    })
    assert cfg.coalesce_window_s == pytest.approx(0.0025)
    assert (cfg.coalesce_max_batch, cfg.coalesce_lock_waves) == (8, 3)
    assert cfg.coalesce_pipeline is False and cfg.metrics_port == 9109
    dflt = parse_config({"group.id": "g"})
    assert dflt.coalesce_window_s == pytest.approx(0.0005)
    assert (dflt.coalesce_max_batch, dflt.coalesce_lock_waves) == (32, 1)
    assert dflt.coalesce_pipeline is True and dflt.metrics_port is None
    with pytest.raises(ValueError, match="coalesce.max_batch"):
        parse_config({"group.id": "g", "tpu.assignor.coalesce.max_batch": "0"})
    with pytest.raises(ValueError, match="lock.waves"):
        parse_config({"group.id": "g", "tpu.assignor.coalesce.roster.lock.waves": "0"})


def test_service_from_config_consumes_knobs():
    with service.AssignorService.from_config(
        {"group.id": "g", "tpu.assignor.solve.timeout.ms": "5000",
         "tpu.assignor.coalesce.window.ms": "2.0", "tpu.assignor.coalesce.max_batch": "4",
         "tpu.assignor.coalesce.roster.lock.waves": "2",
         "tpu.assignor.coalesce.pipeline": "false", "tpu.assignor.metrics.port": "0",
         "tpu.assignor.scrub.interval.ms": "0"},
        port=0, device="cpu",
    ) as s:
        assert s._watchdog.timeout_s == 5.0
        co = s._coalescer
        assert co is not None and co.window_s == pytest.approx(0.002)
        assert (co.max_batch, co.lock_waves, co.pipeline) == (4, 2, False)
        assert co.device.type == "cpu"
        assert s._metrics_port is None and s.metrics_address is None
    with service.AssignorService.from_config(
        {"group.id": "g", "tpu.assignor.coalesce.max_batch": "1",
         "tpu.assignor.scrub.interval.ms": "0"},
        port=0, solve_timeout_s=1.0, device="cpu",
    ) as s2:
        assert s2._coalescer is None and s2._watchdog.timeout_s == 1.0


# -- the warm-up's megabatch waves ----------------------------------------


def test_warmup_drives_the_megabatch_waves():
    reg = metrics.REGISTRY
    restack = reg.counter("klba_coalesce_restack_total")
    hits = reg.counter("klba_coalesce_roster_hits_total")
    applied = reg.counter("klba_delta_epochs_total", {"outcome": "applied"})
    before = (restack.value, hits.value, applied.value)
    got = warmup.warmup(200, [4], solvers=("stream",), coalesce_max_batch=4,
                        stream_refine_iters=16, delta_buckets=2, device="cpu")
    names = [(r[0], r[1]) for r in got]
    assert ("coalesce", 2) in names and ("coalesce", 4) in names
    assert restack.value - before[0] == 2  # one locking wave a batch size
    assert hits.value - before[1] == 4  # a dense and a delta wave each
    assert applied.value - before[2] >= 2 + 4


def test_warmup_megabatch_rows_match_jax():
    kw = dict(max_partitions=40, consumers=[3], solvers=("stream",),
              coalesce_max_batch=2, stream_refine_iters=8, delta_buckets=1)
    rows_jax = [r[:4] for r in jax_warmup.warmup(**kw)]
    rows_port = [r[:4] for r in warmup.warmup(device="cpu", **kw)]
    assert rows_port == rows_jax
    assert ("coalesce", 2, 64, 3) in rows_port
