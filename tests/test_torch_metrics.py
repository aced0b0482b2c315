"""The port's telemetry against the JAX package's, on the CPU.

* ``metrics``: the same ``bucket_index`` over a sweep of integers and
  floats; registries fed the same seeded sequence of records give the same
  ``snapshot()`` and the same ``prometheus()`` text, and the same
  ``histogram_deltas``; spans inside a request scope give the same
  timeline (names and parents); the flight recorder rings, redacts and
  dumps the same records;
* ``trace``: the same ``parse_traceparent`` verdicts, ``format_traceparent``
  strings and ``keep_decision`` over seeded ids;
* ``observability``: ``summarize_topics``, ``replay_decisions``,
  ``trace_decisions`` and ``log_topic_summaries`` give the same records and
  log lines on the README example and BASELINE config 3; the static-drift
  counter moves on the same dispatches; the quality tile's autotune picks
  the same tile and sets the same gauge;
* the device phases the port's linear solve records.

Every comparison is exact (tolerance 0): the registries' clocks are fixed
where a duration is recorded.
"""

import logging
import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.models import greedy as jax_greedy  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import dispatch as jax_dispatch  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import observability as jax_obs  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import trace as jax_trace  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import dispatch, linear_ot  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.packing import pad_topic_rows  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    baseline_workload,
    lag_rows,
)
from kafka_lag_based_assignor_tpu_torch.utils import metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import observability as obs  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import trace  # noqa: E402

MODS = {"jax": (jax_metrics, jax_trace, jax_obs), "port": (metrics, trace, obs)}


# -- bucket_index ---------------------------------------------------------

SWEEPS = {
    "ints_0_5000": list(range(-3, 5000)),
    "powers_of_two": [v for k in range(64) for v in (2 ** k - 1, 2 ** k, 2 ** k + 1)],
    "floats": [x / 7.0 for x in range(-20, 20000, 3)],
    "float_powers": [math.ldexp(1.0, k) * f for k in range(-4, 60)
                     for f in (0.999999, 1.0, 1.000001)],
    "huge": [1e15, 1e18, float(2 ** 62), 2 ** 80, float("inf")],
}


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_bucket_index_matches_jax(sweep):
    values = SWEEPS[sweep]
    assert [metrics.bucket_index(v) for v in values] == [
        jax_metrics.bucket_index(v) for v in values]
    assert metrics.NBUCKETS == jax_metrics.NBUCKETS


# -- registry, snapshot, prometheus, deltas ------------------------------


def feed(registry, seed: int, n: int = 300):
    """A seeded sequence of records into ``registry``."""
    rng = random.Random(seed)
    names = [("klba_a_total", "counter"), ("klba_b", "gauge"), ("klba_c_ms", "histogram")]
    for _ in range(n):
        name, kind = rng.choice(names)
        labels = {"k": rng.choice(["x", "y", 'q"uote\\slash\nnl'])} if rng.random() < 0.7 \
            else None
        if kind == "counter":
            registry.counter(name, labels).inc(rng.randint(1, 5))
        elif kind == "gauge":
            registry.gauge(name, labels).set(rng.random() * 100)
        else:
            v = rng.choice([rng.randint(0, 10 ** 6), rng.random() * 1e4, 0, 1, 2 ** 20])
            registry.histogram(name, labels).observe(v)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_registry_exports_match_jax(seed):
    regs = {name: mods[0].Registry(clock=lambda: 42.0) for name, mods in MODS.items()}
    for reg in regs.values():
        feed(reg, seed)
    snaps = {name: reg.snapshot() for name, reg in regs.items()}
    assert snaps["port"] == snaps["jax"]
    assert regs["port"].prometheus() == regs["jax"].prometheus()
    assert regs["port"].prometheus(snaps["port"]) == regs["jax"].prometheus(snaps["jax"])
    for reg in regs.values():
        feed(reg, seed + 100, n=120)
    after = {name: reg.snapshot() for name, reg in regs.items()}
    assert metrics.histogram_deltas(snaps["port"], after["port"]) == \
        jax_metrics.histogram_deltas(snaps["jax"], after["jax"])


def test_registry_rejects_rebinding_like_jax():
    for mod in (jax_metrics, metrics):
        reg = mod.Registry()
        reg.counter("klba_x")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("klba_x")
        h = reg.histogram("klba_h", {"a": 1})
        assert reg.histogram("klba_h", {"a": "1"}) is h
        for v in (1, 2, 3, 1000):
            h.observe(v)
        assert (h.percentile(0.5), h.percentile(0.99)) == (2.0, 1000)


# -- spans, scopes, log ids ----------------------------------------------


def timeline(mods):
    m = mods[0]
    with m.request_scope(request_id="req-fixed", kind="client", root_name="client") as rid:
        assert m.current_request_id() == rid == "req-fixed"
        with m.span("assign.solve") as outer:
            with m.span("lag.read"):
                assert m.current_open_spans() == ["assign.solve", "lag.read"]
            with m.device_phase("rounding"):
                pass
        with m.request_scope() as inner_rid:  # nested scopes flatten
            assert inner_rid == "req-fixed"
        spans = [(s["name"], s["parent"]) for s in m.current_timeline()]
        assert "device_ms" in outer
    assert m.current_request_id() is None
    return spans


def test_span_timeline_matches_jax():
    assert timeline(MODS["port"]) == timeline(MODS["jax"]) == [
        ("lag.read", "assign.solve"), ("assign.solve", None)]


def test_log_lines_carry_the_request_id():
    records = []
    for name, (m, _, _) in MODS.items():
        prefix = "kafka_lag_based_assignor_tpu" + ("_torch" if name == "port" else "")
        rec = logging.LogRecord(f"{prefix}.x", logging.INFO, __file__, 1, "msg %s",
                                ("a",), None)
        with m.request_scope(request_id="req-7"):
            m.RequestIdLogFilter().filter(rec)
        records.append((rec.getMessage(), rec.request_id))
    assert records[0] == records[1] == ("msg a request_id=req-7", "req-7")


@pytest.mark.parametrize("order", [("jax", "port"), ("port", "jax")])
def test_log_record_factory_keeps_the_jax_request_id(order):
    """With both packages' record factories installed (a process that runs
    both sidecars), in either order, the port's factory never erases the
    JAX package's ``request_id``: a JAX-scoped record keeps it.  Each
    package's scope suffixes its own records; the port's ``request_id``
    attribute survives where the port's factory runs last (the JAX
    factory, when it runs last, sets "-" outside its own scopes)."""
    saved = logging.getLogRecordFactory()
    flags = {n: m._factory_installed[0] for n, (m, _, _) in MODS.items()}
    try:
        for m, _, _ in MODS.values():
            m._factory_installed[0] = False
        for name in order:
            MODS[name][0].install_log_request_ids()
        got = {}
        for name, (m, _, _) in MODS.items():
            logger = "kafka_lag_based_assignor_tpu" + ("_torch" if name == "port" else "")
            with m.request_scope(request_id=f"req-{name}"):
                got[name] = logging.getLogger(logger).makeRecord(
                    logger, logging.INFO, __file__, 1, "msg", (), None)
            assert got[name].getMessage() == f"msg request_id=req-{name}"
        assert got["jax"].request_id == "req-jax"
        if order[-1] == "port":
            assert got["port"].request_id == "req-port"
        outside = logging.getLogger("other").makeRecord(
            "other", logging.INFO, __file__, 1, "msg", (), None)
        assert outside.request_id == "-" and outside.getMessage() == "msg"
    finally:
        logging.setLogRecordFactory(saved)
        for name, (m, _, _) in MODS.items():
            m._factory_installed[0] = flags[name]


# -- flight recorder -----------------------------------------------------


def flight_run(m):
    fr = m.FlightRecorder(capacity=4, dump_dir="", registry_=m.Registry())
    for i in range(6):
        fr.record("stream_epoch", {"epoch": i, "assignments": [1, 2], "nested": {
            "members": ["a"], "_private": 1, "ok": i}})
    dumped = fr.auto_dump("guardrail", {"epoch": 5, "topics": ["t"]})
    with m.request_scope(request_id="req-once"):
        first = fr.auto_dump("breaker_trip", {"key": "rounds"})
        second = fr.auto_dump("ladder", {"method": "assign"})
    payload = fr.last_dump()
    return (dumped, first, second, fr.dump_count(),
            [r["seq"] for r in fr.records()], payload["records"], payload["detail"],
            payload["reason"], fr.snapshot())


def test_flight_recorder_matches_jax():
    assert flight_run(metrics) == flight_run(jax_metrics)


def test_flight_dump_files_rotate(tmp_path):
    fr = metrics.FlightRecorder(capacity=2, dump_dir=str(tmp_path), keep_files=2,
                                disk_min_interval_s=0.0)
    for i in range(3):
        fr.record("rebalance", {"i": i})
        fr.dump("ladder")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["flight-0.json", "flight-1.json"]


# -- trace ids -----------------------------------------------------------

TRACEPARENTS = [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0123456789abcdef" * 2 + "-" + "0123456789abcdef" + "-00",
    "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 17 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-1",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01-",
    "",
    None,
    12345,
]


# The strict-parse rejects of tests/test_trace.py's TestTraceparent: each
# parses to None in both packages.
REJECTED = [
    b"00-" + b"a" * 32 + b"-" + b"b" * 16 + b"-01",
    "00-" + "a" * 32 + "-" + "b" * 16,
    "00-" + "a" * 32 + "-" + "z" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-0x",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-015",
    "x" * 55,
    123,
]
PARSE_CASES = [(v, False) for v in TRACEPARENTS] + [(v, True) for v in REJECTED]


@pytest.mark.parametrize("value,rejected", PARSE_CASES,
                         ids=[f"tp{i}" for i in range(len(PARSE_CASES))])
def test_parse_traceparent_matches_jax(value, rejected):
    got = trace.parse_traceparent(value)
    assert got == jax_trace.parse_traceparent(value)
    if rejected:
        assert got is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_ids_and_keep_decision_match_jax(seed):
    rng = random.Random(seed)
    ids = [format(rng.getrandbits(128), "032x") for _ in range(200)] + ["zz" * 16, ""]
    for rate in (0.0, 0.01, 0.25, 0.5, 0.999, 1.0):
        assert [trace.keep_decision(t, rate) for t in ids] == [
            jax_trace.keep_decision(t, rate) for t in ids]
    for t in ids[:20]:
        sid = format(rng.getrandbits(64), "016x")
        assert trace.format_traceparent(t, sid) == jax_trace.format_traceparent(t, sid)
        assert trace.parse_traceparent(trace.format_traceparent(t, sid)) == \
            jax_trace.parse_traceparent(jax_trace.format_traceparent(t, sid))
    assert trace.ANOMALY_KINDS == jax_trace.ANOMALY_KINDS
    assert trace.SPAN_CATALOG == jax_trace.SPAN_CATALOG


def test_collector_keeps_anomalous_traces_and_dumps(tmp_path):
    coll = trace.TraceCollector(sample_rate=0.0, dump_dir=str(tmp_path),
                                disk_min_interval_s=0.0)
    healthy = trace.TraceState(kind="client")
    bad = trace.TraceState(kind="client")
    bad.mark("timeout")
    assert coll.finish(healthy, 1.0) == "dropped"
    assert coll.finish(bad, 2.0, spans=[{"name": "assign.solve", "duration_ms": 1.0}]) \
        == "kept_anomalous"
    (kept,) = coll.traces()
    assert kept["anomalies"] == ["timeout"] and kept["spans"][0]["parent_id"]
    assert [p.name for p in tmp_path.iterdir()] == ["trace-1.json"]


# -- observability -------------------------------------------------------


def decisions_case(cfg):
    lags, members = baseline_workload(cfg)
    rows = lag_rows(lags)
    subs = {m: sorted(lags) for m in members}
    return rows, jax_greedy.assign_greedy(rows, subs), len(members)


@pytest.mark.parametrize("cfg", [1, 3])
def test_decision_replay_and_summaries_match_jax(cfg, caplog):
    rows, assignment, n_members = decisions_case(cfg)
    assert list(obs.replay_decisions(assignment, rows)) == list(
        jax_obs.replay_decisions(assignment, rows))
    out = {}
    for name, (_, _, mod) in MODS.items():
        stats = mod.RebalanceStats(num_members=n_members)
        mod.summarize_topics(stats, assignment, rows)
        logger = logging.getLogger(f"klba-test-{name}")
        logger.setLevel(mod.TRACE)
        with caplog.at_level(mod.TRACE, logger=logger.name):
            caplog.clear()
            mod.trace_decisions(assignment, rows, logger=logger)
            mod.log_topic_summaries(stats, assignment, logger=logger)
            lines = [(r.levelno, r.getMessage()) for r in caplog.records]
        out[name] = (stats.per_topic, lines)
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == sum(len(v) for v in rows.values()) + len(rows)


def test_breaker_trip_counts_match_jax():
    out = {}
    for name, (_, _, mod) in MODS.items():
        key = f"obs-parity-{name}"
        before = mod.breaker_trip_count(key)
        mod.note_breaker_trip(key)
        mod.note_breaker_trip(key)
        out[name] = (mod.breaker_trip_count(key) - before,
                     mod.breaker_trip_counts()[key] - before)
        assert mod.breaker_trip_count("never-tripped-key") == 0
        assert "never-tripped-key" not in mod.breaker_trip_counts()
    assert out["port"] == out["jax"] == (2, 2)


def test_static_drift_moves_on_the_same_dispatches(monkeypatch):
    """The round scan's key form flips from packed to two-key as one
    topic's lag sum crosses 2^(61 - rank_bits): the drift counter moves
    once in each package, and not again on a repeat."""
    monkeypatch.setattr(jax_dispatch, "_LAST_PACK_SHIFT", {})
    monkeypatch.setattr(dispatch, "_LAST_PACK_SHIFT", {})
    members = [f"m{i}" for i in range(8)]
    small = {"t": [1000 + i for i in range(40)]}
    wide = {"t": [2 ** 57 + i for i in range(40)]}
    moved = {}
    for name, run in (
        ("jax", lambda lags, k: jax_dispatch.assign_device(lags, subs, kernel=k)),
        ("port", lambda lags, k: dispatch.assign_device(lags, subs, kernel=k,
                                                        device="cpu")),
    ):
        mod = jax_obs if name == "jax" else obs
        log = []
        for kernel in ("rounds", "global"):
            for lags in (small, small, wide, wide, small):
                subs = {m: ["t"] for m in members}
                before = mod.static_drift_count()
                run(lag_rows({t: np.array(v, dtype=np.int64) for t, v in lags.items()}),
                    kernel)
                log.append(mod.static_drift_count() - before)
        moved[name] = log
    assert moved["port"] == moved["jax"] == [0, 0, 1, 0, 1] * 2


@pytest.mark.parametrize("stats", [
    None, {}, {"bytes_limit": 16 << 30, "bytes_in_use": 2 << 30},
    {"bytes_limit": 80 * 10 ** 9, "bytes_in_use": 0},
    {"bytes_limit": 1 << 20, "bytes_in_use": 0},
], ids=["cpu", "empty", "16GiB", "80GB", "1MiB"])
def test_quality_tile_autotune_matches_jax(stats, monkeypatch):
    out = {}
    for name, mod, m in (("jax", jax_dispatch, jax_metrics), ("port", dispatch, metrics)):
        monkeypatch.setattr(mod, "_QUALITY", dict(mod._QUALITY))
        monkeypatch.setattr(mod, "_TILE_SOURCE", dict(mod._TILE_SOURCE))
        kw = {} if name == "jax" else {"device": "cpu"}
        tile = mod.autotune_quality_tile(memory_stats=stats, **kw)
        source = mod._TILE_SOURCE["source"]
        gauge = m.REGISTRY.gauge("klba_quality_tile_autotuned", {"source": source}).value
        out[name] = (tile, dict(mod._TILE_SOURCE), gauge, mod.quality_tile())
    assert out["port"] == out["jax"]


def test_linear_solve_records_its_phases_and_series():
    lags, _ = baseline_workload(5, 3000, 16)
    lags_p, pids_p, valid = pad_topic_rows(lags["t0"])
    phases = {p: metrics.REGISTRY.histogram("klba_device_phase_ms", {"phase": p})
              for p in ("h2d", "duals", "rounding")}
    solves = metrics.REGISTRY.counter("klba_quality_solve_total", {"mode": "linear"})
    before = ({p: h.count for p, h in phases.items()}, solves.value)
    with dispatch.quality_scope("linear", tile=256):
        linear_ot.assign_topic_linear(lags_p, pids_p, valid, 16, device="cpu")
    assert {p: h.count - before[0][p] for p, h in phases.items()} == {
        "h2d": 1, "duals": 1, "rounding": 1}
    assert solves.value == before[1] + 1
    info = linear_ot.last_solve_info()
    assert metrics.REGISTRY.gauge("klba_quality_last_peak_bytes").value == \
        info["peak_bytes_estimate"]
    assert metrics.REGISTRY.gauge("klba_quality_last_tile_count").value == info["tiles"]


def test_device_phase_synchronizes_only_a_card():
    hist = metrics.REGISTRY.histogram("klba_device_phase_ms", {"phase": "h2d"})
    before = hist.count
    with metrics.device_phase("h2d", sync=torch.device("cpu")):
        pass
    with metrics.device_phase("h2d"):
        pass
    assert hist.count == before + 2


def test_compile_counter_counts_only_after_install(monkeypatch):
    monkeypatch.setattr(obs, "_compile_counter_installed", [False])
    before = obs.compile_count()
    obs.note_kernel_build()
    assert obs.compile_count() == before
    obs.install_compile_counter()
    obs.note_kernel_build()
    assert obs.compile_count() == before + 1
