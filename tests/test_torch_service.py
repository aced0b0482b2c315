"""The port's sidecar against the JAX package's, on the CPU.

* every case of ``tests/fixtures/wire_conformance.jsonl`` against the
  port's service (``device="cpu"``) over a real socket;
* the twin replay: one sequence of request lines sent to the JAX
  ``AssignorService(coalesce_max_batch=1, scrub_interval_ms=0)`` and to the
  port's service, both behind one stepped clock, gives replies equal after
  dropping the ids, the timing fields and ``stats.device`` (the port's one
  extra key), and moves the same counter series in each package's own
  registry: ``assign`` with every solver but ``sinkhorn``, the wire errors
  (an oversized line with the connection surviving), a stream through
  cold, no-op, drift, delta, stale and gapped bases, ack -> delta answer,
  a remap by name, both zlib encodings and a pid-set change, then
  ``stream_flight``, ``recommend``, the ``MAX_STREAMS`` cap and ``stats``;
* ``sinkhorn`` over the wire: count spread <= 1, peak <= the greedy
  peak, the quality ratio within 2 % of the JAX reply, dense and linear;
* the ladder under each package's own ``faults.injected()``: a
  ``device.solve`` raise answers ``host_greedy``; ``stream.refine`` raises
  descend to ``cold_device`` and ``host_snake`` and warm-restart after;
  corrupted resident state counts strikes and trips the stream breaker at
  ``ESCALATE_AFTER``; with the host rung off the request errors;
* the clients cross: the port's client against the JAX service and the
  JAX client against the port's;
* ``GET /metrics`` on ``metrics_port=0``; ``AssignorService()`` raises
  without a card.

Every comparison is exact: assignments, counters and the stream stats
(float fields from the same integer totals) are equal, not close.
"""

import contextlib
import json
import pathlib
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import service as jax_service  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import dispatch as jax_dispatch  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import service  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.lag import (  # noqa: E402
    AssignmentDeltaTracker,
    LagDeltaTracker,
)
from kafka_lag_based_assignor_tpu_torch.ops import dispatch  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.testing import zipf_lags  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import faults  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import scrub  # noqa: E402
import test_torch_native  # noqa: E402

jax_native_core = test_torch_native.jax_native_core

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "wire_conformance.jsonl"

# Fields that carry ids or times (the two processes mint their own ids
# and take their own time), dropped before the replies are compared.
VOLATILE = frozenset({"request_id", "trace_id", "wall_ms", "lag_read_ms",
                      "solve_ms", "uptime_s", "pressure", "p99_ms"})
# Counter series that differ by design: JAX counts XLA compiles, the port
# counts nvcc / g++ builds; the tail sampler keeps a random share of the
# traces by their (random) ids; a key-form drift is counted against the
# last call of the same signature anywhere in the process, so it depends
# on what other tests ran before in each package.
NOT_COMPARED = frozenset({"klba_compile_total", "klba_trace_total",
                          "klba_static_drift_total"})
# The JAX service's stats sections for features the port's sidecar does
# not run yet (the port answers None for each).
UNPORTED = ("federation",)


def strip(x):
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def normalized(reply, method=None):
    """A reply without ids and times; an ``assign`` answer without
    ``stats.device``; a ``stats`` answer without the unported sections and
    the quality plane's process-wide history."""
    out = strip(reply)
    result = out.get("result")
    if method == "assign" and isinstance(result, dict):
        result["stats"].pop("device", None)
    if method == "stats" and isinstance(result, dict):
        for key in UNPORTED:
            result.pop(key, None)
        # The port's mesh status has one key more: ``virtual``.
        if result.get("mesh") is not None:
            result["mesh"].pop("virtual")
        for key in ("last_linear_solve", "tile_source"):
            result["quality"].pop(key)
    return out


def counters(metrics_module):
    return {
        (name, tuple(sorted(s["labels"].items()))): s["value"]
        for name, entry in metrics_module.REGISTRY.snapshot().items()
        if entry["type"] == "counter" and name not in NOT_COMPARED
        for s in entry["series"]
    }


def moved(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class Clock:
    """A clock the test steps: every call inside one request sees one
    time, the same in both services."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


class Twin:
    """A JAX service and a port service (``device="cpu"``) with the same
    knobs and clock (coalescing off in both unless ``coalesce_max_batch``
    says otherwise), one connection to each, the process-wide quality knobs
    of both packages restored on close."""

    def __init__(self, quality_mode="auto", quality_tile=1024, coalesce_max_batch=1,
                 **kw):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(jax_dispatch.quality_scope(quality_mode,
                                                             quality_tile))
        self._stack.enter_context(dispatch.quality_scope(quality_mode,
                                                         quality_tile))
        self.clock = Clock()
        knobs = dict(quality_mode=quality_mode, quality_tile=quality_tile,
                     clock=self.clock, scrub_interval_ms=0,
                     coalesce_max_batch=coalesce_max_batch, **kw)
        self.jax = self._stack.enter_context(jax_service.AssignorService(
            port=0, **knobs))
        self.port = self._stack.enter_context(
            service.AssignorService(port=0, device="cpu", **knobs))
        self.files = []
        for svc in (self.jax, self.port):
            sock = self._stack.enter_context(socket.create_connection(svc.address))
            self.files.append(self._stack.enter_context(sock.makefile("rwb")))
        self.before = (counters(jax_metrics), counters(metrics))

    def send(self, line: bytes):
        """(JAX reply, port reply) to one raw request line."""
        self.clock.now += 10.0
        replies = []
        for f in self.files:
            f.write(line + b"\n")
            f.flush()
            replies.append(json.loads(f.readline()))
        return replies

    def same(self, method, params=None, rid=7, raw=None):
        """Send one request to both; assert equal normalized replies and
        return the port's (raw) reply."""
        req = {"id": rid, "method": method}
        if params is not None:
            req["params"] = params
        got_jax, got_port = self.send(raw if raw is not None
                                      else json.dumps(req).encode())
        assert normalized(got_port, method) == normalized(got_jax, method)
        return got_port

    def series_moved_alike(self):
        jax_moved = moved(self.before[0], counters(jax_metrics))
        port_moved = moved(self.before[1], counters(metrics))
        assert port_moved == jax_moved
        return port_moved

    def close(self):
        self._stack.close()


@pytest.fixture()
def twin():
    pair = Twin()
    try:
        yield pair
    finally:
        pair.close()


@pytest.fixture(scope="module")
def port_service():
    # No scrubber: this service lives for the whole module, and a pass of
    # its 30 s scrubber would move the port's scrub series inside a twin
    # test's counter diff (the twins run beside it in the same process).
    with dispatch.quality_scope("auto", 1024):
        with service.AssignorService(port=0, device="cpu",
                                     scrub_interval_ms=0) as svc:
            yield svc


def fixtures():
    with open(FIXTURES) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_conformance_fixture_has_every_case():
    assert len(fixtures()) == 18


@pytest.mark.parametrize("fixture", fixtures(), ids=lambda fx: fx["name"])
def test_wire_conformance(port_service, fixture):
    """The JAX service's golden wire cases, as raw lines over TCP."""
    with socket.create_connection(port_service.address) as s:
        f = s.makefile("rwb")
        f.write(fixture["request"].encode() + b"\n")
        f.flush()
        resp = json.loads(f.readline())
    if "expect_error_contains" in fixture:
        assert "error" in resp, resp
        assert fixture["expect_error_contains"] in resp["error"]["message"]
        assert resp["id"] == fixture["expect_id"]
        return
    assert "error" not in resp, resp
    if "expect_id" in fixture:
        assert resp["id"] == fixture["expect_id"]
    if "expect_result" in fixture:
        assert resp["result"] == fixture["expect_result"]
    if "expect_assignments" in fixture:
        assert resp["result"]["assignments"] == fixture["expect_assignments"]
    if "expect_members" in fixture:
        assert sorted(resp["result"]["assignments"]) == sorted(
            fixture["expect_members"])
    if "expect_count_spread_max" in fixture:
        sizes = [len(v) for v in resp["result"]["assignments"].values()]
        assert max(sizes) - min(sizes) <= fixture["expect_count_spread_max"]


@pytest.mark.parametrize("method", ["peer_sync", "federation",
                                    "federated_assign"])
def test_unported_methods_answer_unknown_method(port_service, method):
    """The federation methods on a sidecar without federation answer as the
    JAX sidecar's do: ``federation`` reports ``{"enabled": false}``, the
    other two the "not configured" error, counted under their own label."""
    label = ("klba_request_errors_total", {"method": method})
    before = metrics.REGISTRY.counter(*label).value
    with service.AssignorServiceClient(*port_service.address) as c:
        if method == "federation":
            assert c.request(method, {}) == {"enabled": False}
        else:
            with pytest.raises(RuntimeError, match="federation is not configured"):
                c.request(method, {})
        assert c.ping()
    assert metrics.REGISTRY.counter(*label).value == before + (method != "federation")


# -- the twin replay ------------------------------------------------------

TOPICS = {
    "t0": [[p, int(v)] for p, v in enumerate(zipf_lags(np.random.default_rng(1), 40))],
    "t1": [[p, 500 + 37 * p] for p in range(12)],
}
SUBS = {"m0": ["t0", "t1"], "m1": ["t0"], "m2": ["t0", "t1"], "m3": ["t1"]}
MEMBERS = ["m2", "m0", "m1", "m3"]


def rows(lags, pids=None):
    pids = range(len(lags)) if pids is None else pids
    return [[int(p), int(v)] for p, v in zip(pids, lags)]


def heat(lags, reply, members, factor=1.6):
    """The lags with the partitions of the first member's share scaled."""
    hot = {p for _, p in reply["result"]["assignments"][sorted(members)[0]]}
    return np.array([v * factor if p in hot else v for p, v in enumerate(lags)],
                    dtype=np.int64)


@pytest.mark.usefixtures("jax_native_core")
def test_twin_replay_assign_and_errors(twin):
    assert twin.same("ping")["result"] == "pong"
    for solver in ("rounds", "scan", "global", "native", "host"):
        reply = twin.same("assign", {"topics": TOPICS, "subscriptions": SUBS,
                                     "solver": solver})
        assert reply["result"]["stats"]["device"] == (
            "cpu" if solver in ("rounds", "scan", "global") else None)
    for solver in ("rounds", "scan"):
        reply = twin.same("assign", {"topics": TOPICS, "subscriptions": SUBS,
                                     "solver": solver,
                                     "options": {"refine_iters": 20}})
        assert reply["result"]["options"] == {"refine_iters": 16}
        assert reply["result"]["stats"]["refine_iters"] == 16
    bad = [
        ("assign", {"topics": {"t0": [[0, 5], [1, -7]]},
                    "subscriptions": {"C0": ["t0"]}, "solver": "rounds"}),
        ("assign", {"topics": TOPICS, "subscriptions": SUBS,
                    "options": {"sinkhorn_iters": 5000}}),
        ("assign", {"topics": TOPICS, "subscriptions": SUBS,
                    "options": {"warp": 1}}),
        ("assign", {"topics": TOPICS, "subscriptions": SUBS,
                    "solver": "global", "options": {"refine_iters": 4}}),
        ("frobnicate", None),
        ("metrics", {"view": "nope"}),
        ("stream_flight", {"stream_id": "never"}),
        ("recommend", {"horizon_s": 0}),
    ]
    for method, params in bad:
        assert "error" in twin.same(method, params)
    for raw in (b'{"id": 3, "method": ', b"[1, 2]", b'"ping"'):
        assert "error" in twin.same(None, raw=raw)
    oversized = b"x" * (service.MAX_LINE_BYTES + 16)
    reply = twin.same(None, raw=oversized)
    assert reply["id"] is None and "exceeds" in reply["error"]["message"]
    assert twin.same("ping")["result"] == "pong"  # the connection survived
    stats = twin.same("stats")["result"]
    assert stats["errors"] == 12 and stats["fallbacks"] == 0
    assert all(stats[key] is None for key in UNPORTED)
    assert stats["quality"]["kernel"] == {"duals": False, "digest": False}
    series = twin.series_moved_alike()
    assert series[("klba_requests_total", (("method", "assign"),))] == 7
    assert series[("klba_request_errors_total", (("method", "oversized"),))] == 1
    assert series[("klba_request_errors_total", (("method", "unknown"),))] == 4


def test_twin_replay_stream_epochs(twin):
    rng = np.random.default_rng(3)
    lags = zipf_lags(rng, 64)
    sid = "orders"
    base = {"stream_id": sid, "topic": "t0", "members": MEMBERS}
    cold = twin.same("stream_assign", {**base, "lags": rows(lags)})
    assert cold["result"]["stream"]["cold_start"]
    noop = twin.same("stream_assign", {**base, "lags": rows(lags)})
    assert not noop["result"]["stream"]["refined"]
    lags = heat(lags, noop, MEMBERS)
    drift = twin.same("stream_assign", {**base, "lags": rows(lags)})
    assert drift["result"]["stream"]["refined"]

    tracker = LagDeltaTracker()
    tracker.params_for(rows(lags))
    tracker.note_result(drift["result"])
    lags = lags.copy()
    lags[[3, 17, 40]] += 900
    params = tracker.params_for(rows(lags))
    assert "lag_delta" in params
    delta = twin.same("stream_assign", {**base, **params})
    tracker.note_result(delta["result"])
    epoch = delta["result"]["stream"]["lag_epoch"]
    for stale in (epoch - 1, epoch + 5):
        d = {"indices": [1], "values": [7], "base_epoch": stale}
        resync = twin.same("stream_assign", {**base, "lag_delta": d})
        assert resync["result"]["stream"]["resync"]
    both = {**base, "lags": rows(lags), "lag_delta": params["lag_delta"]}
    assert "error" in twin.same("stream_assign", both)
    missing = {"stream_id": "fresh", "members": MEMBERS,
               "lag_delta": {"indices": [], "values": [], "base_epoch": 0}}
    assert "error" in twin.same("stream_assign", missing)

    acks = AssignmentDeltaTracker()
    acks.note_result(resync["result"], MEMBERS)
    lags = heat(lags, delta, MEMBERS, 1.3)
    acked = acks.stamp({**base, "lags": rows(lags)})
    r = twin.same("stream_assign", acked)
    assert "assignment_delta" in r["result"]
    dense = acks.note_result(r["result"], MEMBERS)
    assert sum(len(v) for v in dense.values()) == 64

    moved_roster = ["m0", "m1", "m2", "m9"]
    remap = twin.same("stream_assign", {**base, "members": moved_roster,
                                        "lags": rows(lags)})
    assert sorted(remap["result"]["assignments"]) == moved_roster
    base["members"] = moved_roster
    zipped = twin.same("stream_assign", {**base, "lags": rows(lags),
                                         "accept_encoding": "zlib"})
    assert "assignments_encoded" in zipped["result"]
    packed = {**base, "lags": service.encode_lags_zlib(rows(lags)),
              "encoding": "zlib"}
    twin.same("stream_assign", packed)
    bad_enc = {**base, "lags": rows(lags), "encoding": "lz4"}
    assert "error" in twin.same("stream_assign", bad_enc)
    shifted = twin.same("stream_assign",
                        {**base, "lags": rows(lags, range(1, 65))})
    assert shifted["result"]["stream"]["cold_start"]

    flight = twin.same("stream_flight", {"stream_id": sid, "clear": True})
    assert len(flight["result"]["records"]) >= 6
    assert twin.same("stream_flight", {"stream_id": sid})["result"]["records"] == []
    rec = twin.same("recommend", {"horizon_s": 120})
    assert sid in rec["result"]["streams"]
    twin.same("recommend", {"stream_id": sid})
    twin.same("stats")
    series = twin.series_moved_alike()
    assert series[("klba_delta_epochs_total", (("outcome", "resync"),))] == 3
    assert series[("klba_assign_delta_epochs_total", (("outcome", "applied"),))] == 1
    assert series[("klba_wire_lag_bytes_total", (("encoding", "zlib"),))] > 0


def test_twin_replay_stream_cap_and_reset(twin):
    for i in range(service.MAX_STREAMS):
        twin.same("stream_assign", {"stream_id": f"cap{i}", "topic": "t0",
                                    "lags": [[0, 1 + i]], "members": ["C0"]})
    over = {"stream_id": "overflow", "topic": "t0", "lags": [[0, 1]],
            "members": ["C0"]}
    assert "too many live streams" in twin.same("stream_assign", over)["error"]["message"]
    assert twin.same("stream_reset", {"stream_id": "cap0"})["result"] == {"dropped": True}
    assert twin.same("stream_reset", {"stream_id": "cap0"})["result"] == {"dropped": False}
    assert "error" not in twin.same("stream_assign", over)
    assert twin.same("stats")["result"]["live_streams"] == service.MAX_STREAMS
    assert len(twin.same("recommend")["result"]["streams"]) == service.MAX_STREAMS
    twin.series_moved_alike()


# -- sinkhorn over the wire -----------------------------------------------


def peak(assignments, lags):
    return max(sum(lags[p] for _, p in tps) for tps in assignments.values())


@pytest.mark.parametrize("mode,P,C", [("auto", 600, 8), ("linear", 700, 6)])
def test_sinkhorn_over_the_wire(mode, P, C):
    lags = zipf_lags(np.random.default_rng(11), P)
    params = {"topics": {"t0": rows(lags)},
              "subscriptions": {f"c{i}": ["t0"] for i in range(C)}}
    pair = Twin(quality_mode=mode, quality_tile=64)
    try:
        greedy = pair.same("assign", {**params, "solver": "rounds"})["result"]
        got_jax, got_port = pair.send(json.dumps(
            {"id": 1, "method": "assign",
             "params": {**params, "solver": "sinkhorn"}}).encode())
    finally:
        pair.close()
    ratios = []
    for reply in (got_jax, got_port):
        result = reply["result"]
        held = sorted(p for tps in result["assignments"].values() for _, p in tps)
        assert held == list(range(P))
        assert result["stats"]["count_spread"] <= 1
        assert peak(result["assignments"], lags) <= peak(greedy["assignments"], lags)
        ratios.append(result["stats"]["quality_ratio"])
    assert abs(ratios[1] - ratios[0]) <= 0.02 * ratios[0]
    assert got_port["result"]["stats"]["device"] == "cpu"


# -- the ladder -----------------------------------------------------------


@contextlib.contextmanager
def both_injected(point, seed=0, **plan):
    """The same plan in each package's own injector."""
    jax_inj = jax_faults.FaultInjector(seed=seed).plan(point, **plan)
    port_inj = faults.FaultInjector(seed=seed).plan(point, **plan)
    with jax_faults.injected(jax_inj), faults.injected(port_inj):
        yield jax_inj, port_inj


def test_device_solve_fault_answers_host_greedy(twin):
    clean = twin.same("assign", {"topics": TOPICS, "subscriptions": SUBS})
    with both_injected("device.solve", mode="raise", times=3):
        for solver in ("rounds", "global", "native"):
            r = twin.same("assign", {"topics": TOPICS, "subscriptions": SUBS,
                                     "solver": solver})
            assert r["result"]["stats"]["fallback_used"]
            assert r["result"]["stats"]["device"] is None
        stats = twin.same("stats")["result"]
        assert stats["faults"]["points"]["device.solve"]["fired"] == 3
    assert r["result"]["assignments"] != {}
    again = twin.same("assign", {"topics": TOPICS, "subscriptions": SUBS})
    assert again["result"]["assignments"] == clean["result"]["assignments"]
    series = twin.series_moved_alike()
    rung = ("klba_ladder_rung_total", (("method", "assign"), ("rung", "host_greedy")))
    assert series[rung] == 3


def stream_case(twin, sid, lags, members=("A", "B"), **extra):
    return twin.same("stream_assign", {"stream_id": sid, "topic": "t0",
                                       "lags": rows(lags), "members": list(members),
                                       **extra})["result"]["stream"]


def test_stream_failure_descends_the_ladder(twin):
    """The cases of the JAX service's ladder tests, under the fault point
    ``stream.refine`` instead of a patched engine: the warm engine and the
    cold retry both failing answer the host snake and snapshot it (the next
    epoch warm-restarts); the warm engine alone failing answers from a
    fresh engine's cold solve."""
    lags = np.arange(1, 257, dtype=np.int64) * 1000
    assert stream_case(twin, "s", lags)["cold_start"]
    with both_injected("stream.refine", mode="raise", times=2):
        s = stream_case(twin, "s", lags)
    assert (s["degraded_rung"], s["fallback_used"], s["cold_start"]) == (
        "host_snake", True, True)
    assert twin.same("stats")["result"]["poisoned_snapshots"] == 1
    s = stream_case(twin, "s", lags)
    assert s["warm_restart"] and not s["cold_start"] and s["degraded_rung"] == "none"
    with both_injected("stream.refine", mode="raise", times=1):
        s = stream_case(twin, "s", lags)
    assert (s["degraded_rung"], s["fallback_used"]) == ("cold_device", False)
    s = stream_case(twin, "s", lags)
    assert not s["cold_start"] and s["degraded_rung"] == "none"
    twin.series_moved_alike()


def test_corruption_strikes_trip_the_stream_breaker():
    """A corrupt -> heal -> corrupt flip-flop: each detection is served
    ``kept_previous`` and counts a strike; the second strike
    (``ESCALATE_AFTER``) trips the stream breaker, and the next epoch fails
    fast to ``kept_previous``."""
    assert scrub.ESCALATE_AFTER == 2 and scrub.FORGIVE_AFTER == 3
    rng = np.random.default_rng(8)
    opts = {"options": {"guardrail": None, "refine_threshold": None}}
    pair = Twin(breaker_cooldown_s=60.0)
    try:
        stream_case(pair, "s0", zipf_lags(rng, 256), **opts)
        for strike in (1, 2):
            with both_injected("device.corrupt.choice", seed=40 + strike,
                               mode="raise", times=1):
                stream_case(pair, "s0", zipf_lags(rng, 256), **opts)
            s = stream_case(pair, "s0", zipf_lags(rng, 256), **opts)
            assert s["degraded_rung"] == "kept_previous" and s["fallback_used"]
            assert pair.port._streams["s0"].scrub_strikes == strike
        breakers = pair.same("stats")["result"]["breakers"]
        assert breakers["stream"]["state"] == "open"
        s = stream_case(pair, "s0", zipf_lags(rng, 256), **opts)
        assert s["degraded_rung"] == "kept_previous"
        series = pair.series_moved_alike()
    finally:
        pair.close()
    escalated = ("klba_quarantine_total", (("buffer", "choice"), ("outcome", "escalated")))
    assert series[escalated] == 1


def test_host_rung_off_fails_the_request():
    pair = Twin(host_fallback=False)
    try:
        with both_injected("device.solve", mode="raise"):
            r = pair.same("assign", {"topics": TOPICS, "subscriptions": SUBS})
        assert "injected" in r["error"]["message"]
        lags = np.arange(1, 65, dtype=np.int64)
        stream_case(pair, "s", lags)
        with both_injected("stream.refine", mode="raise", times=1):
            r = pair.same("stream_assign", {"stream_id": "s", "topic": "t0",
                                            "lags": rows(lags), "members": ["A", "B"]})
        assert "error" in r
        assert pair.same("stats")["result"]["live_streams"] == 0
        pair.series_moved_alike()
    finally:
        pair.close()


# -- clients, listener, device --------------------------------------------


def test_clients_cross_between_the_packages():
    pair = Twin()
    try:
        port_client = service.AssignorServiceClient(*pair.jax.address)
        jax_client = jax_service.AssignorServiceClient(*pair.port.address)
        answers = []
        for client in (port_client, jax_client):
            with client:
                assert client.ping()
                got = client.assign({"t0": TOPICS["t0"]}, {"a": ["t0"], "b": ["t0"]})
                first = client.stream_assign("x", "t0", TOPICS["t0"], ["a", "b"],
                                             encoding="zlib")
                delta = {"indices": [0], "values": [1], "base_epoch": 1}
                second = client.stream_assign("x", "t0", None, ["a", "b"],
                                              lag_delta=delta)
                assert client.stream_reset("x")
                answers.append((got, first["assignments"], second["assignments"]))
        assert answers[0] == answers[1]
    finally:
        pair.close()


def test_metrics_listener_serves_the_exposition():
    with service.AssignorService(port=0, device="cpu", metrics_port=0) as svc:
        with service.AssignorServiceClient(*svc.address) as c:
            c.ping()
            prom = c.request("metrics", {"view": "prometheus"})["prometheus"]
        host, port = svc.metrics_address
        body = urllib.request.urlopen(f"http://{host}:{port}/metrics").read().decode()
        assert 'klba_requests_total{method="ping"}' in body
        assert 'klba_requests_total{method="ping"}' in prom
        ok = urllib.request.urlopen(f"http://{host}:{port}/healthz").read()
        assert ok == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{host}:{port}/nope")
    assert svc.metrics_address is None


def test_from_config_reads_the_sidecar_keys():
    cfg = {"group.id": "g", "tpu.assignor.metrics.port": "0",
           "tpu.assignor.slo.class.orders": "critical",
           "tpu.assignor.delta.buckets": "3",
           "tpu.assignor.host.fallback": "false"}
    svc = service.AssignorService.from_config(cfg, device="cpu")
    try:
        assert svc._metrics_port is None  # 0 = disabled
        assert svc._slo.resolve("orders") == "critical"
        assert svc._delta_opts["delta_buckets"] == 3
        assert svc._host_fallback is False
    finally:
        svc.stop()


def test_stop_leaves_no_service_thread():
    svc = service.AssignorService(port=0, device="cpu", metrics_port=0).start()
    with service.AssignorServiceClient(*svc.address) as c:
        c.ping()
    listener = svc._metrics_http._thread
    svc.stop()
    svc.stop()  # idempotent
    assert svc.wait_stopped(0)
    listener.join(timeout=10)
    assert not svc._thread.is_alive() and not listener.is_alive()
    assert svc.metrics_address is None


def test_service_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        service.AssignorService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        service.AssignorService(device="cuda")
