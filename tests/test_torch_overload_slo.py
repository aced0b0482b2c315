"""The port's overload control against the JAX package's, case by case, on
the CPU: the twins of ``tests/test_overload.py`` that
``tests/test_torch_overload.py`` does not already hold, and a small
``overload_stampede`` (bench.py's config 7) through both sidecars.

Each twin runs the JAX test's scenario once with the JAX package and once
with the port (``device="cpu"``), checks the JAX test's own assertions in
both runs and compares what the two runs observed:

* the controller: the ladder on depth pressure and its actions by class,
  the recovery seed (escalates at once, never lowers a live reading, clears
  the rate limiter), one rung down per cooldown, a stale p99 decaying, an
  open breaker's pressure, sheds counted into ``klba_shed_total`` and the
  flight ring, the ``shed.decide`` fault point; the ``recommend`` math;
* the coalescer's SLO placement and deadline triage: a flush cuts
  ``[critical, standard]`` before the best-effort rows, an expired row is
  shed (``DeadlineShed``) while its batchmate is served, a row tighter than
  the measured flush cost is handed back (``DeadlineReroute``) and served
  inline by its submitter bit for bit, a flush that built a kernel never
  feeds the cost average, the window scale clamps;
* the sidecar: the hot detector's typed ``ShedReject``, the shed ladder by
  class, failing open on a ``shed.decide`` fault and on a controller bug, an
  unknown class rejected, a reject storm that walks back down, an
  ``admit.park`` fault answered on the ladder, ``recommend`` over the wire,
  ``from_config``, and a deadline shed that serves ``kept_previous`` with
  the stream's breaker closed and its warm state kept;
* the stampede: 16 tenants (4 critical, 4 standard, 8 best effort) of 256
  partitions x 8 members against a batch cap of 4, one warm-up round and 3
  measured rounds sent at once, in both sidecars: no critical request shed
  or failed, critical p99 within its 2 s deadline, standard shed only in a
  round where best effort is shed too, every served assignment valid, no
  build in the measured rounds, and the ``recommend`` trajectory of one
  steepening stream monotone and equal across the packages.  Shed counts
  depend on timing and are not compared.

Torch runs on one intra-op thread: a sidecar's threads each run torch ops.
"""

import concurrent.futures as cf
import contextlib
import json
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import service as jax_service  # noqa: E402
from kafka_lag_based_assignor_tpu import testing as jax_testing  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import coalesce as jax_coalesce  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import streaming as jax_streaming  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import observability as jax_obs  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import overload as jax_overload  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import service, testing  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import coalesce, streaming  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import faults, metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import observability, overload  # noqa: E402

#: Each package's modules and the keyword that puts its engines, coalescers
#: and sidecars on the CPU (the JAX package runs on the CPU platform here).
JAX = types.SimpleNamespace(
    name="jax", service=jax_service, testing=jax_testing, coalesce=jax_coalesce,
    streaming=jax_streaming, faults=jax_faults, metrics=jax_metrics,
    observability=jax_obs, overload=jax_overload, on={})
PORT = types.SimpleNamespace(
    name="port", service=service, testing=testing, coalesce=coalesce,
    streaming=streaming, faults=faults, metrics=metrics,
    observability=observability, overload=overload, on={"device": "cpu"})
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax_faults.deactivate()
    faults.deactivate()


def twin(run):
    """``run(pkg)`` for both packages; their observations must be equal."""
    got = {pkg.name: run(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


def shed_counts(pkg):
    return {(c.labels.get("class"), c.labels.get("rung")): c.value
            for c in pkg.metrics.REGISTRY.series("klba_shed_total")}


def shed_delta(pkg, before, by_class=None):
    delta = {k: v - before.get(k, 0) for k, v in shed_counts(pkg).items()
             if v != before.get(k, 0)}
    if by_class is not None:
        return sum(v for (klass, _), v in delta.items() if klass == by_class)
    return delta


# -- OverloadController ----------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def controller(pkg, **kw):
    clock = FakeClock()
    for key, value in (("latency_budget_ms", 100.0), ("depth_high", 4.0),
                       ("cooldown_s", 1.0), ("eval_interval_s", 0.0)):
        kw.setdefault(key, value)
    return pkg.overload.OverloadController(clock=clock, **kw), clock


def test_controller_walks_the_ladder_on_depth_pressure():
    def run(pkg):
        ctl, clock = controller(pkg)
        first = (ctl.admission("standard").action, ctl.rung())
        for _ in range(30):
            ctl.note_depth(40.0)
        clock.t += 0.01
        d = ctl.admission("best_effort")
        assert ctl.rung() == 4 and d.action == "reject" and d.retry_after_ms >= 100
        assert ctl.admission("standard").action == "degrade"
        assert ctl.admission("critical").action == "admit"
        return first, d.action, d.retry_after_ms, ctl.snapshot()

    assert twin(run)[0] == ("admit", 0)


def test_controller_rung_actions_by_class():
    def run(pkg):
        ctl, clock = controller(pkg)
        seen = []
        for target, rung in ((1.1, 1), (1.6, 2), (2.6, 3), (4.1, 4)):
            ctl._ewma_depth = target * ctl.depth_high
            clock.t += 0.01
            d = {k: ctl.admission(k) for k in ("best_effort", "standard", "critical")}
            assert ctl.rung() == rung and d["critical"].action == "admit"
            seen.append((rung, {k: (v.action, v.window_scale) for k, v in d.items()}))
        return seen

    seen = dict(twin(run))
    assert seen[1]["best_effort"][1] < 1.0
    assert seen[2]["best_effort"][0] == "degrade" and seen[2]["standard"][0] == "admit"
    assert seen[3]["best_effort"][0] == "reject" and seen[3]["standard"][0] == "admit"
    assert seen[4]["best_effort"][0] == "reject" and seen[4]["standard"][0] == "degrade"


def test_recovery_seed_escalates_on_first_decision():
    def run(pkg):
        ctl, clock = controller(pkg)
        ctl.seed_recovery_depth(16.0)
        d = ctl.admission("best_effort")
        first = (ctl.rung(), d.action)
        for _ in range(40):
            ctl.note_depth(0.0)
        clock.t += 1.1
        ctl.admission("standard")
        return first, ctl.rung()

    assert twin(run) == ((4, "reject"), 3)


def test_recovery_seed_never_lowers_a_live_reading_nor_waits():
    def run(pkg):
        ctl, _ = controller(pkg)
        for _ in range(30):
            ctl.note_depth(40.0)
        ctl.seed_recovery_depth(2.0)
        with ctl._lock:
            live = ctl._ewma_depth
        assert live > 30.0
        # The seed clears the rate limiter: the next admission re-evaluates.
        slow, _ = controller(pkg, eval_interval_s=60.0)
        slow.admission("standard")
        slow.seed_recovery_depth(16.0)
        return live, slow.admission("best_effort").action, slow.rung()

    assert twin(run)[1:] == ("reject", 4)


def test_controller_deescalates_one_rung_per_cooldown():
    def run(pkg):
        ctl, clock = controller(pkg)
        ctl._ewma_depth = 100.0
        ctl.admission("standard")
        rungs = [ctl.rung()]
        ctl._ewma_depth = 0.0
        clock.t += 0.01
        ctl.admission("standard")
        rungs.append(ctl.rung())
        for _ in range(4):
            clock.t += 1.1
            ctl.admission("standard")
            rungs.append(ctl.rung())
        clock.t += 5.0
        return rungs, ctl.admission("best_effort").action

    assert twin(run) == ([4, 4, 3, 2, 1, 0], "admit")


def test_controller_stale_p99_decays_without_new_epochs():
    def run(pkg):
        ctl, clock = controller(pkg)
        hist = pkg.metrics.REGISTRY.histogram("klba_span_duration_ms",
                                              {"span": "stream.epoch"})
        for _ in range(50):
            hist.observe(2000.0)
        clock.t += 0.01
        ctl.admission("best_effort")
        rungs = [ctl.rung()]
        for _ in range(60):
            clock.t += 1.1
            ctl.admission("best_effort")
            rungs.append(ctl.rung())
            if ctl.rung() == 0:
                break
        return rungs, ctl.admission("best_effort").action

    rungs, action = twin(run)
    assert rungs[0] == 4 and rungs[-1] == 0 and action == "admit"


def test_controller_breaker_open_adds_pressure():
    def run(pkg):
        flag = [False]
        ctl, clock = controller(pkg, breaker_open=lambda: flag[0])
        ctl.admission("standard")
        rungs = [ctl.rung()]
        flag[0] = True
        clock.t += 0.01
        ctl.admission("standard")
        return rungs + [ctl.rung()]

    assert twin(run) == [0, 1]


def test_controller_sheds_are_counted_and_recorded():
    def run(pkg):
        ctl, _ = controller(pkg)
        before = shed_counts(pkg)
        ctl.note_shed("best_effort", "reject_best_effort", "rejected", stream_id="s1")
        recs = [r for r in pkg.metrics.FLIGHT.records() if r.get("kind") == "shed"]
        # The ring's sequence number and time are process-wide.
        last = {k: v for k, v in recs[-1].items() if k not in ("seq", "t", "ts", "time")}
        return shed_delta(pkg, before), last

    delta, last = twin(run)
    assert delta == {("best_effort", "reject_best_effort"): 1}
    assert last["class"] == "best_effort"


def test_shed_decide_fault_point_fires_in_admission():
    def run(pkg):
        ctl, _ = controller(pkg)
        inj = pkg.faults.FaultInjector().plan("shed.decide", times=1)
        with pkg.faults.injected(inj):
            with pytest.raises(pkg.faults.FaultError):
                ctl.admission("standard")
            action = ctl.admission("standard").action
        return action, inj.fired("shed.decide")

    assert twin(run) == ("admit", 1)


# -- recommend math --------------------------------------------------------


def test_recommend_math_matches_jax():
    def run(pkg):
        rec = pkg.overload.recommend_consumers
        out = [rec([(0.0, 1000.0), (30.0, 1000.0)], consumers=4, partitions=64)]
        for rise in (10.0, 50.0, 200.0, 1000.0):
            out.append(rec([(0.0, 1000.0), (30.0, 1000.0 + rise * 30.0)], 4, 64))
        out.append(rec([(0.0, 10.0), (1.0, 10**9)], consumers=4, partitions=8))
        out += [rec([], 3, 100), rec([(0.0, 5.0)], 3, 100),
                rec([(1.0, 5.0), (1.0, 9.0)], 3, 100),
                rec([(0.0, 10**6), (60.0, 10.0)], 3, 100), rec([], 16, 4)]
        streams = {"s": {"slo_class": "standard", "consumers": 3, "partitions": 32,
                         "samples": [(0.0, 100.0), (10.0, 100.0)]}}
        out.append(pkg.overload.recommend_payload(streams, {"rung_index": 0,
                                                            "rung": "none"}))
        out.append(pkg.overload.recommend_payload(
            streams, {"rung_index": 2, "rung": "degrade_best_effort"}))
        return out

    out = twin(run)
    assert out[0] == (4, 0.0)
    rising = [r for r, _ in out[1:5]]
    assert [s for _, s in out[1:5]] == pytest.approx([10.0, 50.0, 200.0, 1000.0])
    assert rising == sorted(rising) and rising[0] >= 4 and rising[-1] > rising[0]
    assert out[5][0] == 8
    assert out[6:11] == [(3, 0.0), (3, 0.0), out[8], out[9], (4, 0.0)]
    assert out[8][0] == 3 and out[9][0] == 3 and out[9][1] < 0
    assert out[11]["streams"]["s"]["recommended_consumers"] == 3
    assert out[12]["streams"]["s"]["recommended_consumers"] == 4


# -- coalescer: SLO placement and deadline triage --------------------------


def warm_engine(pkg, C=8, P=256, seed=0):
    lags = np.random.default_rng(seed).integers(1, 10**6, size=P).astype(np.int64)
    eng = pkg.streaming.StreamingAssignor(num_consumers=C, refine_iters=16,
                                          refine_threshold=None, **pkg.on)
    eng.rebalance(lags)
    return eng, lags


def submission(pkg, eng, lags, klass="standard", deadline_at=None):
    return pkg.coalesce.EpochSubmission(
        payload=lags, bucket=eng._bucket(lags.shape[0]), resident=eng._resident,
        limit=-1.0, num_consumers=eng.num_consumers, iters=eng.refine_iters,
        max_pairs=4, exchange_budget=eng.refine_iters, owner=eng, klass=klass,
        rank=pkg.overload.class_rank(klass), deadline_at=deadline_at)


def coalescer(pkg, **kw):
    return pkg.coalesce.MegabatchCoalescer(**kw, **pkg.on)


def choice_of(result):
    return np.asarray(result[0] if isinstance(result, tuple) else result.choice).tolist()


def test_flush_places_critical_before_best_effort():
    """Two best-effort rows parked first, then a critical and a standard:
    with ``max_batch=2`` the first wave is [critical, standard]."""
    def run(pkg):
        pairs = [warm_engine(pkg, seed=i) for i in range(4)]
        coal = coalescer(pkg, window_s=0.0, max_batch=2, pipeline=False)
        subs = [submission(pkg, e, lg, k) for (e, lg), k in zip(
            pairs, ("best_effort", "best_effort", "critical", "standard"))]
        try:
            coal._flush(list(subs))
        finally:
            coal.close()
        results = [choice_of(s.future.result(timeout=60)) for s in subs]
        waves = [r["classes"] for r in pkg.metrics.FLIGHT.records()
                 if r.get("kind") == "coalesce_flush"][-2:]
        return waves, results

    waves, _ = twin(run)
    assert waves == [["critical", "standard"], ["best_effort", "best_effort"]]


def test_expired_deadline_row_is_shed_not_dispatched():
    def run(pkg):
        eng, lags = warm_engine(pkg, seed=7)
        peer, peer_lags = warm_engine(pkg, seed=8)
        coal = coalescer(pkg, window_s=0.0, max_batch=4, pipeline=False)
        now = pkg.metrics.REGISTRY.clock()
        expired = submission(pkg, eng, lags, "best_effort", deadline_at=now - 1.0)
        live = submission(pkg, peer, peer_lags, "critical", deadline_at=now + 60.0)
        before = shed_counts(pkg)
        try:
            coal._flush([expired, live])
        finally:
            coal.close()
        with pytest.raises(pkg.coalesce.DeadlineShed):
            expired.future.result(timeout=60)
        return choice_of(live.future.result(timeout=60)), shed_delta(pkg, before)

    assert twin(run)[1] == {("best_effort", "admit_deadline"): 1}


def test_tight_deadline_row_reroutes_inline():
    def run(pkg):
        eng, lags = warm_engine(pkg, seed=9)
        peer, peer_lags = warm_engine(pkg, seed=10)
        coal = coalescer(pkg, window_s=0.0, max_batch=4, pipeline=False)
        coal._flush_cost_s = 30.0
        now = pkg.metrics.REGISTRY.clock()
        tight = submission(pkg, eng, lags, "critical", deadline_at=now + 1.0)
        roomy = submission(pkg, peer, peer_lags, "standard", deadline_at=now + 600.0)
        reroutes = pkg.metrics.REGISTRY.counter("klba_coalesce_deadline_reroutes_total")
        n0 = reroutes.value
        try:
            coal._flush([tight, roomy])
        finally:
            coal.close()
        with pytest.raises(pkg.coalesce.DeadlineReroute):
            tight.future.result(timeout=60)
        return choice_of(roomy.future.result(timeout=60)), reroutes.value - n0

    assert twin(run)[1] == 1


def test_rerouted_laggard_served_inline_by_submitter():
    def run(pkg):
        rng = np.random.default_rng(11)
        P, C = 256, 8
        lags0 = rng.integers(1, 10**6, size=P).astype(np.int64)
        eng, ref = (pkg.streaming.StreamingAssignor(
            num_consumers=C, refine_iters=16, refine_threshold=None, **pkg.on)
            for _ in range(2))
        np.testing.assert_array_equal(eng.rebalance(lags0), ref.rebalance(lags0))
        coal = coalescer(pkg, window_s=0.005, max_batch=4)
        coal._flush_cost_s = 30.0
        reroutes = pkg.metrics.REGISTRY.counter("klba_coalesce_deadline_reroutes_total")
        n0 = reroutes.value
        lags1 = rng.integers(1, 10**6, size=P).astype(np.int64)
        try:
            choice = eng.submit_epoch(
                lags1, coal, slo_class="critical",
                rank=pkg.overload.class_rank("critical"),
                deadline_at=pkg.metrics.REGISTRY.clock() + 1.0)
        finally:
            coal.close()
        np.testing.assert_array_equal(choice, ref.rebalance(lags1))
        assert eng.last_stats.refined
        return reroutes.value - n0, np.asarray(choice).tolist()

    assert twin(run)[0] == 1


def test_flush_cost_ewma_excludes_compile_flushes():
    def run(pkg):
        coal = coalescer(pkg, window_s=0.0, max_batch=4, pipeline=False)
        try:
            t = [100.0]
            coal._clock = lambda: t[0]
            n = pkg.observability.compile_count()
            t[0] = 100.01
            coal._note_flush_cost(100.0, n)
            first = coal._flush_cost_s
            t[0] = 140.0
            coal._note_flush_cost(100.0, n - 1)
            return first, coal._flush_cost_s
        finally:
            coal.close()

    first, after = twin(run)
    assert first == pytest.approx(0.3 * 0.01) and after == first


def test_window_scale_clamps():
    def run(pkg):
        coal = coalescer(pkg, window_s=0.001, max_batch=4)
        try:
            scales = []
            for s in (0.0, 5.0, 0.5):
                coal.set_window_scale(s)
                scales.append(coal._window_scales)
            return scales
        finally:
            coal.close()

    assert twin(run) == [(0.05,) * 3, (1.0,) * 3, (0.5,) * 3]


# -- the sidecar -----------------------------------------------------------


def rows(arr):
    return [[i, int(v)] for i, v in enumerate(arr)]


def wire(svc, method, params):
    """``handle_line`` directly: the raw envelope, shed object included."""
    line = json.dumps({"id": 1, "method": method, "params": params})
    return json.loads(svc.handle_line(line.encode()))


def sidecar(pkg, **kw):
    return pkg.service.AssignorService(port=0, **kw, **pkg.on)


@contextlib.contextmanager
def hot(pkg):
    """A sidecar whose detector trips to the deepest rung on the first
    request (depth_high far below one request's weight)."""
    with sidecar(pkg, solve_timeout_s=60.0, breaker_cooldown_s=0.2,
                 overload_depth_high=0.01) as svc:
        svc._overload.eval_interval_s = 0.0
        yield svc


def test_client_raises_typed_shed_reject():
    def run(pkg):
        lags = rows((np.arange(48) + 1) * 10)
        with hot(pkg) as svc:
            c = pkg.service.AssignorServiceClient(*svc.address)
            try:
                c.request("stream_assign", {"stream_id": "crit", "topic": "t", "lags": lags,
                                            "members": ["A", "B"], "slo_class": "critical"})
                with pytest.raises(pkg.overload.ShedReject) as info:
                    c.request("stream_assign", {
                        "stream_id": "be", "topic": "t", "lags": lags,
                        "members": ["A", "B"], "slo_class": "best_effort"})
            finally:
                c.close()
        e = info.value
        return e.klass, e.rung, e.retry_after_ms

    klass, rung, retry = twin(run)
    assert klass == "best_effort" and rung in ("reject_best_effort", "degrade_standard")
    assert retry >= 100


def test_service_shed_ladder_orders_classes():
    def run(pkg):
        lags = rows((np.arange(64) + 1) * 10)
        members = ["A", "B", "C"]
        seen = []
        with hot(pkg) as svc:
            before = shed_counts(pkg)
            for sid, klass in (("crit", "critical"), ("be", "best_effort"),
                               ("std", None), ("std", None), ("crit", "critical")):
                params = {"stream_id": sid, "topic": "t", "lags": lags, "members": members}
                if klass:
                    params["slo_class"] = klass
                r = wire(svc, "stream_assign", params)
                if "error" in r:
                    seen.append(("error", r["error"]["shed"]))
                    continue
                s = r["result"]["stream"]
                pkg.testing.assert_valid_assignment(r["result"]["assignments"], 64)
                seen.append((s["shed"], s["slo_class"], s["churn"], s["degraded_rung"],
                             r["result"]["assignments"]))
            rung = wire(svc, "stats", {})["result"]["overload"]["rung"]
            return (seen, shed_delta(pkg, before), shed_delta(pkg, before, "best_effort"),
                    shed_delta(pkg, before, "standard"), rung)

    seen, delta, be, std, rung = twin(run)
    assert seen[0][0] is None and seen[0][1] == "critical"
    assert seen[1] == ("error", {"class": "best_effort", "rung": "degrade_standard",
                                 "retry_after_ms": seen[1][1]["retry_after_ms"]})
    assert seen[1][1]["retry_after_ms"] >= 100
    assert seen[2][0] is None
    assert seen[3][:4] == ({"rung": "degrade_standard", "served": "kept_previous"},
                           "standard", 0, "none")
    assert seen[3][4] == seen[2][4] and seen[4][0] is None
    assert all(k[0] != "critical" for k in delta) and be >= 1 and std >= 1
    assert rung == "degrade_standard"


def test_service_shed_decide_fault_fails_open():
    def run(pkg):
        lags = rows((np.arange(32) + 1) * 7)
        with hot(pkg) as svc:
            wire(svc, "stream_assign", {"stream_id": "s1", "topic": "t", "lags": lags,
                                        "members": ["A"]})
            inj = pkg.faults.FaultInjector().plan("shed.decide", times=1)
            with pkg.faults.injected(inj):
                r = wire(svc, "stream_assign", {
                    "stream_id": "be2", "topic": "t", "lags": lags, "members": ["A", "B"],
                    "slo_class": "best_effort"})
        pkg.testing.assert_valid_assignment(r["result"]["assignments"], 32)
        return inj.fired("shed.decide"), r["result"]["assignments"]

    assert twin(run)[0] == 1


def test_service_admission_bug_fails_open():
    def run(pkg):
        lags = rows((np.arange(32) + 1) * 7)
        with hot(pkg) as svc:
            def boom(klass):
                raise ValueError("synthetic controller bug")

            svc._overload.admission = boom
            r = wire(svc, "stream_assign", {"stream_id": "bug1", "topic": "t", "lags": lags,
                                            "members": ["A", "B"], "slo_class": "best_effort"})
        pkg.testing.assert_valid_assignment(r["result"]["assignments"], 32)
        return r["result"]["assignments"]

    twin(run)


def test_service_rejects_unknown_slo_class():
    def run(pkg):
        with hot(pkg) as svc:
            r = wire(svc, "stream_assign", {"stream_id": "s", "topic": "t", "lags": [[0, 1]],
                                            "members": ["A"], "slo_class": "ultra"})
        return r["error"]["message"]

    assert "unknown slo_class" in twin(run)


def test_service_reject_storm_deescalates():
    """Only best-effort tenants: a depth stampede that reaches the reject
    rung walks back down (every arrival feeds the in-flight depth)."""
    def run(pkg):
        params = {"stream_id": "be", "topic": "t0", "members": ["A", "B"],
                  "lags": [[i, (i + 1) * 100] for i in range(64)]}
        rejected = fully_served = 0
        with sidecar(pkg, solve_timeout_s=30.0, slo_classes={"be": "best_effort"},
                     overload_depth_high=3.0, overload_cooldown_s=0.05) as svc:
            svc._overload.eval_interval_s = 0.0
            assert "result" in wire(svc, "stream_assign", {**params,
                                                           "slo_class": "standard"})
            for _ in range(10):
                svc._overload.note_depth(30.0)
            for _ in range(300):
                r = wire(svc, "stream_assign", dict(params))
                if "error" in r:
                    assert "shed" in r["error"], r
                    rejected += 1
                elif r["result"]["stream"]["shed"] is None:
                    fully_served = 1
                    break
                time.sleep(0.01)
        return rejected > 0, fully_served

    assert twin(run) == (True, 1)


def test_admit_park_fault_recovers_via_ladder():
    """An ``admit.park`` fault surfaces on the submitting stream alone and
    descends its ladder; the request is still answered validly."""
    def run(pkg):
        lags = [[i, (i + 1) * 13] for i in range(48)]
        drift = [[i, (i + 1) * 13 + (7000 if i % 5 == 0 else 0)] for i in range(48)]
        with sidecar(pkg, solve_timeout_s=60.0, breaker_cooldown_s=0.2,
                     coalesce_window_ms=50.0) as svc:
            c = pkg.service.AssignorServiceClient(*svc.address)
            try:
                for sid in ("a", "b"):
                    c.stream_assign(sid, "t", lags, ["A", "B", "C"])
                inj = pkg.faults.FaultInjector().plan("admit.park", times=1)
                with pkg.faults.injected(inj):
                    r = c.stream_assign("a", "t", drift, ["A", "B", "C"])
            finally:
                c.close()
        pkg.testing.assert_valid_assignment(r["assignments"], 48)
        fired = inj.fired("admit.park")
        if fired:
            assert r["stream"]["degraded_rung"] in ("cold_device", "host_snake")
        return fired, r["stream"]["degraded_rung"], r["assignments"]

    assert twin(run)[0] == 1


def test_recommend_wire_end_to_end():
    def run(pkg):
        base = (np.arange(32) + 1) * 100
        with sidecar(pkg, solve_timeout_s=60.0,
                     overload_latency_budget_ms=10_000_000.0) as svc:
            c = pkg.service.AssignorServiceClient(*svc.address)
            try:
                for _ in range(3):
                    c.stream_assign("orders", "t", rows(base), ["A", "B"])
                    time.sleep(0.01)
                flat = c.request("recommend")
                entry = flat["streams"]["orders"]
                out = [(entry["recommended_consumers"], entry["consumers"],
                        entry["partitions"], flat["overload"]["rung"])]
                arr, last = base.copy(), 2
                for _ in range(3):
                    arr = arr + 50_000
                    c.stream_assign("orders", "t", rows(arr), ["A", "B"])
                    time.sleep(0.01)
                    e = c.request("recommend", {"stream_id": "orders"})["streams"]["orders"]
                    assert e["lag_trend_per_s"] > 0 and e["recommended_consumers"] >= last
                    last = e["recommended_consumers"]
                with pytest.raises(RuntimeError, match="horizon_s"):
                    c.request("recommend", {"horizon_s": -1})
            finally:
                c.close()
        assert 2 < last <= 32
        return out

    assert twin(run) == [(2, 2, 32, "none")]


def test_from_config_wires_slo_and_overload():
    def run(pkg):
        with pkg.service.AssignorService.from_config({
            "group.id": "g", "tpu.assignor.slo.class.orders": "critical",
            "tpu.assignor.slo.deadline.ms.critical": "2000",
            "tpu.assignor.overload.depth.high": "7",
        }, port=0, **pkg.on) as svc:
            return (svc._slo.resolve("orders"), svc._slo.budget_s("critical", 120.0),
                    svc._overload.depth_high)

    assert twin(run) == ("critical", 2.0, 7.0)


def test_deadline_shed_keeps_warm_state_and_skips_breaker():
    """A ``DeadlineShed`` through the watchdog serves ``kept_previous``
    without charging the stream breaker or dropping the warm state."""
    def run(pkg):
        lags = [[i, (i + 1) * 11] for i in range(40)]
        drift = [[i, (i + 1) * 11 + (9000 if i % 3 == 0 else 0)] for i in range(40)]
        with sidecar(pkg, solve_timeout_s=60.0, breaker_failures=1,
                     coalesce_window_ms=20.0) as svc:
            c = pkg.service.AssignorServiceClient(*svc.address)
            try:
                for sid in ("x", "y"):
                    c.stream_assign(sid, "t", lags, ["A", "B"])
                first = c.stream_assign("x", "t", lags, ["A", "B"])
                orig = svc._coalescer._clock
                svc._coalescer._clock = lambda: orig() + 10_000.0
                try:
                    r = c.stream_assign("x", "t", drift, ["A", "B"])
                finally:
                    svc._coalescer._clock = orig
                breaker = svc._watchdog.state("stream")
                r2 = c.stream_assign("x", "t", drift, ["A", "B"])
            finally:
                c.close()
        s = r["stream"]
        pkg.testing.assert_valid_assignment(r["assignments"], 40)
        assert r["assignments"] == first["assignments"]
        return (s["shed"], s["degraded_rung"], s["fallback_used"], breaker,
                r2["stream"]["shed"], r2["stream"]["cold_start"], r2["assignments"])

    got = twin(run)
    assert got[:6] == ({"rung": "admit_deadline", "served": "kept_previous"}, "none",
                       False, "closed", None, False)


# -- the stampede (bench.py's overload_stampede at 16 x 256 x 8) -----------


STAMPEDE_P, STAMPEDE_C, STAMPEDE_ROUNDS = 256, 8, 3
CLASSES = ({f"crit-{i}": "critical" for i in range(4)}
           | {f"std-{i}": "standard" for i in range(4)}
           | {f"be-{i}": "best_effort" for i in range(8)})


def stampede(pkg):
    """bench.py's config 7 at 256 partitions and 3 measured rounds: the
    sidecar as bench.py configures it, every round's 16 requests at once.
    The sidecar's clock (the lag-trend samples' times) steps 1 s a round,
    so both packages see the same trend."""
    members = [f"m{j}" for j in range(STAMPEDE_C)]
    rngs = {sid: np.random.default_rng(7000 + i) for i, sid in enumerate(sorted(CLASSES))}
    lags_now = {sid: rng.integers(10**6, 10**8, STAMPEDE_P).astype(np.int64)
                for sid, rng in rngs.items()}

    def drift(sid):
        bump = rngs[sid].integers(0, 10**6, STAMPEDE_P)
        lags_now[sid] = np.minimum(lags_now[sid] + bump, np.int64(2**31 - 2))
        return lags_now[sid]

    pkg.observability.install_compile_counter()
    clock = FakeClock()
    svc = sidecar(pkg, clock=clock, solve_timeout_s=120.0, slo_classes=CLASSES,
                  slo_deadline_s={"critical": 2.0}, overload_depth_high=6.0,
                  coalesce_window_ms=2.0, coalesce_max_batch=4,
                  coalesce_lock_waves=1 << 30).start()
    svc._overload.eval_interval_s = 0.0
    clients = {sid: pkg.service.AssignorServiceClient(*svc.address, timeout_s=180.0)
               for sid in CLASSES}
    lat = {k: [] for k in ("critical", "standard", "best_effort")}
    errors = dict.fromkeys(lat, 0)
    invalid = [0]
    round_sheds = []
    lock = threading.Lock()

    def one(sid, override=None, record=True, shed=None):
        klass = override or CLASSES[sid]
        t0 = time.perf_counter()
        try:
            r = clients[sid].request("stream_assign", {
                "stream_id": sid, "topic": "t0", "members": members,
                "lags": rows(drift(sid)), **({"slo_class": override} if override else {})})
        except pkg.overload.ShedReject:
            if shed is not None:
                with lock:
                    shed[klass] += 1
            return
        except (RuntimeError, ConnectionError):
            if record:
                with lock:
                    errors[klass] += 1
            return
        if shed is not None and r["stream"]["shed"] is not None:
            with lock:
                shed[klass] += 1
        if record:
            with lock:
                lat[klass].append(time.perf_counter() - t0)
            try:
                pkg.testing.assert_valid_assignment(r["assignments"], STAMPEDE_P)
            except AssertionError:
                with lock:
                    invalid[0] += 1

    pool = cf.ThreadPoolExecutor(max_workers=len(CLASSES))
    try:
        for sid in sorted(CLASSES):
            one(sid, override="standard", record=False)
        clock.t += 1.0
        list(pool.map(lambda s: one(s, record=False), sorted(CLASSES)))
        shed_before = pkg.testing.shed_totals_by_class()
        builds0 = pkg.observability.compile_count()
        for _ in range(STAMPEDE_ROUNDS):
            clock.t += 1.0
            shed = dict.fromkeys(lat, 0)
            list(pool.map(lambda s: one(s, shed=shed), sorted(CLASSES)))
            round_sheds.append(shed)
        builds = pkg.observability.compile_count() - builds0
        shed_after = pkg.testing.shed_totals_by_class()
        recs = []
        for pct in (5, 15, 45):
            arr = lags_now["std-0"]
            lags_now["std-0"] = np.minimum(arr + arr // (100 // pct), np.int64(2**31 - 2))
            clock.t += 1.0
            one("std-0", record=False)
            rec = clients["std-0"].request("recommend", {"stream_id": "std-0"})
            recs.append(rec["streams"]["std-0"]["recommended_consumers"])
    finally:
        pool.shutdown(wait=True)
        for c in clients.values():
            c.close()
        svc.stop()
    return dict(
        lat=lat, errors=errors, invalid=invalid[0], round_sheds=round_sheds, builds=builds,
        shed_by_class={k: v - shed_before.get(k, 0) for k, v in shed_after.items()},
        recs=recs)


def test_stampede_holds_the_overload_gates_in_both_sidecars():
    got = {pkg.name: stampede(pkg) for pkg in PKGS}
    for name, run in got.items():
        crit = run["lat"]["critical"]
        assert crit, f"{name}: no critical request was served"
        assert float(np.percentile(crit, 99)) <= 2.0, (name, crit)
        assert run["errors"] == {"critical": 0, "standard": 0, "best_effort": 0}, name
        assert run["shed_by_class"].get("critical", 0) == 0, name
        for shed in run["round_sheds"]:
            assert shed["critical"] == 0, (name, run["round_sheds"])
            assert not shed["standard"] or shed["best_effort"], (name, run["round_sheds"])
        assert run["invalid"] == 0, name
        assert run["builds"] == 0, name
        assert run["recs"] == sorted(run["recs"]) and run["recs"][-1] > STAMPEDE_C, name
    assert got["port"]["recs"] == got["jax"]["recs"]
