"""The port's overload control against the JAX package's, on the CPU.

* ``parse_config`` over the sidecar's keys (``delta.*``, ``slo.class.*``,
  ``slo.deadline.ms.*``, ``overload.*``, ``metrics.port``, ``quality.*``):
  the same values accepted into the same fields, the same values rejected;
* ``SloPolicy``: the same classes, budgets and rejections;
* ``OverloadController``: one scripted sequence of depth feeds, epoch
  latencies, breaker states and admissions, each package's controller on
  its own copy of one scripted clock, gives the same decisions,
  snapshots, exported state and shed series;
* ``recommend_consumers`` / ``recommend_payload`` give the same numbers;
* over the wire, at a restored ladder rung: a ``best_effort`` stream is
  rejected with the structured ``shed`` envelope (the port's client
  raises ``ShedReject`` from its fields), degraded to ``kept_previous`` a
  rung lower, and admitted when the ``shed.decide`` fault point fails the
  decision — in both services alike.

Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import service as jax_service  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import config as jax_config  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import overload as jax_overload  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import service  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import config  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import overload  # noqa: E402
from test_torch_service import Twin, both_injected, rows, stream_case  # noqa: E402

SIDECAR_FIELDS = ("delta_enabled", "delta_max_fraction", "delta_buckets",
                  "delta_adaptive", "slo_classes", "slo_deadline_s",
                  "overload_latency_budget_ms", "overload_depth_high",
                  "metrics_port", "quality_mode", "quality_tile")

CONFIG_CASES = [
    ({}, "defaults"),
    ({"tpu.assignor.delta.enabled": "false"}, "delta_off"),
    ({"tpu.assignor.delta.max.fraction": "0.5"}, "fraction_half"),
    ({"tpu.assignor.delta.max.fraction": "0"}, "fraction_zero"),
    ({"tpu.assignor.delta.max.fraction": "1.5"}, "fraction_big"),
    ({"tpu.assignor.delta.max.fraction": "x"}, "fraction_text"),
    ({"tpu.assignor.delta.buckets": "0"}, "buckets_0"),
    ({"tpu.assignor.delta.buckets": "16"}, "buckets_16"),
    ({"tpu.assignor.delta.buckets": "17"}, "buckets_17"),
    ({"tpu.assignor.delta.buckets": "-1"}, "buckets_negative"),
    ({"tpu.assignor.delta.adaptive": "no"}, "adaptive_no"),
    ({"tpu.assignor.slo.class.orders": "critical",
      "tpu.assignor.slo.class.audit": "best_effort"}, "classes"),
    ({"tpu.assignor.slo.class.orders": "gold"}, "class_unknown"),
    ({"tpu.assignor.slo.class.": "critical"}, "class_no_stream"),
    ({"tpu.assignor.slo.deadline.ms.critical": "250"}, "deadline"),
    ({"tpu.assignor.slo.deadline.ms.gold": "250"}, "deadline_unknown"),
    ({"tpu.assignor.slo.deadline.ms.standard": "0"}, "deadline_zero"),
    ({"tpu.assignor.slo.deadline.ms.standard": "-5"}, "deadline_negative"),
    ({"tpu.assignor.overload.latency.budget.ms": "1500"}, "latency"),
    ({"tpu.assignor.overload.latency.budget.ms": "-1"}, "latency_negative"),
    ({"tpu.assignor.overload.depth.high": "3.5"}, "depth"),
    ({"tpu.assignor.overload.depth.high": "0"}, "depth_zero"),
    ({"tpu.assignor.overload.depth.high": "deep"}, "depth_text"),
    ({"tpu.assignor.metrics.port": "9100"}, "metrics_port"),
    ({"tpu.assignor.metrics.port": "0"}, "metrics_port_0"),
    ({"tpu.assignor.metrics.port": "-1"}, "metrics_port_negative"),
    ({"tpu.assignor.quality.mode": "linear",
      "tpu.assignor.quality.tile": "64"}, "quality"),
    ({"tpu.assignor.quality.tile": "100"}, "quality_tile_not_pow2"),
]


def parsed(module, extra):
    try:
        cfg = module.parse_config({"group.id": "g", **extra})
    except ValueError:
        return "ValueError"
    return {f: getattr(cfg, f) for f in SIDECAR_FIELDS}


@pytest.mark.parametrize("extra", [c for c, _ in CONFIG_CASES],
                         ids=[i for _, i in CONFIG_CASES])
def test_sidecar_keys_parse_like_jax(extra):
    assert parsed(config, extra) == parsed(jax_config, extra)


def test_sidecar_key_names_are_jax_names():
    for name in ("DELTA_ENABLED_CONFIG", "DELTA_MAX_FRACTION_CONFIG",
                 "DELTA_BUCKETS_CONFIG", "DELTA_ADAPTIVE_CONFIG",
                 "SLO_CLASS_PREFIX", "SLO_DEADLINE_PREFIX",
                 "OVERLOAD_LATENCY_BUDGET_CONFIG", "OVERLOAD_DEPTH_HIGH_CONFIG",
                 "METRICS_PORT_CONFIG"):
        assert getattr(config, name) == getattr(jax_config, name)


def test_constants_are_jax_constants():
    for name in ("SLO_CLASSES", "CLASS_WEIGHTS", "RUNGS", "_WINDOW_SCALE",
                 "_WINDOW_SCALE_BY_RANK", "_THRESHOLDS"):
        assert getattr(overload, name) == getattr(jax_overload, name)
    for klass in overload.SLO_CLASSES:
        assert overload.class_rank(klass) == jax_overload.class_rank(klass)


def outcome(fn):
    try:
        return fn()
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("classes,deadlines", [
    ({}, {}),
    ({"orders": "critical", "audit": "best_effort"}, {"critical": 0.25}),
    ({"orders": "gold"}, {}),
    ({}, {"platinum": 1.0}),
    ({}, {"standard": 0.0}),
])
def test_slo_policy_matches_jax(classes, deadlines):
    def run(module):
        policy = outcome(lambda: module.SloPolicy(classes=classes,
                                                  deadline_s=deadlines))
        if isinstance(policy, tuple):
            return policy
        cases = [("orders", None), ("audit", None), ("other", None),
                 (None, None), (7, None), ("orders", "best_effort"),
                 ("audit", "nope")]
        return ([outcome(lambda s=s, o=o: policy.resolve(s, o)) for s, o in cases]
                + [policy.budget_s(k, t) for k in module.SLO_CLASSES
                   for t in (None, 0.1, 120.0)]
                + [policy.deadline_s(k) for k in module.SLO_CLASSES])

    assert run(overload) == run(jax_overload)


class ScriptClock:
    def __init__(self):
        self.now = 50.0

    def __call__(self):
        return self.now


# (op, argument): feed a depth, observe an epoch latency (ms), set the
# stream breaker, step the clock, or ask for an admission of a class.
SCRIPT = (
    [("admit", k) for k in ("critical", "standard", "best_effort")]
    + [("depth", 30.0), ("step", 0.2), ("admit", "standard"),
       ("depth", 60.0), ("depth", 90.0), ("step", 0.2),
       ("admit", "best_effort"), ("admit", "standard"), ("admit", "critical"),
       ("depth", 120.0), ("admit", "best_effort"), ("depth", 200.0),
       ("depth", 200.0), ("depth", 200.0), ("step", 0.2), ("admit", "best_effort"),
       ("admit", "standard")]
    + [("depth", 0.0)] * 12
    + [x for _ in range(6) for x in (("step", 0.5), ("admit", "best_effort"))]
    + [("epoch_ms", 250.0), ("epoch_ms", 900.0), ("step", 0.2),
       ("admit", "standard"), ("breaker", True), ("step", 0.2),
       ("admit", "best_effort"), ("breaker", False)]
    + [x for _ in range(8) for x in (("step", 1.1), ("admit", "critical"))]
)


def drive(module, metrics_module):
    clock = ScriptClock()
    breaker = {"open": False}
    ctl = module.OverloadController(
        latency_budget_ms=400.0, depth_high=24.0, cooldown_s=1.0,
        eval_interval_s=0.1, clock=clock, breaker_open=lambda: breaker["open"],
    )
    hist = metrics_module.REGISTRY.histogram("klba_span_duration_ms",
                                             {"span": "stream.epoch"})
    log = []
    for op, arg in SCRIPT:
        if op == "depth":
            ctl.note_depth(arg)
        elif op == "epoch_ms":
            hist.observe(arg)
        elif op == "breaker":
            breaker["open"] = arg
        elif op == "step":
            clock.now += arg
        else:
            d = ctl.admission(arg)
            log.append((arg, d.action, d.rung, d.rung_name, d.retry_after_ms,
                        d.window_scale, d.window_scales, ctl.rung(),
                        ctl.snapshot(), ctl.export_state()))
            if d.action != "admit":
                ctl.note_shed(arg, d.rung_name, d.action, stream_id="s")
    ctl.add_standing_pressure(6.0)
    clock.now += 0.2
    log.append(ctl.admission("standard").window_scales)
    ctl.release_standing_pressure(10.0)
    ctl.seed_recovery_depth(48.0)
    log.append((ctl.admission("best_effort").action, ctl.snapshot()))
    ctl.restore_state({"rung": 9, "pressure": "x"})
    ctl.restore_state({"rung": 9, "pressure": 1.0, "ewma_depth": 2.0})
    log.append((ctl.rung(), ctl.standing_pressure(), ctl.export_state()))
    return log


def shed_counts(metrics_module):
    return {tuple(sorted(s.labels.items())): s.value
            for s in metrics_module.REGISTRY.series("klba_shed_total")}


def test_controller_decisions_match_jax():
    before = shed_counts(jax_metrics), shed_counts(metrics)
    got = drive(overload, metrics)
    want = drive(jax_overload, jax_metrics)
    assert got == want
    rungs = {entry[2] for entry in got if isinstance(entry, tuple) and len(entry) == 10}
    assert {0, 1, 2, 3, 4} <= rungs  # the script walks the ladder
    moved = [{k: v - b.get(k, 0) for k, v in shed_counts(m).items()
              if v != b.get(k, 0)} for m, b in zip((jax_metrics, metrics), before)]
    assert moved[1] == moved[0] and moved[1]


def test_controller_rejects_bad_knobs_like_jax():
    for kw in ({"latency_budget_ms": 0}, {"depth_high": -1.0}):
        assert (outcome(lambda: overload.OverloadController(**kw))
                == outcome(lambda: jax_overload.OverloadController(**kw)))


TRENDS = [
    [],
    [(0.0, 100.0)],
    [(5.0, 100.0), (5.0, 900.0)],
    [(0.0, 1000.0), (30.0, 4000.0), (60.0, 9000.0)],
    [(0.0, 9000.0), (60.0, 100.0)],
    [(0.0, 0.0), (10.0, 0.0)],
]


@pytest.mark.parametrize("samples", TRENDS)
@pytest.mark.parametrize("consumers,partitions", [(4, 64), (30, 8), (1, 1)])
def test_recommendation_matches_jax(samples, consumers, partitions):
    for horizon in (1.0, 60.0, 3600.0):
        assert (overload.recommend_consumers(samples, consumers, partitions, horizon)
                == jax_overload.recommend_consumers(samples, consumers, partitions,
                                                    horizon))
    streams = {"s": {"slo_class": "standard", "consumers": consumers,
                     "partitions": partitions, "samples": samples}}
    for rung in (0, 2):
        state = {"rung": overload.RUNGS[rung], "rung_index": rung}
        assert (overload.recommend_payload(streams, state, 90.0)
                == jax_overload.recommend_payload(streams, state, 90.0))


def test_shed_envelopes_over_the_wire():
    """At a restored rung 3 a best_effort stream is REJECTED with the
    structured envelope (standard still solves); at rung 2 a best_effort
    stream with a servable previous choice is served ``kept_previous``;
    under a ``shed.decide`` fault the admission fails open."""
    lags = np.arange(1, 129, dtype=np.int64) * 100
    pair = Twin(overload_cooldown_s=600.0)
    try:
        for sid in ("be", "std"):
            stream_case(pair, sid, lags)

        def rung(index, depth):
            for svc in (pair.jax, pair.port):
                svc._overload.restore_state(
                    {"rung": index, "pressure": depth / 24.0, "ewma_depth": depth})

        rung(3, 62.4)
        best_effort = {"stream_id": "be", "topic": "t0", "lags": rows(lags),
                       "members": ["A", "B"], "slo_class": "best_effort"}
        r = pair.same("stream_assign", best_effort)
        assert r["error"]["shed"] == {"class": "best_effort",
                                      "rung": "reject_best_effort",
                                      "retry_after_ms": 5000}
        # Each package's client raises its ShedReject from the envelope.
        for module, svc, pkg in ((jax_overload, pair.jax, jax_service),
                                 (overload, pair.port, service)):
            with pkg.AssignorServiceClient(*svc.address) as c:
                with pytest.raises(module.ShedReject) as info:
                    c.request("stream_assign", best_effort)
                assert info.value.trace_id == c.last_trace_id is not None
            assert (info.value.klass, info.value.rung, info.value.retry_after_ms) == (
                "best_effort", "reject_best_effort", 5000)
        assert stream_case(pair, "std", lags)["shed"] is None
        rung(2, 40.0)
        s = stream_case(pair, "be", lags * 3, slo_class="best_effort")
        assert s["shed"] == {"rung": "degrade_best_effort", "served": "kept_previous"}
        assert s["churn"] == 0 and not s["fallback_used"]
        rung(3, 62.4)
        with both_injected("shed.decide", mode="raise", times=1):
            s = stream_case(pair, "be", lags, slo_class="best_effort")
        assert s["shed"] is None and s["degraded_rung"] == "none"
        stats = pair.same("stats")["result"]["overload"]
        assert stats["rung"] == "reject_best_effort"
        pair.series_moved_alike()
    finally:
        pair.close()
