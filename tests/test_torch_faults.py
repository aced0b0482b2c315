"""The port's fault injection against the JAX package's, on the CPU.

* ``FAULT_POINTS`` is the JAX package's set;
* ``FaultInjector``s of both packages with the same seed, plans and
  schedules fire on the same calls, sleep or raise the same way and report
  the same ``snapshot()``; ``parse_spec`` accepts and rejects the same
  ``KLBA_FAULTS`` strings; ``install_from_env`` activates the same plans;
* the ``lag.*`` fault points through the plugin, with
  ``tpu.assignor.lag.retries`` 0 (the rebalance fails in both) and 2 (the
  retry absorbs the fault: the same assignment and one
  ``klba_lag_retries_total`` increment in each registry);
* the streaming engines of both packages at the card's bucket
  (``pad_bucket``) under ``stream.refine``, ``delta.diff``,
  ``delta.apply`` and each ``device.corrupt.*`` plan: the same choice bits,
  statistics, raised errors and quarantine counts at every epoch.

Every comparison is exact (tolerance 0).  Injectors are scoped with
``injected`` or called directly, never left active; registry values are
read as deltas.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.ops.streaming import (  # noqa: E402
    StreamingAssignor as JaxEngine,
)
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import scrub as jax_scrub  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.packing import pad_bucket  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.streaming import (  # noqa: E402
    StreamingAssignor,
)
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    baseline_workload,
    zipf_lags,
)
from kafka_lag_based_assignor_tpu_torch.utils import faults  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import scrub  # noqa: E402
from test_torch_ladder import JAX, PORT, PACKAGES, Plugin  # noqa: E402


def test_fault_points_are_the_jax_set():
    assert faults.FAULT_POINTS == jax_faults.FAULT_POINTS
    assert faults.fault_points() == jax_faults.fault_points()
    assert faults.MAX_HANG_S == jax_faults.MAX_HANG_S
    assert (faults.ENV_SPEC, faults.ENV_SEED) == (jax_faults.ENV_SPEC, jax_faults.ENV_SEED)


def fire_log(inj, mod, calls):
    """Fire ``calls`` (point names, or ("epoch", n) to advance the
    schedule clock) on one injector; the outcome of each."""
    log = []
    for c in calls:
        if isinstance(c, tuple):
            inj.set_epoch(c[1])
            continue
        try:
            inj.fire(c)
            log.append("ok")
        except mod.FaultError as exc:
            log.append(str(exc))
    return log, inj.snapshot(), {p: inj.calls(p) for p in set(calls) if isinstance(p, str)}


S, C_, E = "device.solve", "device.compile", "lag.end"

# (seed, [(method, args, kwargs)], calls)
INJECTOR_CASES = {
    "once": (0, [("plan", (S,), {})], [S] * 3),
    "times_after": (0, [("plan", (S,), {"times": 2, "after": 3})], [S] * 8),
    "unlimited": (0, [("plan", (S,), {"times": 0, "after": 1})], [S] * 5),
    "probability_seed7": (7, [("plan", (S,), {"times": 0, "probability": 0.4})], [S] * 40),
    "probability_seed11": (11, [("plan", (S,), {"times": 5, "probability": 0.5})],
                           [S] * 40),
    "two_points": (3, [("plan", (S,), {"times": 0, "probability": 0.3}),
                       ("plan", (E,), {"times": 0, "probability": 0.6})],
                   [S, E] * 20),
    "hang_bounded": (0, [("plan", (C_,), {"mode": "hang", "delay_s": 0.001})], [C_] * 2),
    "latency_proceeds": (0, [("plan", (E,), {"mode": "latency", "times": 2,
                                            "delay_s": 0.001})], [E] * 3),
    "replaced_plan": (0, [("plan", (S,), {"times": 5}), ("plan", (S,), {"after": 2})],
                      [S] * 4),
    "at_calls": (0, [("schedule", (S,), {"at_calls": [2, 5, 6]})], [S] * 7),
    "at_epochs": (0, [("schedule", (S,), {"at_epochs": [1, 3], "per_epoch": 2})],
                  [S, S, ("epoch", 1), S, S, S, ("epoch", 2), S, ("epoch", 3), S, S, S]),
    "at_epochs_every_call": (0, [("schedule", (S,), {"at_epochs": [2], "per_epoch": 0})],
                             [S, ("epoch", 2), S, S, S, ("epoch", 4), S]),
    "calls_and_epochs": (0, [("schedule", (S,), {"at_calls": [3, 4], "at_epochs": [1]})],
                         [S, ("epoch", 1), S, S, S, S]),
    "unplanned_point": (0, [("plan", (S,), {})], [E, E, S]),
}


@pytest.mark.parametrize("case", sorted(INJECTOR_CASES))
def test_injector_fires_on_the_same_calls_as_jax(case):
    seed, setup, calls = INJECTOR_CASES[case]
    out = {}
    for name, pkg in PACKAGES.items():
        mod = pkg["faults"]
        inj = mod.FaultInjector(seed=seed)
        for method, args, kwargs in setup:
            assert getattr(inj, method)(*args, **kwargs) is inj
        out[name] = fire_log(inj, mod, calls)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("bad", [
    lambda m: m.FaultInjector().plan("no.such.point"),
    lambda m: m.FaultInjector().plan("device.solve", mode="explode"),
    lambda m: m.FaultInjector().plan("device.solve", probability=1.5),
    lambda m: m.FaultInjector().schedule("device.solve"),
    lambda m: m.FaultInjector().schedule("device.solve", at_calls=[-1]),
    lambda m: m.FaultInjector().schedule("nope", at_calls=[1]),
], ids=["point", "mode", "probability", "schedule_empty", "schedule_negative",
        "schedule_point"])
def test_invalid_plans_raise_like_jax(bad):
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError):
            bad(pkg["faults"])


SPECS = [
    "device.solve:raise:2,lag.end:latency:3:0.01",
    "device.compile:hang:1:0.002",
    "stream.refine:raise:0:0.05:0.5",
    " device.solve:raise , ,delta.apply:raise:4 ",
    "device.corrupt.choice:raise",
    "wire.read:raise:1",
    "",
    "device.solve",
    "device.solve:raise:x",
    "device.solve:raise:1:0.05:p",
    "not.a.point:raise",
    "device.solve:explode",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    out = {}
    for name, pkg in PACKAGES.items():
        mod = pkg["faults"]
        try:
            inj = mod.parse_spec(spec, seed=5)
        except ValueError:
            out[name] = "ValueError"
            continue
        calls = sorted(mod.FAULT_POINTS)[:4] + ["device.solve"] * 3 + ["lag.end"] * 4
        plans = {p: (pl.mode, pl.times, pl.after, pl.delay_s, pl.probability)
                 for p, pl in inj._plans.items()}
        out[name] = (inj.seed, plans)
        if "hang" not in spec and "latency" not in spec:
            out[name] += fire_log(inj, mod, calls)
    assert out["port"] == out["jax"]


def test_install_from_env_matches_jax():
    env = {"KLBA_FAULTS": "device.solve:raise:2,lag.end:raise:1", "KLBA_FAULTS_SEED": "9"}
    got = {}
    try:
        for name, pkg in PACKAGES.items():
            mod = pkg["faults"]
            assert mod.install_from_env({}) is None
            inj = mod.install_from_env(env)
            assert mod.active() is inj
            got[name] = (inj.seed, sorted(inj._plans))
    finally:
        jax_faults.deactivate()
        faults.deactivate()
    assert got["port"] == got["jax"] == (9, ["device.solve", "lag.end"])
    assert faults.active() is None and jax_faults.active() is None


def test_fire_is_a_noop_when_inactive_and_injected_scopes():
    assert faults.active() is None
    faults.fire("device.solve")
    inj = faults.FaultInjector().plan("device.solve")
    with faults.injected(inj):
        assert faults.active() is inj
        with pytest.raises(faults.FaultError):
            faults.fire("device.solve")
    assert faults.active() is None
    faults.fire("device.solve")


def test_fired_faults_are_exported_like_jax():
    moved = {}
    for name, pkg in PACKAGES.items():
        m, mod = pkg["metrics"], pkg["faults"]
        ctr = m.REGISTRY.counter("klba_fault_fired_total",
                                 {"point": "lag.begin", "mode": "raise"})
        before = ctr.value
        inj = mod.FaultInjector().plan("lag.begin", times=2)
        for _ in range(3):
            try:
                inj.fire("lag.begin")
            except mod.FaultError:
                pass
        moved[name] = ctr.value - before
    assert moved == {"jax": 2, "port": 2}


# -- lag faults through the plugin ---------------------------------------


@pytest.mark.parametrize("retries", [0, 2])
@pytest.mark.parametrize("point", ["lag.begin", "lag.end", "lag.committed"])
def test_lag_faults_match_jax(point, retries):
    lags, members = baseline_workload(1)
    rpc = {"lag.begin": "beginning_offsets", "lag.end": "end_offsets",
           "lag.committed": "committed"}[point]
    runs = {}
    for name, pkg in PACKAGES.items():
        p = Plugin(pkg, lags, members, "rounds",
                   **{"tpu.assignor.lag.retries": retries,
                      "tpu.assignor.lag.retry.backoff.ms": 0})
        ctr = pkg["metrics"].REGISTRY.counter("klba_lag_retries_total", {"rpc": rpc})
        before = ctr.value
        got, fields, _ = p.assign((point, "raise", {}))
        runs[name] = (got, fields, ctr.value - before)
    assert runs["port"] == runs["jax"]
    if retries:
        assert runs["port"][1] == (False, "closed", None) and runs["port"][2] == 1
    else:
        assert runs["port"] == ("FaultError", None, 0)


# -- the streaming engine ------------------------------------------------

P, C = 3000, 24
KW = dict(num_consumers=C, refine_iters=64, imbalance_guardrail=1.25)


def quarantine_counts(pkg):
    return {(c.labels["buffer"], c.labels["outcome"]): c.value
            for c in pkg["metrics"].REGISTRY.series("klba_quarantine_total")}


class Engines:
    """Both packages' engines at the card's bucket, driven through the
    same epochs, each under its own package's injector for the same plan."""

    def __init__(self, monkeypatch):
        for engine in (JaxEngine, StreamingAssignor):
            monkeypatch.setattr(engine, "_bucket", lambda self, n: pad_bucket(n))
        self.engines = {"jax": JaxEngine(mesh_backend=None, **KW),
                        "port": StreamingAssignor(device="cpu", **KW)}
        self.injectors = {}

    def plan(self, seed, *plans):
        for name, pkg in PACKAGES.items():
            inj = pkg["faults"].FaultInjector(seed=seed)
            for point, kwargs in plans:
                inj.plan(point, **kwargs)
            self.injectors[name] = inj

    def epoch(self, lags):
        out = {}
        for name, pkg in PACKAGES.items():
            engine = self.engines[name]
            before = quarantine_counts(pkg)
            inj = self.injectors.get(name)
            try:
                if inj is None:
                    choice = engine.rebalance(lags)
                else:
                    with pkg["faults"].injected(inj):
                        choice = engine.rebalance(lags)
                got = (choice.tolist(), dataclasses.asdict(engine.last_stats))
            except (pkg["faults"].FaultError, (scrub if pkg is PORT else jax_scrub)
                    .CorruptStateDetected) as exc:
                got = (type(exc).__name__, sorted(getattr(exc, "buffers", [])))
            after = quarantine_counts(pkg)
            out[name] = (got, {k: v - before.get(k, 0) for k, v in after.items()
                               if v != before.get(k, 0)},
                         engine.quarantined,
                         None if inj is None else inj.snapshot())
        assert out["port"] == out["jax"]
        return out["port"]


def drifted(lags, choice, rank, n, factor):
    """Lags with ``n`` partitions of the consumer of load rank ``rank``
    scaled by ``factor``: a warm refine over a few changed rows (a delta
    upload)."""
    out = lags.copy()
    order = np.argsort(np.bincount(choice, weights=out, minlength=C))
    rows = np.flatnonzero(choice == order[rank])[:n]
    out[rows] *= factor
    return out


def run_epochs(engines, n_warm=3):
    """A cold epoch, then ``n_warm`` delta epochs; the outcomes."""
    lags = zipf_lags(np.random.default_rng(4), P)
    results = [engines.epoch(lags)]
    choice = np.asarray(results[0][0][0]) if isinstance(results[0][0][0], list) \
        else None
    for i in range(n_warm):
        if choice is None:  # the cold epoch raised: solve cold again
            results.append(engines.epoch(lags))
            choice = np.asarray(results[-1][0][0])
            continue
        lags = drifted(lags, choice, -1 - i % 2, 12, 4)
        results.append(engines.epoch(lags))
        got = results[-1][0][0]
        if isinstance(got, list):
            choice = np.asarray(got)
    return results


@pytest.mark.parametrize("point,kwargs", [
    ("stream.refine", {"after": 1, "times": 1}),
    ("delta.diff", {"times": 0}),
    ("delta.apply", {"times": 0}),
    ("delta.apply", {"after": 1, "times": 1}),
    ("device.corrupt.choice", {}),
    ("device.corrupt.counts", {}),
    ("device.corrupt.lags", {}),
    ("device.corrupt.row_tab", {}),
    ("device.corrupt.choice", {"after": 1, "times": 1}),
], ids=["stream_refine", "delta_diff", "delta_apply", "delta_apply_once",
        "corrupt_choice", "corrupt_counts", "corrupt_lags", "corrupt_row_tab",
        "corrupt_choice_warm"])
def test_stream_faults_match_jax(point, kwargs, monkeypatch):
    engines = Engines(monkeypatch)
    engines.plan(7, (point, kwargs))
    results = run_epochs(engines)
    outcomes = [r[0][0] if isinstance(r[0][0], str) else "answer" for r in results]
    if point.startswith("device.corrupt") and not kwargs:
        # Flipped as the cold epoch adopts its state; the next dispatch's
        # digest (or the delta's conservation check) catches it.
        assert outcomes[0] == "answer"
        assert any(r[1] for r in results[1:])
    if point == "stream.refine":
        assert outcomes == ["answer", "FaultError", "answer", "answer"]
    if point.startswith("delta"):
        assert outcomes == ["answer"] * 4


def test_corruption_plan_seeds_match_jax():
    plans = {}
    for name, pkg in PACKAGES.items():
        mod = scrub if pkg is PORT else jax_scrub
        assert mod.CORRUPT_POINTS == jax_scrub.CORRUPT_POINTS
        assert mod.corruption_plan(limit=10) == []
        inj = pkg["faults"].FaultInjector(seed=13).plan("device.corrupt.lags", times=2) \
            .plan("device.corrupt.counts", after=1)
        with pkg["faults"].injected(inj):
            plans[name] = [mod.corruption_plan(limit=lim) for lim in (None, 7, 4096)]
    assert plans["port"] == plans["jax"]
    assert plans["port"][0] == [("lags", 13 * 1_000_003 + 97)]


def test_record_quarantine_matches_jax():
    out = {}
    for name, pkg in PACKAGES.items():
        mod = scrub if pkg is PORT else jax_scrub
        before = quarantine_counts(pkg)
        mod.record_quarantine(["choice", "lags"], "quarantined", stream_id="s",
                              source="epoch")
        mod.record_quarantine(["choice"], "healed", source="rebuild")
        after = quarantine_counts(pkg)
        rec = pkg["metrics"].FLIGHT.records()[-2]
        out[name] = ({k: v - before.get(k, 0) for k, v in after.items()
                      if v != before.get(k, 0)},
                     {k: rec[k] for k in ("kind", "buffers", "outcome", "stream_id",
                                          "source")})
    assert out["port"] == out["jax"]
    assert jax_metrics is JAX["metrics"] and metrics is PORT["metrics"]
