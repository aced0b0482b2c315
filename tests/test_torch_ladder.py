"""The port's fault ladder against the JAX package's, on the CPU.

* ``parse_config`` over the ladder's keys (``host.fallback``, ``profile``,
  ``solve.timeout.ms``, ``breaker.cooldown.ms``, ``breaker.failures``):
  the same values accepted, the same fields, the same values rejected;
* ``Watchdog``: scripted sequences of calls (the cases of the JAX
  package's ``tests/test_watchdog.py``) on both packages' watchdogs, each
  with its own fake clock, give the same outcomes, ``state()``,
  ``stats()``, ``export_state()`` and registry counter deltas;
* the plugin on ``device="cpu"`` for ``rounds``, ``scan``, ``global``,
  ``sinkhorn`` and ``native``, at the README example and BASELINE config 3,
  with no fault, under ``device.solve`` and ``device.compile`` raise plans,
  a ``device.solve`` hang past the timeout, an open breaker, after
  ``reset_accelerator()``, and with ``host.fallback=false``: the same
  ``GroupAssignment`` (member list order included), ``fallback_used``,
  ``breaker_state`` and ``refine_iters``, and the same counter and
  histogram series moved in each package's own registry, or both raise;
* a kernel build the watchdog abandons still finishes and is reused.

Every comparison is exact (tolerance 0): assignments, states and counts
are integers and strings.  Fault plans are scoped with ``injected`` (one
package's injector at a time); registry values are read as deltas; the
hang drills wait for their abandoned workers before the next case.
"""

import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.assignor import (  # noqa: E402
    LagBasedPartitionAssignor as JaxAssignor,
)
from kafka_lag_based_assignor_tpu.testing import FakeBroker as JaxBroker  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import config as jax_config  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import trace as jax_trace  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import watchdog as jax_watchdog  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.assignor import (  # noqa: E402
    LagBasedPartitionAssignor,
)
from kafka_lag_based_assignor_tpu_torch.ops import _build  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    baseline_workload,
    broker_for,
)
from kafka_lag_based_assignor_tpu_torch.types import (  # noqa: E402
    GroupSubscription,
    Subscription,
)
from kafka_lag_based_assignor_tpu_torch.utils import config  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import faults  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import observability  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import trace  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import watchdog  # noqa: E402
import test_torch_native  # noqa: E402

jax_native_core = test_torch_native.jax_native_core

JAX = dict(config=jax_config, faults=jax_faults, metrics=jax_metrics,
           trace=jax_trace, watchdog=jax_watchdog, assignor=JaxAssignor)
PORT = dict(config=config, faults=faults, metrics=metrics, trace=trace,
            watchdog=watchdog, assignor=LagBasedPartitionAssignor)
PACKAGES = {"jax": JAX, "port": PORT}


# -- parse_config --------------------------------------------------------

LADDER_FIELDS = ("host_fallback", "profile", "solve_timeout_s",
                 "breaker_cooldown_s", "breaker_failures")

# (key, raw value): valid, invalid and odd values of each ladder key.
CONFIG_CASES = [
    ({}, "defaults"),
    ({"tpu.assignor.host.fallback": "false"}, "fallback_false"),
    ({"tpu.assignor.host.fallback": "maybe"}, "fallback_maybe"),
    ({"tpu.assignor.host.fallback": "YES"}, "fallback_yes"),
    ({"tpu.assignor.host.fallback": 0}, "fallback_int0"),
    ({"tpu.assignor.host.fallback": True}, "fallback_bool"),
    ({"tpu.assignor.profile": "1"}, "profile_1"),
    ({"tpu.assignor.profile": "on"}, "profile_on"),
    ({"tpu.assignor.solve.timeout.ms": "2500"}, "timeout_2500"),
    ({"tpu.assignor.solve.timeout.ms": 0}, "timeout_0"),
    ({"tpu.assignor.solve.timeout.ms": -5}, "timeout_negative"),
    ({"tpu.assignor.solve.timeout.ms": ""}, "timeout_empty"),
    ({"tpu.assignor.solve.timeout.ms": None}, "timeout_none"),
    ({"tpu.assignor.solve.timeout.ms": "abc"}, "timeout_abc"),
    ({"tpu.assignor.solve.timeout.ms": "1e3"}, "timeout_1e3"),
    ({"tpu.assignor.breaker.cooldown.ms": "1500"}, "cooldown_1500"),
    ({"tpu.assignor.breaker.cooldown.ms": "-1"}, "cooldown_negative"),
    ({"tpu.assignor.breaker.cooldown.ms": "soon"}, "cooldown_soon"),
    ({"tpu.assignor.breaker.cooldown.ms": 0}, "cooldown_0"),
    ({"tpu.assignor.breaker.failures": "5"}, "failures_5"),
    ({"tpu.assignor.breaker.failures": "0"}, "failures_0"),
    ({"tpu.assignor.breaker.failures": "2.5"}, "failures_2_5"),
    ({"tpu.assignor.breaker.failures": 1}, "failures_1"),
]


def parsed(pkg, extra):
    try:
        cfg = pkg["config"].parse_config({"group.id": "g", **extra})
    except ValueError:
        return "ValueError"
    return {f: getattr(cfg, f) for f in LADDER_FIELDS}


@pytest.mark.parametrize("extra", [c for c, _ in CONFIG_CASES],
                         ids=[i for _, i in CONFIG_CASES])
def test_ladder_keys_parse_like_jax(extra):
    assert parsed(PORT, extra) == parsed(JAX, extra)


def test_ladder_key_names_are_jax_names():
    for name in ("FALLBACK_CONFIG", "PROFILE_CONFIG", "SOLVE_TIMEOUT_CONFIG",
                 "BREAKER_COOLDOWN_CONFIG", "BREAKER_FAILURES_CONFIG"):
        assert getattr(config, name) == getattr(jax_config, name)
    assert parsed(PORT, {})["solve_timeout_s"] == 120.0


# -- Watchdog ------------------------------------------------------------


class FakeClock:
    """Deterministic monotonic clock for cooldown/half-open sequences."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


class Script:
    """One package's watchdog driven through a script; ``log`` collects
    every call's outcome (a value or an exception class name)."""

    def __init__(self, pkg, **kw):
        self.mod = pkg["watchdog"]
        self.metrics = pkg["metrics"]
        self.clock = FakeClock()
        self.wd = self.mod.Watchdog(clock=self.clock, **kw)
        self.log = []
        self.release = threading.Event()

    def hang(self):
        self.release.wait(5)
        return "late"

    def call(self, fn, *args, **kw):
        try:
            self.log.append(self.wd.call(fn, *args, **kw))
        except (self.mod.SolveTimeout, ZeroDivisionError, KeyboardInterrupt) as exc:
            rejected = isinstance(exc, self.mod.SolveRejected)
            self.log.append(("Rejected" if rejected else type(exc).__name__))

    def snapshot(self):
        return {"state": {k: self.wd.state(k) for k in ("device", "sinkhorn", "rounds")},
                "stats": self.wd.stats(), "export": self.wd.export_state(),
                "tripped": self.wd.tripped}


def boom():
    return 1 / 0


def interrupted():
    raise KeyboardInterrupt


def s_fast(s):
    s.call(lambda x: x + 1, 41)


def s_timeout_trips(s):
    s.call(s.hang)
    s.call(lambda: 1)


def s_reset(s):
    s.call(s.hang)
    s.wd.reset()
    s.call(lambda: "ok")


def s_cooldown_probe(s):
    s.call(s.hang)
    s.clock.advance(300.1)
    s.log.append(s.wd.state())
    s.call(lambda: "recovered")


def s_probe_failure_reopens(s):
    s.call(s.hang)
    s.clock.advance(300.1)
    s.call(boom)
    s.call(lambda: "never")


def s_consecutive_exceptions(s):
    for _ in range(3):
        s.call(boom)
    s.call(lambda: "never")
    s.wd.reset()
    for _ in range(2):
        s.call(boom)
    s.call(lambda: "ok")


def s_per_key(s):
    s.call(s.hang, key="sinkhorn")
    s.call(lambda: 7, key="rounds")


def s_budget_exhausted(s):
    s.call(lambda: "never", timeout_s=0.0)
    s.call(lambda: "never", key="other", timeout_s=-1.0)


def s_truncated_budget(s):
    s.call(s.hang, timeout_s=0.02)  # a residual budget: no trip


def s_class_budget(s):
    s.call(s.hang, timeout_s=0.02, budget_total_s=0.02)


def s_straggler(s):
    s.call(boom)  # threshold 1 below: trips
    s.clock.advance(9.0)
    s.wd._on_exception("device", probing=False)
    s.clock.advance(1.1)


def s_shed_passthrough(s):
    def shed():
        raise s.mod.SolveRejected("deadline budget expired while parked")
    s.call(shed)
    s.call(lambda: 1)


def s_base_exception(s):
    s.call(interrupted)
    s.call(lambda: "still serving")


def s_restore_state(s):
    s.call(s.hang)
    s.clock.advance(100.0)
    exported = s.wd.export_state()
    s.wd.restore_state({"device": exported["device"], "bad": {"trips": "x"}})
    s.call(lambda: "still open")


def s_trip_breaker(s):
    s.wd.trip_breaker("rounds")
    s.call(lambda: "never", key="rounds")
    s.clock.advance(300.1)
    s.call(lambda: "probe", key="rounds")


# (name, script, Watchdog arguments)
WATCHDOG_CASES = [
    ("fast", s_fast, {}),
    ("timeout_trips", s_timeout_trips, {}),
    ("reset", s_reset, {}),
    ("cooldown_probe", s_cooldown_probe, {}),
    ("probe_failure_reopens", s_probe_failure_reopens, {"failure_threshold": 99}),
    ("consecutive_exceptions", s_consecutive_exceptions, {}),
    ("per_key", s_per_key, {}),
    ("budget_exhausted", s_budget_exhausted, {"timeout_s": 5.0}),
    ("truncated_budget", s_truncated_budget, {"timeout_s": 30.0}),
    ("class_budget", s_class_budget, {"timeout_s": 30.0}),
    ("straggler", s_straggler, {"timeout_s": 5.0, "failure_threshold": 1,
                                "cooldown_s": 10.0}),
    ("shed_passthrough", s_shed_passthrough, {"timeout_s": 5.0}),
    ("base_exception", s_base_exception, {"timeout_s": 5.0, "failure_threshold": 1}),
    ("restore_state", s_restore_state, {}),
    ("trip_breaker", s_trip_breaker, {}),
    ("inline", s_fast, {"timeout_s": None}),
]

WATCHDOG_SERIES = ("klba_solve_timeouts_total", "klba_solve_rejected_total",
                   "klba_breaker_trips_total", "klba_solve_duration_ms")


def series_values(pkg, names):
    """{(name, labels): value or histogram count} of the named series."""
    out = {}
    for name in names:
        for child in pkg["metrics"].REGISTRY.series(name):
            key = (name, tuple(sorted(child.labels.items())))
            out[key] = child.count if hasattr(child, "count") else child.value
    return out


def deltas(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.mark.parametrize("script,kw", [(s, k) for _, s, k in WATCHDOG_CASES],
                         ids=[n for n, _, _ in WATCHDOG_CASES])
def test_watchdog_sequences_match_jax(script, kw):
    kw = {"timeout_s": 0.05, **kw}
    existing = set(threading.enumerate())
    results = {}
    for name, pkg in PACKAGES.items():
        s = Script(pkg, **kw)
        before = series_values(pkg, WATCHDOG_SERIES)
        try:
            script(s)
        finally:
            s.release.set()
        results[name] = (s.log, s.snapshot(),
                         deltas(before, series_values(pkg, WATCHDOG_SERIES)))
    assert results["port"] == results["jax"]
    join_abandoned_workers(existing)


def test_watchdog_worker_adopts_the_request_scope():
    seen = {}
    for name, pkg in PACKAGES.items():
        wd = pkg["watchdog"].Watchdog(timeout_s=5.0)
        m = pkg["metrics"]
        with m.request_scope(request_id=f"req-{name}"):
            with m.span("assign.solve"):
                seen[name] = wd.call(lambda: (m.current_request_id(),
                                              threading.current_thread().name))
    assert seen["port"] == ("req-port", "klba-solve")
    assert seen["jax"] == ("req-jax", "klba-solve")


def join_abandoned_workers(existing, timeout=5.0):
    """Wait for the ``klba-solve`` workers started since ``existing`` (a
    set of threads): the ones this case's drills abandoned.  Workers that
    other tests of the process abandoned are not this case's to wait for."""
    for t in threading.enumerate():
        if t.name == "klba-solve" and t not in existing:
            t.join(timeout)
            assert not t.is_alive()


# -- the plugin ----------------------------------------------------------

LADDER_SOLVERS = ["rounds", "scan", "global", "sinkhorn", "native"]
WORKLOADS = {"readme": 1, "config3": 3}
# Series that count package-specific work, left out of the comparison:
# XLA compiles and value-derived static arguments are the JAX package's
# (its process-wide state depends on the other tests run in the worker);
# the port counts its kernel builds there.
NOT_COMPARED = {"klba_compile_total", "klba_static_drift_total"}


def moved_series(before, after):
    """The counter and histogram series whose value or count changed."""
    out = set()
    for name, entry in after.items():
        if name in NOT_COMPARED or entry["type"] == "gauge":
            continue
        prior = {tuple(sorted(s["labels"].items())): s
                 for s in before.get(name, {}).get("series", [])}
        for s in entry["series"]:
            key = tuple(sorted(s["labels"].items()))
            field = "count" if entry["type"] == "histogram" else "value"
            if s[field] != prior.get(key, {}).get(field, 0):
                out.add((name, key))
    return out


def jax_broker_for(lags):
    broker = JaxBroker()
    for topic, arr in lags.items():
        for p, value in enumerate(arr.tolist()):
            broker.with_partition(topic, p, end=value, committed=0)
    return broker


# The solve's deadline where a case does not set one: long enough that a
# CPU solve slowed by a loaded test host never times out by accident (the
# solve still runs in the watchdog's worker thread, as at the default).
CASE_TIMEOUT_MS = 600_000


class Plugin:
    """One package's plugin on one workload."""

    def __init__(self, pkg, lags, members, solver, **configs):
        self.pkg = pkg
        self.broker = (broker_for if pkg is PORT else jax_broker_for)(lags)
        kw = {"device": "cpu"} if pkg is PORT else {}
        self.assignor = pkg["assignor"](lambda props: self.broker, **kw)
        configs = {"tpu.assignor.solve.timeout.ms": CASE_TIMEOUT_MS, **configs}
        self.assignor.configure({"group.id": "g", "tpu.assignor.solver": solver,
                                 **{k: str(v) for k, v in configs.items()}})
        self.group = GroupSubscription(
            {m: Subscription(tuple(sorted(lags))) for m in members})

    def assign(self, plan=None):
        """One assign(): (assignment pairs or the exception's class name,
        the ladder fields of last_stats, the registry series it moved)."""
        inj = None
        if plan is not None:
            inj = self.pkg["faults"].FaultInjector(seed=3).plan(*plan[:2], **plan[2])
        before = self.pkg["metrics"].REGISTRY.snapshot()
        existing = set(threading.enumerate())
        self.assignor.last_stats = None
        try:
            if inj is None:
                out = self.assignor.assign(self.broker.cluster(), self.group)
            else:
                # The abandoned worker is waited for with the plan still
                # active: a worker that starts late still meets its fault.
                with self.pkg["faults"].injected(inj):
                    try:
                        out = self.assignor.assign(self.broker.cluster(), self.group)
                    finally:
                        join_abandoned_workers(existing)
            got = {m: [(tp.topic, tp.partition) for tp in a.partitions]
                   for m, a in out.group_assignment.items()}
        except Exception as exc:  # noqa: BLE001 — compared across packages
            got = type(exc).__name__
        finally:
            join_abandoned_workers(existing)
        stats = self.assignor.last_stats
        fields = None if stats is None else (
            stats.fallback_used, stats.breaker_state, stats.refine_iters)
        moved = moved_series(before, self.pkg["metrics"].REGISTRY.snapshot())
        return got, fields, moved


RAISE_SOLVE = ("device.solve", "raise", {})
RAISE_COMPILE = ("device.compile", "raise", {})
HANG = ("device.solve", "hang", {"delay_s": 0.3})


def sc_none(p):
    return [p.assign()]


def sc_solve_raise(p):
    return [p.assign(RAISE_SOLVE)]


def sc_compile_raise(p):
    return [p.assign(RAISE_COMPILE)]


def sc_hang(p):
    return [p.assign(HANG)]


def sc_open_breaker(p):
    return [p.assign(RAISE_SOLVE), p.assign()]


def sc_reset(p):
    first = p.assign(RAISE_SOLVE)
    p.assignor.reset_accelerator()
    return [first, p.assign()]


def sc_no_fallback(p):
    return [p.assign(RAISE_SOLVE)]


# (scenario, its plugin configs)
SCENARIOS = {
    "none": (sc_none, {}),
    "solve_raise": (sc_solve_raise, {}),
    "compile_raise": (sc_compile_raise, {}),
    "hang": (sc_hang, {"tpu.assignor.solve.timeout.ms": 100}),
    "open_breaker": (sc_open_breaker, {"tpu.assignor.breaker.failures": 1}),
    "reset": (sc_reset, {"tpu.assignor.breaker.failures": 1}),
    "no_fallback": (sc_no_fallback, {"tpu.assignor.host.fallback": "false"}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU solves here are many small ops: one intra-op thread
    runs them faster than eight and leaves the other test workers' cores
    alone."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def sample_every_trace(monkeypatch):
    """Keep every finished trace in both packages, so the trace outcome
    counters move the same way (healthy traces are otherwise sampled by
    their random ids)."""
    monkeypatch.setattr(jax_trace.COLLECTOR, "sample_rate", 1.0)
    monkeypatch.setattr(trace.COLLECTOR, "sample_rate", 1.0)


@pytest.mark.usefixtures("jax_native_core", "sample_every_trace")
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("solver", LADDER_SOLVERS)
def test_plugin_ladder_matches_jax(solver, workload, scenario):
    lags, members = baseline_workload(WORKLOADS[workload])
    script, configs = SCENARIOS[scenario]
    runs = {name: script(Plugin(pkg, lags, members, solver, **configs))
            for name, pkg in PACKAGES.items()}
    assert runs["port"] == runs["jax"]
    outcomes = [(got if isinstance(got, str) else "answer", fields)
                for got, fields, _ in runs["port"]]
    device_faulted = scenario in ("solve_raise", "hang") or (
        scenario == "compile_raise" and solver in ("rounds", "scan", "global"))
    if scenario == "no_fallback":
        assert outcomes == [("FaultError", None)]
    elif scenario in ("open_breaker", "reset"):
        assert outcomes[0] == ("answer", (True, "open", None))
        assert outcomes[1][1][:2] == ((True, "open") if scenario == "open_breaker"
                                      else (False, "closed"))
    else:
        fallback, state, _ = outcomes[0][1]
        assert fallback == device_faulted
        assert state == ("open" if scenario == "hang" else "closed")
    rung = ("klba_ladder_rung_total", (("method", "assign"), ("rung", "host_greedy")))
    for (got, fields, moved) in runs["port"]:
        if fields is not None:
            assert (rung in moved) == fields[0]


@pytest.mark.parametrize("solver", ["rounds", "global"])
def test_host_rung_is_the_reference_greedy_not_the_plain_kernels(solver, monkeypatch):
    """The host rung never runs the port's device code: with every
    dispatch entry broken, an open breaker still answers, from the greedy
    oracle the solver falls back to."""
    from kafka_lag_based_assignor_tpu_torch.models import greedy
    from kafka_lag_based_assignor_tpu_torch.ops import dispatch
    from kafka_lag_based_assignor_tpu_torch.testing import lag_rows

    lags, members = baseline_workload(3)
    p = Plugin(PORT, lags, members, solver, **{"tpu.assignor.breaker.failures": 1})
    p.assign(RAISE_SOLVE)

    def broken(*args, **kwargs):
        raise AssertionError("the host rung reached the device dispatch")

    monkeypatch.setattr(dispatch, "assign_group_device", broken)
    got, fields, _ = p.assign()
    assert fields[:2] == (True, "open")
    assert p.assignor.last_stats.device is None
    want = greedy.host_fallback_for(solver)(lag_rows(lags),
                                            {m: sorted(lags) for m in members})
    assert got == {m: [(tp.topic, tp.partition) for tp in tps] for m, tps in want.items()}


def test_fallback_writes_one_flight_dump_and_a_rebalance_record():
    lags, members = baseline_workload(1)
    dumps = {}
    for name, pkg in PACKAGES.items():
        p = Plugin(pkg, lags, members, "rounds")
        before = pkg["metrics"].FLIGHT.dump_count()
        p.assign(RAISE_SOLVE)
        flight = pkg["metrics"].FLIGHT
        last = flight.last_dump()
        dumps[name] = (flight.dump_count() - before, last["reason"], last["detail"],
                       flight.records()[-1]["kind"], flight.records()[-1]["fallback_used"])
    assert dumps["port"] == dumps["jax"] == (1, "ladder", {"method": "assign",
                                                           "rung": "host_greedy"},
                                             "rebalance", True)


def test_profile_key_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(observability, "default_trace_dir", lambda: str(tmp_path))
    lags, members = baseline_workload(1)
    p = Plugin(PORT, lags, members, "rounds", **{"tpu.assignor.profile": "true"})
    got, fields, _ = p.assign()
    assert fields[0] is False
    traces = list(tmp_path.glob("klba-*.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


# -- a build the watchdog abandons ---------------------------------------


def test_abandoned_kernel_build_finishes_and_is_reused(tmp_path, monkeypatch):
    """A first-use build slower than the deadline times the solve out;
    the build finishes in the abandoned worker, is counted once, and the
    next load reuses it without building again.  A stand-in compiler
    (sleeps, then writes a loadable library: a copy of the native core
    that the port builds with ``g++``) takes nvcc's place."""
    from kafka_lag_based_assignor_tpu_torch import native

    real_lib = native.library_path()
    native.load()  # the g++ build: a real shared library to stand in
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys, time\n"
        "time.sleep(0.5)\n"
        f"shutil.copy({str(real_lib)!r}, sys.argv[sys.argv.index('-o') + 1])\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(observability, "_compile_counter_installed", [True])

    before = observability.compile_count()
    existing = set(threading.enumerate())
    wd = watchdog.Watchdog(timeout_s=0.1)
    with pytest.raises(watchdog.SolveTimeout):
        wd.call(_build.load, "state_digest", key="build")
    join_abandoned_workers(existing)
    assert observability.compile_count() == before + 1
    assert _build.library_path("state_digest").exists()
    t0 = time.perf_counter()
    lib = _build.load("state_digest")
    assert time.perf_counter() - t0 < 0.4
    assert lib is _build.load("state_digest")
    assert observability.compile_count() == before + 1
