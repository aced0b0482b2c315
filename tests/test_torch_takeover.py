"""The port sidecar's fenced takeover against the JAX sidecar's, on the CPU.

Twins of the JAX package's ``TestTakeover``, ``TestResyncPacing`` and
``TestHandoffConfig`` (``tests/test_snapshot.py``).  Each case drives the
JAX ``AssignorService`` and the port's (``device="cpu"``) over the wire at
the JAX tests' shape (P 512, C 4, members ``C0..C3``, lags from
``default_rng(seed).integers(0, 10**6, P)`` with their seeds), once per
package, checks the JAX test's own assertions on each run and then compares
the two runs:

* crash takeover: sidecar A serves two streams for two epochs, snapshots
  and stops holding the lease; B reports ``takeover_crash``, a previous
  holder and 2 streams recovered; A's stale write is refused as ``fenced``
  (``klba_snapshot_writes_total{outcome="fenced"}`` + 1) and the backend
  version does not move; B's first epochs answer ``warm_restart``, bit-equal
  to a ``StreamingAssignor`` seeded with A's choice, and ``stats.lifecycle``
  shows the lease and the hand-off;
* drain hand-off: ``takeover_drain`` with no TTL wait, 1 stream recovered,
  its first epoch warm and equal to the seeded baseline;
* an unacquirable lease: B serves cold and valid, its writes ``no_lease``;
* the overload seed: ``seeded_depth`` 6.0, the EWMA at 6.0, the first
  ``best_effort`` admission rejected and the rung at 4;
* the restart wave: 6 streams with ``resync_max_inflight=2``, every answer
  warm and valid, ``high_water`` <= 2 and all 6 epochs paced; a zero cap
  builds no pacer; the pre-stack builds both recovered residents and the
  first answers equal the seeded baseline;
* the hand-off config keys through ``parse_config`` and ``from_config``,
  and the same ``ValueError`` for ``snapshot.backend=s3``.

The sidecar cases run on the ``memory`` and the ``object`` backends (the
JAX tests use ``memory``; ``bench.py``'s ``handoff_storm`` uses ``object``).
The cross-package takeover runs on the ``object`` backend both ways: a JAX
sidecar crashes holding the lease and a port sidecar takes it over, adopts
the streams bit for bit and fences the JAX sidecar's stale write, and the
same with the packages swapped: the lease and fencing documents are shared.

Every sidecar skips the recovery warm-up and writes only explicit
snapshots, as the JAX tests' ``service_for`` does.  No assertion depends on
thread timing: the restart wave holds the pacer's slots until every epoch
of the wave has queued on it.
"""

import itertools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import service as jax_service  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import streaming as jax_streaming  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import config as jax_config  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import snapshot as jax_snapshot  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import service  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import streaming  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    assert_valid_assignment,
    choice_from_assignments,
)
from kafka_lag_based_assignor_tpu_torch.utils import config, metrics, snapshot  # noqa: E402
from test_torch_service import VOLATILE as WIRE_VOLATILE  # noqa: E402
from test_torch_service import rows  # noqa: E402

P, C = 512, 4
MEMBERS = ["C0", "C1", "C2", "C3"]
BACKENDS = ("memory", "object")
PACKAGES = ("jax", "port")
SERVICE = {"jax": jax_service, "port": service}
METRICS = {"jax": jax_metrics, "port": metrics}
# The wire's ids and times, and its process-dependent fields: lease owners
# (host, pid and an instance number), the holder's age and expiry, file
# sizes and paths.
VOLATILE = WIRE_VOLATILE | {"owner", "holder", "previous_holder", "path", "bytes",
                            "age_s", "duration_ms", "waited_ms", "expires_in_s",
                            "holder_age_s", "last_written_at", "error"}


@pytest.fixture(autouse=True)
def _fresh_memory_backends():
    """Each package keeps its ``memory`` backends in a process-wide table."""
    yield
    jax_snapshot.reset_memory_backends()
    snapshot.reset_memory_backends()


def lags_case(seed):
    return np.random.default_rng(seed).integers(0, 10**6, P).astype(np.int64)


def view(x):
    """``x`` without ids, times, owners, paths and the write counters."""
    if isinstance(x, dict):
        return {k: view(v) for k, v in x.items()
                if k not in VOLATILE and not k.startswith("write")}
    if isinstance(x, list):
        return [view(v) for v in x]
    return x


def boot(pkg, path, backend, **kw):
    """A started sidecar of ``pkg`` on the snapshot ``path``, as the JAX
    tests' ``service_for`` boots it (no recovery warm-up, explicit writes),
    with the scrubber off."""
    kw.setdefault("recovery_warmup", False)
    kw.setdefault("snapshot_interval_s", 3600.0)
    if pkg == "port":
        kw["device"] = "cpu"
    return SERVICE[pkg].AssignorService(
        port=0, snapshot_path=str(path), snapshot_backend=backend,
        scrub_interval_ms=0, **kw).start()


def client(pkg, svc):
    return SERVICE[pkg].AssignorServiceClient(*svc.address, timeout_s=120.0)


def counter(pkg, name, **labels):
    return METRICS[pkg].REGISTRY.counter(name, labels or None).value


def baseline(pkg, choice, lags):
    """A ``StreamingAssignor`` of ``pkg`` seeded with ``choice``, rebalanced
    on ``lags``: what an uninterrupted sidecar answers."""
    if pkg == "jax":
        base = jax_streaming.StreamingAssignor(num_consumers=C, imbalance_guardrail=1.25)
    else:
        base = streaming.StreamingAssignor(num_consumers=C, imbalance_guardrail=1.25,
                                           device="cpu")
    base.seed_choice(choice)
    return np.asarray(base.rebalance(lags))


def warm_service(pkg, path, backend, streams, seeds=(0, 50), **kw):
    """Sidecar A on a fenced backend: one epoch per stream for each seed
    offset, then an explicit snapshot.  Returns (A, {sid: choice})."""
    svc = boot(pkg, path, backend, snapshot_lease_ttl_s=kw.pop("lease_ttl_s", 0.4),
               snapshot_lease_wait_s=kw.pop("lease_wait_s", 10.0), **kw)
    with client(pkg, svc) as c:
        for i, sid in enumerate(streams):
            for off in seeds:
                c.stream_assign(sid, "t0", rows(lags_case(off + i)), MEMBERS)
    assert svc.snapshot_now()["ok"]
    return svc, {sid: svc._streams[sid].engine.export_state() for sid in streams}


def first_epochs(pkg, svc, next_lags, expected):
    """Each recovered stream's first epoch on ``svc``: warm, valid and
    equal to ``expected``.  Returns the replies."""
    out = {}
    with client(pkg, svc) as c:
        for sid, lags in next_lags.items():
            r = c.stream_assign(sid, "t0", rows(lags), MEMBERS)
            assert r["stream"]["warm_restart"], (pkg, sid, r["stream"])
            assert_valid_assignment(r["assignments"], P)
            np.testing.assert_array_equal(
                choice_from_assignments(r["assignments"], MEMBERS, P), expected[sid])
            out[sid] = view(r)
    return out


def crash_takeover(pkg, root, backend):
    streams = ("s1", "s2")
    path = root / pkg / "crash"
    svc_a, choices = warm_service(pkg, path, backend, streams)
    svc_a.stop()  # crash: the lease is NOT released
    next_lags = {sid: lags_case(700 + i) for i, sid in enumerate(streams)}
    expected = {sid: baseline(pkg, choices[sid], next_lags[sid]) for sid in streams}
    svc_b = boot(pkg, path, backend, snapshot_lease_ttl_s=0.4, snapshot_lease_wait_s=10.0)
    try:
        handoff = svc_b._last_handoff
        assert handoff["acquired"] and handoff["mode"] == "takeover_crash"
        assert handoff["previous_holder"] is not None
        assert handoff["previous_holder"] != svc_b._snapshot_store._lease_owner
        assert svc_b._last_recovery["streams_recovered"] == 2
        # The fenced-off predecessor cannot write over the adopted state.
        before = counter(pkg, "klba_snapshot_writes_total", outcome="fenced")
        version = svc_b._snapshot_store.backend.version()
        stale = svc_a.snapshot_now()
        assert not stale["ok"] and stale.get("fenced")
        assert counter(pkg, "klba_snapshot_writes_total", outcome="fenced") == before + 1
        assert svc_b._snapshot_store.backend.version() == version
        answers = first_epochs(pkg, svc_b, next_lags, expected)
        with client(pkg, svc_b) as c:
            lc = c.request("stats")["lifecycle"]
        assert lc["lease"]["held"] and lc["handoff"]["mode"] == "takeover_crash"
        return {"handoff": view(handoff), "recovery": view(svc_b._last_recovery),
                "stale": view(stale), "answers": answers, "lifecycle": view(lc),
                "expected": {sid: e.tolist() for sid, e in expected.items()}}
    finally:
        svc_b.stop()


def drain_handoff(pkg, root, backend):
    path = root / pkg / "drain"
    svc_a, choices = warm_service(pkg, path, backend, ("s1",), lease_ttl_s=30.0,
                                  drain_timeout_s=5.0)
    assert svc_a.begin_drain()
    assert svc_a.wait_stopped(15.0)
    next_lags = {"s1": lags_case(9)}
    expected = {"s1": baseline(pkg, choices["s1"], next_lags["s1"])}
    svc_b = boot(pkg, path, backend, snapshot_lease_ttl_s=30.0, snapshot_lease_wait_s=10.0)
    try:
        handoff = svc_b._last_handoff
        # The drain released the lease: no TTL wait, and a hand-off mode.
        assert handoff["acquired"] and handoff["mode"] == "takeover_drain"
        assert handoff["waited_ms"] < 5_000.0
        assert svc_b._last_recovery["streams_recovered"] == 1
        answers = first_epochs(pkg, svc_b, next_lags, expected)
        return {"handoff": view(handoff), "recovery": view(svc_b._last_recovery),
                "answers": answers}
    finally:
        svc_b.stop()


def unacquirable_lease(pkg, root, backend):
    path = root / pkg / "contend"
    svc_a, _ = warm_service(pkg, path, backend, ("s1",), lease_ttl_s=30.0)
    try:
        svc_b = boot(pkg, path, backend, snapshot_lease_ttl_s=30.0,
                     snapshot_lease_wait_s=0.2)
        try:
            handoff = svc_b._last_handoff
            assert not handoff["acquired"] and handoff["error"]
            with client(pkg, svc_b) as c:
                assert c.ping()
                r = c.stream_assign("x", "t0", rows(lags_case(3)), MEMBERS)
                assert_valid_assignment(r["assignments"], P)
                assert r["stream"]["cold_start"]
            denied = svc_b.snapshot_now()
            assert not denied["ok"] and denied.get("denied") == "no_lease"
            return {"handoff": view(handoff), "recovery": view(svc_b._last_recovery),
                    "answer": view(r), "denied": view(denied)}
        finally:
            svc_b.stop()
    finally:
        svc_a.stop()


def overload_seed(pkg, root, backend):
    path = root / pkg / "seed"
    svc_a, _ = warm_service(pkg, path, backend, ("s1", "s2", "s3"))
    svc_a.stop()
    svc_b = boot(pkg, path, backend, snapshot_lease_ttl_s=0.4, snapshot_lease_wait_s=10.0,
                 overload_depth_high=1.0)
    try:
        rec = svc_b._last_recovery
        assert rec["streams_recovered"] == 3
        # 3 standard-class streams x weight 2.0.
        assert rec["seeded_depth"] == pytest.approx(6.0)
        snap = svc_b._overload.snapshot()
        assert snap["ewma_depth"] == pytest.approx(6.0)
        # With depth_high=1 the seeded pressure pins the ladder at its
        # deepest rung on the first decision: a best_effort arrival is shed.
        decision = svc_b._overload.admission("best_effort")
        assert decision.action == "reject"
        assert svc_b._overload.rung() == 4
        return {"recovery": view(rec), "overload": view(snap),
                "decision": (decision.action, decision.rung),
                "after": view(svc_b._overload.snapshot())}
    finally:
        svc_b.stop()


class HeldPacer:
    """Takes every slot of a resync pacer and gives them back once ``n``
    epochs have queued on it: each queued epoch has counted itself in
    ``klba_resync_paced_total``, so the wave is paced whatever the
    threads' timing."""

    def __init__(self, pacer):
        self.pacer = pacer
        self.queued = threading.Semaphore(0)
        paced, queued = pacer._m_paced, self.queued

        class Counted:
            def inc(self, n=1):
                paced.inc(n)
                queued.release()

        pacer._m_paced = Counted()
        for _ in range(pacer.max_inflight):
            assert pacer.acquire(None)

    def release_after(self, n, timeout_s=120.0):
        for _ in range(n):
            assert self.queued.acquire(timeout=timeout_s), "an epoch never reached the pacer"
        for _ in range(self.pacer.max_inflight):
            self.pacer.release()


def restart_wave(pkg, root, backend):
    path = root / pkg / "pace"
    streams = [f"s{i}" for i in range(6)]
    svc_a, choices = warm_service(pkg, path, backend, streams, seeds=(0,))
    svc_a.stop()
    next_lags = {sid: lags_case(600 + i) for i, sid in enumerate(streams)}
    expected = {sid: baseline(pkg, choices[sid], next_lags[sid]) for sid in streams}
    svc_b = boot(pkg, path, backend, snapshot_lease_ttl_s=0.4, snapshot_lease_wait_s=10.0,
                 resync_max_inflight=2)
    try:
        assert svc_b._last_recovery["streams_recovered"] == len(streams)
        paced0 = counter(pkg, "klba_resync_paced_total")
        held = HeldPacer(svc_b._resync_pacer)
        results, errors = {}, []

        def storm(sid):
            try:
                with client(pkg, svc_b) as c:
                    results[sid] = c.stream_assign(sid, "t0", rows(next_lags[sid]), MEMBERS)
            except Exception as exc:  # noqa: BLE001 — the verdict below
                errors.append(exc)

        threads = [threading.Thread(target=storm, args=(sid,)) for sid in streams]
        for t in threads:
            t.start()
        try:
            held.release_after(len(streams))
        finally:
            for t in threads:
                t.join(timeout=120.0)
        assert not errors, errors
        assert sorted(results) == streams
        for sid in streams:
            r = results[sid]
            assert r["stream"]["warm_restart"]
            assert_valid_assignment(r["assignments"], P)
            np.testing.assert_array_equal(
                choice_from_assignments(r["assignments"], MEMBERS, P), expected[sid])
        # The cap bound the concurrency and every epoch of the wave waited.
        assert svc_b._resync_pacer.high_water <= 2
        paced = counter(pkg, "klba_resync_paced_total") - paced0
        assert paced == len(streams)
        return {"recovery": view(svc_b._last_recovery), "paced": paced,
                "high_water": svc_b._resync_pacer.high_water,
                "answers": {sid: view(results[sid]) for sid in streams}}
    finally:
        svc_b.stop()


def zero_cap(pkg, root, backend):
    svc = boot(pkg, root / pkg / "nopace", backend, resync_max_inflight=0)
    try:
        assert svc._resync_pacer is None
        return {"pacer": None}
    finally:
        svc.stop()


def prestack(pkg, root, backend):
    path = root / pkg / "prestack"
    streams = ("s1", "s2")
    svc_a, choices = warm_service(pkg, path, backend, streams, seeds=(0,))
    svc_a.stop()
    next_lags = {sid: lags_case(800 + i) for i, sid in enumerate(streams)}
    expected = {sid: baseline(pkg, choices[sid], next_lags[sid]) for sid in streams}
    svc_b = boot(pkg, path, backend, snapshot_lease_ttl_s=0.4, snapshot_lease_wait_s=10.0,
                 recovery_prestack=True)
    try:
        assert svc_b._last_recovery["streams_prestacked"] == 2
        for sid in streams:
            engine = svc_b._streams[sid].engine
            assert engine._resident is not None
            assert not engine.needs_dense_resync
        return {"recovery": view(svc_b._last_recovery),
                "answers": first_epochs(pkg, svc_b, next_lags, expected)}
    finally:
        svc_b.stop()


CASES = {"crash_takeover": crash_takeover, "drain_handoff": drain_handoff,
         "unacquirable_lease": unacquirable_lease, "overload_seed": overload_seed,
         "restart_wave_paced": restart_wave, "zero_cap": zero_cap, "prestack": prestack}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_takeover_matches_jax(tmp_path, case, backend):
    got = {pkg: CASES[case](pkg, tmp_path, backend) for pkg in PACKAGES}
    assert got["port"] == got["jax"]


def test_parse_config_handoff_keys_match_jax():
    keys = {
        "group.id": "g",
        "tpu.assignor.snapshot.path": "/tmp/x",
        "tpu.assignor.snapshot.backend": "object",
        "tpu.assignor.snapshot.lease.ttl.ms": "15000",
        "tpu.assignor.snapshot.lease.wait.ms": "45000",
        "tpu.assignor.resync.max.inflight": "4",
        "tpu.assignor.recovery.prestack": "true",
    }
    fields = ("snapshot_backend", "snapshot_lease_ttl_s", "snapshot_lease_wait_s",
              "resync_max_inflight", "recovery_prestack")
    got = {}
    for pkg, parse in (("jax", jax_config.parse_config), ("port", config.parse_config)):
        cfg = parse(keys)
        got[pkg] = {f: getattr(cfg, f) for f in fields}
        with pytest.raises(ValueError, match="snapshot.backend") as exc:
            parse({"group.id": "g", "tpu.assignor.snapshot.backend": "s3"})
        got[pkg]["error"] = str(exc.value)
    assert got["port"] == got["jax"]
    assert got["port"]["snapshot_backend"] == "object"
    assert got["port"]["snapshot_lease_ttl_s"] == pytest.approx(15.0)
    assert got["port"]["snapshot_lease_wait_s"] == pytest.approx(45.0)
    assert got["port"]["resync_max_inflight"] == 4
    assert got["port"]["recovery_prestack"] is True


@pytest.mark.parametrize("backend", BACKENDS)
def test_from_config_wires_handoff_keys_as_jax(tmp_path, backend):
    got = {}
    for pkg in PACKAGES:
        extra = {"device": "cpu"} if pkg == "port" else {}
        svc = SERVICE[pkg].AssignorService.from_config(
            {
                "group.id": "g",
                "tpu.assignor.snapshot.path": str(tmp_path / pkg / "ho"),
                "tpu.assignor.snapshot.backend": backend,
                "tpu.assignor.snapshot.lease.ttl.ms": "30000",
                "tpu.assignor.resync.max.inflight": "3",
            },
            port=0, **extra,
        )
        try:
            store = svc._snapshot_store
            got[pkg] = (store.backend.kind, store.fencing_enabled,
                        svc._resync_pacer.max_inflight, svc._lease_wait_s)
        finally:
            svc.stop()
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (backend, True, 3)


def test_invalid_backend_kind_fails_boot_as_jax(tmp_path):
    errors = {}
    for pkg in PACKAGES:
        extra = {"device": "cpu"} if pkg == "port" else {}
        with pytest.raises(ValueError, match="snapshot_backend") as exc:
            SERVICE[pkg].AssignorService(port=0, snapshot_path=str(tmp_path / "x"),
                                         snapshot_backend="s3", **extra)
        errors[pkg] = str(exc.value)
    assert errors["port"] == errors["jax"]


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_cross_package_crash_takeover(tmp_path, monkeypatch, first, second):
    """The rolling migration: ``first``'s sidecar crashes holding the lease
    of an ``object`` backend and ``second``'s takes it over."""
    # In production the two sidecars are two processes; here they share a
    # host name and a pid, so the instance numbers must not coincide.
    monkeypatch.setattr(SERVICE[second], "_OWNER_SEQ", itertools.count(1 << 20))
    streams = ("s1", "s2")
    path = tmp_path / "shared"
    svc_a, choices = warm_service(first, path, "object", streams)
    svc_a.stop()  # crash: the lease is NOT released
    next_lags = {sid: lags_case(700 + i) for i, sid in enumerate(streams)}
    expected = {sid: baseline(second, choices[sid], next_lags[sid]) for sid in streams}
    for sid in streams:
        np.testing.assert_array_equal(baseline(first, choices[sid], next_lags[sid]),
                                      expected[sid])
    svc_b = boot(second, path, "object", snapshot_lease_ttl_s=0.4, snapshot_lease_wait_s=10.0)
    try:
        handoff = svc_b._last_handoff
        assert handoff["acquired"] and handoff["mode"] == "takeover_crash"
        assert handoff["previous_holder"] == svc_a._snapshot_store._lease_owner
        assert handoff["token"] == 2
        assert svc_b._last_recovery["outcome"] == "ok"
        assert svc_b._last_recovery["streams_recovered"] == 2
        before = counter(first, "klba_snapshot_writes_total", outcome="fenced")
        version = svc_b._snapshot_store.backend.version()
        stale = svc_a.snapshot_now()
        assert not stale["ok"] and stale.get("fenced")
        assert counter(first, "klba_snapshot_writes_total", outcome="fenced") == before + 1
        assert svc_b._snapshot_store.backend.version() == version
        first_epochs(second, svc_b, next_lags, expected)
        assert svc_b.snapshot_now()["ok"]
        assert svc_b._snapshot_store.backend.version() == version + 1
    finally:
        svc_b.stop()
