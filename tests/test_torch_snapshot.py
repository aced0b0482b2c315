"""The port's lifecycle snapshots against the JAX package's, on the CPU.

* the lifecycle config keys (``snapshot.*``, ``drain.timeout.ms``,
  ``resync.max.inflight``, ``scrub.interval.ms``, ``recovery.prestack``):
  the same values and the same errors;
* the same sections give byte-equal documents, on each backend;
* each package loads the other's file with an equal ``LoadResult``
  (outcome, sections, skipped sections, age, reason) whether the file is
  whole, has a torn section, is truncated or has the wrong or a future
  version;
* on each of the three backends, one sequence of CAS, lease and fencing
  operations (a CAS conflict, an acquire, a live lease blocking another
  owner, a takeover after expiry, a fenced predecessor's write, a release
  and a re-acquire, a store denied for want of the lease, the injected
  ``snapshot.cas`` / ``backend.partition`` faults) gives the same outcomes
  and moves the same ``klba_snapshot_*`` / ``klba_lease_*`` counters by the
  same amounts in each package's registry.

Both packages run under one stepped wall clock, so stamps and ages agree.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.utils import config as jax_config  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import snapshot as jax_snapshot  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import config  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import faults, metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import snapshot  # noqa: E402

PACKAGES = {"jax": (jax_snapshot, jax_metrics, jax_faults),
            "port": (snapshot, metrics, faults)}

LIFECYCLE_FIELDS = ("snapshot_path", "snapshot_interval_s", "snapshot_max_age_s",
                    "drain_timeout_s", "snapshot_backend", "snapshot_lease_ttl_s",
                    "snapshot_lease_wait_s", "resync_max_inflight",
                    "recovery_prestack", "scrub_interval_s")
P = "tpu.assignor."
LIFECYCLE_CASES = [
    {},
    {P + "snapshot.path": "/var/lib/klba/snap.json", P + "snapshot.interval.ms": "5000",
     P + "snapshot.max.age.ms": "60000", P + "drain.timeout.ms": "2500",
     P + "snapshot.backend": "object", P + "snapshot.lease.ttl.ms": "15000",
     P + "snapshot.lease.wait.ms": "45000", P + "resync.max.inflight": "3",
     P + "scrub.interval.ms": "250", P + "recovery.prestack": "yes"},
    {P + "snapshot.path": "", P + "recovery.prestack": "off", P + "scrub.interval.ms": 0},
    {P + "snapshot.interval.ms": "0"},
    {P + "snapshot.max.age.ms": "0"},
    {P + "drain.timeout.ms": "-1"},
    {P + "snapshot.backend": "s3"},
    {P + "snapshot.lease.ttl.ms": "soon"},
    {P + "snapshot.lease.wait.ms": "-5"},
    {P + "resync.max.inflight": "-1"},
    {P + "resync.max.inflight": "two"},
    {P + "scrub.interval.ms": "abc"},
]


def parsed(parse, case):
    try:
        cfg = parse({"group.id": "g", **case})
    except ValueError as exc:
        return ("error", str(exc))
    return ("ok", {f: getattr(cfg, f) for f in LIFECYCLE_FIELDS})


@pytest.mark.parametrize("case", LIFECYCLE_CASES, ids=range(len(LIFECYCLE_CASES)))
def test_lifecycle_keys_match_jax(case):
    assert parsed(config.parse_config, case) == parsed(jax_config.parse_config, case)


class Wall:
    """A wall clock the test steps, shared by both packages."""

    def __init__(self, now=1_700_000_000.0):
        self.now = now

    def __call__(self):
        return self.now


SECTIONS = {
    "streams": {
        "s1": {"members": ["A", "B", "C"], "pids": 6, "choice": [0, 1, 2, 2, 1, 0],
               "slo_class": "critical", "history": [[12.5, 900], [2.0, 1200]]},
        "s2": {"members": ["x", "y"], "pids": [3, 7, 11], "choice": [1, 0, 1],
               "slo_class": "standard", "history": []},
    },
    "breakers": {"stream": {"state": "open", "trips": 2, "cooldown_remaining_s": 3.5}},
    "overload": {"rung": 1, "ewma_depth": 2.25},
}


def store_for(pkg, kind, path, wall):
    path.parent.mkdir(parents=True, exist_ok=True)
    mod = PACKAGES[pkg][0]
    return mod.SnapshotStore(backend=mod.build_backend(kind, str(path), wall_clock=wall),
                             wall_clock=wall)


@pytest.mark.parametrize("kind", ["file", "memory", "object"])
def test_same_sections_give_byte_equal_documents(tmp_path, kind):
    wall = Wall()
    docs = {}
    for pkg in PACKAGES:
        store = store_for(pkg, kind, tmp_path / pkg / "snap", wall)
        assert store.save(SECTIONS)["ok"]
        docs[pkg] = store.backend.read()[0]
        PACKAGES[pkg][0].reset_memory_backends()
    assert docs["port"] == docs["jax"]
    assert json.loads(docs["port"])["format"] == "klba-snapshot"


def tampered(data: bytes, variant: str) -> bytes:
    if variant == "whole":
        return data
    if variant == "truncated":
        return data[: len(data) // 2]
    doc = json.loads(data)
    if variant == "torn section":
        doc["sections"]["breakers"]["body"]["stream"]["trips"] = 3
    else:
        doc["version"] = {"wrong version": 0, "future version": 2}[variant]
    return json.dumps(doc).encode()


def load_view(result):
    return (result.outcome, result.sections, list(result.skipped), result.age_s,
            result.reason)


@pytest.mark.parametrize("variant", ["whole", "torn section", "truncated",
                                     "wrong version", "future version"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_file(tmp_path, writer, variant):
    wall = Wall()
    path = tmp_path / "snap.json"
    assert store_for(writer, "file", path, wall).save(SECTIONS)["ok"]
    path.write_bytes(tampered(path.read_bytes(), variant))
    wall.now += 42.0
    views = {pkg: load_view(store_for(pkg, "file", path, wall).load()) for pkg in PACKAGES}
    assert views["port"] == views["jax"]
    want = {"whole": "ok", "torn section": "partial"}.get(variant, "cold")
    assert views["port"][0] == want
    if variant in ("whole", "torn section"):
        assert views["port"][3] == 42.0


def counters(metrics_module):
    return {
        (name, tuple(sorted(s["labels"].items()))): s["value"]
        for name, entry in metrics_module.REGISTRY.snapshot().items()
        if entry["type"] == "counter"
        and name.startswith(("klba_snapshot_", "klba_lease_"))
        for s in entry["series"]
    }


def without_times(x):
    if isinstance(x, dict):
        return {k: without_times(v) for k, v in x.items()
                if not k.endswith(("_ms", "_at")) and k not in ("bytes", "age_s")}
    return x


def protocol(pkg, kind, root, wall):
    """One sequence of CAS / lease / fence operations; returns what each
    step answered."""
    mod, _, flt = PACKAGES[pkg]
    path = root / "state"
    out = []

    def step(name, fn):
        try:
            out.append((name, without_times(fn())))
        except Exception as exc:  # noqa: BLE001 — the outcome is compared
            out.append((name, type(exc).__name__, str(exc)))

    root.mkdir(parents=True, exist_ok=True)
    raw = mod.build_backend(kind, str(root / "raw"), wall_clock=wall)
    step("cas first", lambda: raw.write_if(b"one", prev_version=0))
    step("cas racer", lambda: raw.write_if(b"racer", prev_version=0))
    step("cas read", lambda: raw.read())
    step("unconditional", lambda: raw.write_if(b"two"))
    a = store_for(pkg, kind, path, wall)
    a.attach_lease("A", ttl_s=5.0)
    step("A acquire", lambda: a.acquire_lease())
    step("A save", lambda: a.save({"overload": {"rung": 1}}))
    b = store_for(pkg, kind, path, wall)
    b.attach_lease("B", ttl_s=5.0)
    step("B while A lives", lambda: b.acquire_lease(wait_s=0.0))
    step("B save denied", lambda: b.save({"overload": {"rung": 5}}))
    wall.now += 6.0
    step("B takeover", lambda: b.acquire_lease(wait_s=0.0))
    step("B save", lambda: b.save({"overload": {"rung": 2}}))
    step("A fenced", lambda: a.save({"overload": {"rung": 9}}))
    step("B lease stats", lambda: b.lease_stats())
    step("load", lambda: load_view(b.load()))
    step("B release", lambda: b.release_lease())
    c = store_for(pkg, kind, path, wall)
    c.attach_lease("C", ttl_s=5.0)
    step("C acquire", lambda: c.acquire_lease(wait_s=0.0))
    with flt.injected(flt.FaultInjector(seed=3).plan("snapshot.cas", mode="raise",
                                                     times=1)):
        step("C save, CAS race", lambda: c.save({"overload": {"rung": 3}}))
    with flt.injected(flt.FaultInjector(seed=3).plan("backend.partition", mode="raise")):
        step("C save, partitioned", lambda: c.save({"overload": {"rung": 4}}))
        step("load, partitioned", lambda: load_view(c.load()))
    # The store's counters are process-wide totals (compared as deltas
    # below) and its path differs: the rest of its stats.
    step("C stats", lambda: {k: v for k, v in c.stats().items()
                             if k != "path" and not k.startswith("write")})
    step("final load", lambda: load_view(store_for(pkg, kind, path, wall).load()))
    mod.reset_memory_backends()
    return out


@pytest.mark.parametrize("kind", ["file", "memory", "object"])
def test_backend_protocol_matches_jax(tmp_path, kind):
    got = {}
    for pkg, (_, mets, _) in PACKAGES.items():
        before = counters(mets)
        steps = protocol(pkg, kind, tmp_path / pkg, Wall())
        after = counters(mets)
        moved = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        got[pkg] = (steps, moved)
    assert got["port"] == got["jax"]
    steps, moved = got["port"]
    outcome = dict((s[0], s[1:]) for s in steps)
    assert outcome["cas racer"][0] == "CASConflict"
    assert outcome["A fenced"][0]["fenced"]
    assert (("klba_snapshot_writes_total", (("outcome", "fenced"),)), 1) in moved.items()
