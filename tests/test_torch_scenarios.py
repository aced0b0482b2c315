"""The port's scenario fleet against the JAX fleet (``scenarios/``), on the CPU.

* every non-slow test of ``tests/test_scenarios.py``, run on the port's
  copies (``kafka_lag_based_assignor_tpu_torch.scenarios``): generator
  determinism and the golden digests, the fault-plane composer, the envelope
  evaluator, the twin-mismatch count, the corpus floor, the federated entry
  and the clean replay twin;
* every generator's digest equal between the packages, at several seeds
  and at each scenario's own knobs; the two ``CORPUS``es equal field for
  field; both envelope evaluators and both federated-ladder evaluators give
  the same violations on the same seeded records;
* cross-package replays: the same trace through ``scenarios.replay.replay``
  (the JAX sidecar) and the port's ``replay(..., device="cpu")``: every
  record's ``ok``, ``valid``, ``rung``, ``shed``, ``warm_restart``,
  ``resync``, ``churn`` and ``quality_ratio`` equal and the choices equal
  bit for bit, for the clean ``step_load`` twin (48 x 3, 5 epochs),
  ``skew_storm_faulted`` (the refine flake at epoch 4 serves rung
  ``host_snake`` in both) and ``churn_restart`` (delta flakes, then the
  crash at epoch 5: 0 twin mismatches in both);
* the fault the fleet found on the card (``wave_corruption``): a corrupted
  row table's out-of-range row ids through the wave's batched refine and
  the single-stream refine (both bodies) give JAX's outputs: the writes
  are dropped, not raised, and never land in the next row.

Left out of the comparison, as in ``tests/test_torch_service.py``: XLA
compile counts against the port's kernel builds, latencies and trace ids
(and the tail sampler's counts, which follow the random ids).  The port's
fast fleet (``run_fleet(fast_only=True, device="cpu")``, about 90 s on the
CPU) is ``slow`` like its JAX twin; ``chip_smoke.py --scenarios`` runs the
whole corpus on the card.
"""

import dataclasses
import importlib
import json
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import coalesce as jax_coalesce  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import refine as jax_refine  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import coalesce, refine  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.packing import table_rows  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.rounds_kernel import (  # noqa: E402
    assign_topic_rounds,
)
from kafka_lag_based_assignor_tpu_torch.scenarios import (  # noqa: E402
    compose,
    federated,
)
from kafka_lag_based_assignor_tpu_torch.scenarios.corpus import (  # noqa: E402
    CORPUS,
    Scenario,
    get_scenario,
    run_fleet,
)
from kafka_lag_based_assignor_tpu_torch.scenarios.envelopes import (  # noqa: E402
    MESH_LADDER_STEPS,
    RUNG_ORDER,
    Envelope,
    evaluate,
)
from kafka_lag_based_assignor_tpu_torch.scenarios.replay import (  # noqa: E402
    EpochRecord,
    ReplayResult,
    replay,
    twin_mismatches,
)
from kafka_lag_based_assignor_tpu_torch.scenarios.traces import (  # noqa: E402
    GENERATORS,
    PHASES,
    generate,
)
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    choice_from_assignments,
    moved_fraction,
)
from kafka_lag_based_assignor_tpu_torch.utils import faults  # noqa: E402
from scenarios import compose as jax_compose  # noqa: E402
from scenarios import corpus as jax_corpus  # noqa: E402
from scenarios import envelopes as jax_envelopes  # noqa: E402
from scenarios import federated as jax_federated  # noqa: E402
from scenarios import traces as jax_traces  # noqa: E402

# Each package's ``__init__`` binds the name ``replay`` to the function, so
# the modules are taken from the import system.
replay_mod = importlib.import_module("kafka_lag_based_assignor_tpu_torch.scenarios.replay")
jax_replay = importlib.import_module("scenarios.replay")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: a sidecar's handler, solve and coalescer threads
    each run torch ops, and on the CPU their thread pools would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.deactivate()
    jax_faults.deactivate()


# -- trace generator determinism ------------------------------------------

#: The golden digests of ``tests/test_scenarios.py``: the port's generators
#: are pinned to the same bytes.
GOLDEN_DIGESTS = {
    "diurnal_ramp": "4e23b6cfc9558ccc9d2044a81d95c21e564eb4048fda642a93e480b74ff479f7",
    "flapping_consumers": "9c54133132aef23ce8e398693042a8dae0a35f1b8210afb33ca42da39275f1f4",
    "hot_skew_storm": "38ccf39743647e68d6c44604c6b5106b2b8dd6bc4d032aa600f999e30890fb81",
    "lag_wave_multi": "7f2a0af87edc401dcd3402579d0aed70417c06aff96c255346c08a717482a15a",
    "step_load": "8cadddf5f9880e6ec2737f9e2b0202a2c7026db70ff82dbfda2047f95e46634f",
    "zipf_tenants": "bdf7eef4496f6bff3205318c76cbff45166995f4c7cab76b4f31cc85eeb15785",
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_trace_generation_is_seed_deterministic(name):
    """Same (name, seed) -> byte-identical traces; the seed matters."""
    a, b = generate(name, 777), generate(name, 777)
    assert a == b
    payload = lambda t: json.dumps(asdict(t), sort_keys=True)  # noqa: E731
    assert payload(a) == payload(b)
    assert a.digest() == b.digest()
    assert generate(name, 778).digest() != a.digest()


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_trace_golden_digest_pinned(name):
    assert generate(name, 424242).digest() == GOLDEN_DIGESTS[name]


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_trace_structure_invariants(name):
    """Phase tags are from the declared set, warm epochs lead, every lag
    fits int32, and the epoch indices are dense from zero."""
    t = generate(name, 99)
    assert [ev.index for ev in t.epochs] == list(range(len(t.epochs)))
    assert t.epochs[0].phase == "warm"
    for ev in t.epochs:
        assert ev.phase in PHASES
        for se in ev.streams:
            assert len(se.lags) == t.partitions
            assert se.members
            assert max(se.lags) < 2**31
            assert min(se.lags) >= 0
    assert t.consumer_counts


def test_generate_unknown_name_lists_valid():
    with pytest.raises(KeyError, match="hot_skew_storm"):
        generate("no_such_trace", 1)


def test_zipf_trace_has_all_slo_classes_every_epoch():
    t = generate("zipf_tenants", 5, tenants=8)
    for ev in t.epochs:
        assert {se.slo_class for se in ev.streams} == {
            "critical", "standard", "best_effort"
        }


# -- the generators and the catalog against the JAX fleet -----------------


@pytest.mark.parametrize("seed", [0, 777, 424242, 1101])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_trace_digest_equals_jax(name, seed):
    assert sorted(GENERATORS) == sorted(jax_traces.GENERATORS)
    mine, theirs = generate(name, seed), jax_traces.generate(name, seed)
    assert mine.digest() == theirs.digest() == jax_traces.trace_digest(theirs)
    assert asdict(mine) == asdict(theirs)


@pytest.mark.parametrize("name", [sc.name for sc in CORPUS])
def test_scenario_trace_equals_jax(name):
    """Each scenario's own trace (its generator, seed and knobs)."""
    sc = get_scenario(name)
    mine = generate(sc.trace, sc.seed, **sc.trace_knobs)
    theirs = jax_traces.generate(sc.trace, sc.seed, **sc.trace_knobs)
    assert mine.digest() == theirs.digest()
    assert mine.consumer_counts == theirs.consumer_counts


class _OverloadStub:
    eval_interval_s = 1.0


class _ServiceStub:
    def __init__(self):
        self._overload = _OverloadStub()


def scenario_fields(sc) -> dict:
    """Every field of a ``Scenario``, with a ``tune`` hook as its name and
    its effect on a stub sidecar."""
    out = {}
    for f in dataclasses.fields(sc):
        value = getattr(sc, f.name)
        if f.name == "tune" and value is not None:
            stub = _ServiceStub()
            value(stub)
            value = (value.__name__, stub._overload.eval_interval_s)
        elif dataclasses.is_dataclass(value):
            value = asdict(value)
        elif f.name == "planes":
            value = [asdict(p) for p in value]
        out[f.name] = value
    return out


def test_corpus_equals_jax_field_for_field():
    assert [f.name for f in dataclasses.fields(Scenario)] == [
        f.name for f in dataclasses.fields(jax_corpus.Scenario)]
    assert len(CORPUS) == len(jax_corpus.CORPUS) == 12
    for mine, theirs in zip(CORPUS, jax_corpus.CORPUS):
        assert scenario_fields(mine) == scenario_fields(theirs), mine.name
    assert RUNG_ORDER == jax_envelopes.RUNG_ORDER
    assert MESH_LADDER_STEPS == jax_envelopes.MESH_LADDER_STEPS
    assert [f.name for f in dataclasses.fields(Envelope)] == [
        f.name for f in dataclasses.fields(jax_envelopes.Envelope)]
    assert asdict(Envelope()) == asdict(jax_envelopes.Envelope())
    for key in ("FEDERATION_RUNG_ORDER", "GOSSIP_FRESHNESS_EPOCHS",
                "MAX_STALENESS_EPOCHS", "HEAL_GRACE_EPOCHS"):
        assert getattr(federated, key) == getattr(jax_federated, key)


PLANES = ("solver_flake", "wire_latency", "corruption", "refine_hang", "delta_flake",
          "snapshot_flake", "backend_slow", "peer_partition", "mesh_collective",
          "shed_flake")


@pytest.mark.parametrize("plane", PLANES)
def test_plane_catalog_equals_jax(plane):
    args = (("choice", "lags"), (1, 3)) if plane == "corruption" else ((1, 3),)
    mine = getattr(compose, plane)(*args)
    theirs = getattr(jax_compose, plane)(*args)
    assert asdict(mine) == asdict(theirs)
    assert {ev.point for ev in mine.events} <= faults.FAULT_POINTS


def seeded_records(seed: int, module):
    """Seeded synthetic records: phases, classes, sheds, rungs, churn,
    quality and trace ids drawn from one generator."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(40):
        ok = bool(rng.random() < 0.85)
        shed = None if ok or rng.random() < 0.3 else {
            "class": str(rng.choice(["critical", "standard", "best_effort"]))}
        recs.append(module.EpochRecord(
            epoch=int(rng.integers(0, 6)),
            phase=str(rng.choice(["warm", "steady", "transition"])),
            stream_id=f"s{i % 3}",
            slo_class=str(rng.choice(["critical", "standard", "best_effort"])),
            ok=ok, valid=bool(rng.random() < 0.95), shed=shed,
            rung=str(rng.choice(list(RUNG_ORDER))) if ok else "none",
            resync=bool(rng.random() < 0.1),
            churn=float(rng.random()), quality_ratio=float(1 + rng.random() / 4),
            latency_ms=float(rng.random() * 50),
            trace_id=None if rng.random() < 0.05 else f"{rng.integers(2**62):032x}",
        ))
    res = module.ReplayResult(trace_name="t", seed=seed, trace_sha256="x")
    res.records = recs
    res.compiles_by_phase = {"steady": int(rng.integers(0, 2))}
    res.quarantines = int(rng.integers(0, 2))
    res.twin_mismatches = int(rng.integers(0, 2))
    res.mesh_degrades = {"2d->streams": 1, str(rng.choice(["streams->p", "2d->p"])): 1}
    res.kept_trace_ids = [r.trace_id for r in recs[::2] if r.trace_id]
    res.trace_stats = {"kept_sampled": int(rng.integers(0, 30)),
                       "dropped": int(rng.integers(0, 30)), "sample_rate": 0.125}
    return res


@pytest.mark.parametrize("seed", range(4))
def test_envelope_evaluators_agree(seed):
    for sc, jsc in zip(CORPUS, jax_corpus.CORPUS):
        for env, jenv in ((sc.envelope, jsc.envelope),
                          (Envelope(max_steady_churn=0.5, max_quality_ratio=1.2,
                                    max_steady_p99_ms=30.0, min_detected_corruptions=1,
                                    require_bit_exact_recovery=True,
                                    require_mesh_ladder=True, min_mesh_degrades=3),
                           jax_envelopes.Envelope(
                               max_steady_churn=0.5, max_quality_ratio=1.2,
                               max_steady_p99_ms=30.0, min_detected_corruptions=1,
                               require_bit_exact_recovery=True,
                               require_mesh_ladder=True, min_mesh_degrades=3))):
            mine = evaluate(seeded_records(seed, replay_mod), env)
            theirs = jax_envelopes.evaluate(seeded_records(seed, jax_replay), jenv)
            assert mine == theirs


@pytest.mark.parametrize("seed", range(3))
def test_federated_ladder_evaluators_agree(seed):
    rng = np.random.default_rng(seed)
    rungs = list(federated.FEDERATION_RUNG_ORDER) + ["bogus"]
    records = [{"epoch": e, "ok": bool(rng.random() < 0.95),
                "rung": str(rng.choice(rungs)), "warm_cache": bool(rng.random() < 0.8),
                "balanced": bool(rng.random() < 0.95), "error": "x"}
               for e in range(13)]
    sever = sorted(rng.choice(np.arange(1, 12), size=5, replace=False).tolist())
    assert federated.evaluate_ladder(records, sever) == jax_federated.evaluate_ladder(
        records, sever)


# -- the fault-plane composer ---------------------------------------------


def test_compose_merges_same_point_epoch_union_and_bounds():
    inj = compose.build_injector([
        compose.solver_flake(epochs=(2,)),
        compose.solver_flake(epochs=(3,), per_epoch=2),
    ])
    fired = []
    with faults.injected(inj):
        for epoch in range(5):
            inj.set_epoch(epoch)
            for _ in range(3):
                try:
                    faults.fire("stream.refine")
                except faults.FaultError:
                    fired.append(epoch)
    assert fired == [2, 2, 3, 3]


def test_compose_rejects_mode_conflict():
    with pytest.raises(ValueError, match="must agree on mode"):
        compose.build_injector([
            compose.solver_flake(epochs=(2,)),
            compose.refine_hang(epochs=(3,)),
        ])


def test_compose_planes_are_epoch_gated():
    inj = compose.build_injector(
        [compose.wire_latency(epochs=(4,), delay_s=0.0)]
    )
    with faults.injected(inj):
        faults.fire("wire.read")
        assert inj.fired("wire.read") == 0
        inj.set_epoch(4)
        faults.fire("wire.read")
        assert inj.fired("wire.read") == 1


# -- the envelope evaluator -----------------------------------------------


def _rec(**kw):
    base = dict(
        epoch=0, phase="steady", stream_id="s", slo_class="standard",
        ok=True, valid=True,
    )
    base.update(kw)
    return EpochRecord(**base)


def _result(records, **kw):
    r = ReplayResult(trace_name="t", seed=0, trace_sha256="x")
    r.records = records
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_envelope_invalid_and_critical_sheds_are_non_negotiable():
    res = _result([
        _rec(valid=False),
        _rec(slo_class="critical", ok=False,
             shed={"class": "critical", "rung": "r"}),
    ])
    v = evaluate(res, Envelope(max_steady_compiles=None))
    assert any("invalid assignments: 1" in s for s in v)
    assert any("critical-class sheds: 1" in s for s in v)


def test_envelope_shed_ordering_bottom_up():
    res = _result([
        _rec(slo_class="standard", ok=False, shed={"class": "standard"}),
        _rec(slo_class="best_effort"),
    ])
    v = evaluate(res, Envelope(max_steady_compiles=None))
    assert any("shed ordering violated" in s for s in v)
    res = _result([
        _rec(slo_class="standard", ok=False, shed={"class": "standard"}),
        _rec(slo_class="best_effort", ok=False,
             shed={"class": "best_effort"}),
    ])
    assert not any(
        "shed ordering" in s
        for s in evaluate(res, Envelope(max_steady_compiles=None))
    )


def test_envelope_rung_and_steady_gates_are_phase_aware():
    assert list(RUNG_ORDER) == [
        "none", "kept_previous", "cold_device", "host_snake"
    ]
    res = _result([
        _rec(phase="warm", rung="host_snake", churn=1.0),
        _rec(phase="transition", churn=1.0),
        _rec(phase="steady", rung="kept_previous", churn=0.1),
    ])
    env = Envelope(
        max_rung="none", max_steady_compiles=1, max_steady_churn=0.5
    )
    res.compiles_by_phase = {"warm": 7, "steady": 1, "transition": 3}
    v = evaluate(res, env)
    assert any("exceeds envelope 'none'" in s for s in v)
    assert not any("churn" in s for s in v)
    assert not any("compiles" in s for s in v)
    res.compiles_by_phase["steady"] = 2
    assert any("compiles: 2 > 1" in s for s in evaluate(res, env))


def test_envelope_corruption_and_recovery_gates():
    res = _result([_rec()], quarantines=0, corruptions_planted=2)
    v = evaluate(
        res,
        Envelope(max_steady_compiles=None, min_detected_corruptions=1),
    )
    assert any("detected 0 corruption(s) < 1" in s for s in v)
    env = Envelope(
        max_steady_compiles=None, require_bit_exact_recovery=True
    )
    res = _result([_rec()], twin_mismatches=None)
    assert any("no twin comparison" in s for s in evaluate(res, env))
    res.twin_mismatches = 3
    assert any("3 epoch(s) diverged" in s for s in evaluate(res, env))
    res.twin_mismatches = 0
    assert evaluate(res, env) == []


def test_envelope_mesh_ladder_gate():
    env = Envelope(
        max_steady_compiles=None, require_mesh_ladder=True,
        min_mesh_degrades=2,
    )
    res = _result(
        [_rec()],
        mesh_degrades={"2d->streams": 1, "streams->p": 1},
    )
    assert evaluate(res, env) == []
    res.mesh_degrades = {"2d->single": 1, "streams->p": 1}
    v = evaluate(res, env)
    assert any("not a documented one-rung ladder step" in s for s in v)
    res.mesh_degrades = {"2d->streams": 1}
    v = evaluate(res, env)
    assert any("1 degrade(s) < 2 required" in s for s in v)
    res.mesh_degrades = {"1d->single": 1}
    assert evaluate(
        res,
        Envelope(
            max_steady_compiles=None, require_mesh_ladder=True,
            min_mesh_degrades=1,
        ),
    ) == []


def test_mesh_collective_plane_and_large_tenant_2d_entry():
    plane = compose.mesh_collective(epochs=(4, 6))
    assert [ev.point for ev in plane.events] == ["mesh.collective"]
    assert plane.events[0].epochs == (4, 6)
    sc = get_scenario("large_tenant_2d")
    assert sc.planes and sc.planes[0].name == "mesh_collective"
    assert sc.service_kwargs["mesh_shape"] == "2x4"
    assert sc.service_kwargs["coalesce_lock_waves"] == 1
    assert sc.envelope.require_mesh_ladder
    assert sc.envelope.min_mesh_degrades >= 2
    assert sc.envelope.max_invalid == 0


def test_twin_mismatches_counts_missing_cells():
    a = _result([_rec(epoch=1, choice=np.zeros(4, np.int32))])
    b = _result([
        _rec(epoch=1, choice=np.zeros(4, np.int32)),
        _rec(epoch=2, choice=np.ones(4, np.int32)),
    ])
    assert twin_mismatches(a, b) == 1
    assert twin_mismatches(a, b, from_epoch=2) == 1
    assert twin_mismatches(a, b, from_epoch=3) == 0


# -- wire-decode helpers --------------------------------------------------


def test_choice_from_assignments_and_moved_fraction():
    members = ["A", "B"]
    assignments = {"A": [["t", 0], ["t", 2]], "B": [["t", 1]]}
    ch = choice_from_assignments(assignments, members, 4)
    np.testing.assert_array_equal(ch, [0, 1, 0, -1])
    same = ch.copy()
    assert moved_fraction(ch, same) == 0.0
    flipped = ch.copy()
    flipped[0] = 1
    assert moved_fraction(ch, flipped) == pytest.approx(0.25)
    assert moved_fraction(ch, np.zeros(3, np.int32)) == 1.0


# -- the corpus catalog ---------------------------------------------------


def test_corpus_satisfies_the_fleet_floor():
    names = [sc.name for sc in CORPUS]
    assert len(names) == len(set(names))
    assert len(names) >= 8
    composed = [
        sc for sc in CORPUS
        if len(sc.planes) >= 2
        or (sc.planes and sc.crash_epoch is not None)
    ]
    assert len(composed) >= 3
    assert any(sc.crash_epoch is not None for sc in CORPUS)
    assert sum(1 for sc in CORPUS if sc.fast) >= 8
    for sc in CORPUS:
        assert sc.trace in GENERATORS
        assert sc.envelope.max_rung in RUNG_ORDER
    assert get_scenario(names[0]) is CORPUS[0]
    with pytest.raises(KeyError, match="valid"):
        get_scenario("nope")


def test_peer_partition_scenario_gates_the_federated_plane():
    sc = get_scenario("peer_partition")
    assert sc.federated is True
    assert sc.fast is True
    sever = [
        ep
        for plane in sc.planes
        for ev in plane.events
        if ev.point == "peer.partition"
        for ep in ev.epochs
    ]
    assert sever
    epochs = sc.trace_knobs["epochs"]
    assert min(sever) > 0
    assert max(sever) < epochs - 1


def test_run_fleet_rejects_unknown_only():
    with pytest.raises(KeyError, match="unknown scenario"):
        run_fleet(only=["definitely_not_a_scenario"], device="cpu")


# -- the replay twin contract ---------------------------------------------

STEP_TWIN = dict(partitions=48, consumers=3, epochs=5, step_at=3)


def test_replay_twin_bit_identical_assignments():
    """The same trace, faults off, replayed twice wire-level against fresh
    port sidecars yields bit-identical assignment sequences."""
    trace = generate("step_load", 31337, **STEP_TWIN)
    a = replay(trace, device="cpu")
    b = replay(trace, device="cpu")
    assert a.trace_sha256 == b.trace_sha256 == trace.digest()
    assert len(a.records) == len(trace.epochs)
    for rec in a.records:
        assert rec.ok and rec.valid, (rec.epoch, rec.error)
    ca, cb = a.choices(), b.choices()
    assert set(ca) == set(cb) and ca == cb
    for rec in a.records:
        assert rec.choice.shape == (48,)
        assert rec.choice.min() >= 0


# -- cross-package replays ------------------------------------------------

#: Every record field compared between the packages (latency and trace id
#: are each process's own).
COMPARED = ("epoch", "phase", "stream_id", "slo_class", "ok", "valid", "shed", "error",
            "rung", "warm_restart", "resync", "churn", "quality_ratio")


def same_replays(mine, theirs):
    assert len(mine.records) == len(theirs.records) > 0
    for a, b in zip(mine.records, theirs.records):
        assert {k: getattr(a, k) for k in COMPARED} == {
            k: getattr(b, k) for k in COMPARED}, (a.epoch, a.stream_id)
        assert (a.choice is None) == (b.choice is None)
        if a.choice is not None:
            assert a.choice.dtype == b.choice.dtype
            assert a.choice.tobytes() == b.choice.tobytes(), (a.epoch, a.stream_id)
    for key in ("trace_name", "seed", "trace_sha256", "sheds_by_class", "quarantines",
                "corruptions_planted", "restarted_at", "twin_mismatches",
                "mesh_degrades", "faults_snapshot"):
        assert getattr(mine, key) == getattr(theirs, key), key
    assert set(mine.compiles_by_phase) == set(theirs.compiles_by_phase)
    assert set(mine.compiles_by_phase.values()) == {0}  # no build on the CPU


def both_replays(sc, trace, **extra):
    """``sc``'s replay of ``trace`` through each package, each with its own
    injector of the scenario's planes."""
    out = []
    for replay_fn, comp, kw in ((replay, compose, {"device": "cpu"}),
                                (jax_replay.replay, jax_compose, {})):
        injector = comp.build_injector(sc.planes, seed=sc.seed) if sc.planes else None
        out.append(replay_fn(trace, injector=injector,
                             service_kwargs=dict(sc.service_kwargs),
                             crash_epoch=sc.crash_epoch, parallel=sc.parallel,
                             tune=sc.tune, epoch_sleep_s=sc.epoch_sleep_s,
                             request_options=sc.request_options, **kw, **extra))
    return out


def test_step_load_twin_equals_jax():
    trace = generate("step_load", 31337, **STEP_TWIN)
    mine = replay(trace, device="cpu")
    theirs = jax_replay.replay(jax_traces.generate("step_load", 31337, **STEP_TWIN))
    same_replays(mine, theirs)
    assert all(r.ok and r.valid and r.rung == "none" for r in mine.records)


def test_skew_storm_faulted_equals_jax():
    sc = get_scenario("skew_storm_faulted")
    trace = generate(sc.trace, sc.seed, **sc.trace_knobs)
    mine, theirs = both_replays(sc, trace)
    same_replays(mine, theirs)
    rungs = {r.epoch: r.rung for r in mine.records}
    assert rungs[4] == "cold_device"
    assert all(rung == "none" for e, rung in rungs.items() if e != 4)
    assert mine.faults_snapshot["stream.refine"]["fired"] == 1
    assert evaluate(mine, sc.envelope) == jax_envelopes.evaluate(
        theirs, jax_corpus.get_scenario(sc.name).envelope) == []


def test_churn_restart_equals_jax():
    sc = get_scenario("churn_restart")
    trace = generate(sc.trace, sc.seed, **sc.trace_knobs)
    mine, theirs = both_replays(sc, trace)
    clean = {k: v for k, v in sc.service_kwargs.items() if k != "snapshot_path"}
    twins = (replay(trace, service_kwargs=clean, device="cpu"),
             jax_replay.replay(trace, service_kwargs=clean))
    same_replays(twins[0], twins[1])
    mine.twin_mismatches = twin_mismatches(mine, twins[0])
    theirs.twin_mismatches = jax_replay.twin_mismatches(theirs, twins[1])
    assert mine.twin_mismatches == theirs.twin_mismatches == 0
    same_replays(mine, theirs)
    assert mine.restarted_at == 5 and mine.recovery["streams_recovered"] == 3
    assert [r.warm_restart for r in mine.records if r.epoch == 5] == [True] * 3
    assert evaluate(mine, sc.envelope) == []


# -- the corruption drill's refine: out-of-range rows ---------------------

#: Row ids a corrupted row table can hold for a 512-row resident state:
#: past the end by one (the next row's first slot in a stacked wave), far
#: past it, a high bit flipped, and negative past one wrap.
BAD_ROWS = [513, 512 + 12345, 2**30, -(512 + 7)]


def corrupt_rows(seed=7, N=3, P=480, B=512, C=8):
    """N resident states (a rounds solve, then drifted lags), with the
    heaviest and the lightest consumers' first slots of row 1's table
    overwritten by ``bad`` (returned as a function of it)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(N):
        lags = np.zeros(B, np.int64)
        lags[:P] = rng.integers(10**6, 10**8, P)
        lt = torch.from_numpy(lags)
        valid = torch.arange(B) < P
        choice, _, _ = assign_topic_rounds(lt, torch.arange(B, dtype=torch.int32), valid, C,
                                           n_valid=P)
        lags[:P] = rng.integers(10**6, 10**8, P)
        tab, counts, totals = refine.build_choice_tables(lt, valid, choice, C, table_rows(B, C))
        rows.append((lt, choice.to(torch.int32), tab, counts, totals))

    def with_bad(bad):
        tabs = torch.stack([r[2] for r in rows])
        for c in (int(rows[1][4].argmax()), int(rows[1][4].argmin())):
            tabs[1, c, :5] = bad
        return [torch.stack([r[k] for r in rows]) for k in (0, 1)] + [
            tabs, torch.stack([r[3] for r in rows]), torch.stack([r[4] for r in rows])]

    return with_bad


@pytest.mark.parametrize("bad", BAD_ROWS)
def test_corrupted_row_table_wave_equals_jax(bad):
    """A wave whose row 1 holds out-of-range row ids: JAX's vmapped scatter
    drops them; the port's flat scatter must too, on the CPU (an
    out-of-bounds index raised) and on the card (a device-side assert that
    ended the sidecar's CUDA context in the ``wave_corruption`` scenario,
    seed 1104, epoch 4), and must not write them into the next row."""
    lags, choice, tab, counts, _ = corrupt_rows()(bad)
    limits = np.full(3, -1.0)
    got = coalesce._epoch_rows(lags.to(torch.int32), choice, tab, counts,
                               torch.from_numpy(limits), 8, 32, 4, 32)
    want = jax_coalesce._megabatch_fused_locked(
        jnp.asarray(lags.numpy().astype(np.int32)), jnp.asarray(choice.numpy()),
        jnp.asarray(tab.numpy()), jnp.asarray(counts.numpy()), jnp.asarray(limits),
        num_consumers=8, iters=32, max_pairs=4, exchange_budget=32)
    for k, (w, g) in enumerate(zip(want, got)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"output {k}")


@pytest.mark.parametrize("bulk", [False, True], ids=["parity", "bulk"])
@pytest.mark.parametrize("bad", BAD_ROWS)
def test_corrupted_row_table_refine_equals_jax(bad, bulk):
    """One corrupted state through the single-stream refine (both bodies):
    the out-of-range writes dropped as JAX drops them, the same outputs."""
    lags, choice, tab, counts, totals = (t[1] for t in corrupt_rows()(bad))
    kw = dict(iters=32, max_pairs=4, exchange_budget=32, quality_limit=-1.0)
    if bulk:
        kw.update(bulk_transfer=True, fan=8)
    got = refine.refine_rounds_resident(lags, choice, tab, counts, totals, 8, **kw)
    want = jax_refine.refine_rounds_resident(
        jnp.asarray(lags.numpy()), jnp.asarray(choice.numpy()), jnp.asarray(tab.numpy()),
        jnp.asarray(counts.numpy()), jnp.asarray(totals.numpy()), 8, **kw)
    for name, g, w in zip(("choice", "row_tab", "counts", "totals"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got[4], got[5]) == (int(want[4]), int(want[5]))


# -- the full fast fleet (slow: about 90 s on the CPU) --------------------


@pytest.mark.slow
def test_fast_fleet_has_no_envelope_violations():
    fleet = run_fleet(fast_only=True, device="cpu")
    assert fleet["ok"], [
        (r["scenario"], r["violations"])
        for r in fleet["scenarios"] if r["violations"]
    ]
    assert len(fleet["scenarios"]) >= 8
