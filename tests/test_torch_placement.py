"""The port's placement half of ``sharded/`` against the JAX package's:
the resident P-axis placement (``sharded/resident``) with K6's per-shard
digest, and the stream-axis / 2-D placement of locked megabatch rosters
(``sharded/megabatch``).  Placement moves bytes, never values: every epoch,
wave and digest must equal the unplaced port engine's and, on the same
inputs, the JAX engine's with its resident state sharded (the counterparts
of ``tests/test_mesh2d.py``'s placement cases).  The port runs 8 virtual
shards of the CPU; the JAX side the 8-device CPU mesh ``tests/conftest.py``
forces."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.ops.coalesce import (  # noqa: E402
    MegabatchCoalescer as JaxCoalescer,
)
from kafka_lag_based_assignor_tpu.ops.streaming import (  # noqa: E402
    StreamingAssignor as JaxEngine,
)
from kafka_lag_based_assignor_tpu.sharded import mesh as jax_mesh  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import refine  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.coalesce import MegabatchCoalescer  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.dispatch import quality_scope  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.packing import table_rows  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.streaming import (  # noqa: E402
    StreamingAssignor,
    delta_k_ladder,
)
from kafka_lag_based_assignor_tpu_torch.sharded import mesh as port_mesh  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded.megabatch import RowShards  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded.resident import (  # noqa: E402
    PlacedResident,
    place_resident,
    shardable_rows,
)
from kafka_lag_based_assignor_tpu_torch.utils import faults, metrics, scrub  # noqa: E402

P, C = 1024, 8
N_STREAMS, WAVE_P = 8, 512
PLACED = ("klba_resident_placed_total", {"axis": "p"})


@pytest.fixture(scope="module", autouse=True)
def virtual_cpu_shards():
    port_mesh.set_virtual_shards(8, "cpu")
    yield
    port_mesh.set_virtual_shards(None)


@pytest.fixture(autouse=True)
def _clean():
    for mod in (faults, jax_faults):
        mod.deactivate()
    port_mesh.deactivate()
    jax_mesh.deactivate()
    yield
    for mod in (faults, jax_faults):
        mod.deactivate()
    port_mesh.deactivate()
    jax_mesh.deactivate()


def _skewed(rng, n):
    """A low floor with heavy spikes (ties and outliers)."""
    lags = rng.integers(0, 50, n).astype(np.int64)
    spikes = rng.choice(n, n // 16, replace=False)
    lags[spikes] += rng.integers(10**6, 10**9, spikes.shape[0])
    return lags


def _assert_valid(choice, n, c):
    assert choice.shape == (n,)
    assert choice.min() >= 0 and choice.max() < c
    counts = np.bincount(choice, minlength=c)
    assert counts.max() - counts.min() <= 1


def _epoch_script(seed):
    """A seed choice and 6 epochs alternating dense drift and 8-row deltas."""
    rng = np.random.default_rng(seed)
    cur = _skewed(rng, P)
    seed_choice = (np.argsort(np.argsort(-cur, kind="stable")) % C).astype(np.int32)
    epochs = []
    for k in range(6):
        if k % 2 == 0:
            cur = _skewed(rng, P)
        else:
            cur = cur.copy()
            idx = rng.choice(P, 8, replace=False)
            cur[idx] += rng.integers(1, 1000, 8)
        epochs.append(cur)
    return seed_choice, epochs


ENGINE_KW = dict(num_consumers=C, refine_iters=64, refine_threshold=None,
                 cold_refine_iters=64, delta_max_fraction=1.0, delta_buckets=2)


def _drive(engine, seed_choice, epochs):
    engine.seed_choice(seed_choice)
    return [np.asarray(engine.rebalance(e.copy())) for e in epochs]


# -- K6's per-shard entry ---------------------------------------------------


def _state(seed, B, Cn, n_valid):
    """A consistent resident state (tables built from a balanced choice)."""
    rng = np.random.default_rng(seed)
    lags = np.zeros(B, np.int64)
    lags[:n_valid] = rng.integers(0, 10**12, n_valid)
    choice = np.full(B, -1, np.int32)
    choice[:n_valid] = rng.permutation(np.arange(n_valid) % Cn)
    valid = torch.arange(B) < n_valid
    tab, counts, _ = refine.build_choice_tables(
        torch.from_numpy(lags), valid, torch.from_numpy(choice), Cn,
        table_rows(B, Cn))
    return torch.from_numpy(lags), torch.from_numpy(choice), tab, counts


CORRUPTIONS = [None, "choice", "choice_range", "lags", "counts", "row_tab",
               "row_tab_range", "row_tab_sentinel"]


def _corrupt(state, kind):
    lags, choice, tab, counts = (t.clone() for t in state)
    if kind == "choice":
        choice[37] = (choice[37] + 1) % counts.shape[0]
    elif kind == "choice_range":
        choice[900] = counts.shape[0] + 5
    elif kind == "lags":
        lags[611] ^= 1 << 41
    elif kind == "counts":
        counts[2] += 1
    elif kind == "row_tab":
        tab[1, 0] = tab[3, 0]
    elif kind == "row_tab_range":
        tab[0, 1] = lags.shape[0] + 9
    elif kind == "row_tab_sentinel":
        tab[4, -1] = 17
    return lags, choice, tab, counts


@pytest.mark.parametrize("kind", CORRUPTIONS, ids=lambda k: k or "clean")
@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
def test_sharded_digest_equals_gathered_digest(D, kind):
    """``state_digest_sharded`` (the plain version of K6's shard entry, the
    partials summed) equals ``state_digest`` of the gathered state, exactly,
    for every split and every corruption lane; uneven splits (D = 3) too."""
    clean = _state(D, 1200, 8, 1100)
    lags, choice, tab, counts = _corrupt(clean, kind)
    want = refine.state_digest(lags, choice, counts, 8, row_tab=tab)
    lag_s, ch_s = list(torch.tensor_split(lags, D)), list(torch.tensor_split(choice, D))
    offsets = np.cumsum([0] + [t.shape[0] for t in lag_s[:-1]]).tolist()
    got = refine.state_digest_sharded(lag_s, ch_s, counts, 8, tab, offsets)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    truth = int(clean[0].sum())
    assert (scrub.digest_failures(got, 1100, truth) == []) == (kind is None)


def test_sharded_digest_partials_and_limits():
    """Each shard's partial counts only its own rows' owner checks; the
    combine takes the lead's replicated terms once; the limits raise
    ``ValueError`` as ``state_digest``'s, and a CPU shard counts no launch."""
    lags, choice, tab, counts = _state(5, 256, 4, 250)
    parts = [refine._state_digest_shard_torch(lags[lo: lo + 64], choice[lo: lo + 64],
                                              counts, 4, tab, lo, 256, lo == 0)
             for lo in range(0, 256, 64)]
    assert all(int(p[3]) == 0 and int(p[4]) == 0 for p, _ in parts[1:])
    assert sum(int(h.sum()) for _, h in parts) == 250
    before = refine.state_digest_sharded.launches
    with pytest.raises(ValueError, match="consumers"):
        refine.state_digest_sharded([lags], [choice], counts[:0], 0, tab, [0])
    with pytest.raises(ValueError, match="first rows"):
        refine.state_digest_sharded([lags[:128], lags[128:]],
                                    [choice[:128], choice[128:]], counts, 4, tab, [0, 100])
    with pytest.raises(ValueError, match="row table"):
        refine.state_digest_sharded([lags], [choice], counts, 4, None, [0])
    refine.state_digest_sharded([lags], [choice], counts, 4, tab, [0])
    assert refine.state_digest_sharded.launches == before


def test_place_resident_round_trip():
    """Rows split over "p", the tables replicated, fresh tensors (never an
    alias), and ``gather`` the input back bit for bit."""
    state = _state(6, 1024, 8, 1000)
    resident = (state[1], state[2], state[3], state[0])
    mgr = port_mesh.MeshManager(devices=4, solve_min_rows=1).configure()
    mesh = mgr.solve_mesh()
    assert shardable_rows(mesh, 1024) and not shardable_rows(mesh, 1022)
    assert not shardable_rows(None, 1024)
    placed = place_resident(mesh, resident)
    assert placed.row_offsets == [0, 256, 512, 768] and placed.bucket == 1024
    assert [s[0].shape[0] for s in placed.shards] == [256] * 4
    assert placed.owner(700) == (2, 188)
    for got, want in zip(placed.gather(), resident):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    placed.shards[0][1][0, 0] = -7
    assert int(resident[1][0, 0]) != -7


# -- the engine: placed warm and delta epochs --------------------------------


@pytest.mark.parametrize("D", [2, 4])
def test_placed_warm_and_delta_epochs_match_unplaced_and_jax(D):
    """Seeded engines through dense and delta warm epochs: the port's
    placed engine, its unplaced engine and the JAX engine with its resident
    buffers sharded over D devices serve the same choice every epoch; the
    placement counter moves as the JAX one does, and each warm dispatch
    digests the placed state with one K6 shard call a shard."""
    seed_choice, epochs = _epoch_script(0x2D03 + D)
    unplaced = _drive(StreamingAssignor(**ENGINE_KW, mesh_backend=None, device="cpu"),
                      seed_choice, epochs)
    mgr = port_mesh.MeshManager(devices=D, solve_min_rows=256).configure()
    eng = StreamingAssignor(**ENGINE_KW, mesh_backend=mgr, device="cpu")
    c0 = metrics.REGISTRY.counter(*PLACED).value
    placed = _drive(eng, seed_choice, epochs)
    moved = metrics.REGISTRY.counter(*PLACED).value - c0
    assert isinstance(eng._resident, PlacedResident)
    assert [s[0].shape[0] for s in eng._resident.shards] == [eng._bucket(P) // D] * D
    assert eng.delta_epochs["applied"] == 3
    jmgr = jax_mesh.MeshManager(devices=D, solve_min_rows=256).configure()
    jeng = JaxEngine(**ENGINE_KW, mesh_backend=jmgr)
    j0 = jax_metrics.REGISTRY.counter(*PLACED).value
    jax_out = _drive(jeng, seed_choice, epochs)
    assert jeng._resident_sharded
    assert moved == jax_metrics.REGISTRY.counter(*PLACED).value - j0 == len(epochs)
    for k, (a, b, j) in enumerate(zip(unplaced, placed, jax_out)):
        np.testing.assert_array_equal(b, a, err_msg=f"epoch {k}")
        np.testing.assert_array_equal(b, j, err_msg=f"epoch {k}")
        _assert_valid(b, P, C)


def test_placed_cold_warm_delta_parity_quality_linear():
    """The whole script from cold with quality "linear" pinned (the sharded
    linear cold solve is bit-identical to the single-device one): no mesh,
    D = 2 and D = 4 serve the same choice every epoch."""
    _, epochs = _epoch_script(0x2D05)
    outs = {}
    with quality_scope("linear"):
        for D in (None, 2, 4):
            mgr = (port_mesh.MeshManager(devices=D, solve_min_rows=256).configure()
                   if D else None)
            eng = StreamingAssignor(**ENGINE_KW, mesh_backend=mgr, device="cpu")
            outs[D] = [np.asarray(eng.rebalance(e.copy())) for e in epochs]
            assert eng.last_stats.sharded_solve is False
    for D in (2, 4):
        for a, b in zip(outs[None], outs[D]):
            np.testing.assert_array_equal(b, a)


def test_placed_corruption_caught_and_healed_as_unplaced():
    """``device.corrupt.choice`` flips the bit in the shard that owns the
    row (the same bit the unplaced state takes); the next dispatch's sharded
    digest catches it, quarantines, and the epoch after heals to the
    unplaced engine's choice."""
    seed_choice, epochs = _epoch_script(0x2D06)
    outs = []
    for mgr in (None, port_mesh.MeshManager(devices=4, solve_min_rows=256).configure()):
        eng = StreamingAssignor(**ENGINE_KW, mesh_backend=mgr, device="cpu")
        eng.seed_choice(seed_choice)
        got = [eng.rebalance(epochs[0].copy())]
        with faults.injected(faults.FaultInjector(3).plan("device.corrupt.choice", times=1)):
            got.append(eng.rebalance(epochs[1].copy()))
        audited, fails = scrub.audit_engine(eng)
        assert audited and fails == ["choice"]
        with pytest.raises(scrub.CorruptStateDetected):
            eng.rebalance(epochs[2].copy())
        assert eng.quarantined
        got.append(eng.rebalance(epochs[3].copy()))
        assert not eng.quarantined
        assert scrub.audit_engine(eng) == (True, [])
        assert isinstance(eng._resident, PlacedResident) == (mgr is not None)
        outs.append(got)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


def test_warm_boundary_collective_fault_degrades_and_answers():
    """A ``mesh.collective`` fault at a placed warm epoch degrades the
    manager, drops the placed state and answers the epoch cold on the rung
    left (single-device), as the JAX engine does; the next epoch is warm
    again on unplaced tensors."""
    seed_choice, epochs = _epoch_script(0x2D07)
    mgr = port_mesh.MeshManager(devices=4, solve_min_rows=256).configure()
    eng = StreamingAssignor(**ENGINE_KW, mesh_backend=mgr, device="cpu")
    eng.seed_choice(seed_choice)
    eng.rebalance(epochs[0].copy())
    assert isinstance(eng._resident, PlacedResident)
    with faults.injected(faults.FaultInjector(1).plan("mesh.collective", times=1)):
        out = eng.rebalance(epochs[1].copy())
    _assert_valid(out, P, C)
    assert eng.last_stats.cold_start and not eng.last_stats.sharded_solve
    assert mgr.rung == "single" and mgr.status()["degraded"] == "collective"
    out = eng.rebalance(epochs[2].copy())
    _assert_valid(out, P, C)
    assert not eng.last_stats.cold_start and isinstance(eng._resident, tuple)


def test_placed_stream_snapshot_equals_unplaced():
    """What a snapshot stores of a stream (``export_state``, the host
    choice) and what the scrubber audits are the same for a placed and an
    unplaced engine after the same epochs; the placed engine's state is
    placed, the prestack rebuilds it placed."""
    seed_choice, epochs = _epoch_script(0x2D08)
    engines = [StreamingAssignor(**ENGINE_KW, mesh_backend=m, device="cpu")
               for m in (None, port_mesh.MeshManager(devices=2, solve_min_rows=256).configure())]
    for eng in engines:
        _drive(eng, seed_choice, epochs[:3])
        assert scrub.audit_engine(eng) == (True, [])
    np.testing.assert_array_equal(engines[1].export_state(), engines[0].export_state())
    fresh = StreamingAssignor(**ENGINE_KW, mesh_backend=engines[1].mesh_backend, device="cpu")
    fresh.seed_choice(engines[1].export_state())
    assert fresh.prestack_resident() and isinstance(fresh._resident, PlacedResident)
    np.testing.assert_array_equal(fresh.rebalance(epochs[3].copy()),
                                  engines[1].rebalance(epochs[3].copy()))


# -- the coalescer: placed locked rosters -----------------------------------


def _wave_script(seed, waves=6):
    rng = np.random.default_rng(seed)
    cold = [rng.integers(0, 1000, WAVE_P).astype(np.int64) for _ in range(N_STREAMS)]
    script, prev = [], cold
    for w in range(waves):
        if w in (2, 4):
            arrs = []
            for a in prev:
                nxt = a.copy()
                nxt[:8] = nxt[:8] + 1 + (np.arange(8) % 7)
                arrs.append(nxt)
        else:
            arrs = [rng.integers(0, 1000, WAVE_P).astype(np.int64) for _ in range(N_STREAMS)]
        script.append(arrs)
        prev = arrs
    return cold, script


def _wave(engines, coal, arrs):
    outs, errs = [None] * len(engines), []

    def run(i):
        try:
            outs[i] = engines[i].submit_epoch(arrs[i], coal)
        except Exception as exc:  # noqa: BLE001 — asserted by callers
            errs.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(engines))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs, errs


def _locked_batch(coal):
    with coal._roster_lock:
        batches = [r.batch for r in coal._rosters.values() if r.batch is not None]
    assert len(batches) == 1
    return batches[0]


def _run_waves(pkg, spec, cold, script, churn_wave=3):
    """One package's engines and coalescer through the wave script under a
    mesh spec (None, devices=4 streams, or a 2-D shape)."""
    mesh_mod, engine, coalescer, dev = (
        (port_mesh, StreamingAssignor, MegabatchCoalescer, dict(device="cpu"))
        if pkg == "port" else (jax_mesh, JaxEngine, JaxCoalescer, {}))
    mgr = None
    if spec is not None:
        kw = {"devices": 4} if spec == "streams" else {"devices": "auto", "shape": spec}
        mgr = mesh_mod.MeshManager(solve_min_rows=1 << 20, **kw).configure()
    engines = [engine(num_consumers=C, refine_iters=64, refine_threshold=None,
                      delta_max_fraction=1.0, delta_buckets=2, mesh_backend=mgr, **dev)
               for _ in range(N_STREAMS)]
    for e, a in zip(engines, cold):
        e.rebalance(a.copy())
    coal = coalescer(window_s=2.0, max_batch=N_STREAMS, lock_waves=1,
                     delta_k=delta_k_ladder(2)[-1], mesh_manager=mgr, **dev)
    outs = []
    try:
        for w, arrs in enumerate(script):
            if w == churn_wave:
                engines[0].seed_choice(np.asarray(engines[0]._prev_choice, dtype=np.int32))
            got, errs = _wave(engines, coal, arrs)
            assert not errs, errs
            outs.append([np.asarray(o) for o in got])
        batch = _locked_batch(coal)
        stats = coal.stats()
        mesh_shape = dict(batch.mesh.shape) if batch.mesh is not None else None
    finally:
        coal.close(timeout_s=10.0) if pkg == "port" else coal.close()
    return outs, batch, stats, mesh_shape


@pytest.mark.parametrize("spec", ["streams", "2x4"])
def test_locked_waves_with_churn_match_unplaced_and_jax(spec):
    """The wave script (re-stack and lock, dense, delta, a seed_choice churn,
    dense, delta) under a placement: every stream's every wave equals the
    unplaced port coalescer's and the JAX coalescer's under the same mesh;
    the roster ends placed, and ``stream_sharded_rosters`` /
    ``locked_rosters`` read as JAX's."""
    cold, script = _wave_script(0x2D04)
    base, _, _, _ = _run_waves("port", None, cold, script)
    outs, batch, stats, shape = _run_waves("port", spec, cold, script)
    jouts, _, jstats, jshape = _run_waves("jax", spec, cold, script)
    assert isinstance(batch.choice, RowShards)
    assert shape == jshape
    for key in ("locked_rosters", "stream_sharded_rosters"):
        assert stats[key] == jstats[key] == 1
    for w in range(len(script)):
        for i in range(N_STREAMS):
            np.testing.assert_array_equal(outs[w][i], base[w][i], err_msg=f"{w}/{i}")
            np.testing.assert_array_equal(outs[w][i], jouts[w][i], err_msg=f"{w}/{i}")
            _assert_valid(outs[w][i], WAVE_P, C)


def test_locked_waves_4x2_match_unplaced():
    """The other 2-D factorization, the port against itself: 8 devices a
    batch of 8 rows, one row a device, the batched K6 once a device."""
    cold, script = _wave_script(0x2D09, waves=4)
    base, _, _, _ = _run_waves("port", None, cold, script, churn_wave=-1)
    outs, batch, _, shape = _run_waves("port", "4x2", cold, script, churn_wave=-1)
    assert shape == {"streams": 4, "p": 2} and len(batch.choice.parts) == 8
    for w in range(len(script)):
        for i in range(N_STREAMS):
            np.testing.assert_array_equal(outs[w][i], base[w][i])


@pytest.mark.parametrize("shape", ["2x4", "4x2"])
def test_corrupt_locked_row_quarantines_and_heals(shape):
    """``device.corrupt.choice`` on a 2-D-placed locked row: the next wave's
    per-row digest catches it, the poisoned stream(s) fail with
    CorruptStateDetected while the rest serve valid answers, and the healed
    re-stack re-locks on the same 2-D placement."""
    rng = np.random.default_rng(0x2D05)
    mgr = port_mesh.MeshManager(devices="auto", shape=shape, solve_min_rows=1 << 20).configure()
    engines = [StreamingAssignor(num_consumers=C, refine_iters=64, refine_threshold=None,
                                 mesh_backend=mgr, device="cpu") for _ in range(N_STREAMS)]
    for e in engines:
        e.rebalance(rng.integers(0, 1000, WAVE_P).astype(np.int64))
    coal = MegabatchCoalescer(window_s=2.0, max_batch=N_STREAMS, lock_waves=1,
                              mesh_manager=mgr, device="cpu")

    def fresh():
        return [rng.integers(0, 1000, WAVE_P).astype(np.int64) for _ in range(N_STREAMS)]

    try:
        _wave(engines, coal, fresh())
        assert _locked_batch(coal).mesh.shape["p"] > 1
        inj = faults.FaultInjector(11).plan("device.corrupt.choice", times=1)
        with faults.injected(inj):
            _, errs = _wave(engines, coal, fresh())
            assert not errs
            outs, errs = _wave(engines, coal, fresh())
        assert inj.fired("device.corrupt.choice") == 1
        assert len(errs) in (1, 2)
        assert all(isinstance(exc, scrub.CorruptStateDetected) for _, exc in errs)
        for o in outs:
            if o is not None:
                _assert_valid(np.asarray(o), WAVE_P, C)
        outs, errs = _wave(engines, coal, fresh())
        assert not errs
        _wave(engines, coal, fresh())
        assert _locked_batch(coal).mesh.shape["p"] > 1
    finally:
        coal.close(timeout_s=10.0)


def test_placed_wave_collective_fault_degrades_down_the_ladder():
    """A ``mesh.collective`` fault before a placed locked wave: the manager
    steps 2d -> streams, every row is still answered (the single-stream
    isolation path), and the next stable wave re-locks on the streams
    mesh."""
    cold, script = _wave_script(0x2D0A, waves=5)
    mgr = port_mesh.MeshManager(devices="auto", shape="2x4", solve_min_rows=1 << 20).configure()
    engines = [StreamingAssignor(num_consumers=C, refine_iters=64, refine_threshold=None,
                                 mesh_backend=mgr, device="cpu") for _ in range(N_STREAMS)]
    for e, a in zip(engines, cold):
        e.rebalance(a.copy())
    coal = MegabatchCoalescer(window_s=2.0, max_batch=N_STREAMS, lock_waves=1,
                              mesh_manager=mgr, device="cpu")
    try:
        _wave(engines, coal, script[0])
        assert _locked_batch(coal).mesh.shape == {"streams": 2, "p": 4}
        with faults.injected(faults.FaultInjector(2).plan("mesh.collective", times=1)):
            outs, errs = _wave(engines, coal, script[1])
        assert not errs
        for o in outs:
            _assert_valid(np.asarray(o), WAVE_P, C)
        assert mgr.rung == "streams"
        for arrs in script[2:4]:
            _, errs = _wave(engines, coal, arrs)
            assert not errs
        assert _locked_batch(coal).mesh.shape == {"streams": 8}
        assert coal.stats()["stream_sharded_rosters"] == 1
    finally:
        coal.close(timeout_s=10.0)
