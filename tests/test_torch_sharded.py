"""The port's P-axis-sharded backend against the JAX package's, on the CPU.

The port's mesh is one process over a device list; here every shard is a
virtual shard on the CPU (``sharded.mesh.set_virtual_shards(8, "cpu")``),
beside the JAX package's 8 virtual CPU devices (``tests/conftest.py``).

* the mesh manager: spec and shape parsing, configure (auto, fixed, 2-D,
  missing devices, an unsatisfiable shape), off is inert, the degrade /
  restore cycle down the ladder with the same counter series, the
  ``mesh.collective`` check, the row floor, activate scoping and the
  dispatch's selection;
* ``solve_sharded`` / ``refine_sharded`` / ``plan_stats_sharded`` bit for
  bit with JAX at D = 1, 2, 4, 8 (choice, counts, totals, rounds) over a
  small fuzz of seeds, unaligned P, the indivisible-length error;
* ``solve_linear_sharded``: bit-identical across D = 1, 2, 4, 8 and to the
  port's single-device linear solve; its duals within the tolerance of
  ``tests/test_torch_quality.py`` against JAX's sharded duals (two
  iterations: |dA| <= 1e-4 max|A|, |dB| <= 1e-5); the rounded assignment
  held to the invariants;
* the streaming engine's cold routing (floor, pinned off, explicit
  manager, the global manager), a ``mesh.collective`` fault served
  single-device inside the same epoch, concurrent dispatch;
* the config knobs, the warm-up's sharded jobs, and twin sidecars (JAX and
  port, same knobs): ``stats.mesh`` and a sharded cold epoch.

The port's ``status()`` has one key the JAX manager's lacks, ``virtual``;
every other key is compared.
"""

import contextlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import streaming as jax_streaming  # noqa: E402
from kafka_lag_based_assignor_tpu.sharded import mesh as jax_mesh  # noqa: E402
from kafka_lag_based_assignor_tpu.sharded import solve as jax_solve  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import config as jax_config  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import warmup  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import dispatch, linear_ot  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import linear_ot_cuda, refine  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.packing import pad_topic_rows  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.streaming import StreamingAssignor  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded import collectives  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded import mesh as port_mesh  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded import solve as port_solve  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import config  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import faults, metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils.observability import (  # noqa: E402
    count_constrained_bound,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="virtual 8-device CPU mesh unavailable")

MESH_SIZES = (1, 2, 4, 8)


@pytest.fixture(scope="module", autouse=True)
def virtual_cpu_shards():
    port_mesh.set_virtual_shards(8, "cpu")
    yield
    port_mesh.set_virtual_shards(None)


@pytest.fixture(autouse=True)
def no_global_manager():
    for mod in (faults, jax_faults):
        mod.deactivate()
    for mod in (port_mesh, jax_mesh):
        mod.deactivate()
    yield
    for mod in (faults, jax_faults):
        mod.deactivate()
    for mod in (port_mesh, jax_mesh):
        mod.deactivate()


def jmesh(D):
    return JaxMesh(np.asarray(jax.devices()[:D]), (jax_mesh.SOLVE_AXIS,))


def pmesh(D):
    return port_mesh.Mesh(port_mesh.visible_devices()[:D], (port_mesh.SOLVE_AXIS,))


def skewed(seed, P, scale=100):
    return (np.random.default_rng(seed).zipf(1.3, P) * scale).astype(np.int64)


def counters(module, prefix="klba_mesh"):
    return {
        (name, tuple(sorted(s["labels"].items()))): s["value"]
        for name, entry in module.REGISTRY.snapshot().items()
        if entry["type"] == "counter" and name.startswith(prefix)
        for s in entry["series"]
    }


def moved(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


class Series:
    """The counter series one block moves in each package's registry."""

    def __init__(self, prefix="klba_"):
        self.prefix = prefix
        self.before = (counters(jax_metrics, prefix), counters(metrics, prefix))

    def alike(self):
        got = (moved(self.before[0], counters(jax_metrics, self.prefix)),
               moved(self.before[1], counters(metrics, self.prefix)))
        assert got[1] == got[0]
        return got[1]


def port_status(mgr):
    """The port manager's status without its one extra key, ``virtual``
    (True once a spec other than "off" is configured on virtual shards)."""
    status = dict(mgr.status())
    assert status.pop("virtual") == (status["configured"] and mgr.spec != "off")
    return status


def valid_assignment(choice, P, C):
    choice = np.asarray(choice)
    assert choice.shape == (P,)
    assert choice.min() >= 0 and choice.max() < C
    counts = np.bincount(choice, minlength=C)
    assert counts.max() - counts.min() <= 1
    return counts


def quality(choice, lags, C):
    totals = np.bincount(choice, weights=lags, minlength=C)
    return float(totals.max() / totals.mean()) / max(count_constrained_bound(lags, C), 1.0)


# -- the mesh manager --------------------------------------------------------


@pytest.mark.parametrize("spec", ["off", None, "", 0, "0", "auto", 1, "4", 8, "-1", "lots"])
def test_spec_parsing_matches_jax(spec):
    outcomes = []
    for mod in (jax_mesh, port_mesh):
        try:
            outcomes.append(("ok", mod._parse_spec(spec)))
        except ValueError as exc:
            outcomes.append(("raise", str(exc)))
    assert outcomes[1] == outcomes[0]


@pytest.mark.parametrize("shape", ["off", "auto", "2x4", "2*2", (1, 8), "0x4", "2x", "ab"])
def test_shape_parsing_matches_jax(shape):
    outcomes = []
    for mod in (jax_mesh, port_mesh):
        try:
            outcomes.append(("ok", mod._parse_shape(shape)))
        except ValueError as exc:
            outcomes.append(("raise", str(exc)))
    assert outcomes[1] == outcomes[0]
    assert [port_mesh.auto_shape(n) for n in range(1, 17)] == [
        jax_mesh.auto_shape(n) for n in range(1, 17)]


@pytest.mark.parametrize("devices,shape,floor", [
    ("auto", "off", 256), (4, "off", 1024), (2, "auto", 65536), (8, "2x4", 512),
    (8, "auto", 512), (16, "off", 256), (6, "2x2", 256), ("off", "off", 256),
])
def test_configure_matches_jax(devices, shape, floor):
    series = Series("klba_mesh")
    want = jax_mesh.MeshManager(devices=devices, solve_min_rows=floor, shape=shape).configure()
    got = port_mesh.MeshManager(devices=devices, solve_min_rows=floor, shape=shape).configure()
    assert port_status(got) == want.status()
    assert (got.active, got.size, got.rung, got.mesh_shape) == (
        want.active, want.size, want.rung, want.mesh_shape)
    assert got.should_shard_solve(floor) == want.should_shard_solve(floor)
    assert got.should_shard_solve(floor - 1) is False
    if got.solve_available:
        assert got.solve_mesh().shape == dict(want.solve_mesh().shape)
        assert got.solve_mesh().virtual
    if got.mesh2d_available:
        assert got.mesh2d().shape == dict(want.mesh2d().shape)
    series.alike()


def test_off_is_inert_and_missing_devices_degrade():
    mgr = port_mesh.MeshManager(devices="off")
    assert not mgr.active and mgr.size == 0
    with pytest.raises(RuntimeError, match="not active"):
        mgr.solve_mesh()
    port_mesh.set_virtual_shards(None)
    try:
        # No card and no virtual shards on the CPU: nothing is visible.
        if not torch.cuda.is_available():
            assert port_mesh.visible_devices() == []
            lone = port_mesh.MeshManager(devices="auto").configure()
            assert lone.status()["degraded"] is None and not lone.active
    finally:
        port_mesh.set_virtual_shards(8, "cpu")


def test_virtual_shards_from_the_environment(monkeypatch):
    port_mesh.set_virtual_shards(None)
    try:
        monkeypatch.setenv(port_mesh.VIRTUAL_SHARDS_ENV, "3:cpu")
        assert port_mesh.visible_devices() == [torch.device("cpu")] * 3
        mgr = port_mesh.MeshManager(devices="auto").configure()
        assert mgr.size == 3 and mgr.status()["virtual"] is True
        monkeypatch.setenv(port_mesh.VIRTUAL_SHARDS_ENV, "x")
        with pytest.raises(ValueError, match=port_mesh.VIRTUAL_SHARDS_ENV):
            port_mesh.visible_devices()
    finally:
        port_mesh.set_virtual_shards(8, "cpu")


@pytest.mark.parametrize("shape", ["off", "2x4"])
def test_degrade_restore_cycle_matches_jax(shape):
    series = Series("klba_mesh")
    pair = [mod.MeshManager(devices=8, solve_min_rows=256, shape=shape).configure()
            for mod in (jax_mesh, port_mesh)]
    rungs = []
    for _ in range(4):
        for mgr in pair:
            mgr.degrade("collective")
        assert port_status(pair[1]) == pair[0].status()
        rungs.append(pair[1].rung)
    assert rungs == (["streams", "p", "single", "single"] if shape == "2x4"
                     else ["single"] * 4)
    for mgr in pair:
        mgr.restore()
    assert port_status(pair[1]) == pair[0].status()
    assert pair[1].active
    got = series.alike()
    assert got[("klba_mesh_degraded_total", (("reason", "collective"),))] >= 1


def test_check_collective_degrades_one_rung():
    series = Series("klba_mesh")
    pair = [mod.MeshManager(devices=4, solve_min_rows=256).configure()
            for mod in (jax_mesh, port_mesh)]
    for fmod, mmod, mgr in ((jax_faults, jax_mesh, pair[0]), (faults, port_mesh, pair[1])):
        with fmod.injected(fmod.FaultInjector(0).plan("mesh.collective", "raise")):
            with pytest.raises(mmod.MeshCollectiveError):
                mgr.check_collective()
        mgr.check_collective()  # no fault: a no-op
    assert port_status(pair[1]) == pair[0].status()
    assert pair[1].rung == "single"
    series.alike()


def test_activate_scoping_and_selection():
    a = port_mesh.MeshManager(devices=4, solve_min_rows=1000).configure()
    b = port_mesh.MeshManager(devices=2, solve_min_rows=1000).configure()
    assert dispatch.sharded_solve_manager(5000, 8) is None
    with port_mesh.managed(a):
        assert port_mesh.active_manager() is a
        assert dispatch.sharded_solve_manager(5000, 8) is a
        assert dispatch.sharded_solve_manager(999, 8) is None
        assert dispatch.sharded_solve_manager(5000, 1) is None
        port_mesh.deactivate(b)  # not the installed one: a no-op
        assert port_mesh.active_manager() is a
    assert port_mesh.active_manager() is None


def test_collectives_reduce_in_order_and_never_alias():
    parts = [torch.tensor([1.0, 5.0]) * (d + 1) for d in range(4)]
    out = collectives.psum(parts)
    assert all(torch.equal(o, torch.tensor([10.0, 50.0])) for o in out)
    assert len({o.data_ptr() for o in out}) == 4
    assert all(o.data_ptr() != p.data_ptr() for o, p in zip(out, parts))
    assert torch.equal(collectives.pmin(parts)[2], parts[0])
    assert torch.equal(collectives.pmax(parts)[0], parts[3])
    g = collectives.all_gather(parts)
    assert g[1].shape == (4, 2) and torch.equal(g[3][2], parts[2])
    t = collectives.all_gather(parts, tiled=True)
    assert t[0].shape == (8,) and t[0].data_ptr() != t[1].data_ptr()
    single = collectives.psum(parts[:1])
    assert single[0].data_ptr() != parts[0].data_ptr()


# -- the exchange program ---------------------------------------------------


@pytest.mark.parametrize("D", MESH_SIZES)
@pytest.mark.parametrize("seed,P,C", [(0, 3000, 16), (1, 4097, 37)])
def test_solve_sharded_bit_equal_to_jax(D, seed, P, C):
    lags = skewed(seed, P)
    series = Series("klba_sharded")
    want = jax_solve.solve_sharded(jmesh(D), lags, C, refine_iters=24)
    got = port_solve.solve_sharded(pmesh(D), lags, C, refine_iters=24)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3] == want[3]
    valid_assignment(got[0], P, C)
    series.alike()


def test_mesh1_seed_is_the_host_twin():
    lags = skewed(5, 2500)
    got = port_solve.solve_sharded(pmesh(1), lags, 8, refine_iters=0)[0]
    np.testing.assert_array_equal(got, port_solve.seed_reference(lags, 8))
    np.testing.assert_array_equal(port_solve.seed_reference(lags, 8),
                                  jax_solve.seed_reference(lags, 8))


@pytest.mark.parametrize("D", MESH_SIZES)
def test_refine_sharded_bit_equal_to_jax(D):
    P, C = 2048, 12
    rng = np.random.default_rng(D)
    lags = skewed(10 + D, P)
    valid = np.arange(P) < P - 37
    choice = np.where(valid, rng.permutation(P) % C, -1).astype(np.int32)
    lags = np.where(valid, lags, 0)
    want = jax_solve.refine_sharded(jmesh(D), lags, valid, choice, C, iters=16)
    got = port_solve.refine_sharded(pmesh(D), lags, valid, choice, C, iters=16)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3] == want[3]
    if D == 1:
        # Mesh size 1 IS the oracle refine.
        ref = refine.refine_assignment(torch.from_numpy(lags), torch.from_numpy(valid),
                                       torch.from_numpy(choice), C, iters=16)
        np.testing.assert_array_equal(got[0], ref[0].numpy())


def test_refine_sharded_rejects_indivisible_length():
    lags = np.ones(10, np.int64)
    args = (lags, np.ones(10, bool), np.zeros(10, np.int32), 2)
    for fn, mesh in ((jax_solve.refine_sharded, jmesh(4)), (port_solve.refine_sharded, pmesh(4))):
        with pytest.raises(ValueError, match="must divide"):
            fn(mesh, *args)


@pytest.mark.parametrize("D", (2, 8))
def test_plan_stats_sharded_bit_equal_to_jax(D):
    P, C = 1024, 9
    lags = skewed(3, P)
    valid = np.arange(P) % 11 != 0
    choice = np.where(valid, np.arange(P) % C, -1).astype(np.int32)
    want = jax_solve.plan_stats_sharded(jmesh(D), lags, valid, choice, C)
    got = port_solve.plan_stats_sharded(pmesh(D), lags, valid, choice, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_shard_bucket_picks_by_device():
    assert port_solve.shard_bucket(5000, 8, "cpu") == jax_solve.shard_bucket(5000, 8)
    assert port_solve.shard_bucket(5000, 8, "cuda") == 8192
    assert port_solve.shard_bucket(4097, 3, "cpu") % 3 == 0


# -- the linear-OT quality solve ---------------------------------------------

LINEAR_P, LINEAR_C = 5000, 24


@pytest.fixture(scope="module")
def linear_single_device():
    lags = skewed(2, LINEAR_P)
    lp, pp, vp = pad_topic_rows(lags)
    return lags, linear_ot.assign_topic_linear(lp, pp, vp, LINEAR_C, refine_iters=64,
                                               device="cpu")


@pytest.mark.parametrize("D", MESH_SIZES)
def test_linear_sharded_bit_identical_across_meshes(D, linear_single_device):
    lags, ref = linear_single_device
    before = counters(metrics, "klba_sharded")
    choice, counts, totals, rounds = port_solve.solve_linear_sharded(
        pmesh(D), lags, LINEAR_C, refine_iters=64)
    np.testing.assert_array_equal(choice, ref[0][:LINEAR_P])
    np.testing.assert_array_equal(counts, ref[1])
    np.testing.assert_array_equal(totals, ref[2])
    assert linear_ot.last_solve_info()["backend"] == f"sharded:{D}"
    paths = {k[1][0][1] for k in moved(before, counters(metrics, "klba_sharded"))}
    assert paths == ({"linear"} if D == 1 else {"linear", "rounding"})


@pytest.mark.parametrize("D", (2, 4))
def test_linear_sharded_duals_track_jax(D):
    from kafka_lag_based_assignor_tpu.models import sinkhorn as jax_sinkhorn

    P2, C, tile = 4096, 37, 256
    lags = np.zeros(P2, np.int64)
    lags[:3000] = skewed(8, 3000)
    valid = np.arange(P2) < 3000
    scale = jax_sinkhorn._scale_np(lags, valid, C)
    step = jax_solve._linear_duals_executable(jmesh(D), C, 2, tile)
    lags_d, valid_d = jax_solve._place_inputs(jmesh(D), lags, valid)
    A, B, rounds = step(lags_d, valid_d, np.float64(scale), np.float32(3000))
    lp, vp = port_solve._place_inputs(pmesh(D), lags, valid)
    a, b, r = port_solve._linear_duals_sharded(lp, vp, scale, 3000.0, C, 2, tile)
    assert r == int(rounds) == 2
    A, B = np.asarray(A), np.asarray(B)
    for d in range(D):
        np.testing.assert_allclose(a[d].numpy(), A, rtol=0, atol=1e-4 * np.abs(A).max())
        np.testing.assert_allclose(b[d].numpy(), B, rtol=0, atol=1e-5)
        assert torch.equal(a[d], a[0]) and torch.equal(b[d], b[0])


def test_linear_sharded_assignment_holds_the_invariants_beside_jax(linear_single_device):
    lags, _ = linear_single_device
    want = np.asarray(jax_solve.solve_linear_sharded(jmesh(4), lags, LINEAR_C)[0])
    got = port_solve.solve_linear_sharded(pmesh(4), lags, LINEAR_C)[0]
    for choice in (want, got):
        valid_assignment(choice, LINEAR_P, LINEAR_C)
        totals = np.bincount(choice, weights=lags, minlength=LINEAR_C)
        assert totals.max() <= linear_ot.additive_bound(lags, np.ones(LINEAR_P, bool),
                                                        LINEAR_C) + 0.5
    assert quality(got, lags, LINEAR_C) <= quality(want, lags, LINEAR_C) * 1.02


def test_linear_sharded_rejects_bad_meshes_and_shards():
    lags = skewed(1, 300)
    for fn, mesh in ((jax_solve.solve_linear_sharded, jmesh(3)),
                     (port_solve.solve_linear_sharded, pmesh(3))):
        with pytest.raises(ValueError, match="pow2 mesh size"):
            fn(mesh, lags, 4)
    # 16,385 consumers, once refused, are answered; zero consumers raise.
    valid_assignment(port_solve.solve_linear_sharded(pmesh(2), lags, 16385)[0], 300, 16385)
    with pytest.raises(ValueError, match="consumers"):
        port_solve.solve_linear_sharded(pmesh(2), lags, 0)
    with pytest.raises(ValueError, match="tiles"):
        linear_ot_cuda.admit_sharded(100, 4, 64)


# -- the streaming engine ----------------------------------------------------


def engines(mgrs, C, **kw):
    return (jax_streaming.StreamingAssignor(num_consumers=C, mesh_backend=mgrs[0], **kw),
            StreamingAssignor(num_consumers=C, mesh_backend=mgrs[1], device="cpu", **kw))


@contextlib.contextmanager
def both_quality(mode):
    from kafka_lag_based_assignor_tpu.ops import dispatch as jax_dispatch

    with jax_dispatch.quality_scope(mode), dispatch.quality_scope(mode):
        yield


def test_engine_exchange_cold_epoch_and_warm_loop_match_jax():
    P, C = 3000, 8
    mgrs = [mod.MeshManager(devices=4, solve_min_rows=2048).configure()
            for mod in (jax_mesh, port_mesh)]
    rng = np.random.default_rng(4)
    lags = skewed(4, P)
    series = Series()
    with both_quality("sinkhorn"):
        pair = engines(mgrs, C, refine_iters=64)
        for epoch in range(4):
            out = [e.rebalance(lags) for e in pair]
            np.testing.assert_array_equal(out[1], out[0])
            assert vars(pair[1].last_stats) == vars(pair[0].last_stats)
            assert pair[1].last_stats.sharded_solve == (epoch == 0)
            lags = lags.copy()
            lags[rng.integers(0, P, 300)] += rng.integers(1, 10**4, 300)
    got = series.alike()
    assert got[("klba_sharded_dispatch_total", (("path", "solve"),))] == 1


@pytest.mark.parametrize("pin", ["auto", "explicit", "off", "below_floor"])
def test_engine_cold_routing(pin):
    P, C = 5000, 8
    mgr = port_mesh.MeshManager(devices=4, solve_min_rows=P + (pin == "below_floor")).configure()
    backend = {"auto": "auto", "explicit": mgr, "off": None, "below_floor": "auto"}[pin]
    with port_mesh.managed(mgr) if pin != "explicit" else contextlib.nullcontext():
        eng = StreamingAssignor(num_consumers=C, mesh_backend=backend, device="cpu")
        choice = eng.rebalance(skewed(6, P))
    assert eng.last_stats.sharded_solve == (pin in ("auto", "explicit"))
    valid_assignment(choice, P, C)
    if eng.last_stats.sharded_solve:
        with dispatch.quality_scope("linear"):
            single = StreamingAssignor(num_consumers=C, mesh_backend=None, device="cpu")
            np.testing.assert_array_equal(choice, single.rebalance(skewed(6, P)))


def test_collective_fault_degrades_inside_the_epoch():
    P, C = 3000, 8
    mgrs = [mod.MeshManager(devices=4, solve_min_rows=2048).configure()
            for mod in (jax_mesh, port_mesh)]
    lags = skewed(9, P)
    series = Series("klba_mesh")
    with both_quality("sinkhorn"):
        pair = engines(mgrs, C)
        with contextlib.ExitStack() as stack:
            for mod in (jax_faults, faults):
                stack.enter_context(mod.injected(
                    mod.FaultInjector(0).plan("mesh.collective", "raise", times=1)))
            out = [e.rebalance(lags) for e in pair]
    np.testing.assert_array_equal(out[1], out[0])
    assert not pair[1].last_stats.sharded_solve and pair[1].last_stats.cold_start
    valid_assignment(out[1], P, C)
    assert port_status(mgrs[1]) == mgrs[0].status()
    assert mgrs[1].status()["degraded"] == "solve"
    got = series.alike()
    assert got[("klba_mesh_degrade_total", (("from", "1d"), ("to", "single")))] == 1


def test_concurrent_dispatch_serializes_and_nests():
    P, C, N = 2048, 8, 5
    mesh = pmesh(8)
    inputs = [skewed(30 + i, P) for i in range(N)]
    serial = [port_solve.solve_sharded(mesh, x, C, refine_iters=16)[0] for x in inputs]
    results, errors = [None] * N, []

    def run(i):
        try:
            results[i] = port_solve.solve_sharded(mesh, inputs[i], C, refine_iters=16)[0]
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(N)]
    with port_mesh.dispatch_gate():  # re-entrant: a nested entry runs
        nested = port_solve.solve_sharded(mesh, inputs[0], C, refine_iters=16)[0]
        for t in threads:
            t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    np.testing.assert_array_equal(nested, serial[0])
    for got, want in zip(results, serial):
        np.testing.assert_array_equal(got, want)


# -- configuration, warm-up, sidecar -----------------------------------------


@pytest.mark.parametrize("props", [
    {}, {"tpu.assignor.mesh.devices": "auto", "tpu.assignor.mesh.solve.min.rows": "2048"},
    {"tpu.assignor.mesh.devices": "4", "tpu.assignor.mesh.shape": "2*2"},
    {"tpu.assignor.mesh.devices": "lots"}, {"tpu.assignor.mesh.shape": "2x"},
    {"tpu.assignor.mesh.solve.min.rows": "0"},
])
def test_config_knobs_match_jax(props):
    outcomes = []
    for parse in (jax_config.parse_config, config.parse_config):
        try:
            cfg = parse({"group.id": "g", **props})
            outcomes.append((cfg.mesh_devices, cfg.mesh_solve_min_rows, cfg.mesh_shape))
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes[1] == outcomes[0]


def test_warmup_runs_the_sharded_cold_solve():
    from kafka_lag_based_assignor_tpu import warmup as jax_warmup

    mgrs = [mod.MeshManager(devices=4, solve_min_rows=256).configure()
            for mod in (jax_mesh, port_mesh)]
    kw = dict(max_partitions=300, consumers=[4], solvers=("stream",), delta_buckets=0)
    want = jax_warmup.warmup(mesh_manager=mgrs[0], **kw)
    got = warmup.warmup(mesh_manager=mgrs[1], device="cpu", **kw)
    assert [r[:4] for r in got] == [r[:4] for r in want]
    names = {r[0]: r[4] for r in got}
    assert names["sharded_linear"] > 0 and names["sharded_resident"] > 0
    assert mgrs[1].active


class MeshTwin:
    """A JAX sidecar and the port's (``device="cpu"``) with the same mesh
    knobs and clock; coalescing and the scrubber off."""

    def __init__(self, quality_mode, **mesh):
        import test_torch_service as tts

        self.tts = tts
        self.pair = tts.Twin(quality_mode=quality_mode, **mesh)

    def stream(self, sid, lags, members):
        params = {"stream_id": sid, "topic": "t0", "members": members,
                  "lags": [[i, int(x)] for i, x in enumerate(lags)]}
        return self.pair.send(self.tts.json.dumps(
            {"id": 1, "method": "stream_assign", "params": params}).encode())

    def stats_mesh(self):
        got = self.pair.send(b'{"id": 2, "method": "stats"}')
        return [r["result"]["mesh"] for r in got]


def wire_choice(reply, members, P):
    choice = np.full(P, -1)
    for m, parts in reply["result"]["assignments"].items():
        for _, p in parts:
            choice[p] = members.index(m)
    return choice


@pytest.mark.parametrize("mode", ["sinkhorn", "auto"])
def test_sidecar_stats_and_sharded_cold_epoch_match_jax(mode):
    P, members = 1200, [f"m{i}" for i in range(6)]
    twin = MeshTwin(mode, mesh_devices=4, mesh_solve_min_rows=1024)
    try:
        want, got = twin.stats_mesh()
        virtual = got.pop("virtual")
        assert virtual is True and got == want and got["active"] and got["devices"] == 4
        lags = skewed(12, P)
        replies = twin.stream("big", lags, members)
        for r in replies:
            assert r["result"]["stream"]["sharded_solve"] is True
            valid_assignment(wire_choice(r, members, P), P, len(members))
        if mode == "sinkhorn":
            assert twin.tts.normalized(replies[1]) == twin.tts.normalized(replies[0])
        small = twin.stream("small", lags[:500], members)
        assert all(not r["result"]["stream"]["sharded_solve"] for r in small)
        twin.pair.series_moved_alike()
    finally:
        twin.pair.close()
    assert port_mesh.active_manager() is None


def test_sidecar_collective_fault_degrades_and_answers_single_device():
    P, members = 1200, ["a", "b", "c"]
    twin = MeshTwin("sinkhorn", mesh_devices=4, mesh_solve_min_rows=1024)
    try:
        with contextlib.ExitStack() as stack:
            for mod in (jax_faults, faults):
                stack.enter_context(mod.injected(
                    mod.FaultInjector(0).plan("mesh.collective", "raise", times=1)))
            replies = twin.stream("s", skewed(13, P), members)
        assert twin.tts.normalized(replies[1]) == twin.tts.normalized(replies[0])
        assert replies[1]["result"]["stream"]["sharded_solve"] is False
        valid_assignment(wire_choice(replies[1], members, P), P, 3)
        want, got = twin.stats_mesh()
        got.pop("virtual")
        assert got == want and got["rung"] == "single" and got["degraded"] == "solve"
        series = twin.pair.series_moved_alike()
        assert series[("klba_mesh_degrade_total", (("from", "1d"), ("to", "single")))] == 1
    finally:
        twin.pair.close()


def test_sidecar_reads_the_mesh_knobs_from_config():
    from kafka_lag_based_assignor_tpu_torch import service

    svc = service.AssignorService.from_config(
        {"group.id": "g", "tpu.assignor.mesh.devices": "2",
         "tpu.assignor.mesh.solve.min.rows": "4096"}, device="cpu")
    try:
        assert svc._mesh.spec == 2 and svc._mesh.solve_min_rows == 4096
    finally:
        svc.stop()
    off = service.AssignorService(port=0, device="cpu", scrub_interval_ms=0)
    try:
        assert off._mesh is None
    finally:
        off.stop()
